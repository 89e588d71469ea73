"""Closed loop: a fixed number of requests kept outstanding; each answer
sends the next request of the stream. The window counts the answers that
reach the host inside it."""

import time

from harness.serve import Server
from harness.window import serve_window, settle


def run(run):
    srv = Server(run)
    mix = run.cell.traffic
    stream = iter(srv.stream)
    state = {"open": True}

    def send_next(_served=None):
        with srv.lock:
            if not state["open"]:
                return
            req = next(stream)
        srv.submit(req, due=time.perf_counter())

    srv.on_done = send_next
    settle()
    for _ in range(mix["outstanding"]):
        send_next()
    time.sleep(mix["ramp_s"])
    serve_window(run, srv, time.perf_counter())
    with srv.lock:
        state["open"] = False
    w0, w1 = run.window
    run.requests = [s for s in srv.served.values() if s.done is not None and w0 <= s.done < w1]
    srv.finish()

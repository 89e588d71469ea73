"""Open loop: requests due on the mix's arrival schedule, whatever the
system's state; each timed from when it was due. The requests due before
the window warm the system up; those due in it are the window's. Every
request due before the window closes is made in set-up."""

import itertools
import threading
import time

from harness.serve import Server
from harness.window import serve_window, settle


def run(run):
    srv = Server(run)
    mix = run.cell.traffic
    ramp, seconds = mix["ramp_s"], run.seconds
    reqs = list(itertools.takewhile(lambda r: r.due < ramp + seconds, srv.stream))
    settle()
    base = time.perf_counter() + 0.05
    late = []

    def generate():
        for req in reqs:
            target = base + req.due
            wait = target - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - target)
            srv.submit(req, due=target)

    gen = threading.Thread(target=generate, daemon=True)
    gen.start()
    serve_window(run, srv, base + ramp)
    gen.join(timeout=60)
    w0, w1 = run.window
    run.requests = [s for s in srv.served.values() if w0 <= s.due < w1]
    late.sort()
    if late:
        run.note(f"generator lateness: median {late[len(late) // 2] * 1e3:.3f} ms, "
                 f"p99 {late[int(0.99 * (len(late) - 1))] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms "
                 f"over {len(late)} sends")
    srv.finish()

"""The measured window of a serving cell, and its traced slice."""

from __future__ import annotations

import faulthandler
import gc
import threading
import time
from contextlib import contextmanager

SETUP_S = 300  # from the process's start to the window's open, at most
AFTER_WINDOW_S = 240  # from the window's close to the result line, at most
_armed = False


def settle() -> None:
    """End of set-up: collect, then move every object set-up made (the
    libraries, the program, the requests made ahead) out of the collector's
    reach, so that a full collection in the window scans only what the
    window makes: one over the whole heap stalls every thread of the
    process for a tenth of a second or more."""
    gc.collect()
    gc.freeze()


def arm(seconds: float = SETUP_S) -> None:
    """The watchdog of a run started from the command line: should it not
    be disarmed in `seconds`, write every thread's stack to stderr and exit
    1, so that a hang names where it waits."""
    global _armed
    _armed = True
    faulthandler.dump_traceback_later(seconds, exit=True)


def disarm() -> None:
    global _armed
    _armed = False
    faulthandler.cancel_dump_traceback_later()


def watch(run) -> None:
    """At the window's open, give an armed watchdog the window and
    AFTER_WINDOW_S past its close."""
    if _armed:
        arm(run.seconds + AFTER_WINDOW_S)


class Gate:
    """Lets the front's calls and fetches run together, and the profiler
    start or stop alone: with no other thread inside the program or the
    CUDA runtime and the device drained, as the training loop starts and
    stops it. Used only with --trace 1."""

    def __init__(self):
        self._cv = threading.Condition()
        self._inside = 0
        self._shut = False

    @contextmanager
    def call(self):
        with self._cv:
            self._cv.wait_for(lambda: not self._shut)
            self._inside += 1
        try:
            yield
        finally:
            with self._cv:
                self._inside -= 1
                self._cv.notify_all()

    @contextmanager
    def alone(self):
        import torch

        with self._cv:
            self._shut = True
            self._cv.wait_for(lambda: self._inside == 0)
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            yield
        finally:
            with self._cv:
                self._shut = False
                self._cv.notify_all()


def sleep_until(t: float) -> None:
    wait = t - time.perf_counter()
    if wait > 0:
        time.sleep(wait)


def serve_window(run, srv, t0: float) -> None:
    """Open the window at t0 (perf_counter), record the front's calls for
    run.seconds, and with --trace 1 profile its last `trace_s` seconds,
    started and stopped through the front's gate."""
    sleep_until(t0)
    watch(run)
    run.setup_s = t0 - run.started
    run.note(f"window opens {run.setup_s:.3f} s after the process started")
    srv.window = (t0, t0 + run.seconds)
    srv.front.recording = True
    if run.trace:
        from harness.trace import Profile

        gate = srv.front.gate
        sleep_until(t0 + run.seconds - min(run.cell.traffic["trace_s"], run.seconds))
        run.profile = Profile()
        with gate.alone():
            run.profile.start()
        sleep_until(t0 + run.seconds)
        with gate.alone():
            t1 = time.perf_counter()
            run.profile.stop()
        run.profile.collect()
        run.note(f"trace: the profiler took {run.profile.stop_s:.3f} s to stop, {len(run.profile.records)} device records")
    else:
        sleep_until(t0 + run.seconds)
        t1 = time.perf_counter()
    srv.front.recording = False
    if run.profile is not None:
        run.profile.spans = srv.front.spans
    run.window = srv.window = (t0, t1)
    run.batches = [b for b in srv.front.batches if t0 <= b.start < t1]

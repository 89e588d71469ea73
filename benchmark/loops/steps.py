"""Training steps back to back: each step is dispatched, then the one
before it is waited for, so one step is always queued on the device. The
window ends at the completion of the first step that ends after
--seconds; every step it holds is whole. With --trace 1 the steps from the
window's last `trace_s` seconds on are profiled, from a drained device to a
drained device (the step queued when the window closes among them)."""

import time

import torch

from harness.train import Trainer, check
from harness.trace import Profile
from harness.window import settle, watch


def run(run):
    tr = Trainer(run)
    tr.warm()
    mix, cuda = run.cell.traffic, run.device.type == "cuda"
    if run.trace and cuda:
        from harness.trace import warm_profiler

        warm_profiler()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    settle()
    t0 = time.perf_counter()
    watch(run)
    run.setup_s = t0 - run.started
    trace_from = t0 + run.seconds - min(mix["trace_s"], run.seconds)
    spans, traced, pending = [], 0, None  # pending: (step, its completion event)
    while True:
        if run.trace and run.profile is None and time.perf_counter() >= trace_from and pending is not None:
            sync()
            pending[0].done = time.perf_counter()
            run.steps.append(pending[0])
            pending = None
            if run.steps[-1].done - t0 >= run.seconds:
                break
            run.profile = Profile()
            run.profile.start()
        w0 = time.time_ns()
        s = tr.one()
        w1 = time.time_ns()
        traced += run.profile is not None
        ev = torch.cuda.Event() if cuda else None
        if ev is not None:
            ev.record()
        if pending is not None:
            if pending[1] is not None:
                pending[1].synchronize()
            pending[0].done = time.perf_counter()
            run.steps.append(pending[0])
            if run.profile is not None:
                spans += [("program: step() dispatch", w0, w1), ("host: wait for the step before", w1, time.time_ns())]
        pending = (s, ev)
        if run.steps and run.steps[-1].done - t0 >= run.seconds:
            break
    run.window = (t0, run.steps[-1].done)
    sync()
    if run.profile is not None:
        run.profile.stop()
        run.profile.collect()
        run.note(f"trace: the profiler took {run.profile.stop_s:.3f} s to stop, {len(run.profile.records)} device records")
        run.profile.spans = spans
        run.profile.steps = traced
    run.attempted = len(run.steps)
    run.failed = sum(1 for st in run.steps if not torch.isfinite(st.loss).item())
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    tr.free_program()
    chk = run.cell.config["check"]
    check(run, tr, {k: v for k, v in chk.items() if k.endswith("_gap")}, chk["rows_per_block"])

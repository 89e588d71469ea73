"""Tracing, metrics and stage timing (port of smalltts_tpu/utils/profiling.py):

- `trace(dir)`: a torch.profiler trace (host ops, and the card's kernels
  where there is a card) written into `dir` as a Chrome trace;
- `annotate(name)`: a named range inside a trace (record_function);
- `MetricsLogger`: a JSONL metrics file and stdout;
- `StageTimer`: named wall-clock stages.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str = "out/trace") -> Iterator:
    """Profile the block with torch.profiler (CPU activity, and CUDA where a
    card is present) and write its Chrome trace (open it in Perfetto or
    chrome://tracing) to `log_dir`/smalltts_<pid>_<ms>.pt.trace.json. Yields
    the profiler; its `trace_file` names the file once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, f"smalltts_{os.getpid()}_{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(path)
        prof.trace_file = path


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A range named `name` in the trace being taken (none outside one)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class StageTimer:
    """Accumulates named wall-clock stages."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        ms = (now - self._t) * 1e3
        self.stages[name] = self.stages.get(name, 0.0) + ms
        self._t = now
        return ms

    @property
    def total_ms(self) -> float:
        return sum(self.stages.values())


class MetricsLogger:
    """One JSON record a call, {"step": n, name: value, ...}, appended to
    `path` (when given) and echoed to stdout."""

    def __init__(self, path: Optional[str] = None, echo: bool = True) -> None:
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        if self.echo:
            body = " ".join(f"{k}={v:.5g}" for k, v in record.items() if k != "step")
            print(f"step {step}: {body}")

    def close(self) -> None:
        if self._f:
            self._f.close()

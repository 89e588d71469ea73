"""Tracing and metrics (port of smalltts_tpu/utils/profiling.py, with the
program's own spans):

- `annotate(name, **attrs)`: one span of the program, kept in memory while
  a torch.profiler runs in any thread of the process;
- `record(name, start, end, **attrs)`: a span from stamps taken earlier;
- `spans()` / `dropped()`: the spans kept, and how many the bound dropped;
- `trace(dir)`: a torch.profiler trace (host ops, and the card's kernels
  where there is a card) written into `dir` as a Chrome trace, in which
  each span is also a named range;
- `MetricsLogger`: a JSONL metrics file and stdout.

A span's start and end are `time.time_ns()`, the clock that torch.profiler
converts its records to, so spans and the device's records share one clock.
Span names are `<layer>.<stage>` (batcher.queue, pipeline.replay,
teacher.forward, ...).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

# `_is_profiler_enabled` is torch's process-wide flag, set while any
# torch.profiler runs; torch.autograd._profiler_enabled() is per thread and
# reads False in a thread started before the profiler.
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 17


class Span(NamedTuple):
    name: str
    start: int  # ns, time.time_ns()
    end: int
    thread: int  # threading.get_native_id()
    id: int
    parent: Optional[int]  # the id of the span open around it in its thread
    attrs: dict


_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_ranges = False  # inside trace(): each span is a record_function range too


def _keep(span: Span) -> None:
    global _dropped
    with _lock:
        _dropped += len(_spans) == _spans.maxlen
        _spans.append(span)


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _thread() -> int:
    """This thread's native id, read once (each read is a system call)."""
    tid = getattr(_local, "tid", None)
    if tid is None:
        tid = _local.tid = threading.get_native_id()
    return tid


class _Span:
    """A span begun while the profiler was on. `start` is stamped on entry
    unless given; `end` on exit, where the span is kept if the profiler is
    still on."""

    __slots__ = ("name", "attrs", "start", "end", "id", "parent", "_range")
    recording = True

    def __init__(self, name: str, start: Optional[int], attrs: dict) -> None:
        self.name, self.start, self.end, self.attrs = name, start, None, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._range = None
        if _ranges:
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        if self.start is None:
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        if _profiler._is_profiler_enabled:
            _keep(Span(self.name, self.start, self.end, _thread(), self.id, self.parent, self.attrs))
        return False


class _Off:
    """The span of a site reached while no profiler runs: records nothing."""

    __slots__ = ()
    recording = False
    start = end = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def annotate(name: str, start: Optional[int] = None, **attrs):
    """The span `name` around a block, with `attrs` (ids, counts; more by
    `.set(...)`). Kept only while a torch.profiler runs, in whichever
    thread; otherwise it costs one flag read. The span's `start` is the
    stamp given (the end of the span it follows, so the two meet with no
    gap) or the time it is entered; `.start` and `.end` hold the stamps,
    None where the profiler was off at entry. Its parent is the span open
    around it in the same thread."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, start, attrs)


def record(name: str, start: Optional[int], end: Optional[int], **attrs) -> None:
    """Keep the span `name` from the stamps `start` to `end` (time.time_ns())
    if a torch.profiler runs now, however long before it began: a request's
    wait in a queue, stamped at its submit whether or not anything traced
    it. A missing stamp (None) keeps nothing. It has no parent."""
    if start is None or end is None or not _profiler._is_profiler_enabled:
        return
    _keep(Span(name, start, end, _thread(), next(_ids), None, attrs))


def spans() -> List[Span]:
    """A copy of the spans kept, oldest first."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans dropped, oldest first, once MAX_SPANS were kept."""
    return _dropped


@contextlib.contextmanager
def trace(log_dir: str = "out/trace") -> Iterator:
    """Profile the block with torch.profiler (CPU activity, and CUDA where a
    card is present) and write its Chrome trace (open it in Perfetto or
    chrome://tracing) to `log_dir`/smalltts_<pid>_<ms>.pt.trace.json, each
    span of the program in it as a named range. Yields the profiler; its
    `trace_file` names the file once the block has ended."""
    global _ranges
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _ranges = True
    try:
        yield prof
    finally:
        _ranges = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, f"smalltts_{os.getpid()}_{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(path)
        prof.trace_file = path


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

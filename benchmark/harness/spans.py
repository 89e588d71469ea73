"""The program's own spans (smalltts_tpu_torch/utils/profiling.py) over a
traced slice, for the readers of the metrics that read them.

The program stamps its spans with time.time_ns(), the clock torch.profiler
gives its records in, so a span is laid over the device's records as it
is: no offset is fitted. A reader takes the spans that end inside the
slice (`run.profile.wall`). Where the program keeps no spans (a program
older than them), or its bound has dropped some, every reader finds
nothing and its metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from harness.stats import gaps, union_length


def of_slice(run) -> Optional[list]:
    """The program's spans that end inside the traced slice, or None."""
    prof = run.profile
    if prof is None:
        return None
    from smalltts_tpu_torch.utils import profiling

    read, dropped = getattr(profiling, "spans", None), getattr(profiling, "dropped", None)
    if read is None or dropped is None or dropped():
        return None
    lo, hi = prof.wall
    return [s for s in read() if lo <= s.end <= hi]


def per_step_ms(run, name: str) -> Optional[float]:
    """Host ms in the spans called `name` per traced teacher step."""
    spans = of_slice(run)
    steps = sum(s.name == "teacher.step" for s in spans or ())
    if not steps:
        return None
    return sum(s.end - s.start for s in spans if s.name == name) / steps / 1e6


def idle_share_in(run, inside: str, outside: str) -> Optional[float]:
    """The share (%) of the slice's device-idle time that lies inside an
    open span called `inside` and outside each of its children called
    `outside`."""
    spans = of_slice(run)
    if spans is None:
        return None
    prof = run.profile
    lo, hi = prof.wall
    idle = gaps(((r.start, r.end) for r in prof.records), lo, hi)
    total = union_length(idle)
    if total <= 0:
        return None
    parents = {s.id: s for s in spans if s.name == inside}
    children = [s for s in spans if s.name == outside and s.parent in parents]

    def idle_in(named) -> float:
        # |idle & spans| = |idle| + |spans| - |idle | spans|, the spans clipped to the slice
        named = [(s.start, s.end) for s in named]
        return total + union_length(named, lo, hi) - union_length(idle + named, lo, hi)

    return 100.0 * (idle_in(parents.values()) - idle_in(children)) / total

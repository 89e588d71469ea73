"""The traced slice of a run: the device's records from torch.profiler
(CUPTI), kept in memory, and what the metric readers take from them.

Kernel names are the program's: its hand-written kernels keep their C++
names in the trace (attn_*_kernel, adaln_kernel, qk_norm_rope_kernel,
gemm_wgmma_kernel), cuDNN names its fp32 convolutions' kernels after the
operation (fprop, implicit_gemm, ...), and PyTorch's foreach ops run
multi_tensor_apply_kernel."""

from __future__ import annotations

import math
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from harness.stats import gaps, union_length

CLASSES = {
    "attention": re.compile(r"attn_\w+_kernel"),
    "scan": re.compile(r"adaln_kernel|qk_norm_rope_kernel|gemm_wgmma_kernel"),
    "codec_conv": re.compile(r"^(?!.*(bf16|f16|half)).*(fprop|convolve|implicit_gemm|winograd|conv2d|conv1d)", re.I),
    "optimizer": re.compile(r"multi_tensor_apply_kernel"),
}
# the program's launch counters (kernels.LAUNCHES) that count each class's launches
COUNTERS = {
    "attention": ("attention",),
    "scan": ("adaln_modulate", "qk_norm_rope", "gemm_bias", "gemm_swiglu", "gemm_residual",
             "gemm_bias_w8", "gemm_swiglu_w8", "gemm_residual_w8"),
}


def kernel_class(name: str) -> Optional[str]:
    for cls, pat in CLASSES.items():
        if pat.search(name):
            return cls
    return None


@dataclass
class Record:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    corr: int


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start initializes CUPTI,
    which takes seconds, and belongs in set-up, not in the traced slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@dataclass
class Profile:
    """torch.profiler over [start(), stop()): device records (kernels,
    copies, sets), the cudaGraphLaunch calls, and the host bounds of the
    slice on time.perf_counter() and on the wall clock (ns)."""

    records: List[Record] = field(default_factory=list)
    graph_launches: List[Tuple[int, int]] = field(default_factory=list)  # (corr, start ns)
    host: Tuple[float, float] = (0.0, 0.0)
    wall: Tuple[int, int] = (0, 0)
    offset: int = 0  # the profiler's clock less the wall clock, ns
    _prof: object = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.host = (time.perf_counter(), 0.0)
        self.wall = (time.time_ns(), 0)

    def stop(self) -> None:
        self.host = (self.host[0], time.perf_counter())
        self.wall = (self.wall[0], time.time_ns())
        self._prof.stop()
        self.stop_s = time.perf_counter() - self.host[1]

    def collect(self) -> None:
        """Read the stopped profiler's records."""
        for e in self._prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                self.records.append(Record(e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
            elif e.name() == "cudaGraphLaunch":
                self.graph_launches.append((e.correlation_id(), e.start_ns()))
        self._prof = None

    @property
    def window_s(self) -> float:
        return self.host[1] - self.host[0]

    def bounds_ns(self) -> Tuple[int, int]:
        """The slice on the profiler's clock."""
        return self.wall[0] + self.offset, self.wall[1] + self.offset

    def busy_s(self, clip: bool = True) -> float:
        """Seconds in which the device ran a kernel, copy or set: the union
        of their intervals, within the slice where `clip`."""
        lo, hi = self.bounds_ns() if clip else (-math.inf, math.inf)
        return union_length(((r.start, r.end) for r in self.records), lo, hi) / 1e9

    def top_ops(self, n=10) -> List[list]:
        tot = defaultdict(int)
        for r in self.records:
            tot[r.name] += r.end - r.start
        return [[k[:160], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: List[Tuple[str, int, int]], n=10) -> List[list]:
        """The n longest stretches of the slice in which the device ran
        nothing, each named by the host span (name, start ns, end ns, wall
        clock) that overlaps it most, or "host: other"."""
        lo, hi = self.bounds_ns()
        longest = sorted(gaps(((r.start, r.end) for r in self.records), lo, hi), key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in longest:
            best, cover = "host: other", 0
            for name, a, b in spans:
                c = min(b + self.offset, e) - max(a + self.offset, s)
                if c > cover:
                    best, cover = name, c
            out.append([best, (e - s) / 1e9])
        return out

    def records_by_launch(self) -> Dict[int, List[Record]]:
        """Device records grouped by the correlation id of the call that
        launched them (a graph's kernels share their replay's)."""
        out = defaultdict(list)
        for r in self.records:
            out[r.corr].append(r)
        return out

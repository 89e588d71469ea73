"""What every cell shares: finding its files by name, the record of a run,
the result line and the isolation check.

A cell is an entry of `workloads` in BENCHMARK.json. It names a
configuration (its file is the entry's `file` in `configs`) and a traffic
mix (`benchmark/traffic/<traffic>.json`), whose `loop` names the module in
`benchmark/loops/` that drives it. A metric is read by
`benchmark/metrics/<name>.py`. So a new cell, configuration, mix or metric
is new files and new entries in BENCHMARK.json, and no edit."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

# top-level modules the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "smalltts_tpu")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    entry = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], entry["config"], "config")
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic", f"{entry['traffic']}.json"))
    return Cell(name, entry, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def loop_module(kind: str, root: str = ROOT):
    return _module(os.path.join(root, "benchmark", "loops", f"{kind}.py"), f"benchmark_loop_{kind}")


def metric_reader(name: str, root: str = ROOT) -> Callable:
    tag = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    return _module(os.path.join(root, "benchmark", "metrics", f"{name}.py"), tag).read


@dataclass
class Run:
    """What a run records, for the metric readers. Times are host
    time.perf_counter() seconds; device intervals are in `trace`."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    setup_s: Optional[float] = None
    window: Optional[tuple] = None  # (start, end)
    requests: List[Any] = field(default_factory=list)  # serving: every request due in the window
    batches: List[Any] = field(default_factory=list)   # serving: every call the batcher made in the window
    steps: List[Any] = field(default_factory=list)     # training: every step of the window
    profile: Optional[Any] = None                      # the traced slice (harness.trace.Profile)
    traced: List[Any] = field(default_factory=list)    # serving: the slice's batches whose launches it all kept
    checks: Dict[str, tuple] = field(default_factory=dict)  # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    model: Any = None  # the reference's ModelCfg of the cell's configuration
    started: float = 0.0  # perf_counter at the process's start
    served: Dict[int, Any] = field(default_factory=dict)  # serving: every request sent, by index

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


def to_device(t, dev):
    """A host tensor on `dev`, copied from pinned memory: a copy from
    pageable memory waits for all the work queued on the card."""
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: smalltts_tpu_torch is not smalltts_tpu."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def metrics(run: Run, section: List[dict], root: str = ROOT) -> Dict[str, dict]:
    """Each metric of `section` whose reader finds something to read."""
    out = {}
    for m in section:
        v = metric_reader(m["name"], root)(run)
        if v is None:
            continue
        if not math.isfinite(v):
            raise ValueError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def correct(run: Run) -> bool:
    return run.failed == 0 and all(v <= lim for v, lim in run.checks.values())


def result_line(run: Run, device_info: dict, breakdown: Optional[dict] = None) -> dict:
    section = run.cell.per_layer if run.trace else run.cell.end_to_end
    out = {"correct": correct(run), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics(run, section), "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out

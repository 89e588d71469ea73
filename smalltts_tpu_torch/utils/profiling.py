"""Metrics and stage timing (port of smalltts_tpu/utils/profiling.py):
`MetricsLogger`, a JSONL metrics file and stdout; `StageTimer`, named
wall-clock stages."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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

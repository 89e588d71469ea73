"""Each cell on the card, briefly: the result line is whole and correct,
and with --trace 1 the per-layer metrics and the breakdown are there.
Marked `cuda`; skips where there is no card.

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

from harness import core

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the program's hand-written CUDA kernels have no CPU mode")


def _run(cell, seed, seconds, trace):
    out = subprocess.run([sys.executable, os.path.join(core.BENCH_DIR, "run.py"), "--workload", cell, "--seed",
                          str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [w["name"] for w in core.load_benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    res = _run(cell, 2**31 + 17, 4, trace)
    c = core.find_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"] * 1.01
        assert res["breakdown"]["device_ops"]
        assert want <= set(res["metrics"]), want - set(res["metrics"])
    else:
        assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)

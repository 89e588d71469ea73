"""The harness's arithmetic, its discovery of files by name, the traffic
generator's determinism and the isolation of what the benchmark loads."""

import json
import math
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from harness import core, traffic
from harness.stats import gaps, percentile, union_length
from tiny import committed

ROOT = core.ROOT


# ----------------------------------------------------------------- stats


def test_percentile_nearest_rank():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 95) == 5.0
    assert percentile(xs, 20) == 1.0
    assert percentile(list(range(1, 101)), 95) == 95


def test_percentile_failed_requests_are_slowest():
    assert percentile([0.1] * 95 + [math.inf] * 5, 95) == 0.1
    assert percentile([0.1] * 94 + [math.inf] * 6, 95) == math.inf
    assert percentile([math.inf, 0.2], 50) == 0.2


def test_the_gate_lets_the_profiler_in_only_alone():
    import threading
    import time

    from harness.window import Gate

    gate, inside, seen, stop = Gate(), [0], [], threading.Event()

    def caller():
        while not stop.is_set():
            with gate.call():
                inside[0] += 1
                time.sleep(0.001)
                inside[0] -= 1

    threads = [threading.Thread(target=caller) for _ in range(3)]
    for t in threads:
        t.start()
    for _ in range(20):
        time.sleep(0.003)
        with gate.alone():
            seen.append(inside[0])
            time.sleep(0.002)
            seen.append(inside[0])
    stop.set()
    for t in threads:
        t.join()
    assert seen == [0] * 40


def test_an_armed_run_that_hangs_writes_its_stacks_and_exits_1():
    code = "from harness import window; window.arm(0.5); import time; time.sleep(30)"
    res = subprocess.run([sys.executable, "-c", code], cwd=os.path.join(ROOT, "benchmark"),
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 1
    assert "time.sleep" not in res.stdout and "<string>" in res.stderr


def test_union_of_overlapping_and_nested_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)]
    assert union_length(iv) == 15 + 11
    assert union_length(iv, lo=8, hi=24) == 7 + 4
    assert union_length([]) == 0
    assert union_length([(3, 3), (5, 4)]) == 0


def test_gaps_between_intervals():
    assert gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert gaps([(0, 10)], 0, 10) == []


# ------------------------------------------------------------ discovery


def test_a_new_cell_config_mix_and_metric_are_found_from_new_files(tmp_path):
    """Add a configuration, a traffic mix, a cell and a per-layer metric as
    new files and new BENCHMARK.json entries in a copy: the harness finds
    them, and no file already there changes."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = committed("benchmark/configs/smalltts-328m-dmd4.json")
    cfg["name"] = "smalltts-328m-w8"
    cfg["serving"]["w8_stream"] = cfg["serving"]["w8_modulation"] = True
    (tmp_path / "benchmark/configs/smalltts-328m-w8.json").write_text(json.dumps(cfg))
    mix = committed("benchmark/traffic/offline-mixed.json")
    mix["duration_s"]["median"] = 12.0
    (tmp_path / "benchmark/traffic/offline-long.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/batches.offline.py").write_text("def read(run):\n    return len(run.batches)\n")
    bench["configs"].append({"name": "smalltts-328m-w8", "source": "https://github.com/smallbraineng/smalltts",
                             "file": "benchmark/configs/smalltts-328m-w8.json", "reduced": [], "why": "int8 streams"})
    bench["workloads"].append({"name": "serve-offline-w8", "config": "smalltts-328m-w8", "traffic": "offline-long",
                               "chips": 1, "why": "int8 weight streams"})
    bench["per_layer"].append({"name": "batches.offline", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "batcher", "moves": "audio_s_per_s",
                               "workloads": ["serve-offline-w8"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("audio_s_per_s",):
            m["workloads"].append("serve-offline-w8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = core.find_cell("serve-offline-w8", root=str(tmp_path))
    assert cell.config["serving"]["w8_stream"] and cell.traffic["duration_s"]["median"] == 12.0
    assert [m["name"] for m in cell.per_layer] == ["batches.offline"]
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s", "setup_s"}
    assert core.loop_module(cell.traffic["loop"], root=str(tmp_path)).run
    run = core.Run(cell, 1, 1.0, True, None, batches=[1, 2, 3])
    assert core.metrics(run, cell.per_layer, root=str(tmp_path)) == {"batches.offline": {"value": 3.0, "unit": "batches"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_every_metric_of_benchmark_json_has_its_reader_and_every_cell_its_files():
    bench = core.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(core.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = core.find_cell(w["name"])
        assert core.loop_module(cell.traffic["loop"]).run
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


# -------------------------------------------------------------- traffic


@pytest.mark.parametrize("mix", ["offline-mixed", "poisson-short"])
def test_serving_traffic_is_fixed_by_the_seed(mix):
    m = committed(f"benchmark/traffic/{mix}.json")
    n, k = 2048, traffic.BLOCK
    stream = lambda seed: traffic.Stream(m, seed, 198, 64)  # noqa: E731
    a, b, c = ([s[i] for i in range(n)] for s in (stream(2**31 + 11), stream(2**31 + 11), stream(5)))
    key = lambda rs: [(r.duration_s, r.seq_len, r.phonemes.tobytes(), r.ref.tobytes(), r.due) for r in rs]  # noqa: E731
    assert key(a) == key(b)
    assert key(a) != key(c)
    # every seed asks for the same work, in another order, and so does every block
    for rs in (a, c):
        for i in range(0, n, k):
            blk = rs[i:i + k]
            assert sorted((r.duration_s, len(r.phonemes), len(r.ref)) for r in blk) == \
                sorted((r.duration_s, len(r.phonemes), len(r.ref)) for r in a[:k])
    d = m["duration_s"]
    assert np.mean([r.duration_s for r in a]) == pytest.approx(d["mean"], rel=1e-6)
    assert d["min"] <= min(r.duration_s for r in a) and max(r.duration_s for r in a) <= d["max"]
    assert {len(r.phonemes) for r in a} == {max(round(r.duration_s * m["phonemes_per_s"]), 1) for r in a}
    assert {len(r.ref) for r in a} <= set(range(m["reference_frames"]["min"], m["reference_frames"]["max"] + 1))
    assert {r.t_bucket for r in a} <= {16, 40, 80} and max(len(r.phonemes) for r in a) <= 128
    if "rate_per_s" in m:
        gaps_a = np.diff([0.0] + [r.due for r in a])
        gaps_c = np.diff([0.0] + [r.due for r in c])
        assert np.allclose(sorted(gaps_a), sorted(gaps_c))
        assert 1 / np.mean(gaps_a) == pytest.approx(m["rate_per_s"], rel=1e-9)
        spans = [rs[i + k - 1].due - (rs[i - 1].due if i else 0.0) for rs in (a, c) for i in range(0, n, k)]
        assert max(spans) == pytest.approx(min(spans))


def test_the_stream_does_not_run_out():
    """A closed loop draws as many requests as the program answers: far
    more than one run of today's program does."""
    m = committed("benchmark/traffic/offline-mixed.json")
    s = traffic.Stream(m, 3, 198, 64)
    it = iter(s)
    reqs = [next(it) for _ in range(40_000)]
    assert [r.index for r in reqs] == list(range(40_000))
    assert len({r.phonemes.tobytes() for r in reqs}) == 40_000


def test_training_traffic_is_fixed_by_the_seed():
    m = committed("benchmark/traffic/teacher-b96.json")
    a, b, c = (traffic.train_lengths(m, s, 4) for s in (9, 9, 10))
    for k in a:
        assert np.array_equal(a[k], b[k])
        assert sorted(a[k].tolist()) == pytest.approx(sorted(c[k].tolist()))
    assert int(a["latents"].sum()) == 13248  # 96 rows spread evenly over 20-256
    assert int((a["text_u"] < 0.1).sum()) == 10 and int((a["speaker_u"] < 0.1).sum()) == 10


# ------------------------------------------------------------- isolation


def _modules_after(code: str):
    src = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'benchmark')!r}, {os.path.join(ROOT, 'benchmark', 'tests')!r}]
        {textwrap.indent(textwrap.dedent(code), '        ').strip()}
        print(json.dumps(sorted(sys.modules)))
    """)
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_modules_compares_whole_top_level_names():
    assert core.forbidden_modules(["smalltts_tpu_torch", "smalltts_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["smalltts_tpu.models", "jax", "jax.numpy", "flax"]) == [
        "flax", "jax", "jax.numpy", "smalltts_tpu.models"]


def test_the_reference_loads_nothing_of_the_program_or_of_jax():
    mods = _modules_after("from reference import model")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"smalltts_tpu_torch", "smalltts_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules_after("""
        import torch, time, run
        from tiny import tiny_cell
        run.execute(tiny_cell("serve-offline-mixed"), 3, 0.5, False, torch.device("cpu"), time.perf_counter())
    """)
    assert "smalltts_tpu_torch" in mods
    assert core.forbidden_modules(mods) == []

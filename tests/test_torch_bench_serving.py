"""The port's serving load benchmark (smalltts_tpu_torch/scripts/bench_serving.py)
on the CPU, the counterpart of tests/test_stream_concurrency.py.

A stub pipeline with a fixed 20 ms a batch (the same _SimTTS, plus the
warmup the script calls) stands in for SmallTTS in both packages, so the
runs measure the servers, not a model. 8 out-of-process clients x 2
streamed requests (--proc-clients) through the port's script give one JSON
line with the JAX script's keys, 16 requests and a p50 and p95 of time to
first audio, on the client's clock and the server's; the server's nests
inside the client's. The warmup covers exactly the buckets of the streamed
chunk plan, as the JAX script's does. A `--worker` process, run by the
script's file path, imports neither torch nor numpy nor the package.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from smalltts_tpu_torch.scripts import bench_serving  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_MS = 20.0
ARGV = ["--clients", "8", "--requests", "2", "--duration", "5.0", "--stream", "--sentences", "4", "--proc-clients"]


class _SimTTS:
    """Fake pipeline with a fixed per-batch synthesis latency; records the
    buckets its warmup was asked for."""

    warmed = []

    def __init__(self, *args, **kw):
        pass

    def warmup(self, batch_sizes, t_buckets, r_buckets, p_buckets, workers=8):
        _SimTTS.warmed.append((tuple(batch_sizes), tuple(t_buckets), tuple(r_buckets), tuple(p_buckets)))
        return 0

    def synthesize_padded(self, ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, key=None, fetch=True):
        time.sleep(SYNTH_MS / 1e3)
        return np.zeros((ref.shape[0], 1, int(t_bucket) * 3200), np.float32)

    def encode_reference(self, samples):
        return np.zeros((4, 64), np.float32)


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """(port line, JAX line, warmups) of one streamed run of each script."""
    import importlib.util

    from smalltts_tpu.infer import pipeline as jpipe
    from smalltts_tpu_torch.infer import pipeline as ppipe

    mp = pytest.MonkeyPatch()
    _SimTTS.warmed.clear()
    try:
        import contextlib
        import io

        mp.setattr(ppipe, "SmallTTS", _SimTTS)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert bench_serving.main(ARGV + ["--device", "cpu"]) == 0
        port = last_json(buf.getvalue())

        mp.setattr(jpipe, "SmallTTS", _SimTTS)
        mp.setattr(jpipe, "enable_compilation_cache", lambda path: None)
        spec = importlib.util.spec_from_file_location("root_bench_serving",
                                                      os.path.join(ROOT, "scripts", "bench_serving.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        mp.setattr(sys, "argv", ["bench_serving.py"] + ARGV)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            script.main()
        jax_line = last_json(buf.getvalue())
    finally:
        mp.undo()
    return port, jax_line, list(_SimTTS.warmed)


def test_json_line_has_the_jax_scripts_keys(runs):
    port, jax_line, _ = runs
    assert list(port) == list(jax_line)
    assert list(port["server_stats"]) == list(jax_line["server_stats"])
    assert port["metric"] == "serving_stream_ttfb_ms" and port["requests"] == 16 and port["proc_clients"]


def test_stream_percentiles_nest_and_stream(runs):
    port, _, _ = runs
    assert 0 < port["ttfb_p50_ms"] <= port["ttfb_p95_ms"] and port["latency_p50_ms"] <= port["latency_p95_ms"]
    # the server's clock starts after the request is read and stops at the first chunk's write
    assert port["server_ttfb_p50_ms"] <= port["ttfb_p50_ms"] + 1.0
    # first audio well before the whole stream, under 8 concurrent streams
    assert port["server_ttfb_p95_ms"] < port["latency_p50_ms"]
    assert port["server_ttfb_p95_ms"] < 2000.0


def test_warmup_covers_the_streamed_chunk_plan_as_jax_does(runs):
    _, _, warmed = runs
    assert len(warmed) == 2 and warmed[0] == warmed[1]
    batch_sizes, t_buckets, r_buckets, p_buckets = warmed[0]
    assert batch_sizes == (1, 8) and r_buckets == (64,) and len(t_buckets) > 1 and 128 in p_buckets


def test_worker_imports_only_the_standard_library(tmp_path):
    """A --worker process, started by the script's path as --proc-clients
    starts it, answers its requests with neither torch nor numpy nor the
    package imported (python -X importtime logs every import)."""
    import asyncio
    import threading

    from smalltts_tpu_torch.serving.multipart import build_multipart
    from smalltts_tpu_torch.serving.server import TTSServer
    from smalltts_tpu_torch.serving.x402 import X402Config

    server = TTSServer(tts=_SimTTS(), x402_cfg=X402Config(mode="disabled"), tokenizer=lambda t: [1, 2, 3, 4])
    loop, ready, holder = asyncio.new_event_loop(), threading.Event(), {}

    async def serve():
        srv = await asyncio.start_server(server._serve_conn, "127.0.0.1", 0)
        holder["port"] = srv.sockets[0].getsockname()[1]
        ready.set()
        async with srv:
            await srv.serve_forever()

    def run():
        try:
            loop.run_until_complete(serve())
        except RuntimeError:  # stopped from the test's thread
            pass

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10)
    try:
        body, ctype = build_multipart({"audio": bench_serving.make_wav(0.3), "text": "hello there"})
        (tmp_path / "req.mp").write_bytes(body)
        res = subprocess.run([sys.executable, "-X", "importtime", bench_serving.__file__, "--worker", "--port",
                              str(holder["port"]), "--requests", "2", "--duration", "1.0", "--body-file",
                              str(tmp_path / "req.mp"), "--ctype", ctype],
                             capture_output=True, text=True, timeout=120, cwd=tmp_path)
        assert res.returncode == 0, res.stderr[-2000:]
        rec = json.loads(res.stdout)
        assert len(rec["ttfb"]) == len(rec["lat"]) == 2
        imported = {line.split("|")[-1].strip().split(".")[0] for line in res.stderr.splitlines()
                    if line.startswith("import time:")}
        assert "http" in imported and not imported & {"torch", "numpy", "smalltts_tpu_torch", "smalltts_tpu", "jax"}
    finally:
        if server._batcher is not None:
            server._batcher.close()
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)

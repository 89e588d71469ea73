"""The port's HTTP server (smalltts_tpu_torch/serving) against the JAX
package's, and the port's pipeline entry points (contract_shapes, warmup,
compile_cache_size, forward) on the CPU.

1. Contract: the port's and the JAX TTSServer, each around one
   deterministic stub pipeline, give the same status, headers and body for
   /health, /ready, /stats, /metrics, the x402 discovery, an unpaid 402 with
   its payment-required header, bad and oversized durations, hostile
   multipart bodies and one valid request.
2. Full path over a socket: a tiny-config port SmallTTS(device="cpu",
   pcm16_out=True) behind the port's server; the WAV it returns equals the
   one that a second pipeline on the same seed makes with `synthesize`
   (bit for bit: the same fp32 arithmetic in the same order).
3. Pipeline entry points: contract_shapes equals JAX's list, forward groups
   and pads as JAX's forward does, and compile_cache_size stays flat across
   in-contract traffic after warmup.
"""

import asyncio
import base64
import dataclasses
import json
import sys
import urllib.request

import numpy as np
import pytest
import torch

from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS
from smalltts_tpu.serving.server import TTSServer as JServer
from smalltts_tpu.serving.x402 import X402Config as JX402Config
from smalltts_tpu.text import phonemize as j_phonemize
from smalltts_tpu_torch.data.bucketing import HOP_SIZE, LATENT_BUCKETS
from smalltts_tpu_torch.infer.pipeline import SmallTTS
from smalltts_tpu_torch.models.backbone import init_backbone, redraw_zero_init
from smalltts_tpu_torch.serving.audio_io import decode_wav, encode_wav
from smalltts_tpu_torch.serving.batcher import Batcher
from smalltts_tpu_torch.serving.server import TTSServer
from smalltts_tpu_torch.serving.x402 import X402Config
from smalltts_tpu_torch.text import phonemize
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
MAX_SEC = LATENT_BUCKETS[-1] * HOP_SIZE / 24_000


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def sine_wav(seconds=0.6, sr=24_000):
    t = np.arange(int(seconds * sr)) / sr
    return encode_wav(0.5 * np.sin(2 * np.pi * 440.0 * t), sr)


def multipart(fields, boundary="XB"):
    body = b""
    for name, value in fields:
        body += f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'.encode() + value + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


class StubTTS:
    """A deterministic stand-in for the pipeline: latents from the sample
    count, a waveform from the ids, lengths and bucket (numpy, int16)."""

    def encode_reference(self, samples):
        frames = max(-(-len(samples) // HOP_SIZE), 1)
        return np.full((frames, 64), 0.25, np.float32)

    def synthesize_padded(self, ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, **_):
        b = len(seq_lens)
        base = np.arange(t_bucket * HOP_SIZE, dtype=np.int64)[None, None]
        seed = (np.asarray(ph).sum(1) + np.asarray(ph_lens) + 7 * np.asarray(seq_lens))[:, None, None]
        return ((base * (seed + 1)) % 20001 - 10000).astype(np.int16).reshape(b, 1, -1)


def both(mode="disabled", **kw):
    """(port server, JAX server), each around its own stub, one tokenizer.
    Each decodes audio with its own audio_io.backend(): the native C++
    library in both, where it builds."""
    tok = kw.pop("tokenizer", lambda text: [1 + (ord(c) % 90) for c in text][:300])
    return (TTSServer(tts=StubTTS(), x402_cfg=X402Config(mode=mode), tokenizer=tok, **kw),
            JServer(tts=StubTTS(), x402_cfg=JX402Config(mode=mode), tokenizer=tok, **kw))


def same(servers, method, path, query=None, headers=None, body=b""):
    got = [run(s.handle(method, path, dict(query or {}), dict(headers or {}), body)) for s in servers]
    assert got[0] == got[1], (method, path, query, got[0][:2], got[1][:2])
    return got[0]


HOSTILE = [(b"", "multipart/form-data"), (b"", 'multipart/form-data; boundary=""'),
           (b"--B\r\n\r\n", "multipart/form-data; boundary=B"),
           (b"--B\r\nContent-Disposition: form-data\r\n\r\nx--B--", "multipart/form-data; boundary=B"),
           (b"--B--", "multipart/form-data; boundary=B"), (b"\xff" * 4096, "multipart/form-data; boundary=B"),
           (b"--B\r\n" * 500, "multipart/form-data; boundary=B"),
           (("--B\r\nContent-Disposition: form-data; name=\"" + "a" * 10_000 + "\"\r\n\r\nv\r\n--B--").encode(),
            "multipart/form-data; boundary=B"),
           (b"plain body", "text/plain"),
           (multipart([("text", b"hi")])[0], multipart([])[1]),
           (multipart([("audio", b"RIFF....not a wav")])[0], multipart([])[1]),
           (multipart([("audio", b"RIFF....not a wav"), ("text", b"hi")])[0], multipart([])[1])]


@pytest.mark.parametrize("path", ["/health", "/stats", "/metrics", "/.well-known/x402", "/v1/voices", "/nope"])
def test_get_routes_equal_jax(path):
    servers = both("trust")
    same(servers, "GET", path)
    same(servers, "OPTIONS", path)


def test_ready_and_drain_equal_jax():
    servers = both()
    assert same(servers, "GET", "/ready")[0] == 503
    try:
        for s in servers:
            s._ensure_pipeline()
        assert same(servers, "GET", "/ready")[0] == 200
    finally:
        for s in servers:
            s._batcher.close()


@pytest.mark.parametrize("route", ["/synthesize", "/synthesize/stream"])
def test_unpaid_402_equal_jax(route):
    servers = both("trust")
    status, headers, body = same(servers, "POST", route, {"duration": "5"})
    assert status == 402 and body == b""
    challenge = json.loads(base64.b64decode(dict(headers)["payment-required"]))
    assert challenge["accepts"][0]["resource"].endswith(route)
    # a payment header passes the trust gate; the empty body then fails as JAX's does
    same(servers, "POST", route, {"duration": "2"}, {"x-payment": base64.b64encode(b"{}").decode()})


@pytest.mark.parametrize("mode", ["disabled", "local"])
@pytest.mark.parametrize("duration", ["nan", "inf", "-inf", "-1", "0", "abc", "", str(MAX_SEC * 2), str(MAX_SEC)])
def test_bad_or_oversized_duration_equal_jax(mode, duration):
    servers = both(mode)
    status, _, _ = same(servers, "POST", "/synthesize", {"duration": duration},
                        {"content-type": "multipart/form-data; boundary=X"}, b"--X--")
    assert status in (400, 402)


@pytest.mark.parametrize("i", range(len(HOSTILE)))
def test_hostile_multipart_equal_jax(i):
    body, ctype = HOSTILE[i]
    servers = both()
    try:
        status, _, _ = same(servers, "POST", "/synthesize", {"duration": "2"}, {"content-type": ctype}, body)
        assert status == 400
    finally:
        for s in servers:
            if s._batcher:
                s._batcher.close()


def test_valid_request_and_openai_errors_equal_jax():
    body, ctype = multipart([("audio", sine_wav()), ("text", b"hello there")])
    servers = both()
    try:
        status, headers, wav = same(servers, "POST", "/synthesize", {"duration": "1.5"}, {"content-type": ctype},
                                    body)
        assert status == 200 and dict(headers)["content-type"] == "audio/wav"
        assert decode_wav(wav)[0].shape[1] == 12 * HOP_SIZE  # ceil(1.5 s x 7.5) frames
        for req in (b"not json", b"[1]", b'{"input": ""}', b'{"input": "hi", "response_format": "mp3"}',
                    b'{"input": "hi", "voice": "nobody"}'):
            same(servers, "POST", "/v1/audio/speech", {}, {}, req)
    finally:
        for s in servers:
            s._batcher.close()


def tiny_tts():
    gen = torch.Generator().manual_seed(0)
    params = redraw_zero_init(init_backbone(gen, PCFG, device="cpu"), gen, std=0.2)
    return SmallTTS(params, cfg=PCFG, codec_cfg=PCODEC, device="cpu", pcm16_out=True, seed=0)


def test_socket_end_to_end_equals_synthesize():
    """POST /synthesize over a socket through the port's server, Batcher,
    text frontend (chars backend) and tiny pipeline; then /stats. The WAV
    equals encode_wav of a same-seed pipeline's synthesize."""
    phonemize.set_backend("chars")
    wav_in, text, duration = sine_wav(0.6), "Hello there, general Kenobi.", 2.0
    server = TTSServer(tts=tiny_tts(), x402_cfg=X402Config(mode="disabled"))

    async def scenario():
        srv = await asyncio.start_server(server._serve_conn, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]

        def request():
            body, ctype = multipart([("audio", wav_in), ("text", text.encode())])
            req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize?duration={duration}", data=body,
                                         headers={"content-type": ctype})
            with urllib.request.urlopen(req, timeout=300) as resp:
                assert resp.status == 200 and resp.headers["content-type"] == "audio/wav"
                out = resp.read()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as resp:
                stats = json.loads(resp.read())
            return out, stats

        try:
            return await asyncio.get_running_loop().run_in_executor(None, request)
        finally:
            srv.close()
            await srv.wait_closed()

    try:
        out, stats = run(scenario())
    finally:
        if server._batcher:
            server._batcher.close()
    assert stats["requests"] == 1 and stats["synth_ms_p50"] > 0
    ref = tiny_tts()
    samples = ref.encode_reference(decode_wav(wav_in)[0].mean(0))
    want = ref.synthesize(samples, phonemize.get_token_ids(text), duration)
    assert want.dtype == np.int16 and np.abs(want).max() > 0
    assert out == encode_wav(want.reshape(-1), 24_000)


def test_contract_shapes_equal_jax():
    assert SmallTTS.contract_shapes(object()) == JSmallTTS.contract_shapes(object())
    args = dict(batch_sizes=(1, 8, 32), t_buckets=(16, 40), r_buckets=(64,), p_buckets=(128, 384))
    assert SmallTTS.contract_shapes(object(), **args) == JSmallTTS.contract_shapes(object(), **args)
    assert len(SmallTTS.contract_shapes(object(), batch_sizes=(1, 8))) == 2 * 2 * 2 * 6


def test_forward_groups_equal_jax(monkeypatch):
    """forward on the same items gives the same synthesize_padded calls (the
    packed, padded groups) in the port and in JAX, and results of each
    item's true length."""
    phonemize.set_backend("chars")
    j_phonemize.set_backend("chars")
    rs = np.random.RandomState(3)
    conds = [rs.randn(int(n), 64).astype(np.float32) for n in rs.randint(4, 90, size=11)]
    trans = ["Hi.", [1, 2], "[laughter] yes", [5], "", "one two", [9, 9, 9], "Ok!", "a", [3], "What now?"]
    texts = ["Hello world.", [4, 5, 6], "fine", "Numbers: 42", [7], "b", "c", [8], "The end.", "x y", [1]]

    def spy(calls):
        def synthesize_padded(ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, *a, **kw):
            calls.append((ref.copy(), ref_lens.copy(), ph.copy(), ph_lens.copy(), seq_lens.copy(), t_bucket))
            return np.zeros((len(seq_lens), 1, t_bucket * HOP_SIZE), np.float32) + np.arange(len(seq_lens))[:, None, None]
        return synthesize_padded

    outs, calls = [], [[], []]
    for cls, c in ((SmallTTS, calls[0]), (JSmallTTS, calls[1])):
        tts = cls.__new__(cls)
        tts.synthesize_padded = spy(c)
        outs.append(tts.forward(conds, trans, texts, duration_sec=2.5, max_batch=4))
    assert len(calls[0]) == len(calls[1]) == 3
    for got, want in zip(*calls):
        assert got[5] == want[5]
        for g, w in zip(got[:5], want[:5]):
            assert np.array_equal(g, w)
    assert len(outs[0]) == len(outs[1]) == 11
    for g, w in zip(*outs):
        assert np.array_equal(g, w)


def test_compile_cache_flat_after_warmup():
    """As the JAX package's test_no_compile_after_warmup: warm a sub-grid,
    serve in-contract requests through the Batcher, and the count of
    shapes run (graphs on the card) does not grow."""
    tts = tiny_tts()
    n = tts.warmup(batch_sizes=(1, 2), t_buckets=(16,), r_buckets=(64,), p_buckets=(128,))
    assert n == 2 == tts.compile_cache_size() == len(tts.contract_shapes((1, 2), (16,), (64,), (128,)))
    batcher = Batcher(tts, max_batch=2)
    try:
        for ref_len, tok_len, dur in [(8, 3, 1.0), (40, 90, 2.0), (64, 128, 2.1)]:
            batcher.submit(np.zeros((ref_len, 64), np.float32), [1] * tok_len, dur).result(timeout=120)
        futs = [batcher.submit(np.zeros((10, 64), np.float32), [1, 2, 3], 1.5) for _ in range(2)]
        for f in futs:
            f.result(timeout=120)
    finally:
        batcher.close()
    assert tts.compile_cache_size() == n
    tts.synthesize_padded(np.zeros((1, 64, 64), np.float32), [5], np.zeros((1, 384), np.int32), [3], [10], 16)
    assert tts.compile_cache_size() == n + 1  # an unwarmed shape counts once it has run

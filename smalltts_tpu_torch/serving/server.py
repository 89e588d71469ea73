"""TTS serving: asyncio HTTP server with continuous batching.

HTTP contract parity with the reference Rust server
(reference: src/server/src/main.rs:55-165):
  GET  /health                 -> 200 "ok" (never payment-gated)
  GET  /.well-known/x402       -> discovery JSON
  POST /synthesize?duration=N  -> multipart (audio wav, text) -> audio/wav
       unpaid -> 402 + base64 `payment-required` header, empty body
  2 MiB body limit; permissive CORS.

Requests batch through one `synthesize_padded` call per padded group (one
captured CUDA graph per bucket shape on the card) instead of serializing
on a mutex, and phonemization is in-process. Stdlib-only: no web framework
required.

The PyTorch port's own copy of smalltts_tpu/serving/server.py, with its
imports pointing at smalltts_tpu_torch and the same routes, responses and
flags, with one exception: the JAX server's `--compile-cache` (XLA's
persistent compilation cache) has no counterpart and is dropped. The
port's CUDA graphs are captured afresh at each start (`--warmup` captures
the serving contract before the server listens), and the kernels' own
build cache is smalltts_tpu_torch/ops/kernels/build/. The server's
SmallTTS runs on the card.

    python -m smalltts_tpu_torch.serving.server --port 3000 --warmup
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
import time
import urllib.parse
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from smalltts_tpu_torch.serving.x402 import X402Config, X402Gate

BODY_LIMIT = 2 * 1024 * 1024  # main.rs:81
HEADER_LIMIT = 16 * 1024      # total request-line + header bytes per request
MAX_HEADERS = 100
READ_TIMEOUT_S = 30.0         # stalled clients can't pin a connection slot
STATS_WINDOW = 1024           # synth_ms ring buffer

CORS_HEADERS = [
    ("access-control-allow-origin", "*"),
    ("access-control-allow-methods", "*"),
    ("access-control-allow-headers", "*"),
    ("access-control-expose-headers", "*"),
]


def _audio_backend():
    """The port's audio backend (serving.audio_io)."""
    from smalltts_tpu_torch.serving.audio_io import backend

    return backend()


@dataclass
class ServerStats:
    requests: int = 0
    rejected: int = 0  # 503s from batcher backpressure
    ref_cache_hits: int = 0
    ref_cache_misses: int = 0
    synth_ms: "deque" = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))
    # time-to-first-audio-chunk for /synthesize/stream — the metric that
    # justifies streaming at all (playback starts after the first sentence)
    ttfb_ms: "deque" = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))


class TTSServer:
    def __init__(
        self,
        tts=None,
        x402_cfg: Optional[X402Config] = None,
        tokenizer: Optional[Callable] = None,
        max_batch: int = 8,
        read_timeout_s: float = READ_TIMEOUT_S,
        ref_cache_size: int = 64,
        static_dir: Optional[str] = None,
        voices_dir: Optional[str] = None,
        growth_limit: Optional[int] = None,
        latency_slo_ms: Optional[float] = None,
        pcm16: bool = False,
    ) -> None:
        # optional single-binary deployment: serve the web client (GET / ->
        # index.html, plus /samples/*) from the same origin as the API, so
        # the page needs no SMALLTTS_API configuration and no CORS. The
        # reference deploys its React app separately (src/website); serving
        # the static page here is the no-bundler equivalent.
        import os

        self.static_dir = os.path.realpath(static_dir) if static_dir else None
        # named voices for the OpenAI-compatible endpoint: <name>.npy
        # (reference latents) or <name>.wav (encoded lazily, LRU-cached)
        self.voices_dir = os.path.realpath(voices_dir) if voices_dir else None
        self._tts = tts
        self.read_timeout_s = read_timeout_s
        # dedicated pool for host-side request work (phonemize, reference
        # encode, settle): the event loop's DEFAULT executor is process-wide
        # shared state — an embedding application can exhaust it and starve
        # the server (observed in a load test whose client threads shared it)
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(16, thread_name_prefix="tts-host")
        # reference-latents LRU: serving traffic overwhelmingly reuses a few
        # voices, and each encode is a full device round trip — cache by
        # decoded-audio content hash
        self._ref_cache: "OrderedDict" = OrderedDict()
        self._ref_cache_lock = threading.Lock()
        self.ref_cache_size = ref_cache_size
        self._draining = False
        self._active = 0  # in-flight /synthesize coroutines (loop-thread only)
        self.gate = X402Gate(x402_cfg)
        self.stats = ServerStats()
        self.audio = _audio_backend()
        self._batcher = None
        self._max_batch = max_batch
        self._growth_limit = growth_limit
        self._latency_slo_ms = latency_slo_ms
        self._pcm16 = pcm16  # lazy-pipeline default (ignored when tts given)
        if tokenizer is None:
            from smalltts_tpu_torch.text import get_token_ids

            tokenizer = get_token_ids
        self.tokenize = tokenizer

    # lazy so contract tests (health/402/discovery) need no model
    def _ensure_pipeline(self):
        if self._batcher is None:
            from smalltts_tpu_torch.serving.batcher import Batcher

            if self._tts is None:
                from smalltts_tpu_torch.infer.pipeline import SmallTTS

                self._tts = SmallTTS(pcm16_out=self._pcm16)
            self._batcher = Batcher(self._tts, max_batch=self._max_batch,
                                    growth_limit=self._growth_limit,
                                    latency_slo_ms=self._latency_slo_ms)
        return self._batcher

    def _encode_reference_cached(self, samples, raw: Optional[bytes] = None) -> "object":
        """encode_reference with a content-hash LRU (thread-safe).

        Concurrent misses for the SAME audio coalesce onto one encode: the
        first requester parks a Future in the cache, later ones wait on it —
        without this, a burst of requests with a cold shared voice would
        each pay the full device round trip (exactly the hot case the cache
        targets).

        The key hashes the RAW uploaded bytes when available: hashing the
        decoded fp32 samples costs a tobytes() copy plus ~4x the bytes per
        request (host work was the serving bottleneck on small hosts); same content in a different container is just
        a one-time extra cache entry."""
        import hashlib
        from concurrent.futures import Future

        key = hashlib.blake2b(
            raw if raw is not None else samples.tobytes(), digest_size=16
        ).hexdigest()
        fut = None
        with self._ref_cache_lock:
            entry = self._ref_cache.get(key)
            if entry is None:
                self.stats.ref_cache_misses += 1
                fut = Future()
                self._ref_cache[key] = fut
            elif not isinstance(entry, Future):
                self._ref_cache.move_to_end(key)
                self.stats.ref_cache_hits += 1
        if fut is None:  # a value, or another thread's in-flight encode
            if isinstance(entry, Future):
                # coalesced waiter: count a hit only if the encode succeeds
                latents = entry.result(timeout=600)
                with self._ref_cache_lock:
                    self.stats.ref_cache_hits += 1
                return latents
            return entry
        try:
            latents = self._tts.encode_reference(samples)
        except Exception as exc:
            with self._ref_cache_lock:
                self._ref_cache.pop(key, None)
            fut.set_exception(exc)
            raise
        with self._ref_cache_lock:
            self._ref_cache[key] = latents
            self._ref_cache.move_to_end(key)
            while len(self._ref_cache) > self.ref_cache_size:
                self._ref_cache.popitem(last=False)
        fut.set_result(latents)
        return latents

    def _stat_snapshot(self) -> Dict[str, float]:
        """One source of truth for /stats and /metrics."""
        ms = sorted(self.stats.synth_ms)
        tt = sorted(self.stats.ttfb_ms)
        return {
            "requests": self.stats.requests,
            "rejected": self.stats.rejected,
            "pending": self._batcher.pending() if self._batcher else 0,
            # the adaptive controller's active batch class (== max_batch
            # when adaptivity is off): operators watch it to see the server
            # trade latency for throughput under sustained depth
            "batch_class": (self._batcher.batch_class
                            if self._batcher else self._max_batch),
            # lifetime high-water mark: a transient escalation peak can fall
            # between /stats polls, this cannot
            "max_batch_class": (self._batcher.max_batch_class
                                if self._batcher else self._max_batch),
            "ref_cache_hits": self.stats.ref_cache_hits,
            "ref_cache_misses": self.stats.ref_cache_misses,
            "synth_ms_p50": round(ms[len(ms) // 2], 2) if ms else 0.0,
            "synth_ms_p95": round(ms[int(len(ms) * 0.95)], 2) if ms else 0.0,
            "stream_ttfb_ms_p50": round(tt[len(tt) // 2], 2) if tt else 0.0,
            "stream_ttfb_ms_p95": round(tt[int(len(tt) * 0.95)], 2) if tt else 0.0,
        }

    # ------------------------------------------------------------- handlers

    async def handle(self, method: str, path: str, query: Dict[str, str],
                     headers: Dict[str, str], body: bytes):
        """-> (status, headers, body)"""
        if method == "OPTIONS":
            return 200, list(CORS_HEADERS), b""
        if method == "GET" and path == "/health":
            return 200, list(CORS_HEADERS), b"ok"
        if method == "GET" and path == "/ready":
            # readiness (vs liveness): 503 until the pipeline exists and the
            # batcher is accepting — load balancers gate traffic on this so
            # a cold replica never eats requests mid-compile
            if self._batcher is not None and not self._draining:
                return 200, list(CORS_HEADERS), b"ready"
            return (503, [("retry-after", "5"), *CORS_HEADERS],
                    b"draining" if self._draining else b"pipeline not warmed")
        if method == "GET" and path == "/stats":
            return (
                200,
                [("content-type", "application/json"), *CORS_HEADERS],
                json.dumps(self._stat_snapshot()).encode(),
            )
        if method == "GET" and path == "/metrics":
            # Prometheus text exposition of the same numbers as /stats so the
            # server drops into standard scrape-based monitoring; the
            # reference has no metrics surface at all
            st = self._stat_snapshot()
            lines = [
                "# TYPE smalltts_requests_total counter",
                f"smalltts_requests_total {st['requests']}",
                "# TYPE smalltts_rejected_total counter",
                f"smalltts_rejected_total {st['rejected']}",
                "# TYPE smalltts_pending_requests gauge",
                f"smalltts_pending_requests {st['pending']}",
                "# TYPE smalltts_ref_cache_hits_total counter",
                f"smalltts_ref_cache_hits_total {st['ref_cache_hits']}",
                "# TYPE smalltts_ref_cache_misses_total counter",
                f"smalltts_ref_cache_misses_total {st['ref_cache_misses']}",
                "# TYPE smalltts_synth_ms summary",
                f'smalltts_synth_ms{{quantile="0.5"}} {st["synth_ms_p50"]}',
                f'smalltts_synth_ms{{quantile="0.95"}} {st["synth_ms_p95"]}',
                "# TYPE smalltts_stream_ttfb_ms summary",
                f'smalltts_stream_ttfb_ms{{quantile="0.5"}} {st["stream_ttfb_ms_p50"]}',
                f'smalltts_stream_ttfb_ms{{quantile="0.95"}} {st["stream_ttfb_ms_p95"]}',
            ]
            return (
                200,
                [("content-type", "text/plain; version=0.0.4"), *CORS_HEADERS],
                ("\n".join(lines) + "\n").encode(),
            )
        if method == "GET" and path == "/.well-known/x402":
            return (
                200,
                [("content-type", "application/json"), *CORS_HEADERS],
                json.dumps(self.gate.discovery()).encode(),
            )
        if method == "POST" and path == "/synthesize":
            return await self._synthesize(query, headers, body)
        if method == "POST" and path == "/synthesize/stream":
            return await self._synthesize(query, headers, body, stream=True)
        if method == "POST" and path == "/v1/audio/speech":
            return await self._openai_speech(headers, body)
        if method == "GET" and path == "/v1/voices":
            return (200, [("content-type", "application/json"), *CORS_HEADERS],
                    json.dumps({"voices": sorted(self._voice_files())}).encode())
        if method == "GET" and self.static_dir is not None:
            return self._serve_static(path)
        return 404, list(CORS_HEADERS), b"not found"

    # --------------------------------------------- OpenAI-compatible API

    def _voice_files(self) -> Dict[str, str]:
        """{voice_name: path} from voices_dir (*.npy latents / *.wav clips)."""
        import os

        out: Dict[str, str] = {}
        if self.voices_dir and os.path.isdir(self.voices_dir):
            for f in os.listdir(self.voices_dir):
                stem, ext = os.path.splitext(f)
                if ext.lower() in (".npy", ".wav"):
                    # .npy beats .wav for the same name (already encoded)
                    if stem not in out or ext.lower() == ".npy":
                        out[stem] = os.path.join(self.voices_dir, f)
        return out

    def _voice_latents(self, name: str):
        """Reference latents for a named voice (encodes .wav lazily through
        the same content-hash LRU the multipart path uses)."""
        import numpy as np

        path = self._voice_files().get(name)
        if path is None:
            raise KeyError(name)
        if path.lower().endswith(".npy"):  # listing matched ext.lower()
            return np.load(path).astype(np.float32)
        raw = open(path, "rb").read()
        samples = self.audio.decode_and_resample(raw, 24_000)
        return self._encode_reference_cached(samples, raw)

    async def _openai_speech(self, headers, body):
        """POST /v1/audio/speech — OpenAI TTS wire shape: JSON
        {"input": text, "voice": name, "response_format": "wav"} -> audio.
        `model` is accepted and ignored (one model serves); only wav (and
        its alias pcm semantics via wav) is supported. Payment gating uses
        the estimated duration like the reference prices ?duration=."""
        from smalltts_tpu_torch.infer.pipeline import estimate_duration

        try:
            req = json.loads(body.decode("utf-8"))
        except Exception:
            return 400, list(CORS_HEADERS), b"invalid JSON body"
        if not isinstance(req, dict):
            # a JSON array/string/number parsed fine but crashed .get()
            # with no response (found by tests/test_serving_fuzz.py)
            return 400, list(CORS_HEADERS), b"body must be a JSON object"
        text = req.get("input")
        if not isinstance(text, str) or not text.strip():
            return 400, list(CORS_HEADERS), b"missing 'input'"
        fmt = req.get("response_format", "wav")
        if fmt not in ("wav",):
            return (400, list(CORS_HEADERS),
                    f"unsupported response_format {fmt!r}; only 'wav'".encode())
        voice = req.get("voice", "default")
        duration = estimate_duration(text)

        if self._draining:
            return (503, [("retry-after", "5"), *CORS_HEADERS], b"draining")
        resource = "/v1/audio/speech"
        loop = asyncio.get_running_loop()
        if self.gate.blocking:
            allowed, challenge = await loop.run_in_executor(
                self._pool, self.gate.check, headers, duration, resource)
        else:
            allowed, challenge = self.gate.check(headers, duration, resource)
        if not allowed:
            return 402, [("payment-required", challenge), *CORS_HEADERS], b""

        if not isinstance(voice, str):
            return 400, list(CORS_HEADERS), b"'voice' must be a string"
        self._active += 1
        try:
            from smalltts_tpu_torch.serving.batcher import QueueFull

            # pipeline BEFORE voice encode: a .wav voice encodes through
            # self._tts, which is None on a lazily-initialized server until
            # _ensure_pipeline constructs it (crashed with
            # AttributeError and no HTTP response)
            try:
                batcher = await loop.run_in_executor(
                    self._pool, self._ensure_pipeline)
            except Exception as exc:
                return (500, list(CORS_HEADERS),
                        f"pipeline init failed: {exc}".encode())
            try:
                ref_latents = await loop.run_in_executor(
                    self._pool, self._voice_latents, voice)
            except KeyError:
                known = sorted(self._voice_files())
                return (400, list(CORS_HEADERS),
                        f"unknown voice {voice!r}; available: {known}".encode())
            except Exception as exc:
                # corrupt/truncated voice file, racing deletion, ... — a
                # clean 500 beats a dropped connection
                return (500, list(CORS_HEADERS),
                        f"voice {voice!r} failed to load: {exc}".encode())
            try:
                token_ids = await loop.run_in_executor(
                    self._pool, self.tokenize, text)
            except Exception as exc:
                return (500, list(CORS_HEADERS),
                        f"phonemize failed: {exc}".encode())
            t0 = time.perf_counter()
            try:
                fut = batcher.submit(ref_latents, token_ids, duration)
                audio = await asyncio.wrap_future(fut)
            except QueueFull:
                self.stats.rejected += 1
                return (503, [("retry-after", "1"), *CORS_HEADERS],
                        b"server saturated, retry later")
            except Exception as exc:
                return (500, list(CORS_HEADERS),
                        f"inference failed: {exc}".encode())
            self.stats.requests += 1
            self.stats.synth_ms.append((time.perf_counter() - t0) * 1e3)

            extra_headers = []
            if self.gate.settles:
                receipt = await loop.run_in_executor(
                    self._pool, self.gate.settle,
                    headers.get("x-payment", ""), duration, resource)
                if receipt is None:
                    _, challenge = self.gate.check({}, duration, resource)
                    return (402,
                            [("payment-required", challenge), *CORS_HEADERS],
                            b"payment settlement failed")
                extra_headers.append(("x-payment-response", receipt))
            wav = self.audio.encode_wav(audio.reshape(-1), 24_000)
            return (200, [("content-type", "audio/wav"), *extra_headers,
                          *CORS_HEADERS], wav)
        finally:
            self._active -= 1
            self.gate.release(headers.get("x-payment", ""))

    _STATIC_TYPES = {".html": "text/html; charset=utf-8",
                     ".json": "application/json", ".wav": "audio/wav",
                     ".js": "text/javascript", ".css": "text/css",
                     ".ico": "image/x-icon"}

    def _serve_static(self, path: str):
        """GET fallback when `static_dir` is configured: / -> index.html,
        anything else resolved under static_dir with realpath containment
        (symlinks and ../ cannot escape the directory)."""
        import os

        # decode %20 etc. — _serve_conn passes the raw target path, and a
        # file named "voice sample.wav" is requested as /voice%20sample.wav;
        # the realpath containment below already defuses decoded ../
        path = urllib.parse.unquote(path)
        rel = "index.html" if path in ("/", "") else path.lstrip("/")
        try:
            full = os.path.realpath(os.path.join(self.static_dir, rel))
        except ValueError:  # embedded NUL: GET /%00 must 404, not crash
            return 404, list(CORS_HEADERS), b"not found"
        if full != self.static_dir and not full.startswith(
                self.static_dir + os.sep):
            return 404, list(CORS_HEADERS), b"not found"
        if not os.path.isfile(full):
            return 404, list(CORS_HEADERS), b"not found"
        try:
            with open(full, "rb") as fh:
                data = fh.read()
        except OSError:
            return 404, list(CORS_HEADERS), b"not found"
        ctype = self._STATIC_TYPES.get(
            os.path.splitext(full)[1].lower(), "application/octet-stream")
        return 200, [("content-type", ctype), *CORS_HEADERS], data

    async def _synthesize(self, query, headers, body, stream: bool = False):
        """`stream=True` (POST /synthesize/stream): long texts chunk at
        sentence boundaries and each piece is sent the moment it's ready as
        chunked-transfer WAV (unknown-length RIFF header) — playback starts
        after the first sentence. The reference caps synthesis at 30 s and
        has no streaming at all."""
        if self._draining:
            # past /ready flipping: a request that still arrives (load
            # balancer lag) must not start new work during the drain window
            return (503, [("retry-after", "5"), *CORS_HEADERS], b"draining")
        # server-side TTFB clock starts HERE (request fully read, body in
        # hand) — not inside the stream generator — so stats.ttfb_ms covers
        # multipart parse + ref encode + settle + queue + first synthesis,
        # the whole server-owned latency a client's first audio byte waits
        # on (isolate server-side TTFB from the load
        # generator's in-process thread-scheduling noise)
        t_req = time.perf_counter()
        self._active += 1
        try:
            return await self._synthesize_inner(query, headers, body, stream,
                                                t_req)
        finally:
            self._active -= 1

    async def _synthesize_inner(self, query, headers, body, stream: bool,
                                t_req: float):
        try:
            duration = float(query.get("duration", 1.0))
        except ValueError:
            return 400, list(CORS_HEADERS), b"invalid duration"
        # float() accepts 'nan'/'inf', which would detonate later on the
        # batcher dispatch thread (math.ceil(nan) in frames_for_duration)
        # and strand every queued request — one unauthenticated request
        # must never brick synthesis
        if not math.isfinite(duration) or duration <= 0:
            return 400, list(CORS_HEADERS), b"invalid duration"
        if not stream:
            # the serving contract tops out at the largest latent bucket —
            # pick_bucket CLAMPS, so a 60 s request would synthesize 32 s
            # while x402 charged for the full 60. Reject before
            # the payment check so nobody pays for undeliverable audio;
            # longer texts belong on /synthesize/stream (unbounded, chunked).
            from smalltts_tpu_torch.data.bucketing import (HOP_SIZE,
                                                     LATENT_BUCKETS)

            max_sec = LATENT_BUCKETS[-1] * HOP_SIZE / 24_000
            if duration > max_sec + 1e-9:
                return (400, list(CORS_HEADERS),
                        f"duration {duration:g}s exceeds the {max_sec:g}s "
                        f"cap; use /synthesize/stream for long-form"
                        .encode())

        # the challenge must name the resource the client actually called: a
        # facilitator or strict client validates the signed payment against
        # the request URL, and /synthesize/stream advertising /synthesize is
        # a mismatch
        resource = "/synthesize/stream" if stream else "/synthesize"
        if self.gate.blocking:
            # facilitator (network) and local (EC math) verification must not
            # stall the event loop
            allowed, challenge = await asyncio.get_running_loop().run_in_executor(
                self._pool, self.gate.check, headers, duration, resource)
        else:
            allowed, challenge = self.gate.check(headers, duration, resource)
        if not allowed:
            # 402 without body, challenge in the header (e2e.rs:241-253)
            return 402, [("payment-required", challenge), *CORS_HEADERS], b""
        try:
            return await self._synthesize_checked(headers, body, duration,
                                                  stream, t_req)
        finally:
            # Free this request's check-time nonce reservation so a request
            # that failed between check and settle stays retryable. ONLY the
            # request that passed check owns a reservation — releasing on
            # denied paths too would let a concurrent duplicate's 402 free
            # the in-flight holder's reservation and reopen the paid-compute
            # amplification this closes. After a
            # successful settle the nonce is burned and this is a no-op.
            self.gate.release(headers.get("x-payment", ""))

    async def _synthesize_checked(self, headers, body, duration: float,
                                  stream: bool, t_req: float):
        """Everything after the payment gate has ALLOWED the request (the
        caller owns the nonce reservation and releases it when we return)."""
        content_type = headers.get("content-type", "")
        if "multipart/form-data" not in content_type:
            return 400, list(CORS_HEADERS), b"expected multipart/form-data"
        from smalltts_tpu_torch.serving.multipart import parse_multipart

        try:
            fields = parse_multipart(body, content_type)
        except ValueError as exc:
            return 400, list(CORS_HEADERS), str(exc).encode()
        if "audio" not in fields:
            return 400, list(CORS_HEADERS), b"missing 'audio'"
        if "text" not in fields:
            return 400, list(CORS_HEADERS), b"missing 'text'"

        try:
            samples = self.audio.decode_and_resample(fields["audio"], 24_000)
        except Exception as exc:
            return 400, list(CORS_HEADERS), f"audio decode failed: {exc}".encode()

        text = fields["text"].decode("utf-8", "replace")
        loop = asyncio.get_running_loop()
        if stream:
            return await self._synthesize_stream(headers, samples, text,
                                                 duration, loop,
                                                 raw_audio=fields["audio"],
                                                 t_req=t_req)
        try:
            token_ids = await loop.run_in_executor(self._pool, self.tokenize, text)
        except Exception as exc:
            return 500, list(CORS_HEADERS), f"phonemize failed: {exc}".encode()

        t0 = time.perf_counter()
        from smalltts_tpu_torch.serving.batcher import QueueFull

        try:
            # pipeline construction can compile for minutes — never block the
            # event loop (use server --warmup to pay this at startup)
            batcher = await loop.run_in_executor(self._pool, self._ensure_pipeline)
            ref_latents = await loop.run_in_executor(
                self._pool, self._encode_reference_cached, samples,
                fields["audio"],
            )
            fut = batcher.submit(ref_latents, token_ids, duration)
            audio = await asyncio.wrap_future(fut)
        except QueueFull:
            self.stats.rejected += 1
            return (
                503,
                [("retry-after", "1"), *CORS_HEADERS],
                b"server saturated, retry later",
            )
        except Exception as exc:
            return 500, list(CORS_HEADERS), f"inference failed: {exc}".encode()
        self.stats.requests += 1
        self.stats.synth_ms.append((time.perf_counter() - t0) * 1e3)

        extra_headers = []
        if self.gate.settles:
            # capture-after-serve (reference x402-axum order: verify ->
            # handler -> settle; failed capture returns 402, main.rs:60-79).
            # Local mode settles the same way: check() verified without side
            # effects, settle() burns the nonce + archives the authorization.
            receipt = await loop.run_in_executor(
                self._pool, self.gate.settle, headers.get("x-payment", ""),
                duration, "/synthesize")
            if receipt is None:
                _, challenge = self.gate.check({}, duration, "/synthesize")
                return (
                    402,
                    [("payment-required", challenge), *CORS_HEADERS],
                    b"payment settlement failed",
                )
            extra_headers.append(("x-payment-response", receipt))

        wav = self.audio.encode_wav(audio.reshape(-1), 24_000)
        return (
            200,
            [("content-type", "audio/wav"), *extra_headers, *CORS_HEADERS],
            wav,
        )

    async def _synthesize_stream(self, headers, samples, text, duration, loop,
                                 raw_audio: bytes = None,
                                 t_req: float = None):
        """-> (200, headers, async byte generator). Sentence chunks stream
        as they synthesize; facilitator settlement happens BEFORE the body
        starts (a mid-stream 402 is impossible over chunked transfer)."""
        import struct

        import numpy as np

        from smalltts_tpu_torch.infer.long_form import (
            as_float_waveform,
            crossfade_stream_step,
            head_split,
            split_sentences,
        )
        from smalltts_tpu_torch.infer.pipeline import estimate_duration
        from smalltts_tpu_torch.serving.batcher import QueueFull

        try:
            batcher = await loop.run_in_executor(self._pool, self._ensure_pipeline)
            ref_latents = await loop.run_in_executor(
                self._pool, self._encode_reference_cached, samples, raw_audio,
            )
        except Exception as exc:
            return 500, list(CORS_HEADERS), f"inference failed: {exc}".encode()

        extra_headers = []
        if self.gate.settles:
            # streams settle BEFORE the body (a mid-stream 402 is impossible
            # over chunked transfer); in local mode this burns the nonce at
            # stream start — the unavoidable cost of pay-then-stream
            receipt = await loop.run_in_executor(
                self._pool, self.gate.settle, headers.get("x-payment", ""),
                duration, "/synthesize/stream")
            if receipt is None:
                _, challenge = self.gate.check({}, duration, "/synthesize/stream")
                return (402, [("payment-required", challenge), *CORS_HEADERS],
                        b"payment settlement failed")
            extra_headers.append(("x-payment-response", receipt))

        sr = 24_000
        fade = int(sr * 20 / 1e3)

        def wav_header_unknown_len() -> bytes:
            # RIFF with 0xFFFFFFFF sizes: the streaming convention players
            # accept when total length is unknown up front
            return struct.pack(
                "<4sI4s4sIHHIIHH4sI",
                b"RIFF", 0xFFFFFFFF, b"WAVE",
                b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16,
                b"data", 0xFFFFFFFF,
            )

        from smalltts_tpu_torch.serving.audio_io import pcm16 as pcm

        # The streaming body keeps running batcher.submit/executor work while
        # being consumed by _respond_chunked, well after _synthesize_inner
        # returned — so it must hold its OWN drain-accounting slot, or
        # shutdown() can close the batcher/pool mid-stream.
        # Incrementing inside the generator body (not before returning it)
        # can't leak if the generator is never iterated; the sub-tick gap
        # before first iteration degrades gracefully because Batcher.submit
        # raises QueueFull once the batcher is closed (fail fast, no hang).
        # Payment was priced on ?duration= (gate.check verified value >=
        # price_for_duration(duration)), so in enforcing modes the stream
        # must not synthesize more audio than was paid for — otherwise a
        # 0.1 s payment buys a 30-minute text. Trust mode keeps
        # the documented behavior: duration is a hint, the full text streams.
        paid_budget = duration if self.gate.enforcing else None

        # First-chunk fast path (TTFB measured WORSE
        # than non-streaming): clip a ~24-char head off sentence 1 so the
        # first audio chunk synthesizes in the SMALLEST latent bucket, and
        # submit it at priority 1 so it never queues behind other streams'
        # later chunks. The 20 ms crossfade blends the cut.
        chunks = split_sentences(text)
        if chunks:
            head, rest = head_split(chunks[0])
            if rest:
                chunks = [head, rest] + chunks[1:]
        # per-chunk duration plan, spending the paid budget in order (the
        # budget math must happen BEFORE pipelined submission)
        plan = []
        budget = paid_budget
        for chunk in chunks:
            if not chunk.strip():
                continue
            chunk_dur = estimate_duration(chunk)
            if budget is not None:
                if budget <= 1e-6:
                    break  # paid audio exhausted; close the stream there
                chunk_dur = min(chunk_dur, budget)
                budget -= chunk_dur
            plan.append((chunk, chunk_dur))

        async def gen():
            from collections import deque

            futs: deque = deque()
            self._active += 1
            try:
                yield wav_header_unknown_len()
                pending = None
                # TTFB is measured from REQUEST ARRIVAL (t_req, captured in
                # _synthesize before parse/ref-encode/settle), so the stat
                # is the full server-owned first-chunk latency; fall back to
                # generator start when called without it (direct tests)
                t0 = t_req if t_req is not None else time.perf_counter()
                ttfb_ms = None
                # PIPELINED submission: keep a window of chunks in the
                # batcher so chunk N+1..N+k synthesize while chunk N streams
                # (the old submit-await-submit serialization made every
                # stream pay queue+synthesis latency PER SENTENCE); results
                # are consumed strictly in order so the crossfade chain is
                # unchanged.
                lookahead = 4
                idx = 0

                async def refill():
                    nonlocal idx
                    while idx < len(plan) and len(futs) < lookahead:
                        chunk, chunk_dur = plan[idx]
                        pri = 1 if idx == 0 else 0
                        idx += 1
                        tokens = await loop.run_in_executor(
                            self._pool, self.tokenize, chunk
                        )
                        if not tokens:
                            continue
                        try:
                            futs.append(batcher.submit(
                                ref_latents, tokens, chunk_dur, priority=pri))
                        except QueueFull:
                            self.stats.rejected += 1
                            # propagate: _respond_chunked aborts WITHOUT the
                            # terminal chunk, so the client's chunked decoder
                            # raises incomplete-read instead of treating the
                            # truncated audio as a complete response
                            raise

                await refill()
                while futs:
                    audio = await asyncio.wrap_future(futs.popleft())
                    await refill()  # keep the window full while we emit
                    # as_float_waveform rescales a pcm16_out pipeline's int16
                    # back to [-1, 1] for the crossfade; the non-faded region
                    # round-trips losslessly through pcm()
                    cur = as_float_waveform(audio)
                    emit, pending = crossfade_stream_step(pending, cur, fade)
                    if emit is not None:
                        if ttfb_ms is None:
                            ttfb_ms = (time.perf_counter() - t0) * 1e3
                            self.stats.ttfb_ms.append(ttfb_ms)
                        yield pcm(emit)
                if pending is not None:
                    if ttfb_ms is None:
                        self.stats.ttfb_ms.append(
                            (time.perf_counter() - t0) * 1e3)
                    yield pcm(pending)
                self.stats.requests += 1
                self.stats.synth_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                # an abandoned/aborted stream must not leave its lookahead
                # window synthesizing for nobody (the fetch loop tolerates
                # cancelled futures per-request)
                for f in futs:
                    f.cancel()
                self._active -= 1

        return 200, [("content-type", "audio/wav"), *extra_headers,
                     *CORS_HEADERS], gen()

    # ------------------------------------------------------------ transport

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                # keep-alive idle wait uses the same bound as in-request
                # reads: a stalled or silent client frees its slot
                request_line = await asyncio.wait_for(
                    reader.readline(), self.read_timeout_s
                )
                if not request_line:
                    break
                if len(request_line) > HEADER_LIMIT:
                    await self._respond(writer, 431, list(CORS_HEADERS),
                                        b"request line too long")
                    break
                try:
                    method, target, _version = request_line.decode().split()
                except ValueError:
                    break
                headers: Dict[str, str] = {}
                header_bytes = len(request_line)
                too_big = False
                bad_framing = None
                while True:
                    line = await asyncio.wait_for(
                        reader.readline(), self.read_timeout_s
                    )
                    if line in (b"\r\n", b"\n", b""):
                        break
                    header_bytes += len(line)
                    if header_bytes > HEADER_LIMIT or len(headers) >= MAX_HEADERS:
                        too_big = True
                        break
                    if line[:1] in (b" ", b"\t"):
                        # obs-fold continuation: deprecated (RFC 7230 3.2.4)
                        # and a smuggling primitive when a front proxy joins
                        # folded lines this parser would treat as separate
                        bad_framing = b"obsolete header folding"
                        continue
                    k, _, v = line.decode("latin-1").partition(":")
                    k, v = k.strip().lower(), v.strip()
                    if k == "content-length" and headers.get(k, v) != v:
                        # duplicate conflicting Content-Length: last-wins
                        # here could disagree with a first-wins front proxy
                        # on where this request's body ends (RFC 7230 3.3.3
                        # mandates rejection)
                        bad_framing = b"conflicting content-length"
                    headers[k] = v
                if too_big:
                    await self._respond(writer, 431, list(CORS_HEADERS),
                                        b"headers too large")
                    break
                if "transfer-encoding" in headers:
                    # this server only frames request bodies by
                    # Content-Length; silently ignoring a chunked body would
                    # desync the connection (the body bytes would parse as
                    # the NEXT request — the classic smuggling vector behind
                    # a connection-reusing proxy). 501 + close (RFC 7230
                    # 3.3.1 allows rejecting unsupported transfer codings).
                    await self._respond(writer, 501, list(CORS_HEADERS),
                                        b"transfer-encoding not supported")
                    break
                if bad_framing is not None:
                    await self._respond(writer, 400, list(CORS_HEADERS),
                                        bad_framing)
                    break
                try:
                    length = int(headers.get("content-length", 0))
                    if length < 0:  # readexactly(-1) raises uncaught
                        raise ValueError
                except ValueError:
                    await self._respond(writer, 400, list(CORS_HEADERS),
                                        b"bad content-length")
                    break
                if length > BODY_LIMIT:
                    await self._respond(writer, 413, list(CORS_HEADERS), b"body too large")
                    break
                body = (
                    await asyncio.wait_for(reader.readexactly(length),
                                           self.read_timeout_s)
                    if length
                    else b""
                )
                parsed = urllib.parse.urlsplit(target)
                query = dict(urllib.parse.parse_qsl(parsed.query))
                status, hdrs, payload = await self.handle(
                    method, parsed.path, query, headers, body
                )
                if isinstance(payload, (bytes, bytearray)):
                    await self._respond(writer, status, hdrs, payload)
                else:  # async byte generator -> chunked transfer encoding
                    await self._respond_chunked(writer, status, hdrs, payload)
                    break  # chunked stream ends the connection
                if headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.TimeoutError):
            pass
        finally:
            writer.close()

    @staticmethod
    async def _respond_chunked(writer, status: int, headers, agen) -> None:
        """HTTP/1.1 chunked transfer of an async byte generator."""
        reason = {200: "OK"}.get(status, "")
        lines = [f"HTTP/1.1 {status} {reason}"]
        lines += [f"{k}: {v}" for k, v in headers]
        lines.append("transfer-encoding: chunked")
        lines.append("connection: close")
        lines.append("\r\n")
        writer.write("\r\n".join(lines).encode())
        await writer.drain()
        complete = False
        try:
            async for piece in agen:
                if not piece:
                    continue
                writer.write(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
                await writer.drain()
            complete = True
        except Exception:
            # generator failure (QueueFull, inference error) or client
            # disconnect: abort the connection WITHOUT the terminal chunk.
            # The WAV header carries unknown-length sizes, so a terminator
            # here would present truncated audio as a spec-valid complete
            # response the client cannot distinguish.
            pass
        finally:
            # close the generator NOW (not at GC) so its finally blocks —
            # drain accounting, batcher futures — run before the connection
            # is torn down, even when the client disconnected mid-stream
            try:
                await agen.aclose()
            except Exception:
                pass
            if complete:
                writer.write(b"0\r\n\r\n")
                await writer.drain()

    @staticmethod
    async def _respond(writer, status: int, headers, body: bytes) -> None:
        reason = {200: "OK", 400: "Bad Request", 402: "Payment Required",
                  404: "Not Found", 413: "Payload Too Large",
                  431: "Request Header Fields Too Large",
                  500: "Internal Server Error",
                  501: "Not Implemented",
                  503: "Service Unavailable"}.get(status, "")
        lines = [f"HTTP/1.1 {status} {reason}"]
        lines += [f"{k}: {v}" for k, v in headers]
        lines.append(f"content-length: {len(body)}")
        lines.append("\r\n")
        writer.write("\r\n".join(lines).encode() + body)
        await writer.drain()

    async def shutdown(self, drain_timeout_s: float = 30.0) -> None:
        """Graceful drain: flip /ready to 503 (load balancers stop routing),
        reject stragglers, wait for in-flight request coroutines, close the
        batcher, then release the host-work pool. The pool must outlive the
        in-flight coroutines: they schedule executor work (encode, settle)
        after resuming, and a shut pool would 500 requests whose synthesis
        already succeeded."""
        self._draining = True
        deadline = time.monotonic() + drain_timeout_s
        while self._active > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        if self._batcher is not None:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(self._pool, self._batcher.close)
        # release the host-work threads (embedding apps recreate servers)
        self._pool.shutdown(wait=False)

    async def run(self, host: str = "0.0.0.0", port: int = 3000) -> None:
        import signal

        server = await asyncio.start_server(self._serve_conn, host, port)
        print(f"listening on {host}:{port}")
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass  # e.g. non-main thread
        async with server:
            serve_task = asyncio.ensure_future(server.serve_forever())
            stop_task = asyncio.ensure_future(stop.wait())
            done, _ = await asyncio.wait(
                {serve_task, stop_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if stop_task in done:
                print("shutdown signal: draining in-flight requests")
                await self.shutdown()
                serve_task.cancel()


def main() -> None:
    import argparse
    import os

    ap = argparse.ArgumentParser(description="smalltts_tpu_torch serving (one CUDA card)")
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT", 3000)))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--payments", default="disabled",
                    choices=["disabled", "trust", "facilitator", "local"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--warmup", action="store_true",
                    help="capture the FULL serving shape contract, one CUDA "
                         "graph per bucket, before listening (no request "
                         "ever captures)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--growth-limit", type=int, default=32,
                    help="adaptive batching: grow the batch class up to this "
                         "under sustained queue depth; 0 disables and "
                         "pins the class at --max-batch")
    ap.add_argument("--latency-slo-ms", type=float, default=2000.0,
                    help="adaptive batching steps the class back down when "
                         "p95 request sojourn breaches this (0 disables the "
                         "latency guard)")
    ap.add_argument("--voices", default=None, metavar="DIR",
                    help="named-voice directory for /v1/audio/speech "
                         "(<name>.npy reference latents or <name>.wav)")
    ap.add_argument("--static", default=None, metavar="DIR",
                    help="serve a static web client from DIR at GET / "
                         "(e.g. website/); same-origin, so the page needs "
                         "no API configuration")
    ap.add_argument("--pcm16", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="quantize to int16 PCM on the device: halves "
                         "device->host result bytes and removes host-side "
                         "quantization (<=1 LSB vs the fp32 path). ON by "
                         "default; --no-pcm16 restores the fp32 "
                         "device->host path")
    args = ap.parse_args()

    tts = None
    if args.checkpoint or args.warmup:
        from smalltts_tpu_torch.infer.pipeline import SmallTTS
        from smalltts_tpu_torch.serving.batcher import batch_ladder

        tts = SmallTTS(checkpoint=args.checkpoint, pcm16_out=args.pcm16)
        if args.warmup:
            # warm the growth classes too: an adaptive step-up mid-traffic
            # must swap graphs, never stall a live queue on a capture
            sizes = (1, *batch_ladder(args.max_batch, args.growth_limit))
            print(f"warming up the serving shape contract (batches {sizes})...")
            n = tts.warmup(batch_sizes=sizes, progress=True)
            print(f"warmed {n} shapes ({tts.compile_cache_size()} CUDA graphs); "
                  "in-contract requests never capture")
    srv = TTSServer(tts=tts, x402_cfg=X402Config(mode=args.payments),
                    max_batch=args.max_batch, static_dir=args.static,
                    voices_dir=args.voices, pcm16=args.pcm16,
                    growth_limit=args.growth_limit or None,
                    latency_slo_ms=args.latency_slo_ms or None)
    if tts is not None:
        srv._ensure_pipeline()  # warmed servers report /ready immediately
    asyncio.run(srv.run(args.host, args.port))


if __name__ == "__main__":
    main()

"""Serving load benchmark: the full HTTP path as a client sees it (port of
scripts/bench_serving.py).

    python -m smalltts_tpu_torch.scripts.bench_serving [--clients 16] [--requests 8] [--duration 5.0]
        [--max-batch 8] [--distinct-voices 1] [--soak-seconds 0] [--stream] [--sentences 4]
        [--pcm16/--no-pcm16] [--proc-clients] [--growth-limit 0] [--latency-slo-ms 0] [--device cuda]

HTTP parse -> multipart -> wav decode -> phonemize -> reference encode
(LRU) -> continuous batcher -> synthesis (one CUDA graph per bucket on the
card) -> WAV response, through the port's TTSServer on a local socket.
Before the clients start, SmallTTS.warmup captures exactly the buckets the
run will hit, the streamed chunk plan's included (long_form.split_sentences
and head_split, as the server plans them), so no capture lands in a
latency percentile. Prints one JSON line: throughput (audio-s/s, req/s) and
latency p50/p95 (with --stream, time to the first audio chunk as the client
and the server see it).

`--proc-clients` runs the load generators as processes of their own: this
file with `--worker`, spawned by its path, which imports the standard
library only (no torch, no numpy, not the package), so a client never
starts a CUDA context or holds the server's GIL.
"""

import argparse
import json
import os
import sys
import time


def worker_main(argv: list) -> None:
    """Out-of-process load generator (`--worker`, internal): issues the
    requests over http.client and prints one JSON line
    {"ttfb": [...seconds...], "lat": [...seconds...]}."""
    import http.client

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--duration", type=float, required=True)
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--body-file", required=True)
    ap.add_argument("--ctype", required=True)
    args = ap.parse_args(argv)
    with open(args.body_file, "rb") as f:
        body = f.read()
    path = ("/synthesize/stream" if args.stream else "/synthesize") + f"?duration={args.duration}"
    ttfb, lat = [], []
    for _ in range(args.requests):
        # one connection a request: the chunked endpoint closes connections,
        # and a connect per request keeps stream and non-stream symmetric
        conn = http.client.HTTPConnection("127.0.0.1", args.port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", path, body, {"Content-Type": args.ctype})
        r = conn.getresponse()
        assert r.status == 200, (r.status, r.read()[:200])
        head = r.read(44)          # RIFF header
        first = r.read(2)          # first PCM sample
        t_first = time.perf_counter()
        data = head + first + r.read()
        t_done = time.perf_counter()
        assert data[:4] == b"RIFF" and len(data) > 46, len(data)
        conn.close()
        ttfb.append(t_first - t0)
        lat.append(t_done - t0)
    print(json.dumps({"ttfb": ttfb, "lat": lat}))


def make_wav(seconds: float, freq: float = 440.0, sr: int = 24_000) -> bytes:
    import numpy as np

    from smalltts_tpu_torch.serving.audio_io import encode_wav

    x = 0.3 * np.sin(2 * np.pi * freq * np.arange(int(seconds * sr)) / sr)
    return encode_wav(x.astype(np.float32), sr)


def multipart(wav: bytes, text: str, boundary: str = "XB") -> tuple:
    from smalltts_tpu_torch.serving.multipart import build_multipart

    return build_multipart({"audio": wav, "text": text}, boundary=boundary)


def stream_text(sentences: int) -> str:
    """Sentences long enough that long_form keeps them apart (~330 chars)."""
    return " ".join((f"sentence number {i} " * 12).strip() + "." for i in range(sentences))


def warm_buckets(text: str, duration: float, stream: bool):
    """(latent buckets, phoneme buckets) the run's requests reach: the
    request's duration bucket, and with `stream` each chunk of the server's
    plan (split_sentences, the head split of the first sentence)."""
    from smalltts_tpu_torch.data.bucketing import (
        LATENT_BUCKETS,
        SERVING_PHONEME_BUCKETS,
        frames_for_duration,
        pick_bucket,
    )

    t_buckets, p_buckets = {pick_bucket(frames_for_duration(duration), LATENT_BUCKETS)}, {128}
    if stream:
        from smalltts_tpu_torch.infer.long_form import head_split, split_sentences
        from smalltts_tpu_torch.infer.pipeline import estimate_duration
        from smalltts_tpu_torch.text import get_token_ids

        sents = split_sentences(text)
        head, rest = head_split(sents[0])
        for s in ([head, rest] if rest else [sents[0]]) + sents[1:]:
            if s.strip():
                t_buckets.add(pick_bucket(frames_for_duration(estimate_duration(s)), LATENT_BUCKETS))
                p_buckets.add(pick_bucket(max(len(get_token_ids(s)), 1), SERVING_PHONEME_BUCKETS))
    return sorted(t_buckets), sorted(p_buckets)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Load-test the HTTP serving path.")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8, help="per client")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--distinct-voices", type=int, default=1,
                    help="1 = shared voice (LRU steady state); N cycles N refs")
    ap.add_argument("--soak-seconds", type=float, default=0.0,
                    help="run clients in a loop until the deadline and report "
                         "RSS growth (leak check) instead of fixed request counts")
    ap.add_argument("--stream", action="store_true",
                    help="bench /synthesize/stream with a multi-sentence text "
                         "and report time-to-first-audio-chunk (TTFB) p50/p95")
    ap.add_argument("--sentences", type=int, default=4,
                    help="sentences per streamed request (--stream)")
    ap.add_argument("--pcm16", action=argparse.BooleanOptionalAction, default=True,
                    help="serve with int16 quantization on the device "
                         "(SmallTTS(pcm16_out=True)), the server's default; "
                         "--no-pcm16 is the A/B")
    ap.add_argument("--proc-clients", action="store_true",
                    help="run load generators as SUBPROCESSES (stdlib-only "
                         "workers over real sockets) instead of in-process "
                         "threads, so client bookkeeping never shares the "
                         "server's GIL")
    ap.add_argument("--growth-limit", type=int, default=0,
                    help="adaptive batch growth limit (0 = fixed class, the "
                         "default here so latency percentiles measure ONE "
                         "class; growth classes are warmed when enabled)")
    ap.add_argument("--latency-slo-ms", type=float, default=0.0,
                    help="adaptive step-down SLO (0 disables)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.serving.batcher import batch_ladder
    from smalltts_tpu_torch.serving.server import TTSServer
    from smalltts_tpu_torch.serving.x402 import X402Config

    tts = SmallTTS(seed=0, pcm16_out=args.pcm16, device=args.device)
    text = stream_text(args.sentences) if args.stream else "the quick brown fox jumps over it"
    t_buckets, p_buckets = warm_buckets(text, args.duration, args.stream)
    t0 = time.time()
    sizes = (1, *batch_ladder(args.max_batch, args.growth_limit))
    tts.warmup(batch_sizes=sizes, t_buckets=t_buckets, r_buckets=(64,), p_buckets=p_buckets, workers=8)
    print(f"warmup in {time.time() - t0:.0f}s", file=sys.stderr)

    server = TTSServer(tts=tts, x402_cfg=X402Config(mode="disabled"), max_batch=args.max_batch,
                       growth_limit=args.growth_limit or None, latency_slo_ms=args.latency_slo_ms or None)
    bodies = [multipart(make_wav(0.6, 440.0 + 20 * v), text) for v in range(max(1, args.distinct_voices))]

    async def run() -> dict:
        import http.client
        import threading

        srv = await asyncio.start_server(server._serve_conn, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        lat: list = []
        ttfb: list = []
        lock = threading.Lock()

        def client(cid: int, n_req: int, deadline: float = 0.0) -> None:
            # the chunked endpoint closes its connection, so only the
            # non-stream client keeps one alive
            conn = None if args.stream else http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            j = 0
            while (j < n_req) if not deadline else (time.perf_counter() < deadline):
                body, ctype = bodies[(cid + j) % len(bodies)]
                t0 = time.perf_counter()
                if args.stream:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                    conn.request("POST", f"/synthesize/stream?duration={args.duration}", body,
                                 {"Content-Type": ctype})
                    r = conn.getresponse()
                    assert r.status == 200, r.status
                    head = r.read(44)      # streaming RIFF header
                    first = r.read(2)      # first PCM sample of sentence 1
                    t_first = time.perf_counter()
                    data = head + first + r.read()
                    assert data[:4] == b"RIFF" and len(data) > 46, len(data)
                    conn.close()
                    with lock:
                        ttfb.append(t_first - t0)
                        lat.append(time.perf_counter() - t0)
                else:
                    conn.request("POST", f"/synthesize?duration={args.duration}", body, {"Content-Type": ctype})
                    r = conn.getresponse()
                    data = r.read()
                    assert r.status == 200 and data[:4] == b"RIFF", (r.status, data[:80])
                    with lock:
                        lat.append(time.perf_counter() - t0)
                j += 1
            if conn is not None:
                conn.close()

        # the clients' own pool: the loop's default executor is shared
        pool = ThreadPoolExecutor(args.clients + 4)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(pool, client, 0, 2)  # warm the serving path
        lat.clear()
        ttfb.clear()

        def rss_mb() -> float:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        return int(line.split()[1]) / 1024.0
            return -1.0

        # /stats percentiles cover exactly the measured window
        server.stats.ttfb_ms.clear()
        server.stats.synth_ms.clear()

        rss_before = rss_mb()
        t0 = time.perf_counter()
        deadline = t0 + args.soak_seconds if args.soak_seconds else 0.0
        if args.proc_clients:
            assert not args.soak_seconds, "--proc-clients has no soak mode"
            import tempfile

            files = []
            for i, (body, ctype) in enumerate(bodies):
                with tempfile.NamedTemporaryFile(delete=False, suffix=f".mp{i}") as bf:
                    bf.write(body)
                files.append((bf.name, ctype))
            procs = []
            for c in range(args.clients):
                fname, ctype = files[c % len(files)]
                cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--port", str(port),
                       "--requests", str(args.requests), "--duration", str(args.duration),
                       "--body-file", fname, "--ctype", ctype]
                if args.stream:
                    cmd.append("--stream")
                procs.append(await asyncio.create_subprocess_exec(
                    *cmd, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE))
            outs = await asyncio.gather(*[p.communicate() for p in procs])
            wall = time.perf_counter() - t0
            for fname, _ in files:
                os.unlink(fname)
            for p, (o, e) in zip(procs, outs):
                assert p.returncode == 0, e.decode()[-500:]
                rec = json.loads(o)
                ttfb.extend(rec["ttfb"])
                lat.extend(rec["lat"])
        else:
            await asyncio.gather(*[loop.run_in_executor(pool, client, c, args.requests, deadline)
                                   for c in range(args.clients)])
            wall = time.perf_counter() - t0
        rss_after = rss_mb()
        pool.shutdown()
        srv.close()
        await srv.wait_closed()
        await server.shutdown()
        lat.sort()
        total = len(lat)
        p50 = 1e3 * lat[len(lat) // 2] if lat else 0.0
        p95 = 1e3 * lat[min(int(len(lat) * 0.95), len(lat) - 1)] if lat else 0.0
        out = {
            "metric": "serving_audio_sec_per_sec",
            "value": round(total * args.duration / wall, 1),
            "req_per_sec": round(total / wall, 1),
            "requests": total,
            "latency_p50_ms": round(p50, 1),
            "latency_p95_ms": round(p95, 1),
            "clients": args.clients,
            "duration_sec": args.duration,
            "max_batch": args.max_batch,
            "distinct_voices": args.distinct_voices,
            "pcm16": bool(args.pcm16),
            "growth_limit": args.growth_limit,
            "proc_clients": bool(args.proc_clients),
        }
        if args.growth_limit:
            out["final_batch_class"] = server._stat_snapshot()["batch_class"]
        if args.stream:
            ttfb.sort()
            out["metric"] = "serving_stream_ttfb_ms"
            out["ttfb_p50_ms"] = round(1e3 * ttfb[len(ttfb) // 2], 1) if ttfb else 0.0
            out["ttfb_p95_ms"] = round(1e3 * ttfb[min(int(len(ttfb) * 0.95), len(ttfb) - 1)], 1) if ttfb else 0.0
            out["value"] = out["ttfb_p50_ms"]
            out["sentences"] = args.sentences
            # the server's own clock, request arrival -> first PCM chunk, over the same window
            out["server_stats"] = server._stat_snapshot()
            out["server_ttfb_p50_ms"] = out["server_stats"]["stream_ttfb_ms_p50"]
            out["server_ttfb_p95_ms"] = out["server_stats"]["stream_ttfb_ms_p95"]
        if args.soak_seconds:
            out["soak_seconds"] = args.soak_seconds
            out["rss_before_mb"] = round(rss_before, 1)
            out["rss_after_mb"] = round(rss_after, 1)
        return out

    print(json.dumps(asyncio.run(run())))
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        # the stdlib-only load generator: nothing above imports torch, numpy or the package
        worker_main(sys.argv[1:])
    else:
        raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (smalltts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds every kernel source in smalltts_tpu_torch/csrc/ (one nvcc each, all
   started together) and prints the build times.
2. Kernel phases: each hand-written kernel against its plain PyTorch version
   on the card, at the serving path's shapes, with the tolerance stated;
   kernel, plain and (where one exists) library-call times from CUDA events.
3. Serving phase: SmallTTS(pcm16_out=True) at full width (default
   BackboneConfig / CodecConfig, bf16, seeded random weights) behind the
   port's Batcher answers 10 requests; the launch counters, reset just
   before, must show every kernel of the path; one batch is held against
   the same batch run with the plain versions forced; synthesize_padded
   (fetch=False) must queue a batch with no synchronizing call, and one
   batch is profiled (host dispatch time, wall time, device busy time).
4. Prints the card's name and power limit, one JSON line of per-kernel
   numbers, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA card or without the
package beside this script; any failed check raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

MEM_BW = 3.35e12                      # H100 SXM HBM3, bytes/s
PEAK = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 off the tensor cores
ATTN_SRC = "smalltts_tpu_torch/csrc/attention.cu"
BLOCK_SRC = "smalltts_tpu_torch/csrc/dit_block.cu"
ATTN_TPU = "smalltts_tpu/ops/pallas/attention.py:58"
ATTN_KERNELS = ("attn_kernel<", "attn_tc_kernel<")  # fp32 (CUDA cores), bf16 (tensor cores)
BLOCK_TPU = "smalltts_tpu/ops/pallas/block.py:216"
SCAN_KERNELS = ("adaln_modulate", "qk_norm_rope", "gemm_bias", "gemm_swiglu", "gemm_residual")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"


def bound(nbytes: float, flops: float, kind: str):
    t_bytes, t_ops = nbytes / MEM_BW, flops / PEAK[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    """Bytes the tensors hold; a view broadcast over its first dim counts once."""
    total = 0
    for t in ts:
        while t.dim() and t.stride(0) == 0:
            t = t[0]
        total += t.numel() * t.element_size()
    return total


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import smalltts_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the smalltts_tpu_torch package is not beside this script", file=sys.stderr)
        return 2

    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels import attention as A
    from smalltts_tpu_torch.ops.kernels import dit_block as K

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    secs = kernels.build_all()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} s per source, "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    def device_ms(fn, iters=10, match=None):
        """Device time per call from torch.profiler: the kernels whose names
        hold one of `match` (every kernel when None), summed over `iters`
        calls. None when the profiler reports no device time."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = prof.key_averages()
        if sum(_dev_us(e) for e in evts) == 0:
            return None  # the profiler sees no device time at all
        total = sum(_dev_us(e) for e in evts if match is None or any(m in e.key for m in match))
        check(total > 0, f"no profiled kernel matches {match}")
        return total / 1e3 / iters

    def timed(fn, iters, match=None, per=1):
        """(ms, wall ms, clock) per launch: ms is profiler device time, or the
        event-timed wall time (clock "wall") where the profiler saw none."""
        wall = time_ms(fn, iters=iters) / per
        dev_t = device_ms(fn, iters=iters, match=match)
        return (wall, wall, "wall") if dev_t is None else (dev_t / per, wall, "device")

    def err(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max()), float((got - want).abs().max() / want.abs().max())

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    def key_mask(B, S):
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        m = torch.arange(S, device=dev)[None] < lens[:, None]
        m[-1] = False  # one fully-masked row: a uniform average, as the reference gives
        return m

    entries = []

    # ------------------------------------------------------------- kernel A
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    print("phase A: attention kernel vs plain (tolerance: max|diff|/max|plain| <= 1e-5 fp32, 2e-2 bf16)")
    shapes = []
    for label, B, H, T, S2, D in (("style R=256", 8, 8, 256, 0, 64), ("text P=384", 8, 4, 384, 0, 128),
                                  ("dit T=40 + cross Sc=192, gated", 8, 8, 40, 192, 120)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((B, H, T, D), dtype) for _ in range(3))
            m = key_mask(B, T)
            two = dict(k2=randn((B, H, S2, D), dtype), v2=randn((B, H, S2, D), dtype),
                       key_mask2=key_mask(B, S2), gate=randn((B, H, T, D), dtype)) if S2 else {}
            got = A.fused_attention(q, k, v, m, **two)
            want = A.attention_plain(q, k, v, m, **two)
            abs_e, rel_e = err(got, want)
            check(rel_e <= tol[dtype], f"attention {label} {dtype}: rel err {rel_e:.3e}")
            ms, wall, clock = timed(lambda: A.fused_attention(q, k, v, m, **two), 20, ATTN_KERNELS)
            plain_ms = timed(lambda: A.attention_plain(q, k, v, m, **two), 20)[0]
            if S2:
                kc, vc = torch.cat([k, two["k2"]], 2), torch.cat([v, two["v2"]], 2)
                mc = torch.cat([m, two["key_mask2"]], 1)[:, None, None, :]
                lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, kc, vc, attn_mask=mc)  # noqa: E731
            else:
                lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None, None, :])  # noqa: E731
            lib_ms = timed(lib, 20)[0]
            S = T + S2
            b_ms, b_by = bound(nbytes(q, k, v, m, *two.values(), got), 4.0 * B * H * T * S * D,
                               "bf16" if dtype == torch.bfloat16 else "fp32")
            row = dict(shape=f"{label} B={B} H={H} D={D}", dtype=str(dtype).split(".")[-1],
                       max_abs_err=abs_e, rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            shapes.append(row)
            print("  " + json.dumps(row), flush=True)
    head = shapes[4]  # the DiT's gated two-source form in bf16: 48 of a batch's 68 launches
    entries.append(dict(name="attention", route="cuda", source=ATTN_SRC, replaces=ATTN_TPU,
                        **{k: head[k] for k in ("max_abs_err", "ms", "wall_ms", "clock", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}, shape=head["shape"], shapes=shapes))

    # ------------------------------------------------------------- kernel B
    from smalltts_tpu_torch.models.dit import DiTConfig, fuse_serving_projections, init_dit, rope_cos_sin

    cfg = DiTConfig()
    B, T, Sc, L, H = 8, 40, 192, cfg.n_blocks, cfg.hidden_dim
    heads, hd, F = cfg.heads, cfg.head_dim, cfg.ff_dim
    print(f"phase B: DiT block kernels vs plain at B={B} T={T} Sc={Sc}, {L} layers x {H} wide, bf16")
    p = fuse_serving_projections({"dit": init_dit(g, cfg, torch.bfloat16, dev)})["dit"]
    blocks = p["blocks"]
    mods = randn((L, 6 * H), scale=0.5)[:, None, :].expand(L, B, 6 * H)  # randomised adaLN
    x = randn((B, T, H))
    mask, cmask = key_mask(B, T), key_mask(B, Sc)
    mask[-1, :5] = True  # padded batch rows still have valid frames
    ck, cv = randn((L, B, heads, Sc, hd)), randn((L, B, heads, Sc, hd))
    cos, sin = rope_cos_sin(cfg, T, dev)
    scan = lambda: K.fused_dit_scan(x, mods, mask, ck, cv, cmask, blocks, cos, sin, heads=heads, head_dim=hd)  # noqa: E731
    got = scan()
    with kernels.force_plain():
        want = scan()
        plain_ms = timed(scan, 5)[0]
    rel_l2 = float((got.float() - want.float()).norm() / want.float().norm())
    print(f"  12-layer scan: rel-L2 {rel_l2:.3e} (tolerance 2e-2)", flush=True)
    check(rel_l2 <= 2e-2 and bool(torch.isfinite(got).all()), f"fused_dit_scan rel-L2 {rel_l2:.3e}")
    abs_e, _ = err(got, want)
    ms, wall, clock = timed(scan, 10)
    attn, ff = blocks["attn"], blocks["ff"]
    M = B * T
    wbytes = nbytes(attn["qkvg"]["w"], attn["qkvg"]["b"], attn["to_out"]["w"], ff["w13"]["w"], ff["w13"]["b"],
                    ff["w2"]["w"], ff["w2"]["b"], attn["q_norm"]["scale"], attn["k_norm"]["scale"])
    flops = L * (2.0 * M * H * (4 * H + H + 2 * F) + 2.0 * M * F * H + 4.0 * B * heads * T * (T + Sc) * hd)
    b_ms, b_by = bound(wbytes + nbytes(x, mods, mask, ck, cv, cmask, cos, sin, got), flops, "bf16")
    print(f"  scan: {ms:.4f} ms on the device ({wall:.4f} ms wall), {plain_ms:.4f} ms plain, "
          f"bound {b_ms:.4f} ms ({b_by})")
    scan_entry = dict(name="fused_dit_scan", route="cuda", source=BLOCK_SRC, replaces=BLOCK_TPU,
                      max_abs_err=abs_e, rel_l2=rel_l2, ms=ms, wall_ms=wall, clock=clock, plain_ms=plain_ms,
                      bound_ms=b_ms,
                      bound_by=b_by, library_ms=None, shape=f"B={B} T={T} Sc={Sc} L={L} H={H}")

    # each launch of a layer, timed over the 12 layers' weights (88+ MB: out of L2, as in the scan)
    h_in = randn((B, T, H))
    mid_in = randn((B, T, F))
    per_layer = [
        ("adaln_modulate", lambda l: K.adaln_modulate(h_in, mods[l][:, :H], mods[l][:, H:2 * H]),
         lambda l: K.adaln_modulate_plain(h_in, mods[l][:, :H], mods[l][:, H:2 * H]),
         None, lambda l: (nbytes(h_in, mods[l][:, :2 * H]) + h_in.numel() * 2, 0.0)),
        ("qk_norm_rope", None, None, None, None),
        ("gemm_bias", lambda l: K.gemm_bias(h_in, attn["qkvg"]["w"][l], attn["qkvg"]["b"][l]),
         lambda l: K.gemm_bias_plain(h_in, attn["qkvg"]["w"][l], attn["qkvg"]["b"][l]),
         lambda l: torch.addmm(attn["qkvg"]["b"][l], h_in.view(M, H), attn["qkvg"]["w"][l]),
         lambda l: (nbytes(h_in, attn["qkvg"]["w"][l], attn["qkvg"]["b"][l]) + M * 4 * H * 2,
                    2.0 * M * H * 4 * H)),
        ("gemm_swiglu", lambda l: K.gemm_swiglu(h_in, ff["w13"]["w"][l], ff["w13"]["b"][l]),
         lambda l: K.gemm_swiglu_plain(h_in, ff["w13"]["w"][l], ff["w13"]["b"][l]), None,
         lambda l: (nbytes(h_in, ff["w13"]["w"][l], ff["w13"]["b"][l]) + M * F * 2, 2.0 * M * H * 2 * F)),
        ("gemm_residual", lambda l: K.gemm_residual(mid_in, ff["w2"]["w"][l], ff["w2"]["b"][l], x.clone(),
                                                   mods[l][:, 5 * H:]),
         lambda l: K.gemm_residual_plain(mid_in, ff["w2"]["w"][l], ff["w2"]["b"][l], x.clone(),
                                         mods[l][:, 5 * H:]), None,
         lambda l: (nbytes(mid_in, ff["w2"]["w"][l], ff["w2"]["b"][l], mods[l][:, 5 * H:]) + 2 * M * H * 2,
                    2.0 * M * F * H)),
    ]
    qkvg0 = randn((B, T, 4 * H))
    qs, ks = attn["q_norm"]["scale"], attn["k_norm"]["scale"]
    per_layer[1] = ("qk_norm_rope", lambda l: K.qk_norm_rope(qkvg0.clone(), qs[l], ks[l], cos, sin),
                    lambda l: K.qk_norm_rope_plain(qkvg0.clone(), qs[l], ks[l], cos, sin), None,
                    lambda l: (2 * 2 * M * H * 2 + nbytes(qs[l], ks[l], cos, sin), 0.0))

    def over_layers(fn):
        def run():
            for l in range(L):
                fn(l)
        return run

    kernel_names = {"adaln_modulate": ("adaln_kernel",), "qk_norm_rope": ("qk_norm_rope_kernel",),
                    "gemm_bias": ("gemm_kernel<0>", "gemm_kernelILi0E"),
                    "gemm_swiglu": ("gemm_kernel<1>", "gemm_kernelILi1E"),
                    "gemm_residual": ("gemm_kernel<2>", "gemm_kernelILi2E")}
    for name, kfn, pfn, lfn, cost in per_layer:
        got_k, want_k = kfn(0), pfn(0)
        abs_e, rel_e = err(got_k, want_k)
        check(rel_e <= 2e-2, f"{name}: rel err {rel_e:.3e}")
        ms, wall, clock = timed(over_layers(kfn), 5, kernel_names[name], per=L)
        pms = timed(over_layers(pfn), 5, per=L)[0]
        lms = timed(over_layers(lfn), 5, per=L)[0] if lfn else None
        b_ms, b_by = bound(*cost(0), "bf16")
        e = dict(name=name, route="cuda", source=BLOCK_SRC, replaces=BLOCK_TPU, max_abs_err=abs_e,
                 rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=lms, shape=f"M={M}")
        entries.append(e)
        print("  " + json.dumps(e), flush=True)
    entries.append(scan_entry)
    del blocks, p, ck, cv
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- serving phase
    import numpy as np

    from smalltts_tpu_torch.data.bucketing import HOP_SIZE, SAMPLE_RATE, frames_for_duration
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.infer.sampler import sample_latents
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.serving.batcher import Batcher, pad_group, Request

    print("phase serve: SmallTTS(pcm16_out=True), default BackboneConfig/CodecConfig, bf16, seed 0")
    t_init = time.perf_counter()
    gb = torch.Generator(device=dev).manual_seed(0)
    params = redraw_zero_init(init_backbone(gb, BackboneConfig(), device=dev), gb)
    tts = SmallTTS(params, pcm16_out=True, seed=0)
    del params
    n_params = sum(t.numel() for t in _leaves(tts.params))
    print(f"  built in {time.perf_counter() - t_init:.2f} s: {n_params / 1e6:.1f}M backbone params "
          f"({tts.dtype}), codec fp32, {tts.num_steps} steps", flush=True)

    rs = np.random.RandomState(0)
    durations = [2.0, 5.0] * 5
    waves = [(0.1 * rs.randn(int(rs.uniform(2.0, 6.0) * SAMPLE_RATE))).astype(np.float32) for _ in durations]
    ids = [rs.randint(1, 198, size=int(rs.randint(40, 201))).tolist() for _ in durations]
    # warm-up outside the counted run (cuDNN picks its algorithms on first use)
    tts.synthesize(tts.encode_reference(waves[0]), ids[0], 2.0)
    torch.cuda.synchronize()

    batches = []

    class Recorder:
        """Passes through to the pipeline and records each padded batch."""

        def __init__(self, inner):
            self.inner = inner

        def synthesize_padded(self, ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, **kw):
            batches.append(dict(batch=len(seq_lens), requests=int((np.asarray(ref_lens) > 0).sum()),
                                t_bucket=t_bucket, ref_bucket=ref.shape[1], phoneme_bucket=ph.shape[1]))
            return self.inner.synthesize_padded(ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, **kw)

    kernels.reset_launches()
    t_serve = time.perf_counter()
    refs = [tts.encode_reference(w) for w in waves]
    batcher = Batcher(Recorder(tts), max_batch=8)
    t_sub, t_done = [], [0.0] * len(durations)
    try:
        futs = []
        for i, (ref, tok, d) in enumerate(zip(refs, ids, durations)):
            t_sub.append(time.perf_counter())
            futs.append(batcher.submit(ref, tok, d))
            # the time the request resolved, whatever order the futures are read in
            futs[-1].add_done_callback(lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
        outs = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
    lat_ms = [(done - sub) * 1e3 for sub, done in zip(t_sub, t_done)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = dict(kernels.LAUNCHES)
    for out, d in zip(outs, durations):
        n = frames_for_duration(d) * HOP_SIZE
        check(out.dtype == np.int16 and out.shape == (1, n), f"result {out.dtype} {out.shape}, want int16 (1, {n})")
        check(int(np.abs(out).max()) > 0, "an all-zero waveform")
    print(f"  {len(outs)} requests answered in {serve_s:.3f} s (reference encode included)")
    print(f"  per-request latency ms (submit -> result): {json.dumps([round(v, 3) for v in lat_ms])}")
    print(f"  batches: {json.dumps(batches)}")
    print(f"  launches during the serving phase: {json.dumps(launches)}", flush=True)
    for e in entries:
        if e["name"] == "fused_dit_scan":
            # a host loop that launches nothing itself: the launches of its
            # per-layer kernels, and the one attention launch each layer
            # makes (one per qk_norm_rope launch; the attention counter also
            # holds the encoders' launches)
            e["launches"] = sum(launches.get(n, 0) for n in SCAN_KERNELS) + launches.get("qk_norm_rope", 0)
            e["launches_of"] = list(SCAN_KERNELS) + ["attention (one per layer)"]
        else:
            e["launches"] = launches.get(e["name"], 0)
        check(e["launches"] > 0, f"kernel {e['name']} was not launched by the serving path")

    # one batch with the kernels vs the same batch with the plain versions forced
    group = [Request(r, tok, d) for r, tok, d in zip(refs[:8], ids[:8], durations[:8])]
    ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, _ = pad_group(group, 8)
    tt = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    args = (tts.params, tts.cfg, tt(ref, tts.dtype), tt(ref_lens, torch.int32), tt(ph, torch.int64),
            tt(ph_lens, torch.int32), tt(seq_lens, torch.int32))
    noises = torch.randn((tts.num_steps, 8, t_bucket, 64), generator=g, device=dev).to(tts.dtype)
    with torch.inference_mode():
        lat_k = sample_latents(*args, num_steps=tts.num_steps, noises=noises)
        with kernels.force_plain():
            lat_p = sample_latents(*args, num_steps=tts.num_steps, noises=noises)
    lat_rel = float((lat_k.float() - lat_p.float()).norm() / lat_p.float().norm())
    print(f"  batch of 8 (t_bucket {t_bucket}) kernels vs plain: latents rel-L2 {lat_rel:.3e} (tolerance 5e-2)")
    check(bool(torch.isfinite(lat_k).all()) and lat_rel <= 5e-2, f"serving latents rel-L2 {lat_rel:.3e}")

    # where one batch's time goes: wall clock unprofiled, device busy from the profiler
    from torch.profiler import ProfilerActivity, profile

    def one_batch(fetch=True):
        return tts.synthesize_padded(ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, fetch=fetch)

    one_batch()
    # fetch=False must queue the whole batch without waiting for the card:
    # PyTorch raises here on any synchronizing call (a pageable copy, .item())
    torch.cuda.set_sync_debug_mode("error")
    try:
        one_batch(fetch=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  synthesize_padded(fetch=False) queued a batch with no synchronizing call", flush=True)
    # dispatch: host time to queue the batch; wall: until its waveform is on the host
    walls, dispatch = [], []
    for _ in range(5):
        t_b = time.perf_counter()
        audio = one_batch(fetch=False)
        dispatch.append((time.perf_counter() - t_b) * 1e3)
        audio.cpu()
        walls.append((time.perf_counter() - t_b) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_batch()
    kern = sorted(((e.key, _dev_us(e) / 1e3, e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA") and _dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    ours = sum(r[1] for r in kern if any(n in r[0] for n in ATTN_KERNELS + ("adaln_kernel", "qk_norm_rope_kernel",
                                                                          "gemm_kernel")))
    wall_med = sorted(walls)[len(walls) // 2]
    prof_row = dict(batch=8, t_bucket=t_bucket, ref_bucket=ref.shape[1], phoneme_bucket=ph.shape[1],
                    wall_ms=walls, dispatch_ms=dispatch, device_busy_ms=busy, hand_written_kernels_ms=ours,
                    idle_share=(1.0 - busy / wall_med) if busy else None,
                    top=[dict(kernel=k[:90], ms=t, count=c) for k, t, c in kern[:12]])
    print(f"  serving batch profile: {json.dumps(prof_row)}", flush=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _dev_us(evt) -> float:
    """Self device time (us) of a profiler average, across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())

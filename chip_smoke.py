#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (smalltts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds every kernel source in smalltts_tpu_torch/csrc/ (one nvcc each, all
   started together) and prints the build times.
2. Kernel phases: each hand-written kernel against its plain PyTorch version
   on the card, at the serving path's shapes, with the tolerance stated;
   kernel, plain and (where one exists) library-call times. A: attention,
   the served DiT shapes (T 16 and 40, cross Sc 448) among them, and the
   fp32 (3xTF32) kernel at every fp32 shape the trainers launch beside
   scaled_dot_product_attention, with ptxas's registers and spills (a
   spill fails the run); B: the DiT
   block scan's kernels, bf16 and int8-weight, at M = 320 and M = 128 rows
   (and the teacher sampler's M = 1536):
   adaln_modulate, qk_norm_rope, and the four GEMM products (qkvg with its
   bias, w13 with SwiGLU, to_out and w2 with the gated residual), and the
   12-layer scan on bf16 and on int8 stream weights; C: the three w8
   products, each shape on the kernel its
   route names (tensor cores wherever TMA can read the operands), timed on
   the device clock or the run fails. Then the GEMM and attention wrappers'
   host time per call (median of 1000).
3. Serving phases, both at full width (default BackboneConfig /
   CodecConfig, bf16, the same seeded random weights) behind the port's
   Batcher, 10 requests each: SmallTTS(pcm16_out=True), then the int8
   path SmallTTS(pcm16_out=True, w8_modulation=True, w8_stream=True). Each
   bucket shape runs as a CUDA graph, captured the first time it is used.
   The launch counters, reset just before each, must show every kernel of
   that path; the launches that the graph replays make (the counts taken
   while each graph was captured, times its replays) must be the scan's
   exact count, 384 launches a batch (4 scans x 12 layers x 8), with no
   int8 GEMM on the bf16 path and no bf16 GEMM on the int8 one; one batch
   is held against the same
   batch with the plain versions forced; synthesize_padded(fetch=False)
   must queue a batch with no synchronizing call, and one batch is profiled
   (host dispatch time, wall time, device busy time): the profiler must see
   every counted GEMM and attention launch on the port's kernels and no
   library attention kernel. The int8 batch is also held against the bf16
   batch on the same noise.
   Then phase serve pt (see `serve_pt`): the seed-0 weights saved by
   torch.save under the reference's key names and as an npz, served by
   SmallTTS(checkpoint=...) from each: params and a batch's latents equal
   bit for bit, one request from the .pt; phase serve main serves that .pt
   through the server's command line.
   Phase serve http (see `serve_http`): the bf16 model warmed over the
   serving contract (48 graphs), the port's TTSServer on a local socket
   answering 8 concurrent /synthesize requests and one chunked
   /synthesize/stream with no capture in the request path, a trust-mode
   server's 402, a replayed batch against the eager function bit for bit,
   and eager against replayed host dispatch, wall, device busy and idle
   share.
   Phase serve imf (after the int8 phase): the same weights with an
   r_gate leaf drawn from N(0, 0.1), an IMF checkpoint, served by
   SmallTTS(pcm16_out=True) with sampler="auto", which must choose IMF-2:
   the audio backend must be the native C++ library (built from
   smalltts_tpu_torch/native), the 10 requests through the Batcher with
   exactly 192 scan launches a batch (2 steps x 12 layers x 8), kernels
   against plain on one batch, replay against eager bit for bit on (8, r 64,
   p 384, t 40), the gated DMD-4 (sampler="dmd", 384 a batch) and int8
   IMF-2 (within 5e-2 rel-L2 of the bf16 latents) on the same weights, and
   IMF-2's host dispatch, wall and graph span beside the gated DMD-4's.
   After serve main, phases onnx codec and imported (see `onnx_phases`):
   the native codec exported by torch.onnx.export and run by OnnxCodec
   against the native codec, SmallTTS(codec=OnnxCodec) through its CUDA
   graph, and ImportedSmallTTS on the backbone's exported condition
   encoder and denoiser against the torch modules.
   Then phases train teacher and teacher sampler (see `train_phases`): the
   port's train_teacher at full width, 5 steps at batch 2 in fp32 with one
   save and 5 at batch 16 in bf16, and the many-step CFG sampler, 32 steps
   at batch 2 in bf16. Last, phase train distill (see `distill_phase`): the
   attention kernel at the distiller's shapes (the ASR's head dim 4, the
   discriminator's 1030 keys), one student, disc and scorer step against
   the plain versions, and train_distill at full width, 3 iterations at
   batch 2 in fp32 with a save and 3 in bf16, with the exact attention
   launches of each step.
4. Prints the card's name and power limit, one JSON line of per-kernel
   numbers, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA card or without the
package beside this script; any failed check raises.

    python3 chip_smoke.py --compare DIR

compares the package in DIR (another checkout, for example a `git archive`
of the parent commit) with this one on the card. Each turn is a worker
process of its own with the full-width bf16 model, and the turns alternate
DIR, this, this, DIR, three times. It prints the served batch's host
dispatch and wall time (synthesize_padded(fetch=False), then the waveform
to the host), the qkvg, attention and adaLN wrappers' host time per call,
and the device time per launch of the scan's kernels at both served row
counts and of the 12-layer scan (bf16 and int8 weights), each tree's
median, its turns' values and the change's minus the parent's in each
adjacent pair of turns. A turn is `python3 chip_smoke.py --worker DIR`.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

MEM_BW = 3.35e12                      # H100 SXM HBM3, bytes/s
# dense tensor-core bf16; fp32 off the tensor cores; fp32-accurate products on the tensor cores as three
# TF32 passes (495 TFLOP/s TF32): the least time for the fp32 attention kernel's work
PEAK = {"bf16": 989e12, "fp32": 67e12, "fp32_3xtf32": 495e12 / 3}
ATTN_SRC = "smalltts_tpu_torch/csrc/attention.cu"
BLOCK_SRC = "smalltts_tpu_torch/csrc/dit_block.cu"
ATTN_TPU = "smalltts_tpu/ops/pallas/attention.py:58"
# fp32 (tensor cores, 3xTF32), bf16 (tensor cores), head dim 4 (CUDA cores, either dtype)
ATTN_KERNELS = ("attn_tf32_kernel<", "attn_mma_kernel<", "attn_small_kernel<")
# no library attention may run on the serving path: profiler names of PyTorch's fused attentions
LIBRARY_ATTENTION = ("flash", "fmha", "efficient_attention", "mem_eff", "scaled_dot_product", "sdpa")
BLOCK_TPU = "smalltts_tpu/ops/pallas/block.py:216"
W8_SRC = "smalltts_tpu_torch/csrc/w8.cu"
W8_TPU = {"w8_matmul_all_layers": "smalltts_tpu/ops/pallas/w8.py:167", "w8_matmul": "smalltts_tpu/ops/pallas/w8.py:80",
          "w8_matmul_stacked": "smalltts_tpu/ops/pallas/w8.py:117"}
W8_TOL = 1e-2  # one bf16 rounding (2^-8 of a value) that fp32 sums in another order may flip
W8_TC, W8_STREAM = "w8_wgmma_kernel", "w8_stream_kernel"  # profiler names: tensor cores; CUDA cores
# wrapper_host_ms's keys of the kernels whose `kernels` entry carries a wrapper host time
WRAPPER_KEYS = {"gemm_bias": "gemm_bias qkvg M=320", "qk_norm_rope": "qk_norm_rope M=320",
                "attention": "attention dit T=40 + Sc=448"}
GEMMS = ("gemm_bias", "gemm_swiglu", "gemm_residual")
SCAN_KERNELS = ("adaln_modulate", "qk_norm_rope") + GEMMS
# profiler names of the GEMM instances: demangled, or mangled (gemm_wgmma_kernel<EPI, W8, BN>)
GEMM_NAMES = {f"{n}{sfx}": (f"gemm_wgmma_kernel<{i}, {w},", f"gemm_wgmma_kernelILi{i}ELb{int(w == 'true')}E")
              for i, n in enumerate(GEMMS) for sfx, w in (("", "false"), ("_w8", "true"))}
KERNEL_NAMES = {"adaln_modulate": ("adaln_kernel",), "qk_norm_rope": ("qk_norm_rope_kernel",), **GEMM_NAMES}
# the bf16 and int8 serve batches differ by the int8 weight rounding (~0.4%
# of each weight, per channel) carried through 48 products a step and 4
# steps: 5.0e-3 rel-L2 on an H100 at this configuration. A wiring fault (a
# wrong scale axis or layer) gives O(1); the bound is the kernels-vs-plain
# one, 5e-2, a tenth of the 10% of peak at which the JAX package holds the
# int8 stream path's waveform (tests/test_pallas.py)
W8_VS_BF16_TOL = 5e-2


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"


def bound(nbytes: float, flops: float, kind: str):
    t_bytes, t_ops = nbytes / MEM_BW, flops / PEAK[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_kind(dtype, D) -> str:
    """The peak an attention launch's bound is taken at: bf16 tensor cores;
    fp32 through the 3xTF32 kernel, or, at head dim 4, the CUDA cores."""
    if str(dtype).endswith("bfloat16"):
        return "bf16"
    return "fp32" if D == 4 else "fp32_3xtf32"


def ptxas_report(log_path: str) -> dict:
    """Registers and spill bytes of each attention kernel in an nvcc
    `-Xptxas -v` log, by the kernel's name and template arguments."""
    import re

    out, name = {}, None
    for line in open(log_path):
        m = re.search(r"Compiling entry function '\w*?(attn_\w+?_kernel)I(\w*?)EEv", line)
        if m:
            args = re.sub(r"Li(\d+)E", r",\1", m.group(2)).replace("13__nv_bfloat16", "bf16").replace("f,", "float,")
            name = f"{m.group(1)}<{args.lstrip(',')}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = dict(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


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


def time_ms(fn, iters=20, warmup=3):
    """Event-timed wall ms per call on the card."""
    import torch

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


def device_ms(fn, iters=10, match=None, launches=1):
    """Device time per call from torch.profiler over iters + 1 calls, each
    of which launches `launches` kernels whose names hold one of `match`:
    their mean time per launch times `launches` (a trace may drop a
    record; one with fewer than iters * launches of them is taken again,
    3 tries); every kernel's time over the calls when `match` is None.
    None when the profiler reports no device time, or lost records each
    try."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters + 1):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if _dev_us(e) > 0]
        if not evts:
            return None  # the profiler sees no device time at all
        if match is None:
            return sum(_dev_us(e) for e in evts) / 1e3 / (iters + 1)
        hits = [e for e in evts if any(m in e.key for m in match)]
        check(bool(hits), f"no profiled kernel matches {match}")
        seen = sum(e.count for e in hits)
        if seen >= iters * launches:
            return sum(_dev_us(e) for e in hits) / 1e3 / seen * launches
        print(f"  (profiler trace holds {seen} of at least {iters * launches} launches: taken again)", flush=True)
    return None


def timed(fn, iters, match=None, per=1):
    """(ms, wall ms, clock) per launch, `per` launches a call: ms is
    profiler device time, or the event-timed wall time (clock "wall")
    where the profiler saw none or lost records."""
    wall = time_ms(fn, iters=iters) / per
    dev_t = device_ms(fn, iters=iters, match=match, launches=per)
    return (wall, wall, "wall") if dev_t is None else (dev_t / per, wall, "device")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    # --worker DIR: one side of --compare, the package in DIR
    other = _arg("--worker")
    sys.path.insert(0, os.path.abspath(other) if other else os.path.dirname(os.path.abspath(__file__)))
    try:
        import smalltts_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the smalltts_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    if other:
        return worker(torch)
    if "--compare" in sys.argv:
        return compare(_arg("--compare"))

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
    # the served shapes (ref bucket 64 + phoneme bucket 384 -> Sc = 448; latent buckets 16 and 40;
    # the style encoder at the served ref bucket) beside the earlier ones
    for label, B, H, T, S2, D in (("style R=256", 8, 8, 256, 0, 64), ("text P=384", 8, 4, 384, 0, 128),
                                  ("dit T=40 + cross Sc=192, gated", 8, 8, 40, 192, 120),
                                  ("dit T=40 + cross Sc=448, gated (served)", 8, 8, 40, 448, 120),
                                  ("dit T=16 + cross Sc=448, gated (served)", 8, 8, 16, 448, 120),
                                  ("style R=64 (served)", 8, 8, 64, 0, 64)):
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
            b_ms, b_by = bound(nbytes(q, k, v, m, *two.values(), got), 4.0 * B * H * T * S * D, attn_kind(dtype, D))
            row = dict(shape=f"{label} B={B} H={H} D={D}", dtype=str(dtype).split(".")[-1],
                       max_abs_err=abs_e, rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            shapes.append(row)
            print("  " + json.dumps(row), flush=True)
    # the fp32 (3xTF32) kernel at every fp32 shape the trainers launch: the teacher step's (batch 2;
    # the DiT's self keys 256 and its ref + text 262, one source of 518), the distiller's backbone at the
    # teacher's CFG batch of 6, and its discriminator's 1030 keys at batch 4 and 2; key counts that are
    # no multiple of the 32-key tile, a fully-masked row in each (key_mask). Bound: operations at 165
    # TFLOP/s (three TF32 passes at 495) or bytes, whichever is longer
    print("  fp32 training shapes: the 3xTF32 kernel vs plain (1e-5), scaled_dot_product_attention beside it")
    train_rows = []
    for label, B, H, T, S, D in (("teacher dit T=256 + 64 + 198", 2, 8, 256, 518, 120),
                                 ("teacher text P=198", 2, 4, 198, 198, 128), ("teacher style R=64", 2, 8, 64, 64, 64),
                                 ("distill dit B6", 6, 8, 256, 518, 120), ("distill text B6", 6, 4, 198, 198, 128),
                                 ("distill style B6", 6, 8, 64, 64, 64), ("disc S=1030 B4", 4, 8, 1030, 1030, 64),
                                 ("disc S=1030 B2", 2, 8, 1030, 1030, 64)):
        q, k, v = randn((B, H, T, D), torch.float32), randn((B, H, S, D), torch.float32), randn((B, H, S, D), torch.float32)
        m = key_mask(B, S)
        got = A.fused_attention(q, k, v, m)
        want = A.attention_plain(q, k, v, m)
        abs_e, rel_e = err(got, want)
        check(rel_e <= tol[torch.float32], f"attention {label} fp32: rel err {rel_e:.3e}")
        ms, wall, clock = timed(lambda: A.fused_attention(q, k, v, m), 20, ATTN_KERNELS)
        check(clock == "device", f"attention {label} fp32: no device-clock time")
        plain_ms = timed(lambda: A.attention_plain(q, k, v, m), 10)[0]
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None, None, :]),
                       20)[0]
        b_ms, b_by = bound(nbytes(q, k, v, m, got), 4.0 * B * H * T * S * D, attn_kind(torch.float32, D))
        row = dict(shape=f"{label} B={B} H={H} Tq={T} S={S} D={D}", dtype="float32", max_abs_err=abs_e,
                   rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, library_over_kernel=lib_ms / ms)
        train_rows.append(row)
        print("  " + json.dumps(row), flush=True)
    ptxas = ptxas_report(os.path.join(kernels.BUILD_DIR, "attention.log"))
    print(f"  ptxas (attention.cu): {json.dumps(ptxas)}", flush=True)
    tf32 = {n: r for n, r in ptxas.items() if n.startswith("attn_tf32_kernel")}
    check(len(tf32) == 3 and not any(r["spill_stores"] or r["spill_loads"] for r in tf32.values()),
          f"the 3xTF32 kernels spill, or are missing from the build log: {tf32}")
    # the served DiT form in bf16 (T 40, Sc 448): 48 of a batch's 68 launches
    head = next(r for r in shapes if r["shape"].startswith("dit T=40 + cross Sc=448") and r["dtype"] == "bfloat16")
    fp32 = train_rows[0]  # the teacher's DiT shape: 12 launches a teacher step, 252 a distillation iteration
    entries.append(dict(name="attention", route="cuda", source=ATTN_SRC, replaces=ATTN_TPU,
                        **{k: head[k] for k in ("max_abs_err", "ms", "wall_ms", "clock", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}, shape=head["shape"], shapes=shapes,
                        fp32_kernel=dict(kernel="attn_tf32_kernel", **{k: fp32[k] for k in (
                            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
                        fp32_train_shapes=train_rows, ptxas=ptxas))

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

    # each launch of a layer, timed over the 12 layers' weights (88+ MB: out of L2, as in the scan),
    # at the two served row counts, M = 320 (latent bucket 40) and M = 128 (bucket 16), and at the
    # teacher sampler's M = 1536 (its 3x CFG batch of 6 rows x t 256; here 8 rows x 192)
    def acts(Tm):
        m_ = key_mask(B, Tm)
        m_[-1, :3] = True
        return dict(h=randn((B, Tm, H)), mid=randn((B, Tm, F)), x=randn((B, Tm, H), scale=2.0), mask=m_,
                    rope=rope_cos_sin(cfg, Tm, dev))

    act_rows = {T: acts(T), 16: acts(16), 192: acts(192)}
    qs, ks = attn["q_norm"]["scale"], attn["k_norm"]["scale"]

    def gemm_rows(at, fw, sfx):
        """kernel name -> [(shape, kernel, plain, library, cost)] for the layer's four products at the
        three row counts; a leaf holds bf16 `w` or int8 `w_q` + `scale`. The library call is torch.addmm (mm
        for to_out, which has no bias) on the product alone, with the bf16 weights."""
        def weight(lin, l):
            return (lin["w_q"][l], lin["scale"][l]) if "w_q" in lin else (lin["w"][l], None)

        def leaf_bytes(lin, l):
            return nbytes(*(lin[k][l] for k in ("w", "w_q", "scale", "b") if k in lin))

        def at_rows(act):
            h_, mid_, x_, m_ = act["h"], act["mid"], act["x"], act["mask"]
            M_ = h_.shape[0] * h_.shape[1]
            qk, out_, w13, w2 = at["qkvg"], at["to_out"], fw["w13"], fw["w2"]

            def bias(fn):
                def run(l):
                    w, s = weight(qk, l)
                    return fn(h_, w, qk["b"][l], w_scale=s)
                return run

            def swiglu(fn):
                def run(l):
                    w, s = weight(w13, l)
                    return fn(h_, w, w13["b"][l], w_scale=s)
                return run

            def resid(fn, lin, a, gate_at, masked):
                def run(l):
                    w, s = weight(lin, l)
                    return fn(a, w, lin["b"][l] if "b" in lin else None, x_.clone(), mods[l][:, gate_at:gate_at + H],
                              m_ if masked else None, w_scale=s)
                return run

            return {
                "gemm_bias": [(f"qkvg M={M_} K={H} N={4 * H}", bias(K.gemm_bias), bias(K.gemm_bias_plain),
                               lambda l: torch.addmm(attn["qkvg"]["b"][l], h_.view(M_, H), attn["qkvg"]["w"][l]),
                               lambda l: (nbytes(h_) + leaf_bytes(qk, l) + M_ * 4 * H * 2, 2.0 * M_ * H * 4 * H))],
                "gemm_swiglu": [(f"w13 M={M_} K={H} N={2 * F} (out {F})", swiglu(K.gemm_swiglu),
                                 swiglu(K.gemm_swiglu_plain),
                                 lambda l: torch.addmm(ff["w13"]["b"][l], h_.view(M_, H), ff["w13"]["w"][l]),
                                 lambda l: (nbytes(h_) + leaf_bytes(w13, l) + M_ * F * 2, 2.0 * M_ * H * 2 * F))],
                "gemm_residual": [
                    (f"w2 M={M_} K={F} N={H}", resid(K.gemm_residual, w2, mid_, 5 * H, False),
                     resid(K.gemm_residual_plain, w2, mid_, 5 * H, False),
                     lambda l: torch.addmm(ff["w2"]["b"][l], mid_.view(M_, F), ff["w2"]["w"][l]),
                     lambda l: (nbytes(mid_, mods[l][:, 5 * H:]) + leaf_bytes(w2, l) + 2 * M_ * H * 2,
                                2.0 * M_ * F * H)),
                    (f"to_out M={M_} K={H} N={H}, row-masked",
                     resid(K.gemm_residual, out_, h_, 2 * H, True), resid(K.gemm_residual_plain, out_, h_, 2 * H, True),
                     lambda l: torch.mm(h_.view(M_, H), attn["to_out"]["w"][l]),
                     lambda l: (nbytes(h_, mods[l][:, 2 * H:3 * H], m_) + leaf_bytes(out_, l) + 2 * M_ * H * 2,
                                2.0 * M_ * H * H))],
            }

        rows = {}
        for act in act_rows.values():
            for name, rs in at_rows(act).items():
                rows.setdefault(name + sfx, []).extend(rs)
        return rows

    def adaln_rows():
        """adaln_modulate at the three row counts, each layer's shift/scale_msa (a modulation shared by the
        batch, stride 0, as the sampler hoists it)."""
        rows = []
        for act in act_rows.values():
            x_ = act["x"]
            run = lambda fn, x_=x_: (lambda l: fn(x_, mods[l][:, :H], mods[l][:, H:2 * H]))  # noqa: E731
            rows.append((f"M={x_.shape[0] * x_.shape[1]} H={H}", run(K.adaln_modulate), run(K.adaln_modulate_plain),
                         None, lambda l, x_=x_: (2 * nbytes(x_) + nbytes(mods[l][:, :2 * H]), 0.0)))
        return rows

    def qk_rows():
        """qk_norm_rope at the three row counts, in place on a qkvg buffer (the kernel and the plain
        version each on its own copy), each layer's q/k norm scales."""
        rows = []
        for act in act_rows.values():
            q0 = randn((*act["h"].shape[:2], 4 * H))
            cos_, sin_ = act["rope"]
            run = lambda fn, buf, c=cos_, s_=sin_: (lambda l: fn(buf, qs[l], ks[l], c, s_))  # noqa: E731
            rows.append((f"M={q0.shape[0] * q0.shape[1]} heads={heads} D={hd} rot={cos_.shape[1]}",
                         run(K.qk_norm_rope, q0.clone()), run(K.qk_norm_rope_plain, q0.clone()), None,
                         lambda l, q0=q0, c=cos_, s_=sin_: (2 * 2 * q0.shape[0] * q0.shape[1] * H * 2
                                                            + nbytes(qs[l], ks[l], c, s_), 0.0)))
        return rows

    per_layer = {"adaln_modulate": adaln_rows(), "qk_norm_rope": qk_rows(), **gemm_rows(attn, ff, "")}

    def over_layers(fn):
        def run():
            for l in range(L):
                fn(l)
        return run

    def layer_entry(name, rows, **extra):
        """Each shape of kernel `name` against its plain version (2e-2), then timed over the 12
        layers; the entry carries the first shape's numbers and every shape's row."""
        shape_rows = []
        for label, kfn, pfn, lfn, cost in rows:
            got_k, want_k = kfn(0), pfn(0)
            abs_e, rel_e = err(got_k, want_k)
            check(rel_e <= 2e-2, f"{name} {label}: rel err {rel_e:.3e}")
            ms, wall, clock = timed(over_layers(kfn), 5, KERNEL_NAMES[name], per=L)
            pms = timed(over_layers(pfn), 5, per=L)[0]
            lms = timed(over_layers(lfn), 5, per=L)[0] if lfn else None
            b_ms, b_by = bound(*cost(0), "bf16")
            row = dict(shape=label, max_abs_err=abs_e, rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock, plain_ms=pms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lms)
            print(f"  {name}: {json.dumps(row)}", flush=True)
            shape_rows.append(row)
        e = dict(name=name, route="cuda", source=BLOCK_SRC, replaces=BLOCK_TPU, **shape_rows[0], **extra)
        if len(shape_rows) > 1:
            e["shapes"] = shape_rows
        entries.append(e)

    for name, rows in per_layer.items():
        layer_entry(name, rows, **({"library_of": "torch.addmm (torch.mm for to_out), product only"}
                                   if name in GEMMS else {}))
    entries.append(scan_entry)

    # int8 stream weights (w8_stream): the four products' weights int8, as
    # quantize_stream_weights stores them in bf16 arithmetic, (L, 1, N) scales
    from smalltts_tpu_torch.models.dit import quantize_stream_weights

    qb = quantize_stream_weights({"blocks": blocks})["blocks"]
    print("phase B, int8 stream weights: each GEMM epilogue vs plain over the 12 layers (tolerance 2e-2); "
          "library = torch.addmm on the bf16 weights, the float path's product")
    for name, rows in gemm_rows(qb["attn"], qb["ff"], "_w8").items():
        layer_entry(name, rows, library_of="torch.addmm (torch.mm for to_out), product only, bf16 weights")
    scan8 = lambda: K.fused_dit_scan(x, mods, mask, ck, cv, cmask, qb, cos, sin, heads=heads, head_dim=hd)  # noqa: E731
    got = scan8()
    with kernels.force_plain():
        want = scan8()
        plain_ms = timed(scan8, 5)[0]
    rel_l2 = float((got.float() - want.float()).norm() / want.float().norm())
    print(f"  12-layer scan on int8 stream weights: rel-L2 {rel_l2:.3e} (tolerance 2e-2)", flush=True)
    check(rel_l2 <= 2e-2 and bool(torch.isfinite(got).all()), f"int8 fused_dit_scan rel-L2 {rel_l2:.3e}")
    abs_e, _ = err(got, want)
    ms, wall, clock = timed(scan8, 10)
    qa, qf = qb["attn"], qb["ff"]
    wbytes = nbytes(*(lin[k] for lin in (qa["qkvg"], qa["to_out"], qf["w13"], qf["w2"])
                      for k in ("w_q", "scale", "b") if k in lin), attn["q_norm"]["scale"], attn["k_norm"]["scale"])
    b_ms, b_by = bound(wbytes + nbytes(x, mods, mask, ck, cv, cmask, cos, sin, got), flops, "bf16")
    print(f"  int8 scan: {ms:.4f} ms on the device ({wall:.4f} ms wall), {plain_ms:.4f} ms plain, "
          f"bound {b_ms:.4f} ms ({b_by}); int8 stream bytes {wbytes / 1e6:.1f} MB")
    entries.append(dict(name="fused_dit_scan_w8", route="cuda", source=BLOCK_SRC, replaces=BLOCK_TPU,
                        max_abs_err=abs_e, rel_l2=rel_l2, ms=ms, wall_ms=wall, clock=clock, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        shape=f"B={B} T={T} Sc={Sc} L={L} H={H}, int8 qkvg/to_out/w13/w2"))
    del blocks, qb, p, ck, cv
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- kernel C
    from smalltts_tpu_torch.ops.kernels import w8 as W8

    print(f"phase C: w8 kernels vs plain, bf16 x, int8 weights (tolerance: max|diff|/max|plain| <= {W8_TOL}); "
          "library = torch.bmm / torch.mm with an fp32 result on the same weights in bf16, the product the "
          "float path computes (nn.matmul_f32)")

    def w8_stack(n, K_, N_):
        """n int8 (K_, N_) weights with their scales, and the same weights in bf16."""
        w = randn((n, K_, N_), torch.float32, 0.02)
        wq, sc = W8.quantize_w8(w)
        return wq, sc, w.to(torch.bfloat16)

    def w8_row(label, n, kfn, pfn, lfn, nbytes_, flops_, per, kernel=W8_TC):
        """Check the first launch against plain, then time launches over the n
        weights: device time of `kernel`, the one this shape's route must
        launch (a run that launches another finds no match and fails, and so
        does one the profiler cannot time)."""
        over = lambda fn: (lambda: [fn(i) for i in range(n)])  # noqa: E731
        got_k, want_k = kfn(0), pfn(0)
        abs_e, rel_e = err(got_k, want_k)
        check(rel_e <= W8_TOL, f"w8 {label}: rel err {rel_e:.3e}")
        ms, wall, clock = timed(over(kfn), 5, (kernel,), per=per)
        check(clock == "device", f"w8 {label}: the profiler gave no device time for {kernel}")
        pms = timed(over(pfn), 5, per=per)[0]
        lms = timed(over(lfn), 5, per=per)[0]
        b_ms, b_by = bound(nbytes_, flops_, "bf16")
        row = dict(shape=label, kernel=kernel, max_abs_err=abs_e, rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock,
                   plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lms)
        print("  " + json.dumps(row), flush=True)
        return row

    def w8_entry(name, rows, head, **extra):
        entries.append(dict(name=name, route="cuda", source=W8_SRC, replaces=W8_TPU[name],
                            **{k: rows[head][k] for k in ("max_abs_err", "ms", "wall_ms", "clock", "plain_ms",
                                                          "bound_ms", "bound_by", "library_ms")},
                            shape=rows[head]["shape"], shapes=rows, **extra))

    # the main path's shape: the 4 steps' time embeddings x every layer's modulation weights (66 MB int8)
    M4, Lm = 4, cfg.n_blocks
    x4 = randn((M4, H))
    wq, sc, wbf = w8_stack(Lm, H, 6 * H)
    x4e = x4.expand(Lm, M4, H).contiguous()
    row = w8_row(f"M={M4} K={H} N={6 * H} L={Lm}", 1, lambda i: W8.w8_matmul_all_layers(x4, wq, sc),
                 lambda i: W8.w8_matmul_ref(x4, wq, sc), lambda i: torch.bmm(x4e, wbf, out_dtype=torch.float32),
                 nbytes(x4, wq, sc) + Lm * M4 * 6 * H * 2, 2.0 * Lm * M4 * H * 6 * H, 1)
    w8_entry("w8_matmul_all_layers", [row], 0, library_of="torch.bmm, bf16 weights, fp32 result",
             on_main_path=True)
    del wq, sc, wbf

    # the JAX package's test shapes, then a row count just above the 8-row tile and one that is no
    # multiple of the 64-row tile, each over enough weights (>= 128 MB of int8) to stream from HBM;
    # last a view that TMA cannot read (N a multiple of 8 only), which the streaming kernel takes
    rows = []
    for M_, K_, N_ in ((320, 960, 2880), (40, 2400, 960), (8, 960, 5760),
                       (16, 960, 5760), (200, 960, 2880), (5, 96, 136)):
        n = -(-128_000_000 // (K_ * N_)) if N_ % 16 == 0 else 12
        xm = randn((M_, K_))
        wq, sc, wbf = w8_stack(n, K_, N_)
        rows.append(w8_row(f"M={M_} K={K_} N={N_} (over {n} weights)", n,
                           lambda i: W8.w8_matmul(xm, wq[i], sc[i]), lambda i: W8.w8_matmul_ref(xm, wq[i], sc[i]),
                           lambda i: torch.mm(xm, wbf[i], out_dtype=torch.float32),
                           nbytes(xm, wq[0], sc[0]) + M_ * N_ * 2, 2.0 * M_ * K_ * N_, n,
                           kernel=W8_TC if N_ % 16 == 0 else W8_STREAM))
        del wq, sc, wbf
    w8_entry("w8_matmul", rows, 0, library_of="torch.mm, bf16 weights, fp32 result", on_main_path=False)

    # the stacked form: the index is a device int32 that the kernel reads; every layer of a 12-layer
    # stack, at the few-rows and at a many-rows M
    Ns = 4 * H
    wq, sc, wbf = w8_stack(Lm, H, Ns)
    idx = [torch.full((1,), i, dtype=torch.int32, device=dev) for i in range(Lm)]
    rows = []
    for Ms in (8, 320):
        xs = randn((Ms, H))
        for i in (0, 5, 11):
            e_abs, e_rel = err(W8.w8_matmul_stacked(xs, wq, sc, idx[i]), W8.w8_matmul_ref(xs, wq[i], sc[i]))
            check(e_rel <= W8_TOL, f"w8_matmul_stacked M {Ms} idx {i}: rel err {e_rel:.3e}")
            print(f"  w8_matmul_stacked M={Ms}, device index {i}: rel err {e_rel:.3e}")
        rows.append(w8_row(f"M={Ms} K={H} N={Ns}, index in a device int32, over the {Lm} layers", Lm,
                           lambda i: W8.w8_matmul_stacked(xs, wq, sc, idx[i]),
                           lambda i: W8.w8_matmul_ref(xs, wq[i], sc[i]),
                           lambda i: torch.mm(xs, wbf[i], out_dtype=torch.float32),
                           nbytes(xs, wq[0], sc[0], idx[0]) + Ms * Ns * 2, 2.0 * Ms * H * Ns, Lm))
    w8_entry("w8_matmul_stacked", rows, 0, library_of="torch.mm, bf16 weights, fp32 result", on_main_path=False)
    del wq, sc, wbf
    torch.cuda.empty_cache()

    host_ms = wrapper_host_ms(torch, dev)
    print(f"wrapper host time per call, median of 1000 (ms): {json.dumps(host_ms)}", flush=True)
    for e in entries:
        if e["name"] in ("attention", "gemm_bias", "qk_norm_rope"):
            e["wrapper_host_ms"] = host_ms[WRAPPER_KEYS[e["name"]]]

    # --------------------------------------------------------- serving phases
    import numpy as np

    from smalltts_tpu_torch.data.bucketing import HOP_SIZE, frames_for_duration
    from smalltts_tpu_torch.infer.sampler import sample_latents
    from smalltts_tpu_torch.serving.batcher import Batcher, pad_group, Request

    durations, waves, ids = serve_requests()

    def build(label, **opts):
        """SmallTTS at full width on the same seeded weights for every phase."""
        print(f"phase serve {label}: SmallTTS(pcm16_out=True{''.join(f', {k}=True' for k in opts)}), "
              "default BackboneConfig/CodecConfig, bf16, seed 0")
        t_init = time.perf_counter()
        tts = full_width_tts(torch, dev, **opts)
        n_params = sum(t.numel() for t in _leaves(tts.params))
        print(f"  built in {time.perf_counter() - t_init:.2f} s: {n_params / 1e6:.1f}M backbone params "
              f"({tts.dtype}), codec fp32, {tts.num_steps} steps", flush=True)
        return tts

    def serve(tts):
        """10 requests through the Batcher, the launch counters reset just
        before; returns (launches, batches, references)."""
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
        replays0 = {k: g.replays for k, g in tts._graphs.items()}
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
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        replayed, n_replays = graph_launches(tts, replays0)
        check(n_replays == len(batches), f"{n_replays} graph replays for {len(batches)} batches")
        for out, d in zip(outs, durations):
            n = frames_for_duration(d) * HOP_SIZE
            check(out.dtype == np.int16 and out.shape == (1, n), f"result {out.dtype} {out.shape}, want int16 (1, {n})")
            check(int(np.abs(out).max()) > 0, "an all-zero waveform")
        print(f"  {len(outs)} requests answered in {serve_s:.3f} s (reference encode included)")
        print(f"  per-request latency ms (submit -> result): {json.dumps([round(v, 3) for v in lat_ms])}")
        print(f"  batches: {json.dumps(batches)}")
        print(f"  launches during the serving phase: {json.dumps(launches)} (each new bucket's eager run before "
              f"its capture included); made by the {n_replays} graph replays, from the counts taken at capture: "
              f"{json.dumps(replayed)}; {tts.compile_cache_size()} graphs", flush=True)
        return launches, replayed, batches, refs

    def scan_launches(launches, gemms):
        """The scan is a host loop that launches nothing itself: the launches
        of its per-layer kernels, and the one attention launch each layer
        makes (one per qk_norm_rope launch; the attention counter also holds
        the encoders' launches)."""
        names = ("adaln_modulate", "qk_norm_rope") + gemms
        total = sum(launches.get(n, 0) for n in names) + launches.get("qk_norm_rope", 0)
        return total, list(names) + ["attention (one per qk_norm_rope launch)"]

    def check_scan_counts(launches, n_b, tts, sfx):
        """The exact launch counts of n_b batches, as their graph replays
        make them (the counts taken at capture, times the replays): 4 scans
        a batch of 12 layers, each two adaLNs, qkvg, the q/k norm, w13 and
        two residuals (+ one attention): 384 a batch; none of the other
        weight type's GEMMs."""
        per = n_b * tts.num_steps * tts.cfg.dit.n_blocks
        other = "_w8" if not sfx else ""
        want = {"adaln_modulate": 2 * per, "qk_norm_rope": per, f"gemm_bias{sfx}": per, f"gemm_swiglu{sfx}": per,
                f"gemm_residual{sfx}": 2 * per, **{n + other: 0 for n in GEMMS}}
        got = {k: launches.get(k, 0) for k in want}
        check(got == want, f"scan launch counts {json.dumps(got)}, want {json.dumps(want)}")
        total = scan_launches(launches, tuple(n + sfx for n in GEMMS))[0]
        check(total == 8 * per, f"scan launches {total} for {n_b} batches")
        print(f"  scan launch counts as expected for {n_b} batches: {total} ({total // n_b} a batch), "
              f"{json.dumps(want)}", flush=True)

    def batch_checks(tts, group_args, noises):
        """One batch with the kernels vs the same batch with the plain
        versions forced; the no-sync check of fetch=False; one batch
        profiled, in which the profiler must show every counted GEMM and
        attention launch on the port's kernels and no library attention.
        Returns the latents with the kernels."""
        ref, ref_lens, ph, ph_lens, seq_lens, t_bucket = group_args
        tt = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
        args = (tts.params, tts.cfg, tt(ref, tts.dtype), tt(ref_lens, torch.int32), tt(ph, torch.int64),
                tt(ph_lens, torch.int32), tt(seq_lens, torch.int32))
        with torch.inference_mode():
            lat_k = sample_latents(*args, num_steps=tts.num_steps, noises=noises, sampler=tts.sampler)
            with kernels.force_plain():
                lat_p = sample_latents(*args, num_steps=tts.num_steps, noises=noises, sampler=tts.sampler)
        lat_rel = float((lat_k.float() - lat_p.float()).norm() / lat_p.float().norm())
        print(f"  batch of 8 (t_bucket {t_bucket}) kernels vs plain: latents rel-L2 {lat_rel:.3e} (tolerance 5e-2)")
        check(bool(torch.isfinite(lat_k).all()) and lat_rel <= 5e-2, f"serving latents rel-L2 {lat_rel:.3e}")

        # where one batch's time goes: wall clock unprofiled, device busy from the profiler
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
        dispatch, walls = batch_host_ms(one_batch, 5)
        kernels.reset_launches()
        busy, kern = profile_batch(one_batch)
        counted = {k: v for k, v in kernels.LAUNCHES.items() if v}
        ours = sum(r[1] for r in kern if any(n in r[0] for n in PORT_KERNELS))

        def seen(match):  # launches the profiler saw of kernels whose names hold one of `match`
            return sum(c for k, _, c in kern if any(m in k for m in match))

        lib_att = sorted({k[:80] for k, _, _ in kern if any(n in k.lower() for n in LIBRARY_ATTENTION)})
        check(not lib_att, f"library attention kernels ran in the served batch: {lib_att}")
        check(seen(ATTN_KERNELS[1:]) == counted.get("attention", 0) > 0,
              f"bf16 attention kernels seen {seen(ATTN_KERNELS[1:])}, counted {counted.get('attention', 0)}")
        for n, match in {**KERNEL_NAMES, "w8_matmul_all_layers": (W8_TC,)}.items():
            check(seen(match) == counted.get(n, 0), f"{n}: the profiler saw {seen(match)}, the counter {counted.get(n, 0)}")
        print(f"  profiled batch: every counted launch seen on the port's kernels ({json.dumps(counted)}), "
              "no library attention kernel", flush=True)
        wall_med = sorted(walls)[len(walls) // 2]
        prof_row = dict(batch=8, t_bucket=t_bucket, ref_bucket=ref.shape[1], phoneme_bucket=ph.shape[1],
                        wall_ms=walls, dispatch_ms=dispatch, device_busy_ms=busy, hand_written_kernels_ms=ours,
                        idle_share=(1.0 - busy / wall_med) if busy else None,
                        top=[dict(kernel=k[:90], ms=t, count=c) for k, t, c in kern[:12]])
        print(f"  serving batch profile: {json.dumps(prof_row)}", flush=True)
        return lat_k

    # bf16 serving: every kernel of this path launched
    tts = build("bf16")
    launches, replayed, batches, refs = serve(tts)
    check(not any(launches.get(n) for n in W8_TPU), "an int8 kernel ran on the bf16 path")
    check_scan_counts(replayed, len(batches), tts, "")
    unserved = {n: launches.get(n, 0) for n in ("w8_matmul", "w8_matmul_stacked")}  # no serving path calls them
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["launches"], e["launches_of"] = scan_launches(launches, GEMMS)
        elif e["name"] in ("attention",) + SCAN_KERNELS:
            e["launches"] = launches.get(e["name"], 0)
        else:
            continue
        check(e["launches"] > 0, f"kernel {e['name']} was not launched by the serving path")
    group = [Request(r, tok, d) for r, tok, d in zip(refs[:8], ids[:8], durations[:8])]
    group_args = pad_group(group, 8)[:6]
    noises = torch.randn((tts.num_steps, 8, group_args[5], 64), generator=g, device=dev).to(tts.dtype)
    lat_bf16 = batch_checks(tts, group_args, noises)
    del tts
    torch.cuda.empty_cache()

    # int8 serving: the w8 product once per batch, the int8 GEMM for every
    # product of the scan, and no bf16 GEMM
    tts = build("w8", w8_modulation=True, w8_stream=True)
    launches, replayed, batches, _ = serve(tts)
    check(replayed.get("w8_matmul_all_layers", 0) == len(batches),
          f"w8_matmul_all_layers replayed {replayed.get('w8_matmul_all_layers', 0)} times for {len(batches)} batches")
    check_scan_counts(replayed, len(batches), tts, "_w8")
    for e in entries:
        if e["name"] == "fused_dit_scan_w8":
            e["launches"], e["launches_of"] = scan_launches(launches, tuple(n + "_w8" for n in GEMMS))
        elif e["name"] in ("w8_matmul_all_layers",) + tuple(n + "_w8" for n in GEMMS):
            e["launches"] = launches.get(e["name"], 0)
        elif e["name"] in unserved:
            # no serving path calls them (phase C holds them): the counts of both serve phases, 0
            e["launches"], e["launches_bf16_serve"] = launches.get(e["name"], 0), unserved[e["name"]]
            check(e["launches"] == 0 and e["launches_bf16_serve"] == 0,
                  f"{e['name']} was launched by a serving path")
            continue
        else:
            if e["name"] in ("attention",) + SCAN_KERNELS:
                e["launches_w8_serve"] = launches.get(e["name"], 0)
            continue
        check(e["launches"] > 0, f"kernel {e['name']} was not launched by the int8 serving path")
    lat_w8 = batch_checks(tts, group_args, noises)
    w8_rel = float((lat_w8.float() - lat_bf16.float()).norm() / lat_bf16.float().norm())
    print(f"  int8 vs bf16 batch, same inputs and noise: latents rel-L2 {w8_rel:.3e} "
          f"(must be > 0 and <= {W8_VS_BF16_TOL}: the int8 weight rounding)", flush=True)
    check(0.0 < w8_rel <= W8_VS_BF16_TOL, f"int8 vs bf16 latents rel-L2 {w8_rel:.3e}")
    del tts
    torch.cuda.empty_cache()

    # an IMF checkpoint: IMF-2 ("auto"), the gated DMD-4 and int8 IMF-2 on the same weights
    t_phase = time.perf_counter()
    from smalltts_tpu_torch import native
    from smalltts_tpu_torch.serving import audio_io

    check(audio_io.backend() is native, "audio_io.backend() is the numpy module: the native audio library did not build")
    print("phase serve imf: SmallTTS(pcm16_out=True) on the seed-0 weights plus an r_gate drawn from N(0, 0.1), "
          f"default BackboneConfig/CodecConfig, bf16; audio backend {audio_io.backend().__name__}")
    tts = full_width_tts(torch, dev, r_gate=True)
    check((tts.sampler, tts.num_steps) == ("imf", 2), f"auto chose {tts.sampler}-{tts.num_steps}, want imf-2")
    print(f"  sampler='auto' on a checkpoint with r_gate: {tts.sampler}, {tts.num_steps} steps", flush=True)
    launches, replayed, batches, _ = serve(tts)
    check_scan_counts(replayed, len(batches), tts, "")
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["launches_imf_serve"] = scan_launches(launches, GEMMS)[0]
        elif e["name"] in ("attention",) + SCAN_KERNELS:
            e["launches_imf_serve"] = launches.get(e["name"], 0)
    imf_noise = torch.randn((1, 8, group_args[5], 64), generator=g, device=dev).to(tts.dtype)
    lat_imf = batch_checks(tts, group_args, imf_noise)
    big = padded_batch(tts)
    n_big = torch.randn((1,) + big[0].shape[:1] + (big[5], 64), generator=g, device=dev).to(tts.dtype)
    got, want = tts.synthesize_padded(*big, fetch=False, noises=n_big), eager_batch(tts, big, n_big)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    print(f"  IMF-2 replay vs eager, batch (8, r 64, p 384, t 40), same noise: {n_diff} of {got.numel()} int16 "
          "samples differ", flush=True)
    check(n_diff == 0 and int(want.abs().max()) > 0, f"IMF replay differs from eager on {n_diff} samples")
    rows = {"imf-2": graph_timing(torch, tts, big)}
    del tts
    dmd = full_width_tts(torch, dev, r_gate=True, sampler="dmd")
    check((dmd.sampler, dmd.num_steps) == ("dmd", 4), f"sampler='dmd' gave {dmd.sampler}-{dmd.num_steps}")
    rows["dmd-4 gated"] = graph_timing(torch, dmd, big)
    check_scan_counts(dmd._graphs[bucket_key(big)].launches, 1, dmd, "")  # the counts of one replay
    del dmd
    w8 = full_width_tts(torch, dev, r_gate=True, w8_modulation=True, w8_stream=True)
    tt = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    with torch.inference_mode():
        lat_w8 = sample_latents(w8.params, w8.cfg, tt(group_args[0], w8.dtype), tt(group_args[1], torch.int32),
                                tt(group_args[2], torch.int64), tt(group_args[3], torch.int32),
                                tt(group_args[4], torch.int32), num_steps=2, noises=imf_noise, sampler="imf")
    w8_rel = float((lat_w8.float() - lat_imf.float()).norm() / lat_imf.float().norm())
    print(f"  int8 IMF-2 vs bf16 IMF-2 batch, same inputs and noise: latents rel-L2 {w8_rel:.3e} "
          f"(must be > 0 and <= {W8_VS_BF16_TOL})", flush=True)
    check(0.0 < w8_rel <= W8_VS_BF16_TOL, f"int8 vs bf16 IMF latents rel-L2 {w8_rel:.3e}")
    out = w8.synthesize_padded(*group_args)
    w8_launches = w8._graphs[bucket_key(group_args)].launches
    check(out.dtype == np.int16 and int(np.abs(out).max()) > 0, "int8 IMF batch: an all-zero waveform")
    check(w8_launches.get("w8_matmul_all_layers", 0) == 1, f"int8 IMF graph: {json.dumps(w8_launches)}")
    check_scan_counts(w8_launches, 1, w8, "_w8")
    del w8
    torch.cuda.empty_cache()
    print(f"  batch (8, 64, 384, 40), IMF-2 beside the gated DMD-4 on the same weights: {json.dumps(rows)}")
    print(f"  phase serve imf: {time.perf_counter() - t_phase:.2f} s", flush=True)
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["serve_imf"] = dict(batch=[8, 64, 384, 40], int8_vs_bf16_rel_l2=w8_rel,
                                  **{k: {m: v[m] for m in ("dispatch_ms_median", "wall_ms_median", "graph_span_ms")}
                                     for k, v in rows.items()})

    # the port's HTTP server on the bf16 path, its contract warmed first; then a reference torch
    # checkpoint served, and the server's command line on it
    serve_http(torch, dev, entries)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="smoke_pt_")
    try:
        pt = serve_pt(torch, dev, entries, tmp)
        torch.cuda.empty_cache()
        serve_main(entries, checkpoint=pt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    onnx_phases(torch, dev, entries)
    torch.cuda.empty_cache()
    train_phases(torch, dev, entries)
    torch.cuda.empty_cache()
    distill_phase(torch, dev, entries)

    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def serve_http(torch, dev, entries):
    """Phase serve http: the full-width bf16 SmallTTS (seed-0 weights, as
    the bf16 phase) warmed over the serving contract, one CUDA graph per
    bucket, then the port's TTSServer on 127.0.0.1 in a thread, payments
    disabled: /ready, 8 concurrent POST /synthesize (multipart WAV + text,
    ?duration= 2 and 5), one chunked /synthesize/stream of three sentences,
    /stats; no graph may be captured in the request path. Then an unpaid
    request to a trust-mode server (402), one padded batch replayed against
    the eager synthesize fn on the same noise (bit for bit), and eager
    against replayed timing of 5 batches each, with one batch of each
    profiled."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from smalltts_tpu_torch.data.bucketing import HOP_SIZE, frames_for_duration
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.serving.audio_io import encode_wav
    from smalltts_tpu_torch.serving.server import TTSServer
    from smalltts_tpu_torch.serving.x402 import X402Config

    print("phase serve http: SmallTTS(pcm16_out=True), default BackboneConfig/CodecConfig, bf16, seed 0, "
          "behind the port's TTSServer")
    tts = full_width_tts(torch, dev)
    torch.cuda.synchronize()
    reserved0, allocated0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    n_shapes = tts.warmup(batch_sizes=(1, 8))
    warm_s = time.perf_counter() - t0
    n_graphs = tts.compile_cache_size()
    pool = graph_pool_bytes(torch, tts)
    print(f"  warmup: {n_shapes} shapes, {n_graphs} CUDA graphs in {warm_s:.2f} s; graph pool "
          f"{pool / 2 ** 20 if pool is not None else 'not reported'} MiB; reserved "
          f"{(torch.cuda.memory_reserved() - reserved0) / 2 ** 20:.1f} MiB and allocated "
          f"{(torch.cuda.memory_allocated() - allocated0) / 2 ** 20:.1f} MiB more than before", flush=True)
    check(n_shapes == n_graphs == 48, f"warmup: {n_shapes} shapes, {n_graphs} graphs, want 48")

    durations, waves, _ = serve_requests()
    texts = ["The quick brown fox jumps over the lazy dog.", "Hello there, how are you today?",
             "A journey of a thousand miles begins with a single step.", "Good morning!",
             "She sells sea shells by the sea shore, and the shells she sells are surely sea shells.",
             "It was the best of times, it was the worst of times.", "Please call me back at noon.",
             "Every morning the small dog waits by the door for the postman to arrive with the letters."]
    srv = TTSServer(tts=tts, x402_cfg=X402Config(mode="disabled"), max_batch=8)
    srv._ensure_pipeline()
    loop = asyncio.new_event_loop()
    server = loop.run_until_complete(asyncio.start_server(srv._serve_conn, "127.0.0.1", 0))
    port = server.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        status, _, body, _ = http(port, "GET", "/ready")
        check(status == 200 and body == b"ready", f"/ready answered {status} {body[:80]!r}")

        def synth(i):
            d = durations[i]
            form, ctype = multipart_form([("audio", encode_wav(waves[i], 24_000)), ("text", texts[i].encode())])
            t_req = time.perf_counter()
            status, hdrs, body, _ = http(port, "POST", f"/synthesize?duration={d:g}", form, {"content-type": ctype})
            ms = (time.perf_counter() - t_req) * 1e3
            check(status == 200 and hdrs.get("content-type") == "audio/wav", f"request {i}: {status} {body[:200]!r}")
            channels, rate, bits = wav_format(body)
            samples = np.frombuffer(body[44:], np.int16)
            n = frames_for_duration(d) * HOP_SIZE
            check((channels, rate, bits) == (1, 24_000, 16) and samples.size == n,
                  f"request {i}: {channels} ch {rate} Hz {bits} bit, {samples.size} samples, want 1/24000/16, {n}")
            check(int(np.abs(samples).max()) > 0, f"request {i}: an all-zero waveform")
            return ms

        with ThreadPoolExecutor(8) as pool_:
            lat = list(pool_.map(synth, range(8)))
        print(f"  8 concurrent /synthesize, each 200 audio/wav 24 kHz mono int16 of the expected length; "
              f"latency ms: {json.dumps([round(v, 3) for v in lat])}", flush=True)

        form, ctype = multipart_form([("audio", encode_wav(waves[8], 24_000)),
                                      ("text", b"The first sentence is here. Then a second one follows it. "
                                               b"And the third sentence ends the stream.")])
        t_req = time.perf_counter()
        status, hdrs, chunks, t_first = http(port, "POST", "/synthesize/stream?duration=12", form,
                                             {"content-type": ctype})
        total_ms, ttfb_ms = (time.perf_counter() - t_req) * 1e3, (t_first - t_req) * 1e3
        check(status == 200 and hdrs.get("transfer-encoding") == "chunked" and isinstance(chunks, list)
              and len(chunks) >= 2, f"/synthesize/stream: {status} {hdrs}, {len(chunks)} chunks")
        check(int(np.abs(np.frombuffer(b"".join(chunks)[44:], np.int16)).max()) > 0, "stream: all-zero audio")
        print(f"  /synthesize/stream: {len(chunks)} chunks, {sum(map(len, chunks))} bytes, first chunk after "
              f"{ttfb_ms:.3f} ms, all after {total_ms:.3f} ms", flush=True)
        status, _, body, _ = http(port, "GET", "/stats")
        print(f"  /stats: {body.decode()}", flush=True)
        check(tts.compile_cache_size() == n_graphs,
              f"a graph was captured in the request path ({tts.compile_cache_size()} != {n_graphs})")
        print(f"  no capture in the request path: {tts.compile_cache_size()} graphs", flush=True)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        server.close()
        loop.run_until_complete(server.wait_closed())
        loop.close()
        srv._batcher.close()
        srv._pool.shutdown(wait=True)

    gate = TTSServer(tts=object(), x402_cfg=X402Config(mode="trust"))
    status, hdrs, body = asyncio.run(gate.handle("POST", "/synthesize", {"duration": "5"}, {}, b""))
    gate._pool.shutdown(wait=True)
    check(status == 402 and dict(hdrs).get("payment-required") and body == b"",
          f"unpaid request in trust mode: {status}")
    print("  trust-mode server: an unpaid /synthesize answers 402 with a payment-required header", flush=True)

    # one padded batch (8, r 64, p 384, t 40): replay against the eager function on the same noise
    args = padded_batch(tts)
    g = torch.Generator(device=dev).manual_seed(3)
    noises = torch.randn((tts.num_steps, 8, 40, 64), generator=g, device=dev).to(tts.dtype)

    def eager(fetch=True, noises=None):
        return eager_batch(tts, args, noises, fetch)

    def replayed(fetch=True, noises=None):
        return tts.synthesize_padded(*args, fetch=fetch, noises=noises)

    got, want = replayed(False, noises), eager(False, noises)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    print(f"  replay vs eager, batch (8, r 64, p 384, t 40), same noise: {n_diff} of {got.numel()} int16 samples "
          f"differ (max |diff| {int((got.int() - want.int()).abs().max())})", flush=True)
    check(n_diff == 0, f"replay differs from eager on {n_diff} samples")

    rows = {}
    for name, fn in (("eager", eager), ("replayed", replayed)):
        fn()
        dispatch, walls = batch_host_ms(fn, 5)
        busy, kern = profile_batch(fn)
        wall_med = _median(walls)
        rows[name] = dict(dispatch_ms=dispatch, wall_ms=walls, dispatch_ms_median=_median(dispatch),
                          wall_ms_median=wall_med, device_busy_ms=busy,
                          idle_share=(1.0 - busy / wall_med) if busy else None)
        if name == "replayed":
            ours = [(k, t, c) for k, t, c in kern if any(m in k for m in PORT_KERNELS)]
            rows[name]["port_kernels"] = [dict(kernel=k[:90], ms=t, count=c) for k, t, c in ours]
            check(bool(ours), "the profiled replay shows none of the port's kernels")
        print(f"  {name} batch (8, 64, 384, 40): {json.dumps(rows[name])}", flush=True)
    # the graph alone on the device clock, unprofiled: an upper bound on the replayed batch's busy time (the
    # profiler adds time to the kernels it traces inside a graph)
    graph = tts._graphs[(8, 64, 384, 40)].graph
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spans = []
    for _ in range(5):
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        spans.append(e0.elapsed_time(e1))
    rows["replayed"]["graph_span_ms"] = spans
    print(f"  the batch's graph alone, CUDA events around replay(), 5 times (ms): {json.dumps(spans)}; share of the "
          f"replayed batch's median wall outside the graph's median span: "
          f"{1.0 - _median(spans) / rows['replayed']['wall_ms_median']:.4f}", flush=True)
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["serve_http"] = dict(warmup_s=warm_s, graphs=n_graphs, graph_pool_bytes=pool, request_ms=lat,
                                   stream_ttfb_ms=ttfb_ms, stream_chunks=len(chunks),
                                   dispatch_ms_median={k: v["dispatch_ms_median"] for k, v in rows.items()},
                                   wall_ms_median={k: v["wall_ms_median"] for k, v in rows.items()},
                                   idle_share={k: v["idle_share"] for k, v in rows.items()},
                                   device_busy_ms={k: v["device_busy_ms"] for k, v in rows.items()},
                                   graph_span_ms=_median(spans))
    del tts
    kernels.reset_launches()


def serve_pt(torch, dev, entries, tmp):
    """Phase serve pt: the seed-0 weights of the serve phases (fp32, before
    the pipeline's bf16 cast) saved into `tmp` twice: by torch.save under
    the reference's key names ({"model": state_dict}, from
    utils.torch_convert.backbone_state_dict), and as the JAX package's npz
    with the config as metadata. SmallTTS(checkpoint=...) on each: the same
    params bit for bit; one request through the .pt one, the launch
    counters reset just before (attention and every scan kernel launched);
    one batch of 8 sampled from each on the same noise, latents equal bit
    for bit. Returns the .pt's path."""
    import numpy as np

    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.infer.sampler import sample_latents
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_meta
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.torch_convert import backbone_state_dict

    t_phase = time.perf_counter()
    cfg = BackboneConfig()
    gb = torch.Generator(device=dev).manual_seed(0)
    tree = params_to_jax(redraw_zero_init(init_backbone(gb, cfg, device=dev), gb))
    pt, npz = os.path.join(tmp, "seed0.pt"), os.path.join(tmp, "seed0.npz")
    torch.save({"model": backbone_state_dict(tree)}, pt)
    ckpt.save_pytree(npz, tree, backbone_meta(cfg))
    del tree
    print(f"phase serve pt: the seed-0 weights as a reference torch checkpoint ({os.path.getsize(pt) / 1e9:.2f} GB, "
          f"torch.save of the reference's keys) and as an npz; SmallTTS(checkpoint=...) on each, pcm16_out=True",
          flush=True)
    t0 = time.perf_counter()
    tts = SmallTTS(checkpoint=pt, pcm16_out=True, seed=0)
    load_s = time.perf_counter() - t0
    ref = SmallTTS(checkpoint=npz, pcm16_out=True, seed=0)
    fa, fb = ckpt.flatten_pytree(tts.params), ckpt.flatten_pytree(ref.params)
    check(fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa),
          "SmallTTS from the .pt and from the npz hold different params")
    durations, waves, ids = serve_requests()
    tts.synthesize(tts.encode_reference(waves[0]), ids[0], 2.0)  # warm-up outside the counted request
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = tts.synthesize(tts.encode_reference(waves[1]), ids[1], durations[1])
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(out.dtype == np.int16 and int(np.abs(out).max()) > 0, f"the .pt request: {out.dtype}, all zero or not")
    check(all(launches.get(n, 0) > 0 for n in ("attention",) + SCAN_KERNELS), f"the .pt request launched {launches}")
    ref_, ref_lens, ph, ph_lens, seq_lens, t_bucket = padded_batch(tts)
    noises = torch.randn((tts.num_steps, 8, t_bucket, 64), generator=gb, device=dev).to(tts.dtype)
    tt = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    lat = []
    with torch.inference_mode():
        for p in (tts, ref):
            lat.append(sample_latents(p.params, p.cfg, tt(ref_, p.dtype), tt(ref_lens, torch.int32), tt(ph, torch.int64),
                                      tt(ph_lens, torch.int32), tt(seq_lens, torch.int32), num_steps=p.num_steps,
                                      noises=noises, sampler=p.sampler))
    n_diff = int((lat[0] != lat[1]).sum())
    check(n_diff == 0 and bool(torch.isfinite(lat[0]).all()), f".pt against npz latents: {n_diff} differ")
    row = dict(pt_bytes=os.path.getsize(pt), load_s=load_s, request_launches=launches,
               latents_differing=n_diff, latents=list(lat[0].shape))
    print(f"  {json.dumps(row)}; phase serve pt: {time.perf_counter() - t_phase:.2f} s", flush=True)
    for e in entries:
        if e["name"] in ("attention",) + SCAN_KERNELS:
            e["launches_pt_serve"] = launches.get(e["name"], 0)
        elif e["name"] == "fused_dit_scan":
            e["serve_pt"] = row
    del tts, ref, lat
    return pt


def serve_main(entries, checkpoint=None, timeout_s=600):
    """Phase serve main: `python -m smalltts_tpu_torch.serving.server
    --warmup` in a process of its own, with its default flags (batch
    classes 1, 8 and 32) on a free local port, as a user starts the server,
    serving `checkpoint` (a reference torch checkpoint) where one is given:
    /ready polled until it answers 200, one /synthesize, then SIGTERM, on
    which it drains and exits 0. Prints the seconds to /ready, the card's
    memory in use then (nvidia-smi) and the server's own summary lines."""
    import signal
    import socket

    import numpy as np

    from smalltts_tpu_torch.serving.audio_io import encode_wav

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = ["-m", "smalltts_tpu_torch.serving.server", "--warmup", "--host", "127.0.0.1", "--port", str(port)]
    cmd += ["--checkpoint", checkpoint] if checkpoint else []
    print(f"phase serve main: python {' '.join(cmd)}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *cmd], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        ready_s = None
        while ready_s is None and time.perf_counter() - t0 < timeout_s:
            check(proc.poll() is None, f"the server exited with {proc.returncode}:\n" + "".join(lines[-30:]))
            try:
                if http(port, "GET", "/ready")[0] == 200:
                    ready_s = time.perf_counter() - t0
            except OSError:
                pass
            time.sleep(1.0)
        check(ready_s is not None, f"the server was not ready after {timeout_s} s")
        mem = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        rs = np.random.RandomState(1)
        form, ctype = multipart_form([("audio", encode_wav((0.1 * rs.randn(72_000)).astype(np.float32), 24_000)),
                                      ("text", b"The server answers its first request.")])
        t_req = time.perf_counter()
        status, hdrs, body, _ = http(port, "POST", "/synthesize?duration=3", form, {"content-type": ctype})
        req_ms = (time.perf_counter() - t_req) * 1e3
        check(status == 200 and hdrs.get("content-type") == "audio/wav" and len(body) > 44
              and int(np.abs(np.frombuffer(body[44:], np.int16)).max()) > 0, f"/synthesize: {status} {body[:200]!r}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"the server exited with {rc} on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=60)
    summary = [ln.rstrip() for ln in lines if not ln.startswith("warmup ")]
    print(f"  ready after {ready_s:.2f} s (process start, model init, warmup); card memory used then: {mem}; "
          f"one /synthesize (3 s) {req_ms:.3f} ms; exit 0 on SIGTERM", flush=True)
    print("  server output: " + json.dumps(summary[-12:]), flush=True)
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["serve_main"] = dict(ready_s=ready_s, memory_used=mem, request_ms=req_ms)


ONNX_CODEC_TOL = 1e-5  # fp32, TF32 off in both: the same convolutions, some sums in another order
IMPORTED_TOL = 1e-4  # fp32 through 4 denoiser steps and the codec: op chains the exporter split differently


def onnx_phases(torch, dev, entries):
    """Phases onnx codec and imported, each printing its seconds.

    onnx codec: the port's full-width native codec (default CodecConfig, fp32,
    seed weights) wrapped with the VibeVoice contract (onnxtorch.export) and
    exported by torch.onnx.export with dynamic batch and time axes; OnnxCodec
    on the card against the native codec on the same latents and waveform
    (max |diff| / max |native| <= ONNX_CODEC_TOL); then SmallTTS(codec=
    OnnxCodec) on the seed-0 backbone, one padded batch through its CUDA
    graph against the eager fn (bit for bit), and its graph timing beside
    the native-codec pipeline's on the same batch.

    imported: the seed-0 backbone in fp32, its condition encoder and cached
    DiT step exported with the published positional contract (plain
    versions of the kernels; the ten denoiser inputs all used, the RoPE from
    the `rope` input) and the decoder above; ImportedSmallTTS on the card
    with injected noise against the same recurrence over the torch modules
    the graphs came from (max |diff| / max |want| <= IMPORTED_TOL)."""
    import tempfile

    import numpy as np

    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, codec_encode, init_codec
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, ConditionEncoder, Denoiser, export
    from smalltts_tpu_torch.onnxtorch.interp import highest_precision
    from smalltts_tpu_torch.onnxtorch.pipeline import ImportedSmallTTS, _rope_freqs
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.schedule import get_alpha_sigma

    def rel(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    t_phase = time.perf_counter()
    print("phase onnx codec: the native codec (default CodecConfig, fp32, seed 1 weights, as SmallTTS(seed=0) "
          "draws them) exported by torch.onnx.export, then OnnxCodec on the card", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {n: os.path.join(tmp, n + ".onnx") for n in ("encoder", "decoder", "condition_encoder", "denoiser")}
        ccfg = CodecConfig()
        g = torch.Generator(device=dev).manual_seed(1)
        cp = init_codec(g, ccfg, device=dev)
        hop = ccfg.hop
        t0 = time.perf_counter()
        with kernels.force_plain():
            for name, module, example, axes in (
                    ("encoder", CodecEncoder(cp, ccfg), torch.zeros((1, 1, 4 * hop), device=dev), {0: "b", 2: "t"}),
                    ("decoder", CodecDecoder(cp, ccfg), torch.zeros((1, 4, 64), device=dev), {0: "b", 1: "t"})):
                blob = export(module, (example,), dynamic_axes={"x": axes}, input_names=["x"])
                with open(paths[name], "wb") as f:
                    f.write(blob)
        export_s = time.perf_counter() - t0
        codec = OnnxCodec(paths["encoder"], paths["decoder"], device=dev)
        print(f"  exported in {export_s:.2f} s with dynamic batch and time axes (example: 4 frames; run below at "
              f"40 and 64): {os.path.getsize(paths['encoder'])} and {os.path.getsize(paths['decoder'])} bytes; "
              f"{codec.describe()}", flush=True)
        lat = torch.randn((8, 40, 64), generator=g, device=dev)
        wav = 0.1 * torch.randn((1, 1, 64 * hop), generator=g, device=dev)
        with torch.inference_mode():
            dec_err = rel(codec.decode_fn(codec.params, lat), codec_decode(cp, lat, ccfg))
            enc_err = rel(codec.encode_fn(codec.params, wav), codec_encode(cp, wav, ccfg))
        print(f"  OnnxCodec vs the native codec: decode (8, 40, 64) {dec_err:.3e}, encode (1, 1, 64 x hop) "
              f"{enc_err:.3e} (max |diff| / max |native|, tolerance {ONNX_CODEC_TOL})", flush=True)
        check(dec_err <= ONNX_CODEC_TOL and enc_err <= ONNX_CODEC_TOL, f"OnnxCodec: {dec_err:.3e}, {enc_err:.3e}")
        tts = full_width_tts(torch, dev, codec=codec)
        check(tts.onnx_codec is codec, "SmallTTS did not take the OnnxCodec")
        args = padded_batch(tts)
        noises = torch.randn((tts.num_steps, 8, 40, 64), generator=g, device=dev).to(tts.dtype)
        got, want = tts.synthesize_padded(*args, fetch=False, noises=noises), eager_batch(tts, args, noises)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        print(f"  SmallTTS(codec=OnnxCodec) replay vs eager, batch (8, r 64, p 384, t 40), same noise: {n_diff} of "
              f"{got.numel()} int16 samples differ", flush=True)
        check(n_diff == 0 and int(want.abs().max()) > 0, f"ONNX-codec replay differs from eager on {n_diff} samples")
        rows = {"onnx codec": graph_timing(torch, tts, args)}
        del tts
        native_tts = full_width_tts(torch, dev, codec="native")
        native_out = native_tts.synthesize_padded(*args, fetch=False, noises=noises)
        rows["native codec"] = graph_timing(torch, native_tts, args)
        lsb = int((native_out.int() - got.int()).abs().max())
        del native_tts
        torch.cuda.empty_cache()
        print(f"  the same batch through the ONNX and the native codec: max |diff| {lsb} LSB; "
              f"{json.dumps(rows)}", flush=True)
        print(f"  phase onnx codec: {time.perf_counter() - t_phase:.2f} s", flush=True)

        t_phase = time.perf_counter()
        print("phase imported: ImportedSmallTTS on the seed-0 backbone's condition encoder and cached DiT step "
              "(fp32, exported with the published positional contract) and the decoder above", flush=True)
        cfg = BackboneConfig()
        gb = torch.Generator(device=dev).manual_seed(0)
        bp = redraw_zero_init(init_backbone(gb, cfg, device=dev), gb)
        cond, den, dec = ConditionEncoder(bp, cfg), Denoiser(bp, cfg), CodecDecoder(cp, ccfg)
        del bp
        rs = np.random.RandomState(0)
        R, P, dur = 64, 200, 5.0
        S = int(dur * 24_000 / 3_200)
        ref = rs.randn(R, 64).astype(np.float32)
        tokens = rs.randint(1, 198, P).tolist()
        mask_p = torch.ones((1, P), dtype=torch.bool, device=dev)
        cargs = (torch.from_numpy(ref[None]).to(dev), torch.tensor([R], device=dev),
                 torch.tensor([tokens], device=dev), mask_p)
        rope = torch.from_numpy(_rope_freqs(S)).to(dev)
        t0 = time.perf_counter()
        with kernels.force_plain(), highest_precision():
            with torch.no_grad():
                kv = cond(*cargs)
            for name, module, example in (("condition_encoder", cond, cargs), (
                    "denoiser", den, (torch.zeros((1, S, 64), device=dev), torch.ones((1, S), dtype=torch.bool,
                                      device=dev), torch.tensor([0.5], device=dev), *kv, mask_p, rope))):
                with open(paths[name], "wb") as f:
                    f.write(export(module, example))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        imported = ImportedSmallTTS(paths["condition_encoder"], paths["denoiser"], paths["decoder"], device=dev)
        load_s = time.perf_counter() - t0
        n_in = len(imported.denoiser.input_names)
        print(f"  exported in {export_s:.2f} s ({os.path.getsize(paths['condition_encoder'])} and "
              f"{os.path.getsize(paths['denoiser'])} bytes; R {R}, P {P}, S {S} fixed by the tracer), loaded in "
              f"{load_s:.2f} s; denoiser graph: {len(imported.denoiser.model.graph.nodes)} nodes, {n_in} inputs",
              flush=True)
        check(n_in == 10, f"the denoiser graph has {n_in} inputs, want the contract's 10")
        noises = rs.randn(4, 1, S, 64).astype(np.float32)
        t0 = time.perf_counter()
        got = imported.synthesize(ref, tokens, dur, noises=noises)
        synth_s = time.perf_counter() - t0
        with kernels.force_plain(), highest_precision(), torch.inference_mode():
            ts = torch.linspace(1.0, 0.0, 4, device=dev)
            alphas, sigmas = get_alpha_sigma(ts)
            x = torch.zeros((1, S, 64), device=dev)
            mask = torch.ones((1, S), dtype=torch.bool, device=dev)
            for i in range(4):
                x_t = alphas[i] * x + sigmas[i] * torch.from_numpy(noises[i]).to(dev)
                x = alphas[i] * x_t - sigmas[i] * den(x_t, mask, ts[i:i + 1], *kv, mask_p, rope)
            want = dec(x)[0].cpu().numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"  ImportedSmallTTS vs the torch modules, same noise: waveform {got.shape}, max |diff| / max |want| "
              f"{err:.3e} (tolerance {IMPORTED_TOL}); synthesize {synth_s:.2f} s", flush=True)
        check(got.shape == (1, S * hop) and bool(np.isfinite(got).all()) and err <= IMPORTED_TOL,
              f"imported: {got.shape}, {err:.3e}")
        del cond, den, dec, imported
        torch.cuda.empty_cache()
        print(f"  phase imported: {time.perf_counter() - t_phase:.2f} s", flush=True)
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["onnx"] = dict(codec_decode_rel=dec_err, codec_encode_rel=enc_err, imported_rel=err,
                             **{k: {m: v[m] for m in ("dispatch_ms_median", "wall_ms_median", "graph_span_ms")}
                                for k, v in rows.items()})


# the attention Function's dq/dk/dv against autograd through attention_plain, max|diff|/max|plain|:
# fp32 sums in another order, and the backward reads the kernel's output; in bf16 that output
# is rounded to bf16 and each gradient is rounded once (tests/test_torch_train_cuda.py)
TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PORT_KERNELS = ATTN_KERNELS + ("adaln_kernel", "qk_norm_rope_kernel", "gemm_wgmma_kernel", W8_TC, W8_STREAM)


def train_phases(torch, dev, entries):
    """Phase train teacher: the full-width teacher step (default
    BackboneConfig, 328M) through the port's own entry points.

    - The fp32 DiT stem conv and its gradients against the CPU's (nn.conv1d
      keeps cuDNN's TF32 off), within 1e-5.
    - Kernels against plain: teacher_loss and its gradients on seed-0
      weights (zero-init leaves re-drawn) and a dummy batch, with the
      kernels and with kernels.force_plain(), fp32 at batch 2 and bf16 at
      batch 16: loss within 1e-5 relative (bf16 1e-2), each module's
      gradient within 1e-4 rel-L2 (bf16 5e-2); the bf16 backward must run
      through matmul_f32's autograd Function.
    - train_teacher on the dummy loader, seed 0: 5 steps at batch 2 in fp32
      with one save (the last step, into a temporary directory that is
      removed), then 5 steps at batch 16 in bf16. Counters reset before
      each: exactly 32 attention launches a step (8 text, 12 style, 12 DiT
      layers; the backward is PyTorch ops) and no other kernel. The loss
      finite, params changed from their init, EMA equal to params bit for
      bit (decay 0 through step 101), the saved EMA and params reloading
      equal. Median step ms over steps 2-5, latent frames a second (batch x
      256 padded frames a step), peak max_memory_allocated; then one more
      step profiled (step_profile: host dispatch, synchronizing calls,
      wall, device busy, idle share, top kernels).
    - The attention kernel's forward and the PyTorch backward
      (attention_backward) at the step's three shapes, beside
      scaled_dot_product_attention's forward and backward: device time per
      call, every kernel of the call summed (timed). First the attention
      Function's dq/dk/dv there against autograd through attention_plain,
      with one fully-masked row (TRAIN_GRAD_TOL).

    Phase teacher sampler: make_teacher_sampler, 32 steps at batch 2 in
    bf16 on the seed-0 weights (zero-init leaves re-drawn), 3x CFG batch,
    t 256, ref 64, phonemes 198: float32 latents against force_plain (5e-2
    rel-L2) and against the plain path on the same weights' values in fp32
    (1e-1 rel-L2: the bf16 denoiser's roundings over 32 steps of CFG, which
    amplifies differences 4.5x; a wiring fault gives O(1)), exact launch counts (the scan's 8 a layer, 32 steps x 12 layers; 20
    encoder attentions and one a layer a step), wall ms."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    import numpy as np

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.infer.teacher_sampler import make_teacher_sampler
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.ops import kernels, nn
    from smalltts_tpu_torch.ops.kernels import attention as A
    from smalltts_tpu_torch.ops.precision import cast_floats
    from smalltts_tpu_torch.train.optim import teacher_optimizer
    from smalltts_tpu_torch.train.teacher import (TeacherTrainConfig, make_teacher_step, teacher_draws, teacher_loss,
                                                  train_teacher)
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_meta
    from smalltts_tpu_torch.utils.convert import params_from_jax

    cfg = BackboneConfig()
    attn = next(e for e in entries if e["name"] == "attention")
    t_phase = time.perf_counter()
    print("phase train teacher: train_teacher, default BackboneConfig (328M), seed 0, dummy loader; "
          "kernels vs plain first", flush=True)

    def batch_of(b, seed=0):
        return {k: torch.as_tensor(v, device=dev) for k, v in
                dummy_batch(np.random.default_rng(seed), DummyDataConfig(batch_size=b)).items() if k != "texts"}

    def node_names(root):
        seen, stack, names = set(), [root], {}
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            names[type(fn).__name__] = names.get(type(fn).__name__, 0) + 1
            stack.extend(f for f, _ in fn.next_functions)
        return names

    # the fp32 DiT stem conv (960 channels in 16 groups, k 31) and its gradients against the
    # CPU's: nn.conv1d keeps cuDNN's TF32 off (PyTorch's default is on), within 1e-5
    gc = torch.Generator().manual_seed(3)
    xc, wc, dyc = (torch.randn(shape, generator=gc) for shape in ((2, 256, 960), (960, 60, 31), (2, 256, 960)))

    def stem(d):
        leaves = [t.detach().to(d).requires_grad_(True) for t in (xc, wc)]
        y = nn.conv1d({"w": leaves[1], "b": torch.zeros(960, device=d)}, leaves[0], groups=16)
        y.backward(dyc.to(d))
        return [t.cpu() for t in (y.detach(), *(a.grad for a in leaves))]

    conv_err = {n: float((a - b_).abs().max() / b_.abs().max()) for n, a, b_ in zip(("y", "dx", "dw"), stem(dev),
                                                                                      stem("cpu"))}
    print(f"  fp32 stem conv (2, 256, 960), 16 groups, k 31, against the CPU's (tolerance 1e-5): "
          f"{json.dumps(conv_err)}", flush=True)
    check(max(conv_err.values()) <= 1e-5, f"fp32 stem conv against the CPU: {conv_err}")
    attn["train_stem_conv_rel_err"] = conv_err

    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = ckpt.flatten_pytree(redraw_zero_init(init_backbone(gen, cfg, device=dev), gen))
    for dtype, b, tol_loss, tol_g in (("float32", 2, 1e-5, 1e-4), ("bfloat16", 16, 1e-2, 5e-2)):
        batch = batch_of(b)
        draws = teacher_draws(torch.Generator(device=dev).manual_seed(1), batch)
        res = []
        for plain in (False, True):
            req = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
            with kernels.force_plain() if plain else torch.enable_grad():
                loss = teacher_loss(ckpt.unflatten_pytree(req), cfg, batch, draws,
                                    TeacherTrainConfig(compute_dtype=dtype))
                nodes = node_names(loss.grad_fn)
                grads = torch.autograd.grad(loss, list(req.values()))
            res.append((float(loss.detach()), dict(zip(req, grads)), nodes))
            del req, loss, grads
        (loss_k, g_k, nodes), (loss_p, g_p, _) = res
        sums = {}
        for n, g in g_k.items():
            m = "/".join(n.split("/")[:2])
            a, c = sums.get(m, (0.0, 0.0))
            sums[m] = (a + float((g - g_p[n]).norm()) ** 2, c + float(g_p[n].norm()) ** 2)
        errs = {m: (a / max(c, 1e-60)) ** 0.5 for m, (a, c) in sums.items()}
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"  {dtype} batch {b}: loss {loss_k:.6f} (plain {loss_p:.6f}, rel {loss_rel:.3e}, tolerance {tol_loss}); "
              f"per-module gradient rel-L2 (tolerance {tol_g}): {json.dumps({m: float(f'{e:.3e}') for m, e in errs.items()})}; "
              f"autograd nodes: _AttentionBackward {nodes.get('_AttentionBackward', 0)}, "
              f"_MatmulF32Backward {nodes.get('_MatmulF32Backward', 0)}", flush=True)
        check(np.isfinite(loss_k) and loss_rel <= tol_loss, f"{dtype} teacher loss kernels vs plain rel {loss_rel:.3e}")
        check(max(errs.values()) <= tol_g, f"{dtype} gradients kernels vs plain: {errs}")
        check(nodes.get("_AttentionBackward", 0) == 32, f"{dtype}: {nodes.get('_AttentionBackward', 0)} attention nodes")
        if dtype == "bfloat16":
            check(nodes.get("_MatmulF32Backward", 0) > 0, "the bf16 backward did not run through matmul_f32's Function")
        attn.setdefault("train_kernels_vs_plain", {})[f"{dtype} B{b}"] = dict(
            loss=loss_k, loss_plain=loss_p, loss_rel=loss_rel, grad_rel_l2_max=max(errs.values()))
        del g_k, g_p, res
        torch.cuda.empty_cache()
    del leaves

    def step_profile(tcfg, b, params, ema):
        """One more step on the trained state, outside train_teacher: its host
        dispatch (queued with sync-debug "warn": the synchronizing calls it
        makes are counted), its wall time (median of 3, synchronized), and
        one profiled step's device busy time and top kernels."""
        import warnings

        tx, _ = teacher_optimizer(params, tcfg.num_steps)
        step, state = make_teacher_step(cfg, tx, tcfg), tx.init(params)
        batch = batch_of(b, seed=5)
        draws = teacher_draws(torch.Generator(device=dev).manual_seed(5), batch)
        one = lambda: step(params, state, ema, batch, draws, np.float32(0.0))  # noqa: E731
        one()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                one()
                dispatch = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sorted({str(w.message)[:120] for w in caught if "synchroniz" in str(w.message)})
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy, kern = profile_batch(lambda: (one(), torch.cuda.synchronize()))
        wall = statistics.median(walls)
        attn_ms = sum(t for k, t, _ in kern if any(m in k for m in ATTN_KERNELS))
        by_kernel = {m[:-1]: sum(t for k, t, _ in kern if m in k) for m in ATTN_KERNELS}
        return dict(dispatch_ms=dispatch, sync_calls=syncs, wall_ms=walls, device_busy_ms=busy,
                    idle_share=1.0 - busy / wall, attention_kernel_ms=attn_ms, attention_ms_by_kernel=by_kernel,
                    kernels=sum(c for _, _, c in kern),
                    top=[dict(kernel=k[:90], ms=t, count=c) for k, t, c in kern[:10]])

    tmp = tempfile.mkdtemp(prefix="teacher_smoke_")
    runs = {}
    try:
        for dtype, b, save in (("float32", 2, True), ("bfloat16", 16, False)):
            steps = 5
            stamps, losses = [], []

            def on_step(step, loss):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                losses.append(loss)

            tcfg = TeacherTrainConfig(num_steps=steps, batch_size=b, save_every=steps - 1 if save else 10 ** 9,
                                      compute_dtype=dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            params, ema = train_teacher(tcfg, cfg, seed=0, checkpoint_dir=tmp, device=dev, on_step=on_step)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            peak = torch.cuda.max_memory_allocated()
            losses = [float(x) for x in losses]
            step_ms = [(b_ - a_) * 1e3 for a_, b_ in zip(stamps, stamps[1:])]
            med = statistics.median(step_ms)
            check(launches == {"attention": 32 * steps}, f"train teacher {dtype} launches {launches}, "
                  f"want {{'attention': {32 * steps}}}")
            check(all(np.isfinite(losses)), f"train teacher {dtype}: losses {losses}")
            g0 = torch.Generator(device=dev).manual_seed(0)
            init = ckpt.flatten_pytree(init_backbone(g0, cfg, device=dev))
            flat_p, flat_e = ckpt.flatten_pytree(params), ckpt.flatten_pytree(ema)
            changed = sum(not torch.equal(flat_p[k], v) for k, v in init.items())
            check(changed > 0 and not torch.equal(flat_p["velocity/w"], init["velocity/w"]),
                  f"train teacher {dtype}: params did not change ({changed} leaves)")
            check(all(torch.equal(flat_p[k], flat_e[k]) for k in flat_p), f"train teacher {dtype}: EMA != params")
            del init
            row = dict(dtype=dtype, batch=b, steps=steps, losses=losses, step_ms=step_ms, step_ms_median=med,
                       latent_frames_per_s=b * 256 / (med / 1e3), peak_memory_bytes=peak, wall_s=wall,
                       leaves_changed=f"{changed} of {len(flat_p)}", launches=launches)
            if save:
                t_load = time.perf_counter()
                for name, tree in (("checkpoint_ema.npz", flat_e), ("checkpoint_latest.npz", flat_p)):
                    path = os.path.join(tmp, name)
                    back = ckpt.flatten_pytree(params_from_jax(ckpt.load_pytree(path),
                                                               backbone_config_from_meta(ckpt.load_meta(path))))
                    check(back.keys() == tree.keys() and all(torch.equal(back[k], tree[k].cpu()) for k in tree),
                          f"{name} does not reload equal")
                state = ckpt.load_train_state(os.path.join(tmp, "train_state.npz"))
                check(int(state["step"]) == steps - 1 and int(state["opt_state"]["count"]) == steps,
                      f"train_state step {int(state['step'])} count {int(state['opt_state']['count'])}")
                row["saved_bytes"] = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)
                                         if f.endswith(".npz"))
                row["reload_s"] = time.perf_counter() - t_load
                del state
            row["profile"] = step_profile(tcfg, b, params, ema)
            print(f"  train_teacher {dtype} batch {b}: {json.dumps(row)}", flush=True)
            runs[f"{dtype} B{b}"] = row
            del params, ema, flat_p, flat_e
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    attn["train_teacher"] = runs
    attn["launches_train_teacher"] = {k: r["launches"].get("attention", 0) for k, r in runs.items()}

    # the attention's forward and backward at the step's shapes, beside SDPA's
    rows = []
    g = torch.Generator(device=dev).manual_seed(2)
    for dtype, B in ((torch.float32, 2), (torch.bfloat16, 16)):
        for label, H, Tq, S, D in (("text P=198", 4, 198, 198, 128), ("style R=64", 8, 64, 64, 64),
                                   ("dit T=256 + 64 + 198", 8, 256, 518, 120)):
            q, k, v = (torch.randn((B, H, n, D), generator=g, device=dev).to(dtype) for n in (Tq, S, S))
            dout = torch.randn((B, H, Tq, D), generator=g, device=dev).to(dtype)
            m = torch.arange(S, device=dev)[None] < torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)[:, None]
            grads = []  # the Function's gradients against autograd through the plain version
            mg = m.clone()
            mg[-1] = False  # a fully-masked row: no gradient to its q or k
            for fn in (A.attention, A.attention_plain):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                grads.append(torch.autograd.grad(fn(*leaves, mg), leaves, dout))
            grad_err = {n: float((a.float() - b_.float()).abs().max() / b_.float().abs().max())
                        for n, a, b_ in zip(("dq", "dk", "dv"), *grads)}
            tol_g = TRAIN_GRAD_TOL[str(dtype).split(".")[-1]]
            check(max(grad_err.values()) <= tol_g and float(grads[0][0][-1].abs().max()) == 0.0,
                  f"attention Function gradients {label} {dtype}: {grad_err}")
            del grads, leaves
            out = A.fused_attention(q, k, v, m)
            ms, _, clock = timed(lambda: A.fused_attention(q, k, v, m), 20, ATTN_KERNELS)
            bwd_ms, bwd_wall, _ = timed(lambda: A.attention_backward(q, k, v, m, out, dout), 10)
            qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
            o_lib = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=m[:, None, None, :])
            lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=m[:, None, None, :]), 20)[0]
            lib_bwd_ms, lib_bwd_wall, _ = timed(
                lambda: torch.autograd.grad(o_lib, (qs, ks, vs), dout, retain_graph=True), 10)
            kind = "bf16" if dtype == torch.bfloat16 else "fp32"
            b_ms, b_by = bound(nbytes(q, k, v, m, out), 4.0 * B * H * Tq * S * D, attn_kind(dtype, D))
            bb_ms, bb_by = bound(nbytes(q, k, v, m, out, dout) * 2 - nbytes(m, out, dout), 10.0 * B * H * Tq * S * D,
                                 kind)
            row = dict(shape=f"{label} B={B} H={H} D={D}", dtype=kind, grad_rel_err=grad_err, ms=ms, clock=clock, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, backward_ms=bwd_ms, backward_wall_ms=bwd_wall, backward_bound_ms=bb_ms,
                       backward_bound_by=bb_by, library_backward_ms=lib_bwd_ms, library_backward_wall_ms=lib_bwd_wall)
            rows.append(row)
            print("  attention at the teacher step's shapes: " + json.dumps(row), flush=True)
            del q, k, v, dout, out, qs, ks, vs, o_lib
    attn["train_shapes"] = rows
    torch.cuda.empty_cache()
    print(f"  phase train teacher: {time.perf_counter() - t_phase:.2f} s", flush=True)

    # ------------------------------------------------------ teacher sampler
    t_phase = time.perf_counter()
    steps, B = 32, 2
    print(f"phase teacher sampler: make_teacher_sampler(num_steps={steps}), default BackboneConfig, bf16, "
          "seed-0 weights (zero-init leaves re-drawn), batch 2, t 256, ref 64, phonemes 198", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cast_floats(redraw_zero_init(init_backbone(gen, cfg, device=dev), gen), torch.bfloat16)
    b = batch_of(B, seed=3)
    args = (params, b["ref_latents"].to(torch.bfloat16), b["ref_latents_lengths"], b["phonemes"],
            b["phonemes_lengths"], b["latents_lengths"])
    noises = torch.randn((steps, B, 256, cfg.latent_dim), generator=gen, device=dev)
    sample = make_teacher_sampler(cfg, num_steps=steps)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    lat = sample(*args, noises, 256)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    per = steps * cfg.dit.n_blocks
    want = {"attention": 20 + per, "adaln_modulate": 2 * per, "qk_norm_rope": per, "gemm_bias": per,
            "gemm_swiglu": per, "gemm_residual": 2 * per}
    check(launches == want, f"teacher sampler launches {json.dumps(launches)}, want {json.dumps(want)}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sample(*args, noises, 256)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with kernels.force_plain():
        lat_p = sample(*args, noises, 256)
        # the same weights' values in fp32 through the plain path: what the bf16 denoiser costs
        lat_32 = sample(cast_floats(params, torch.float32), args[1].float(), *args[2:], noises, 256)
    rel_l2 = float((lat - lat_p).norm() / lat_p.norm())
    rel_32 = float((lat - lat_32).norm() / lat_32.norm())
    valid = torch.arange(256, device=dev)[None, :, None] < b["latents_lengths"][:, None, None]
    check(lat.dtype == torch.float32 and bool(torch.isfinite(lat).all()) and rel_l2 <= 5e-2
          and float(lat.masked_fill(valid, 0).abs().max()) == 0.0, f"teacher sampler latents rel-L2 {rel_l2:.3e}")
    check(rel_32 <= 1e-1, f"teacher sampler bf16 against fp32 rel-L2 {rel_32:.3e}")
    row = dict(steps=steps, batch=B, t_bucket=256, rel_l2_vs_plain=rel_l2, rel_l2_vs_fp32_plain=rel_32,
               first_call_ms=first_ms, wall_ms=walls, wall_ms_median=statistics.median(walls), launches=launches)
    print(f"  teacher sampler: {json.dumps(row)}", flush=True)
    for e in entries:
        if e["name"] in want:
            e["launches_teacher_sampler"] = launches[e["name"]]
        elif e["name"] == "fused_dit_scan":
            e["launches_teacher_sampler"] = sum(launches[n] for n in want if n != "attention") + per
            e["teacher_sampler"] = row
    del params, lat, lat_p, lat_32, noises
    torch.cuda.empty_cache()
    print(f"  phase teacher sampler: {time.perf_counter() - t_phase:.2f} s", flush=True)



# the attention kernel at the distiller's shapes against attention_plain: the forward as phase A
# holds it; the Function's dq/dk/dv as the teacher phase holds them (TRAIN_GRAD_TOL)
DISTILL_FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# kernels against plain over one student, disc and scorer step (fp32): the losses and metrics, and
# each module's gradient rel-L2 (fp32 sums in another order, as the teacher phase bounds them)
DISTILL_LOSS_TOL = 1e-4
DISTILL_GRAD_TOL = 1e-4


def distill_attention_launches(cfg, disc_cfg, asr_cfg, n_updates, gates_open):
    """Attention launches of one distillation iteration, by step, derived
    from the configs: a backbone forward launches one a text, style and DiT
    layer; a backward through a remat DiT one more a DiT layer (its blocks
    run again); the discriminator and the ASR one a conformer layer. The
    student step: the teacher's style encoder, 4 backbone forwards without
    grad (the student at t_prev and t_cur, the teacher's 3x CFG batch in
    one, the scorer), the student with grad, the discriminator, the ASR when
    its gate is open. The disc step: the scorer's features and the
    discriminator. The scorer step, per update: the student without grad and
    the scorer with grad."""
    fwd = cfg.text.num_layers + cfg.style.num_layers + cfg.dit.n_blocks
    remat = cfg.dit.n_blocks if cfg.dit.remat else 0
    disc = disc_cfg.conformer.num_layers
    student = cfg.style.num_layers + 4 * fwd + fwd + remat + disc + (asr_cfg.conformer.num_layers if gates_open else 0)
    return {"student": student, "disc": fwd + disc, "scorer": n_updates * (2 * fwd + remat)}


def distill_phase(torch, dev, entries):
    """Phase train distill: DMD2 distillation through the port's own entry
    points at full width: the default BackboneConfig with dit.remat (328M)
    for the student, the scorer and the frozen teacher;
    DiscriminatorConfig(960, 960), a 6 x 512 conformer, 8 heads of 64;
    ASRConfig(64), a 7 x 64 conformer, 16 heads of 4; SVConfig(64), ECAPA
    768 x 4 + 2304. Seed-0 random weights (the backbone's zero-init leaves
    re-drawn), asr_start_step = sv_start_step = 0, the dummy loader.

    - The attention kernel against attention_plain at every shape the
      train_distill runs send: the ASR's (2, 16, 1024, 4) with a key mask,
      fp32 (and bf16, which no run sends); the discriminator's
      self-attention (4 and 2, 8, 1030, 64), fp32 (S = 3 x 256 + 64 + 198);
      the backbone's text, style and DiT shapes at batch 2 and 6 (the
      teacher's CFG batch), fp32 and bf16 (at these batches the bf16 kernel
      splits the keys across a cluster). The forward (DISTILL_FWD_TOL) and
      the Function's dq/dk/dv against autograd through attention_plain
      (TRAIN_GRAD_TOL), one launch a call; the kernel's device ms from
      three profiled calls (a wall-clock reading fails the run) beside
      scaled_dot_product_attention's and the bound.
    - Kernels against kernels.force_plain(), fp32, batch 2: one student
      step (gates open), one disc step and one scorer step (one update)
      from the same state and draws, with an optimizer that records the
      gradients and leaves the params: the student's metrics and the two
      losses within DISTILL_LOSS_TOL, each module's gradient within
      DISTILL_GRAD_TOL rel-L2.
    - train_distill, 3 iterations at batch 2 in fp32 (a save at the last,
      into a temporary directory that is removed) and 3 in bf16: the
      attention launches of each iteration, counted, equal to what
      distill_attention_launches derives (step 0's gates are shut: `step >
      0`), no other kernel, and no attention shape that was not held
      against plain above; the metrics finite; student, scorer and disc
      changed; the teacher bit-equal to its start; the saved npz files
      reload equal. Peak max_memory_allocated. Then, on the trained state,
      4 more iterations step by step, the first with the gates shut: each
      step's launches, in all and by shape (the conformers' against the
      derived counts), and the median ms of the last 3; in fp32 one
      iteration's host dispatch and wall, and one profiled iteration's
      device busy time and idle share. Each held shape's launches an
      iteration, as counted, go into its row of the kernels line."""
    import contextlib
    import dataclasses
    import shutil
    import statistics
    import tempfile

    import numpy as np

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.models.asr import ASRConfig, init_asr
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.discriminator import DiscriminatorConfig, init_discriminator
    from smalltts_tpu_torch.models.sv import SVConfig, init_sv
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels import attention as A
    from smalltts_tpu_torch.ops.precision import cast_floats
    from smalltts_tpu_torch.train import distill as D
    from smalltts_tpu_torch.train.optim import distill_optimizer
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_meta
    from smalltts_tpu_torch.utils.convert import params_from_jax

    attn = next(e for e in entries if e["name"] == "attention")
    t_phase = time.perf_counter()
    base = BackboneConfig()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, remat=True))
    disc_cfg = DiscriminatorConfig(transformer_dim=cfg.hidden_dim, ref_dim=cfg.hidden_dim)
    asr_cfg, sv_cfg = ASRConfig(input_dim=cfg.latent_dim), SVConfig(input_dim=cfg.latent_dim)
    data = DummyDataConfig(batch_size=2)
    print("phase train distill: train_distill, default BackboneConfig with remat (student, scorer, teacher), "
          "DiscriminatorConfig(960, 960), ASRConfig(64), SVConfig(64), seed 0, dummy loader; attention at the "
          "new shapes first", flush=True)

    # ------------------------------------------------ the attention at the distiller's shapes
    g = torch.Generator(device=dev).manual_seed(4)
    s_disc = 3 * data.max_latents + data.max_ref + data.max_phonemes
    n_asr = 4 * data.max_latents
    # (label, dtype, B, H, Tq, S, D): every shape the train_distill runs below send, each held here
    # (they check that no other is launched). The ASR's (fp32: the ASR runs on the upcast x0 in both
    # runs; bf16 as well, which no run sends) and the discriminator's at batch 4 (the disc step) and 2
    # (the student's GAN loss); the backbone's at batch 2 (student, scorer, disc features) and the
    # teacher's 3x CFG batch of 6, fp32 and bf16: in bf16 there the (b, h, q tile) blocks alone leave
    # SMs idle and the kernel splits the keys across a cluster (the teacher phase's B=16 is one split)
    shapes = [("asr T=1024", dt, 2, 16, n_asr, n_asr, 4) for dt in (torch.float32, torch.bfloat16)]
    shapes += [(f"disc S={s_disc}", torch.float32, B, 8, s_disc, s_disc, 64) for B in (4, 2)]
    shapes += [(label, dt, B, H, Tq, S, D_) for dt in (torch.float32, torch.bfloat16) for B in (2, 6)
               for label, H, Tq, S, D_ in (("text P=198", 4, 198, 198, 128), ("style R=64", 8, 64, 64, 64),
                                           ("dit T=256 + 64 + 198", 8, 256, 518, 120))]

    def shape_key(B, H, Tq, S, D_, kind):
        return f"B={B} H={H} Tq={Tq} S={S} D={D_} {kind}"

    def shape_counts():
        """kernels.SHAPE_LAUNCHES of the attention, by shape_key."""
        return {shape_key(*k[:5], "bf16" if k[5] == torch.bfloat16 else "fp32"): n
                for (name, k), n in kernels.SHAPE_LAUNCHES.items() if name == "attention"}

    def device_times(fn, n=3):
        """n device-clock times (ms) of fn's kernel from separate profiled
        calls of `timed`; a call whose trace lost records is taken again,
        up to 2n calls, and fewer than n device readings fail the run."""
        got = []
        for _ in range(2 * n):
            ms, _, clock = timed(fn, 20, ATTN_KERNELS)
            if clock == "device":
                got.append(ms)
                if len(got) == n:
                    break
        check(len(got) == n, f"attention: {len(got)} of {n} device-clock times")
        return got

    rows = []
    for label, dtype, B, H, Tq, S, D_ in shapes:
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v = (torch.randn((B, H, n, D_), generator=g, device=dev).to(dtype) for n in (Tq, S, S))
        dout = torch.randn((B, H, Tq, D_), generator=g, device=dev).to(dtype)
        m = torch.arange(S, device=dev)[None] < torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)[:, None]
        kernels.reset_launches()
        got = A.fused_attention(q, k, v, m)
        check(kernels.LAUNCHES.get("attention", 0) == 1, f"attention {label} {kind}: the kernel was not launched")
        want = A.attention_plain(q, k, v, m)
        abs_e = float((got.float() - want.float()).abs().max())
        rel_e = abs_e / float(want.float().abs().max())
        check(rel_e <= DISTILL_FWD_TOL[str(dtype).split(".")[-1]], f"attention {label} {kind}: rel err {rel_e:.3e}")
        mg = m.clone()
        mg[-1] = False  # a fully-masked row: no gradient to its q or k
        grads = []
        for fn in (A.attention, A.attention_plain):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            grads.append(torch.autograd.grad(fn(*leaves, mg), leaves, dout))
        grad_err = {n: float((a.float() - b_.float()).abs().max() / b_.float().abs().max())
                    for n, a, b_ in zip(("dq", "dk", "dv"), *grads)}
        check(max(grad_err.values()) <= TRAIN_GRAD_TOL[str(dtype).split(".")[-1]]
              and float(grads[0][0][-1].abs().max()) == 0.0, f"attention Function {label} {kind}: {grad_err}")
        del grads, leaves
        ms_runs = device_times(lambda: A.fused_attention(q, k, v, m))
        plain_ms = timed(lambda: A.attention_plain(q, k, v, m), 10)[0]
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None, None, :]),
                       20)[0]
        b_ms, b_by = bound(nbytes(q, k, v, m, got), 4.0 * B * H * Tq * S * D_, attn_kind(dtype, D_))
        row = dict(shape=f"{label} B={B} H={H} D={D_}", key=shape_key(B, H, Tq, S, D_, kind), dtype=kind, max_abs_err=abs_e,
                   rel_err=rel_e, grad_rel_err=grad_err, ms=statistics.median(ms_runs), ms_runs=ms_runs,
                   clock="device", plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        rows.append(row)
        print("  attention at the distiller's shapes: " + json.dumps(row), flush=True)
        del q, k, v, dout, got, want
    attn["head_dims"] = list(A.HEAD_DIMS)
    attn["distill_shapes"] = rows
    for D_bad in (8, 32):  # any other head dim still raises
        z = torch.zeros((1, 1, 4, D_bad), device=dev)
        try:
            A.fused_attention(z, z, z, torch.ones((1, 4), dtype=torch.bool, device=dev))
        except ValueError:
            continue
        raise AssertionError(f"attention with head dim {D_bad} did not raise")

    # --------------------------------------------------------- weights, batches
    gen = torch.Generator(device=dev).manual_seed(0)
    teacher = redraw_zero_init(init_backbone(gen, cfg, device=dev), gen)
    disc = init_discriminator(gen, disc_cfg, device=dev)
    asr = init_asr(gen, asr_cfg, device=dev)
    sv = init_sv(gen, sv_cfg, device=dev)
    n_params = {k: sum(t.numel() for t in ckpt.flatten_pytree(v).values()) for k, v in
                (("backbone", teacher), ("disc", disc), ("asr", asr), ("sv", sv))}
    print(f"  params: {json.dumps(n_params)}", flush=True)

    def batch_of(seed):
        return {k: torch.as_tensor(v, device=dev) for k, v in dummy_batch(np.random.default_rng(seed), data).items()
                if k != "texts"}

    # ------------------------------------------------------------ kernels vs plain
    class Capture:
        """An optimizer that records the gradients and leaves the params."""

        def init(self, params):
            return {}

        def update(self, grads, state, params):
            self.grads = grads
            return ckpt.map_pytree(torch.zeros_like, grads), state

    batch = batch_of(11)
    dgen = torch.Generator(device=dev).manual_seed(12)
    sd, dd, scd = D.student_draws(dgen, batch), D.disc_draws(dgen, batch), D.scorer_draws(dgen, batch, 1)
    tcfg = D.DistillConfig(asr_start_step=0, sv_start_step=0, scorer_updates=1)
    res = []
    for plain in (False, True):
        txs = (Capture(), Capture(), Capture())
        with kernels.force_plain() if plain else contextlib.nullcontext():
            _, _, carry, metrics = D.make_student_step(cfg, disc_cfg, asr_cfg, sv_cfg, txs[0], tcfg)(
                teacher, {}, teacher, teacher, disc, asr, sv, batch, 1, sd)
            _, _, d_loss = D.make_disc_step(cfg, disc_cfg, txs[1])(disc, {}, teacher, batch, carry, dd)
            _, _, s_loss = D.make_scorer_step(cfg, txs[2], 1)(teacher, {}, teacher, batch, carry, scd)
        res.append(({**{k: float(v) for k, v in metrics.items()}, "disc_loss": float(d_loss),
                     "scorer_loss": float(s_loss)},
                    {n: ckpt.flatten_pytree(t.grads) for n, t in zip(("student", "disc", "scorer"), txs)}))
        del carry, txs
    (mk, gk), (mp_, gp) = res
    loss_err = {k: abs(mk[k] - mp_[k]) / max(abs(mp_[k]), 1e-30) for k in mk}
    grad_err = {}
    for net, flat in gk.items():
        sums = {}
        for n, gr in flat.items():
            mod = "/".join(n.split("/")[:2])
            a, c = sums.get(mod, (0.0, 0.0))
            sums[mod] = (a + float((gr - gp[net][n]).norm()) ** 2, c + float(gp[net][n].norm()) ** 2)
        grad_err[net] = {mod: (a / max(c, 1e-60)) ** 0.5 for mod, (a, c) in sums.items() if c > 0}
    worst = {net: max(e.values()) for net, e in grad_err.items()}
    print(f"  kernels vs plain, fp32 batch 2, one student (gates open), disc and scorer step: metrics {json.dumps(mk)}; "
          f"relative error (tolerance {DISTILL_LOSS_TOL}): {json.dumps({k: float(f'{v:.3e}') for k, v in loss_err.items()})}; "
          f"worst module gradient rel-L2 (tolerance {DISTILL_GRAD_TOL}): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}", flush=True)
    check(all(np.isfinite(v) for v in mk.values()) and mk["st_asr"] > 0 and mk["st_sv"] > 0,
          f"distill metrics {mk}")
    check(max(loss_err.values()) <= DISTILL_LOSS_TOL, f"distill metrics kernels vs plain: {loss_err}")
    check(max(worst.values()) <= DISTILL_GRAD_TOL, f"distill gradients kernels vs plain: {grad_err}")
    attn["distill_kernels_vs_plain"] = dict(metrics=mk, metrics_rel_err=loss_err, grad_rel_l2_worst=worst)
    del res, gk, gp

    # the CTC loss alone at the student step's shape (a Python loop over the ASR's frames): host time
    # of its forward and backward, synchronized, median of 3
    from smalltts_tpu_torch.ops.losses import ctc_loss
    from smalltts_tpu_torch.ops.masking import length_mask

    n_frames = 4 * data.max_latents
    logits = torch.randn((2, n_frames, asr_cfg.vocab), generator=g, device=dev)
    logit_pad = 1.0 - length_mask(4 * batch["latents_lengths"], n_frames).float()
    label_pad = 1.0 - length_mask(batch["phonemes_lengths"], data.max_phonemes).float()
    ctc_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = logits.clone().requires_grad_(True)
        ctc_loss(x, logit_pad, batch["phonemes"], label_pad).sum().backward()
        torch.cuda.synchronize()
        ctc_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  ctc_loss forward and backward, (2, {n_frames}, {asr_cfg.vocab}) over {data.max_phonemes} labels: "
          f"{json.dumps(ctc_ms)} ms", flush=True)
    attn["distill_ctc_ms"] = ctc_ms
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- train_distill
    want = {gates: distill_attention_launches(cfg, disc_cfg, asr_cfg, D.DistillConfig().scorer_updates, gates)
            for gates in (False, True)}
    per_iter = {gates: sum(w.values()) for gates, w in want.items()}
    # the conformers' launches by step and shape, derived likewise: the ASR's layers in a student step
    # with the gates open, the discriminator's at batch 2 there and at batch 4 in the disc step
    asr_key = shape_key(2, 16, n_asr, n_asr, 4, "fp32")
    disc_keys = {b_: shape_key(b_, 8, s_disc, s_disc, 64, "fp32") for b_ in (2, 4)}
    n_disc = disc_cfg.conformer.num_layers
    want_conf = {gates: {"student": {asr_key: asr_cfg.conformer.num_layers if gates else 0, disc_keys[2]: n_disc},
                         "disc": {disc_keys[4]: n_disc}, "scorer": {}} for gates in (False, True)}
    row_keys = {r["key"] for r in rows}
    start = {k: {n: t.clone() for n, t in ckpt.flatten_pytree(v).items()} for k, v in (("teacher", teacher),
                                                                                         ("disc", disc))}

    def conformer_counts(counts):
        return {k: n for k, n in counts.items() if k == asr_key or k in disc_keys.values()}

    def breakdown(tcfg, student, scorer, disc_p, teacher_p, profile):
        """Four more iterations on the trained state, step by step (each
        step synchronized and timed, its attention launches counted, in all
        and by shape): the first at step 0 (the gates shut), three at step
        10 (open; the step ms medians are theirs). With `profile` one more
        iteration's host dispatch (queued, unsynchronized) and wall, and
        one profiled."""
        txs = (distill_optimizer(student), distill_optimizer(disc_p), distill_optimizer(scorer))
        opts = [tx.init(p) for tx, p in zip(txs, (student, disc_p, scorer))]
        steps = (D.make_student_step(cfg, disc_cfg, asr_cfg, sv_cfg, txs[0], tcfg),
                 D.make_disc_step(cfg, disc_cfg, txs[1], tcfg.compute_dtype),
                 D.make_scorer_step(cfg, txs[2], tcfg.scorer_updates, tcfg.compute_dtype))
        bgen = torch.Generator(device=dev).manual_seed(21)
        state = {"student": student, "disc": disc_p, "scorer": scorer}

        def iteration(b, step, timer=None):
            nonlocal opts
            sdraw, ddraw, scdraw = (D.student_draws(bgen, b), D.disc_draws(bgen, b),
                                    D.scorer_draws(bgen, b, tcfg.scorer_updates))

            def mark(name):
                if timer is not None:
                    torch.cuda.synchronize()
                    timer.append((name, kernels.LAUNCHES.get("attention", 0), shape_counts(), time.perf_counter()))

            mark("start")
            state["student"], opts[0], carry, _ = steps[0](state["student"], opts[0], teacher_p, state["scorer"],
                                                           state["disc"], asr, sv, b, step, sdraw)
            mark("student")
            state["disc"], opts[1], _ = steps[1](state["disc"], opts[1], state["scorer"], b, carry, ddraw)
            mark("disc")
            state["scorer"], opts[2], _ = steps[2](state["scorer"], opts[2], state["student"], b, carry, scdraw)
            mark("scorer")

        b = batch_of(22)
        per_step = {"student": [], "disc": [], "scorer": [], "iteration": []}
        launches = {"gates shut": {}, "gates open": []}
        by_shape = {}
        for i, step in enumerate((0, 10, 10, 10)):
            gates = "gates open" if step > tcfg.asr_start_step else "gates shut"
            timer, counts = [], {}
            iteration(b, step, timer)
            for (_, n0, s0, t0_), (name, n1, s1, t1_) in zip(timer, timer[1:]):
                counts[name] = n1 - n0
                by_shape.setdefault(gates, {}).setdefault(name, {k: n - s0.get(k, 0) for k, n in s1.items()
                                                                 if n - s0.get(k, 0)})
                if i:
                    per_step[name].append((t1_ - t0_) * 1e3)
            if i:
                per_step["iteration"].append((timer[-1][3] - timer[0][3]) * 1e3)
                launches["gates open"].append(counts)
            else:
                launches["gates shut"] = counts
                shut_ms = (timer[-1][3] - timer[0][3]) * 1e3
        row = dict(step_ms=per_step, step_ms_median={k: statistics.median(v) for k, v in per_step.items()},
                   gates_shut_iteration_ms=shut_ms, step_launches=launches, step_launches_by_shape=by_shape)
        if not profile:
            return row
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iteration(b, 10)
        dispatch = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        # device activity only: an iteration is ~2e5 launches, whose host-side events the profiler
        # would take minutes to gather
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            iteration(b, 10)
            torch.cuda.synchronize()
        kern = sorted(((e.key, _dev_us(e) / 1e3, e.count) for e in prof.key_averages() if _dev_us(e) > 0),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in kern)
        attn_ms = sum(t for k_, t, _ in kern if any(m_ in k_ for m_ in ATTN_KERNELS))
        by_kernel = {m_[:-1]: sum(t for k_, t, _ in kern if m_ in k_) for m_ in ATTN_KERNELS}
        return dict(row, dispatch_ms=dispatch, wall_ms=wall, device_busy_ms=busy, idle_share=1.0 - busy / wall,
                    attention_kernel_ms=attn_ms, attention_ms_by_kernel=by_kernel, kernels=sum(c for _, _, c in kern),
                    top=[dict(kernel=k_[:90], ms=t, count=c) for k_, t, c in kern[:10]])

    tmp = tempfile.mkdtemp(prefix="distill_smoke_")
    runs = {}
    try:
        for dtype, save in (("float32", True), ("bfloat16", False)):
            steps = 3
            stamps, counts, shapes_seen, metrics_seen = [], [], [], []

            def on_step(step, metrics):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                counts.append(dict(kernels.LAUNCHES))
                shapes_seen.append(shape_counts())
                metrics_seen.append({k: float(v) for k, v in metrics.items()})

            tcfg = D.DistillConfig(num_steps=steps, batch_size=2, save_every=steps - 1 if save else 10 ** 9,
                                   asr_start_step=0, sv_start_step=0, compute_dtype=dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            student, scorer, disc_t, _ = D.train_distill(
                tcfg, cfg, disc_cfg, asr_cfg, sv_cfg, checkpoint_dir=tmp, seed=0, device=dev, on_step=on_step,
                params_override={"teacher": teacher, "asr": asr, "sv": sv, "disc": disc})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            cum = [c.get("attention", 0) for c in counts]
            iter_launches = [b_ - a_ for a_, b_ in zip([0] + cum, cum)]
            iter_shapes = [{k: n - prev.get(k, 0) for k, n in cur.items() if n - prev.get(k, 0)}
                           for prev, cur in zip([{}] + shapes_seen, shapes_seen)]
            want_iter = [per_iter[s > tcfg.asr_start_step] for s in range(steps)]
            check(iter_launches == want_iter and set(launches) == {"attention"},
                  f"train distill {dtype}: attention launches by iteration {iter_launches}, want {want_iter}; "
                  f"all launches {launches}")
            unheld = set().union(*iter_shapes) - row_keys
            check(not unheld, f"train distill {dtype}: attention launched at shapes not held against plain: {unheld}")
            check(all(np.isfinite(v) for m_ in metrics_seen for v in m_.values()),
                  f"train distill {dtype}: metrics {metrics_seen}")
            flat = {n: ckpt.flatten_pytree(t) for n, t in (("student", student), ("scorer", scorer),
                                                            ("disc", disc_t), ("teacher", teacher))}
            for n, ref in (("student", start["teacher"]), ("scorer", start["teacher"]), ("disc", start["disc"])):
                changed = sum(not torch.equal(flat[n][k], v) for k, v in ref.items())
                check(changed > 0, f"train distill {dtype}: {n} did not change")
            check(all(torch.equal(flat["teacher"][k], v) for k, v in start["teacher"].items()),
                  f"train distill {dtype}: the teacher changed")
            iter_ms = [(b_ - a_) * 1e3 for a_, b_ in zip(stamps, stamps[1:])]
            row = dict(dtype=dtype, batch=2, iterations=steps, metrics=metrics_seen, iteration_ms=iter_ms,
                       iteration_ms_median=statistics.median(iter_ms), wall_s=wall, peak_memory_bytes=peak,
                       attention_launches_by_iteration=iter_launches, attention_launches_by_shape=iter_shapes)
            if save:
                t_load = time.perf_counter()
                for name, tree, cfg_ in (("student_latest.npz", student, cfg), ("scorer_latest.npz", scorer, cfg),
                                         ("discriminator_latest.npz", disc_t, disc_cfg)):
                    path = os.path.join(tmp, name)
                    if cfg_ is cfg:
                        check(backbone_config_from_meta(ckpt.load_meta(path)) == cfg, f"{name}: metadata config")
                    back = ckpt.flatten_pytree(params_from_jax(ckpt.load_pytree(path), cfg_))
                    ref = ckpt.flatten_pytree(tree)
                    check(back.keys() == ref.keys() and all(torch.equal(back[k], ref[k].cpu()) for k in ref),
                          f"{name} does not reload equal")
                row["saved_bytes"] = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)
                                         if f.endswith(".npz"))
                row["reload_s"] = time.perf_counter() - t_load
            teacher_p = cast_floats(teacher, torch.bfloat16) if dtype == "bfloat16" else teacher
            kernels.reset_launches()
            row["breakdown"] = breakdown(tcfg, student, scorer, disc_t, teacher_p, profile=save)
            step_l, step_s = row["breakdown"]["step_launches"], row["breakdown"]["step_launches_by_shape"]
            check(step_l["gates shut"] == want[False] and all(c == want[True] for c in step_l["gates open"]),
                  f"train distill {dtype}: attention launches by step {step_l}, want {want}")
            for gates, name in ((g_, n_) for g_ in (False, True) for n_ in ("student", "disc", "scorer")):
                got_c = conformer_counts(step_s["gates open" if gates else "gates shut"][name])
                want_c = {k: n for k, n in want_conf[gates][name].items() if n}
                check(got_c == want_c, f"train distill {dtype}: {name} step, gates {'open' if gates else 'shut'}: "
                      f"conformer attention launches {got_c}, want {want_c}")
            med = row["breakdown"]["step_ms_median"]["iteration"]
            row["latent_frames_per_s"] = 2 * data.max_latents / (med / 1e3)
            print(f"  train_distill {dtype} batch 2: {json.dumps(row)}", flush=True)
            runs[f"{dtype} B2"] = row
            del student, scorer, disc_t, flat, teacher_p
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # each shape's launches an iteration, as counted in the runs (iteration 0: the gates shut; 1: open)
    for r in rows:
        r["launches_per_iteration"] = {k: {"gates shut": run["attention_launches_by_shape"][0].get(r["key"], 0),
                                           "gates open": run["attention_launches_by_shape"][1].get(r["key"], 0)}
                                       for k, run in runs.items()}
    attn["train_distill"] = runs
    attn["launches_train_distill"] = {k: r["attention_launches_by_iteration"] for k, r in runs.items()}
    del teacher, disc, asr, sv
    torch.cuda.empty_cache()
    print(f"  attention launches an iteration by shape: "
          f"{json.dumps({r['key']: r['launches_per_iteration'] for r in rows})}", flush=True)
    print(f"  phase train distill: {time.perf_counter() - t_phase:.2f} s", flush=True)


def profile_batch(fn):
    """(device busy ms, [(kernel, ms, count)] by time) of one call of `fn`
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    kern = sorted(((e.key, _dev_us(e) / 1e3, e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA") and _dev_us(e) > 0), key=lambda r: -r[1])
    return sum(r[1] for r in kern), kern


def graph_pool_bytes(torch, tts):
    """Bytes of the memory segments in the pipeline's shared graph pool, from
    the allocator's snapshot; None where the snapshot names no pools."""
    pool = tuple(tts._graph_pool) if tts._graph_pool is not None else None
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs if tuple(sg.get("segment_pool_id", ())) == pool)


def multipart_form(fields, boundary="smokeboundary"):
    body = b"".join(f'--{boundary}\r\nContent-Disposition: form-data; name="{n}"\r\n\r\n'.encode() + v + b"\r\n"
                    for n, v in fields)
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def wav_format(body):
    """(channels, sample rate, bits per sample) of a 44-byte PCM WAV header."""
    import struct

    return struct.unpack_from("<H", body, 22)[0], struct.unpack_from("<I", body, 24)[0], \
        struct.unpack_from("<H", body, 34)[0]


def http(port, method, path, body=b"", headers=None):
    """One HTTP/1.1 request on a socket of its own -> (status, headers, body,
    time of the first body chunk). A chunked body comes back as the list of
    its chunks."""
    import socket

    hdrs = {"host": "127.0.0.1", "content-length": str(len(body)), "connection": "close", **(headers or {})}
    with socket.create_connection(("127.0.0.1", port), timeout=600) as sock:
        sock.sendall(f"{method} {path} HTTP/1.1\r\n".encode()
                     + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items()).encode() + b"\r\n" + body)
        f = sock.makefile("rb")
        status = int(f.readline().split()[1])
        got = {}
        while True:
            line = f.readline()
            if line in (b"\r\n", b""):
                break
            k, v = line.decode("latin-1").split(":", 1)
            got[k.strip().lower()] = v.strip()
        if got.get("transfer-encoding") == "chunked":
            chunks, t_first = [], None
            while True:
                size = int(f.readline().split(b";")[0], 16)
                if size == 0:
                    break
                chunks.append(f.read(size))
                f.readline()
                t_first = t_first or time.perf_counter()
            return status, got, chunks, t_first
        data = f.read(int(got.get("content-length", 0)))
        return status, got, data, time.perf_counter()


def _arg(flag):
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else None


def serve_requests():
    """The serve phases' 10 requests, from seed 0: (durations, waveforms,
    phoneme ids)."""
    import numpy as np

    from smalltts_tpu_torch.data.bucketing import SAMPLE_RATE

    rs = np.random.RandomState(0)
    durations = [2.0, 5.0] * 5
    waves = [(0.1 * rs.randn(int(rs.uniform(2.0, 6.0) * SAMPLE_RATE))).astype(np.float32) for _ in durations]
    ids = [rs.randint(1, 198, size=int(rs.randint(40, 201))).tolist() for _ in durations]
    return durations, waves, ids


def full_width_tts(torch, dev, r_gate=False, **opts):
    """SmallTTS at full width (default BackboneConfig / CodecConfig, bf16) on
    weights drawn from seed 0; with `r_gate`, an IMF checkpoint of the same
    weights: an r_gate leaf drawn next from N(0, 0.1)."""
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init

    gb = torch.Generator(device=dev).manual_seed(0)
    params = redraw_zero_init(init_backbone(gb, BackboneConfig(), device=dev), gb)
    if r_gate:
        params["r_gate"] = 0.1 * torch.randn((BackboneConfig().hidden_dim,), generator=gb, device=dev)
    return SmallTTS(params, pcm16_out=True, seed=0, **opts)


def padded_batch(tts):
    """The serve requests' first 8 references and phoneme ids (each repeated
    to 200), at 5 s, padded as the batcher pads them: the bucket (8, r 64,
    p 384, t 40). Returns synthesize_padded's positional arguments."""
    from smalltts_tpu_torch.serving.batcher import Request, pad_group

    _, waves, ids = serve_requests()
    group = [Request(tts.encode_reference(w), (tok * 4)[:200], 5.0) for w, tok in zip(waves[:8], ids[:8])]
    args = pad_group(group, 8)[:6]
    check(bucket_key(args) == (8, 64, 384, 40), f"padded batch bucket {bucket_key(args)}")
    return args


def bucket_key(args):
    """(batch, r, p, t) of synthesize_padded's positional arguments."""
    return (len(args[4]), args[0].shape[1], args[2].shape[1], args[5])


def eager_batch(tts, args, noises=None, fetch=False):
    """The pipeline's eager synthesize fn (what its graphs capture) on one
    padded batch, with `noises` or the pipeline's generator's."""
    import torch

    ref, ref_lens, ph, ph_lens, seq_lens, t_bucket = args
    with torch.inference_mode():
        out = tts._synthesize_fn(tts.params, tts.codec_params, tts._tensor(ref, tts.dtype),
                                 tts._tensor(ref_lens, torch.int32), tts._tensor(ph, torch.int64),
                                 tts._tensor(ph_lens, torch.int32), tts._tensor(seq_lens, torch.int32),
                                 tts._noises(len(seq_lens), t_bucket) if noises is None else noises,
                                 t_bucket=t_bucket)
    return out.cpu().numpy() if fetch else out


def graph_timing(torch, tts, args, n=5):
    """One padded batch as its CUDA graph (captured here if new): host
    dispatch and wall ms of `n` batches (batch_host_ms), and the graph alone
    on the device clock, CUDA events around replay(), `n` times."""

    def one_batch(fetch=True):
        return tts.synthesize_padded(*args, fetch=fetch)

    one_batch()
    dispatch, walls = batch_host_ms(one_batch, n)
    graph = tts._graphs[bucket_key(args)].graph
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spans = []
    for _ in range(n):
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        spans.append(e0.elapsed_time(e1))
    return dict(dispatch_ms=dispatch, wall_ms=walls, graph_spans_ms=spans, dispatch_ms_median=_median(dispatch),
                wall_ms_median=_median(walls), graph_span_ms=_median(spans))


def graph_launches(tts, replays0):
    """(launches, replays) of the pipeline's CUDA graphs since `replays0`
    ({bucket: replays} taken before): each graph's counts, taken while it
    was captured, times its replays since then."""
    total, n = {}, 0
    for key, g in tts._graphs.items():
        k = g.replays - replays0.get(key, 0)
        n += k
        for name, v in g.launches.items():
            total[name] = total.get(name, 0) + v * k
    return {name: v for name, v in total.items() if v}, n


def batch_host_ms(one_batch, n):
    """(dispatch, wall) ms of `n` batches: dispatch is the host time to queue
    a batch (one_batch(fetch=False)), wall the time until its waveform is on
    the host."""
    dispatch, walls = [], []
    for _ in range(n):
        t_b = time.perf_counter()
        audio = one_batch(fetch=False)
        dispatch.append((time.perf_counter() - t_b) * 1e3)
        audio.cpu()
        walls.append((time.perf_counter() - t_b) * 1e3)
    return dispatch, walls


def worker(torch, batches=5):
    """One turn of --compare, in a process of its own: builds the kernels and
    the full-width bf16 model of the package on sys.path, then prints one
    JSON line: the host dispatch and wall ms of `batches` padded batches of 8
    (t 40, ref 64, phoneme 384), the wrappers' host ms per call and the
    scan's device ms (scan_device_ms)."""
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.serving.batcher import pad_group, Request

    dev = torch.device("cuda")
    kernels.build_all()
    tts = full_width_tts(torch, dev)
    durations, waves, ids = serve_requests()
    group = [Request(tts.encode_reference(w), tok, d) for w, tok, d in zip(waves[:8], ids[:8], durations[:8])]
    args = pad_group(group, 8)[:6]

    def one_batch(fetch=True):
        return tts.synthesize_padded(*args, fetch=fetch)

    if hasattr(tts, "warmup"):  # a tree with CUDA graphs: the bucket's graph is captured here
        tts.warmup(batch_sizes=(8,), t_buckets=(args[5],), r_buckets=(args[0].shape[1],),
                   p_buckets=(args[2].shape[1],))
    for _ in range(2):  # warm-up: cuDNN picks its algorithms, the tables are made
        one_batch()
    dispatch, walls = batch_host_ms(one_batch, batches)
    print(json.dumps({"buckets": [args[5], args[0].shape[1], args[2].shape[1]], "dispatch_ms": dispatch,
                      "wall_ms": walls, "wrapper_host_ms": wrapper_host_ms(torch, dev),
                      "device_ms": scan_device_ms(torch, dev)}), flush=True)
    return 0


def compare(other, blocks=3):
    """--compare DIR: see the module docstring. `blocks` runs of the turns
    DIR, this, this, DIR; every turn is a fresh worker process, so what one
    process's placement on the host costs is spread over the turns."""
    trees = {"parent": os.path.abspath(other), "change": os.path.dirname(os.path.abspath(__file__))}
    print(f"card: {card_line()}", flush=True)
    res = {n: [] for n in trees}
    for _ in range(blocks):
        for name in ("parent", "change", "change", "parent"):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[name]],
                               capture_output=True, text=True, timeout=600)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                raise RuntimeError(f"compare: the {name} worker failed (exit {p.returncode}):\n{p.stderr[-3000:]}")
            res[name].append(json.loads(lines[-1]))
            print(f"turn {name}: {lines[-1]}", flush=True)
    # each adjacent pair of turns (parent, change or change, parent) ran at nearly one host speed
    pairs = [(res["change"][i]["dispatch_ms"], res["parent"][i]["dispatch_ms"], res["change"][i]["wall_ms"],
              res["parent"][i]["wall_ms"]) for i in range(2 * blocks)]
    summary = {"change_minus_parent_ms": {
        "dispatch_pairs": [_median(c) - _median(p) for c, p, _, _ in pairs],
        "wall_pairs": [_median(c) - _median(p) for _, _, c, p in pairs]}}
    for name, turns in res.items():
        summary[name] = {
            "batches": sum(len(t["wall_ms"]) for t in turns),
            "dispatch_ms_median": _median([x for t in turns for x in t["dispatch_ms"]]),
            "wall_ms_median": _median([x for t in turns for x in t["wall_ms"]]),
            "dispatch_ms_turn_medians": [_median(t["dispatch_ms"]) for t in turns],
            "wall_ms_turn_medians": [_median(t["wall_ms"]) for t in turns],
            "wrapper_host_ms": {k: [t["wrapper_host_ms"][k] for t in turns] for k in turns[0]["wrapper_host_ms"]}}
    # device ms: each tree's turns and median, and change minus parent in each adjacent pair
    summary["device_ms"] = {
        k: {"parent_median": _median([t["device_ms"][k] for t in res["parent"]]),
            "change_median": _median([t["device_ms"][k] for t in res["change"]]),
            "pairs": [res["change"][i]["device_ms"][k] - res["parent"][i]["device_ms"][k] for i in range(2 * blocks)],
            "parent": [t["device_ms"][k] for t in res["parent"]], "change": [t["device_ms"][k] for t in res["change"]]}
        for k in res["change"][0]["device_ms"]}
    print(json.dumps({"compare": summary}))
    return 0


def _median(xs):
    xs = sorted(xs)
    return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2


def wrapper_host_ms(torch, dev, calls=1000):
    """Host time per call (ms, median of `calls`) at served shapes of the
    qkvg product's two wrappers (gemm_bias, then qk_norm_rope), each alone
    and the pair, the attention's, and adaln_modulate's as a control: the
    Python checks, the ctypes call and the C launch code. The device runs
    behind; it is drained every 50 calls, outside the timed calls."""
    from smalltts_tpu_torch.ops.kernels import attention as A
    from smalltts_tpu_torch.ops.kernels import dit_block as K

    g = torch.Generator(device=dev).manual_seed(1)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    a, w, b = r(8, 40, 960), r(960, 3840), r(3840)
    qkvg, qs, cos = r(8, 40, 3840), r(8, 120), torch.ones((40, 64), device=dev)
    q, k, v, gate, k2, v2 = r(8, 8, 40, 120), r(8, 8, 40, 120), r(8, 8, 40, 120), r(8, 8, 40, 120), \
        r(8, 8, 448, 120), r(8, 8, 448, 120)
    m1, m2 = torch.ones((8, 40), dtype=torch.bool, device=dev), torch.ones((8, 448), dtype=torch.bool, device=dev)
    shift = r(8, 960)
    res = {}
    for name, fn in ((WRAPPER_KEYS["gemm_bias"], lambda: K.gemm_bias(a, w, b)),
                     (WRAPPER_KEYS["qk_norm_rope"], lambda: K.qk_norm_rope(qkvg, qs, qs, cos, cos)),
                     ("qkvg product + q/k norm M=320", lambda: K.qk_norm_rope(K.gemm_bias(a, w, b), qs, qs, cos, cos)),
                     (WRAPPER_KEYS["attention"], lambda: A.fused_attention(q, k, v, m1, k2, v2, m2, gate=gate)),
                     ("adaln_modulate M=320 (control)", lambda: K.adaln_modulate(a, shift, shift))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ts = []
        for i in range(calls):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
            if i % 50 == 49:
                torch.cuda.synchronize()
        res[name] = sorted(ts)[len(ts) // 2] * 1e3
    return res


def scan_device_ms(torch, dev):
    """Device ms per launch (torch.profiler) of the scan's kernels at both
    served row counts (M = 320 and 128), and per call of the 12-layer scan
    B8 T40 Sc192, bf16 and int8 stream weights, on seeded random inputs, for
    the package on sys.path: --compare makes the same calls in either tree.
    Each kernel is timed over the 12 layers' weights, as in phase B."""
    from smalltts_tpu_torch.models.dit import (DiTConfig, fuse_serving_projections, init_dit,
                                               quantize_stream_weights, rope_cos_sin)
    from smalltts_tpu_torch.ops.kernels import dit_block as K

    g = torch.Generator(device=dev).manual_seed(2)
    cfg = DiTConfig()
    B, Sc, L, H, heads, hd, F = 8, 192, cfg.n_blocks, cfg.hidden_dim, cfg.heads, cfg.head_dim, cfg.ff_dim

    def r(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)

    blocks = fuse_serving_projections({"dit": init_dit(g, cfg, torch.bfloat16, dev)})["dit"]["blocks"]
    trees = {"": blocks, " int8": quantize_stream_weights({"blocks": blocks})["blocks"]}
    mods = r((L, 6 * H), 0.5)[:, None, :].expand(L, B, 6 * H)
    qs, ks = blocks["attn"]["q_norm"]["scale"], blocks["attn"]["k_norm"]["scale"]
    ck, cv = r((L, B, heads, Sc, hd)), r((L, B, heads, Sc, hd))
    cmask = torch.arange(Sc, device=dev)[None] < torch.randint(Sc // 2, Sc + 1, (B, 1), generator=g, device=dev)

    def over_layers(fn):
        return lambda: [fn(l) for l in range(L)]

    def prod(fn, lin, a, *rest):
        """fn(a, w, b, *rest, w_scale) on layer l's weight of the leaf `lin`, bf16 or int8."""
        def run(l):
            w, s = (lin["w_q"][l], lin["scale"][l]) if "w_q" in lin else (lin["w"][l], None)
            return fn(a, w, lin["b"][l] if "b" in lin else None, *(f(l) for f in rest), w_scale=s)
        return run

    res = {}
    for T in (16, 40):  # the scan below runs on T = 40's inputs
        M = B * T
        x, mid, qkvg = r((B, T, H), 2.0), r((B, T, F)), r((B, T, 4 * H))
        mask = torch.ones((B, T), dtype=torch.bool, device=dev)
        cos, sin = rope_cos_sin(cfg, T, dev)
        calls = {f"adaln_modulate M={M}": (lambda l: K.adaln_modulate(x, mods[l][:, :H], mods[l][:, H:2 * H]),
                                           "adaln_kernel"),
                 f"qk_norm_rope M={M}": (lambda l: K.qk_norm_rope(qkvg, qs[l], ks[l], cos, sin), "qk_norm_rope_kernel")}
        for sfx, tree in trees.items():
            at, ff = tree["attn"], tree["ff"]
            calls.update({
                f"gemm_bias qkvg M={M}{sfx}": (prod(K.gemm_bias, at["qkvg"], x), "gemm_wgmma_kernel"),
                f"gemm_swiglu w13 M={M}{sfx}": (prod(K.gemm_swiglu, ff["w13"], x), "gemm_wgmma_kernel"),
                f"gemm_residual w2 M={M}{sfx}": (prod(K.gemm_residual, ff["w2"], mid, lambda l: x,
                                                      lambda l: mods[l][:, 5 * H:]), "gemm_wgmma_kernel"),
                f"gemm_residual to_out M={M}{sfx}": (prod(K.gemm_residual, at["to_out"], x, lambda l: x,
                                                          lambda l: mods[l][:, 2 * H:3 * H], lambda l: mask),
                                                     "gemm_wgmma_kernel")})
        for name, (fn, match) in calls.items():
            res[name] = timed(over_layers(fn), 5, (match,), per=L)[0]
    for sfx, tree in trees.items():
        res[f"scan B8 T40 Sc192{sfx}"] = timed(lambda: K.fused_dit_scan(
            x, mods, mask, ck, cv, cmask, tree, cos, sin, heads=heads, head_dim=hd), 10)[0]
    return res


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

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
   host time per call (median of 1000). Phase A, head dim 16 (see
   `attn_d16_phase`): attn_tf32_kernel<16> and attn_mma_kernel<16> against
   plain at the demo loop's shapes. Phase A, head dim 4 (see
   `attn_small_phase`): the ASR's attention kernel against plain at its
   (2, 16, 1024) in fp32 and bf16, timed against its bound (exponentials,
   multiply-adds over the live keys, or bytes: `small_bound`), at ragged
   lengths, masks with dead tiles between live ones, two gated sources and
   unaligned views, and attention_backward's time. Phase A, CTC (see `ctc_phase`):
   ops/losses.ctc_loss with the CTC kernels (csrc/ctc.cu) against the
   plain versions on the card at the trainers' (2, 1024, 198), feasible,
   repeated-label, infeasible, 384-label, switch, 512-, 4095-label, long
   and batch-8 batches, loss and gradient; ptxas's spills; kernel (the
   backward's factor blocks and chains also alone), plain, F.ctc_loss
   times and the chain floors. Phase A, codec (see
   `codec_pointwise_phase`): the codec decoder's pointwise pass against its
   plain version and the channel-last op chain, bit for bit, at the
   offline cell's largest batch; its time beside its bytes bound.
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
   at batch 2 in bf16. Then phases train asr and train sv (see
   `aux_trainer_phase`): train_asr and train_sv at full width, 5 steps at
   batch 2 with a save, exact launch counts, one step profiled, the ASR
   step against its plain versions, the voxceleb ECAPA teacher over the
   decoded batch; and phase train corpus (see `corpus_phase`): a synthetic
   corpus written, and the ASR trainer's command line with --data-dir on it
   in its own process. Then phase train distill (see `distill_phase`): the
   attention kernel at the distiller's shapes (the ASR's head dim 4, the
   discriminator's 1030 keys), one student, disc and scorer step against
   the plain versions, and train_distill at full width, 3 iterations at
   batch 2 in fp32 with a save and 2 in bf16, with the exact attention
   and CTC launches of each step. Last, phase train imf (see `imf_phase`):
   one fp32 IMF step against the plain versions, the bf16 teacher's
   rollout against its plain versions, and train_imf at full width,
   batch 2: plain in fp32 (with a save, served as IMF-2) and bf16,
   adversarial and DMD, with the exact attention launches of each
   iteration. Then the codec phases (see `codec_phases`), at the default
   CodecConfig (77.6M params) in fp32, where no kernel of the port may
   launch: train codec (train_codec at batch 8 x 25,600 samples, 7 steps
   with a save, one step profiled, one step on the card against the same
   step on the CPU with cuDNN's TF32 left at PyTorch's default), train
   codec distill (a second codec exported by onnxtorch.export as the ONNX
   teacher; the codec_distill command line with and without the encoder
   graph, then train_codec_distill at batch 4 x 22,400 samples timed and
   profiled in this process, with the teacher's share of the device time),
   serve trained codec (SmallTTS(codec_checkpoint=the distilled npz), one
   batch through its CUDA graph with its exact launches) and tools (the
   profile entry point's trace, compiled_cost and utilization of a codec
   decode, eval_quality --roundtrip on the distilled codec).
   Last, phase parallel (see `parallel_phase`), the port's data and tensor
   parallelism (smalltts_tpu_torch/parallel) in rank processes of this
   script (`--parallel-worker`): NCCL at world size 1 (SmallTTS(mesh=) at
   328M, bf16, batch (8, 64, 384, 40), its dp all-gather captured in the
   bucket's CUDA graph, against SmallTTS() on the same noise, bit for bit,
   with the serve phase's 68 attention and 384 scan launches); two gloo
   ranks on the one card (which collectives gloo runs on CUDA tensors, a
   256 MB all-reduce's time, a dp = 2 teacher step at 328M in fp32, global
   batch 2, against the single-process step; tp = 2 SmallTTS, eager,
   bf16 and int8, and fp32 latents on the split layout, against the
   single process); each kernel those launched at its shard shapes
   against its plain version, timed; and the four-rank dry run
   (smalltts_tpu_torch.scripts.dryrun_multihost) on CPU ranks.
   Last, phase scripts (see `scripts_phase`): the port's entry points
   (smalltts_tpu_torch/scripts) in this process at full width on the
   seed-0 weights: test_checkpoint (and --convert), clone with the served
   launch counts, interactive, batch, tryme without assets, phonemize,
   import_codec, test_x402 against a local-payments server, bench_serving
   (32 requests from process clients, and a streamed run) and
   demo_quality_loop on the card with its head-dim-16 attention and CTC
   launches.
   Then phase certify (see `certify_phase`): smalltts_tpu_torch.scripts.
   certify at full width on a fixture tree around the imported phase's
   four graphs (the CodecConfig() codec, the seed-0 328M backbone with the
   published graph contracts), with the backbone's npz and reference .pt
   and the graphs' reference latents as tryme latents: every stage passes
   but espeak_goldens (skips: no espeak), quality passes or fails on its
   mel threshold alone, its attention and scan launches counted; SmallTTS
   against the imported graphs on the imported stage's noise; the runs
   without assets and with a corrupt decoder. Phase ab (see `ab_phase`):
   both A/B scripts at their default cells, the split layout against the
   scan kernels, every line timing both arms. Last, phase imf (see
   `imf_exp_phase`): exp_imf_boundary and exp_imf_source on the synthetic
   corpus at cut step counts, with head-dim-16 attention launches.
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

    python3 chip_smoke.py --asr-compare DIR

times the ASR trainer's step (phase train asr's) of the package in DIR
against this one's, in turns DIR, this, this, DIR, twice, each a process
of its own (`--asr-worker DIR`): host dispatch, wall, device busy, idle
share and the CTC kernels' device time.

    python3 chip_smoke.py --attn-small [--attn-small-parent DIR]

runs phase A, head dim 4, alone, with a sweep of S = Tq over 256-4096 and
B x H over 8-128; with --attn-small-parent (here or in the whole run), the
head-dim-4 kernel of DIR (built here) beside this checkout's, held against
plain and timed in turns.

    python3 chip_smoke.py --codec

runs the codec phases alone, after the kernels' build.

    python3 chip_smoke.py --codec-pointwise

runs phase A, codec (the decoder's pointwise pass, `codec_pointwise_phase`)
alone, after the codec source's build.

    python3 chip_smoke.py --parallel

runs phase parallel alone, after the kernels' build.

    python3 chip_smoke.py --scripts

runs phase A at head dim 16 and phase scripts alone, after the kernels'
build.

    python3 chip_smoke.py --certify | --ab | --imf

runs phase certify, ab or imf alone, after the kernels' build.

    python3 chip_smoke.py --imf-quality

runs, after the kernels' build, tests/test_torch_imf_quality.py (the
corpus test's assertions at the harness's step counts, 300 / 800 / 150 /
400) on the card in a process of its own, and exits with pytest's code. The
default run does not.

    python3 chip_smoke.py --ctc [--ctc-parent DIR]

runs phase A, CTC alone, then the forward's sweep over N and the
backward's over the states a thread (`ctc_sweep`); with --ctc-parent, the
kernels of DIR (built here) against this checkout's, bit for bit and timed
in turns.
"""

from __future__ import annotations

import functools
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
CODEC_PASSES = 27  # codec_pointwise launches a decode of CodecConfig(): one after each convolution


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"


def bound(nbytes: float, flops: float, kind: str):
    t_bytes, t_ops = nbytes / MEM_BW, flops / PEAK[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_kind(dtype, D) -> str:
    """The peak an attention launch's bound is taken at: bf16 tensor cores,
    or fp32 through the 3xTF32 kernel. Head dim 4 runs on the CUDA cores in
    either dtype and has a bound of its own (small_bound)."""
    if D == 4:
        raise ValueError("a head dim of 4 is bounded by small_bound")
    return "bf16" if str(dtype).endswith("bfloat16") else "fp32_3xtf32"


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
    """(ms, clock): device time per call from torch.profiler over iters + 1
    calls, each of which launches `launches` kernels whose names hold one of
    `match`: their mean time per launch times `launches`; every kernel's
    time over the calls when `match` is None (clock "device").

    The card's traces drop kernel records at random (a trace of 21 calls
    has held 6 or 8 of their launches). A trace short of iters * launches
    records is taken again, 3 tries; after that the mean runs over the
    launches the fullest trace kept, still on the device clock. Where no
    trace kept one, the calls are timed by CUDA events behind a spin kernel
    that holds the stream until every call is queued (clock "events": the
    device's own timestamps with no host gap between the calls; it counts
    every kernel the call launches). (None, "wall") when the profiler sees
    no device time and the stream could not be held."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None  # (records, ms) of the fullest short trace
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters + 1):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if _dev_us(e) > 0]
        if match is None:
            if evts:
                return sum(_dev_us(e) for e in evts) / 1e3 / (iters + 1), "device"
            continue
        hits = [e for e in evts if any(m in e.key for m in match)]
        seen = sum(e.count for e in hits)
        if seen >= iters * launches:
            return sum(_dev_us(e) for e in hits) / 1e3 / seen * launches, "device"
        print(f"  (profiler trace holds {seen} of at least {iters * launches} launches: taken again)", flush=True)
        if seen and (best is None or seen > best[0]):
            best = (seen, sum(_dev_us(e) for e in hits) / 1e3 / seen * launches)
    if best is not None:
        print(f"  (device time: the mean over the {best[0]} launches the fullest trace kept)", flush=True)
        return best[1], "device"
    held = held_stream_ms(fn, iters)
    return (held, "events") if held is not None else (None, "wall")


def held_stream_ms(fn, iters):
    """Device ms per call from CUDA events around iters calls queued behind
    a spin kernel (torch.cuda._sleep) that outlasts their enqueueing: the
    spin's end event still pending once every call is queued proves the
    device ran the calls back to back. Sleeps 4x longer on each of 4 tries;
    None if the host never got ahead."""
    import torch

    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(host_s, 1e-3) * 4e9)  # 2x the enqueue time at up to 2 GHz
    for _ in range(4):
        e_held, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(cycles)
        e_held.record()
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        ahead = not e_held.query()
        torch.cuda.synchronize()
        if ahead:
            return e0.elapsed_time(e1) / iters
        cycles *= 4
    return None


DEVICE_CLOCKS = ("device", "events")


def timed(fn, iters, match=None, per=1):
    """(ms, wall ms, clock) per launch, `per` launches a call: ms is on the
    device's clock (see device_ms: clock "device" or "events"), or the
    event-timed wall time (clock "wall") where neither could be had."""
    wall = time_ms(fn, iters=iters) / per
    dev_t, clock = device_ms(fn, iters=iters, match=match, launches=per)
    return (wall, wall, "wall") if dev_t is None else (dev_t / per, wall, clock)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    # --worker DIR / --asr-worker DIR: one side of --compare / --asr-compare, the package in DIR
    other = _arg("--worker") or _arg("--asr-worker")
    sys.path.insert(0, os.path.abspath(other) if other else os.path.dirname(os.path.abspath(__file__)))
    try:
        import smalltts_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the smalltts_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    if other:
        return asr_worker(torch) if "--asr-worker" in sys.argv else worker(torch)
    if "--parallel-worker" in sys.argv:
        return parallel_worker(torch)
    if "--parallel" in sys.argv:
        return parallel_only(torch)
    if "--compare" in sys.argv:
        return compare(_arg("--compare"))
    if "--asr-compare" in sys.argv:
        return asr_compare(_arg("--asr-compare"))
    if "--ctc" in sys.argv:
        return ctc_only(torch)
    if "--attn-small" in sys.argv:
        return attn_small_only(torch)
    if "--codec" in sys.argv:
        return codec_only(torch)
    if "--codec-pointwise" in sys.argv:
        return codec_pointwise_only(torch)
    if "--scripts" in sys.argv:
        return scripts_only(torch)
    if "--imf-quality" in sys.argv:
        return imf_quality_only(torch)
    for flag, phase in (("--certify", certify_only), ("--ab", ab_phase), ("--imf", imf_exp_phase)):
        if flag in sys.argv:
            return phase_only(torch, phase, [dict(name="attention"), dict(name="fused_dit_scan")])

    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels import attention as A
    from smalltts_tpu_torch.ops.kernels import dit_block as K

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    probe = threading.Thread(target=ctc_probe)  # the CTC timing build, beside the kernels'
    probe.start()
    secs = kernels.build_all()
    probe.join()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} s per source (and ctc_probe), "
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
        check(clock in DEVICE_CLOCKS, f"attention {label} fp32: no device-clock time")
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
    check(len(tf32) == 4 and not any(r["spill_stores"] or r["spill_loads"] for r in tf32.values()),
          f"the 3xTF32 kernels spill, or are missing from the build log: {tf32}")
    mma16 = {n: r for n, r in ptxas.items() if n.startswith("attn_mma_kernel<16")}
    check(len(mma16) == 1 and not any(r["spill_stores"] or r["spill_loads"] for r in mma16.values()),
          f"attn_mma_kernel<16> spills, or is missing from the build log: {mma16}")
    small = {n: r for n, r in ptxas.items() if n.startswith("attn_small_kernel")}
    check(len(small) == 2 and not any(r["spill_stores"] or r["spill_loads"] for r in small.values()),
          f"the head-dim-4 kernels spill, or are missing from the build log: {small}")
    # the served DiT form in bf16 (T 40, Sc 448): 48 of a batch's 68 launches
    head = next(r for r in shapes if r["shape"].startswith("dit T=40 + cross Sc=448") and r["dtype"] == "bfloat16")
    fp32 = train_rows[0]  # the teacher's DiT shape: 12 launches a teacher step, 252 a distillation iteration
    entries.append(dict(name="attention", route="cuda", source=ATTN_SRC, replaces=ATTN_TPU,
                        **{k: head[k] for k in ("max_abs_err", "ms", "wall_ms", "clock", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}, shape=head["shape"], shapes=shapes,
                        fp32_kernel=dict(kernel="attn_tf32_kernel", **{k: fp32[k] for k in (
                            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
                        fp32_train_shapes=train_rows, ptxas=ptxas))
    attn_d16_phase(torch, dev, entries)
    attn_small_phase(torch, dev, entries, parent=_arg("--attn-small-parent"))

    ctc_phase(torch, dev, entries, parent=_arg("--ctc-parent"))
    codec_pointwise_phase(torch, dev, entries)

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
        check(clock in DEVICE_CLOCKS, f"w8 {label}: no device-clock time for {kernel}")
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
        scan_counts(launches, n_b, tts.num_steps, tts.cfg.dit.n_blocks, sfx, echo=True)

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
    check(replayed.get("codec_pointwise", 0) == CODEC_PASSES * len(batches),
          f"codec_pointwise replayed {replayed.get('codec_pointwise', 0)} times for {len(batches)} batches")
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["launches"], e["launches_of"] = scan_launches(launches, GEMMS)
        elif e["name"] in ("attention", "codec_pointwise") + SCAN_KERNELS:
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
    graphs = tempfile.mkdtemp(prefix="smoke_graphs_")  # the imported phase's graphs, phase certify's fixture
    try:
        inputs = onnx_phases(torch, dev, entries, graphs)
        torch.cuda.empty_cache()
        train_phases(torch, dev, entries)
        torch.cuda.empty_cache()
        for which in ("asr", "sv"):
            aux_trainer_phase(torch, dev, entries, which)
        corpus_phase(entries)
        distill_phase(torch, dev, entries)
        imf_phase(torch, dev, entries)
        codec_phases(torch, dev, entries)
        torch.cuda.empty_cache()
        parallel_phase(torch, dev, entries)
        torch.cuda.empty_cache()
        scripts_phase(torch, dev, entries)
        torch.cuda.empty_cache()
        certify_phase(torch, dev, entries, graphs, inputs)
    finally:
        shutil.rmtree(graphs, ignore_errors=True)
    torch.cuda.empty_cache()
    ab_phase(torch, dev, entries)
    torch.cuda.empty_cache()
    imf_exp_phase(torch, dev, entries)

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


def onnx_phases(torch, dev, entries, root):
    """Phases onnx codec and imported, each printing its seconds. The four
    graphs are written into the caller's directory `root` in the layout
    certify reads (codec/{encoder,decoder}.onnx, dmd/{condition_encoder,
    denoiser}.onnx); returns the imported phase's inputs (imported_inputs:
    ref, tokens, duration), on which phase certify builds its fixture.

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
    import numpy as np

    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, codec_encode, init_codec
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, ConditionEncoder, Denoiser
    from smalltts_tpu_torch.onnxtorch.interp import highest_precision
    from smalltts_tpu_torch.onnxtorch.pipeline import ImportedSmallTTS
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.schedule import get_alpha_sigma

    def rel(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    t_phase = time.perf_counter()
    print("phase onnx codec: the native codec (default CodecConfig, fp32, seed 1 weights, as SmallTTS(seed=0) "
          "draws them) exported by torch.onnx.export, then OnnxCodec on the card", flush=True)
    paths = {n: os.path.join(root, sub, n + ".onnx") for sub, n in GRAPHS}
    ccfg = CodecConfig()
    g = torch.Generator(device=dev).manual_seed(1)
    cp = init_codec(g, ccfg, device=dev)
    hop = ccfg.hop
    t0 = time.perf_counter()
    export_codec_graphs(torch, dev, root, cp, ccfg)
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
    rs, inputs = imported_inputs()
    ref, tokens, dur = inputs["ref"], inputs["tokens"], inputs["duration"]
    R, P, S = ref.shape[0], len(tokens), int(dur * 24_000 / 3_200)
    t0 = time.perf_counter()
    kv, mask_p, rope = export_backbone_graphs(torch, dev, root, cond, den, ref, tokens, S)
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
    return inputs


# the four graphs certify reads, (directory, name) under the assets root
GRAPHS = (("codec", "encoder"), ("codec", "decoder"), ("dmd", "condition_encoder"), ("dmd", "denoiser"))


def imported_inputs():
    """The imported phase's inputs, which phase certify's fixture shares:
    R 64 reference frames and P 200 tokens from RandomState(0), 5 s.
    Returns the RandomState (the imported phase draws its noises next) and
    dict(ref, tokens, duration)."""
    import numpy as np

    rs = np.random.RandomState(0)
    ref = rs.randn(64, 64).astype(np.float32)
    return rs, dict(ref=ref, tokens=rs.randint(1, 198, 200).tolist(), duration=5.0)


def export_codec_graphs(torch, dev, root, cp, ccfg):
    """The codec's encoder and decoder (onnxtorch.export, the kernels' plain
    versions, dynamic batch and time axes) as root/codec/{encoder,decoder}.onnx."""
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export
    from smalltts_tpu_torch.ops import kernels

    os.makedirs(os.path.join(root, "codec"), exist_ok=True)
    with kernels.force_plain():
        for name, module, example, axes in (
                ("encoder", CodecEncoder(cp, ccfg), torch.zeros((1, 1, 4 * ccfg.hop), device=dev), {0: "b", 2: "t"}),
                ("decoder", CodecDecoder(cp, ccfg), torch.zeros((1, 4, 64), device=dev), {0: "b", 1: "t"})):
            blob = export(module, (example,), dynamic_axes={"x": axes}, input_names=["x"])
            with open(os.path.join(root, "codec", f"{name}.onnx"), "wb") as f:
                f.write(blob)


def export_backbone_graphs(torch, dev, root, cond, den, ref, tokens, S):
    """The backbone's condition encoder and cached DiT step with the published
    positional contract, traced in fp32 at (R, P, S) on the kernels' plain
    versions, as root/dmd/{condition_encoder,denoiser}.onnx. Returns the
    denoiser's fixed inputs: the condition K/V, the phoneme mask, the RoPE."""
    from smalltts_tpu_torch.onnxtorch.export import export
    from smalltts_tpu_torch.onnxtorch.interp import highest_precision
    from smalltts_tpu_torch.onnxtorch.pipeline import _rope_freqs
    from smalltts_tpu_torch.ops import kernels

    os.makedirs(os.path.join(root, "dmd"), exist_ok=True)
    R, P = ref.shape[0], len(tokens)
    mask_p = torch.ones((1, P), dtype=torch.bool, device=dev)
    cargs = (torch.from_numpy(ref[None]).to(dev), torch.tensor([R], device=dev), torch.tensor([tokens], device=dev),
             mask_p)
    rope = torch.from_numpy(_rope_freqs(S)).to(dev)
    with kernels.force_plain(), highest_precision():
        with torch.no_grad():
            kv = cond(*cargs)
        for name, module, example in (("condition_encoder", cond, cargs), (
                "denoiser", den, (torch.zeros((1, S, 64), device=dev), torch.ones((1, S), dtype=torch.bool, device=dev),
                                  torch.tensor([0.5], device=dev), *kv, mask_p, rope))):
            with open(os.path.join(root, "dmd", f"{name}.onnx"), "wb") as f:
                f.write(export(module, example))
    return kv, mask_p, rope


# the attention Function's dq/dk/dv against autograd through attention_plain, max|diff|/max|plain|:
# fp32 sums in another order, and the backward reads the kernel's output; in bf16 that output
# is rounded to bf16 and each gradient is rounded once (tests/test_torch_train_cuda.py)

# ------------------------------------------------------------------ attention, head dim 4

ATTN_SMALL = ("attn_small_kernel<",)  # profiler name of the head-dim-4 kernel (both trees')
# the SFUs' exponential rate on Hopper: 16 MUFU.EX2 a clock on each SM
SFU_PER_CLOCK = 16


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock in Hz, as `nvidia-smi
    --query-gpu=clocks.max.sm --format=csv,noheader` reads it, read once;
    1980 MHz (the H100 SXM's) where it cannot be read, said so."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(res.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        print(f"  (clocks.max.sm not read: {res.stdout.strip()!r}; the SFU bound takes 1980 MHz)", flush=True)
        return 1980e6


def live_keys(*masks) -> int:
    """The keys a head-dim-4 launch weighs, summed over the batch rows: a
    row's live keys over every source, or all its keys where none is live
    (the uniform average)."""
    live = sum(m.sum(1) for m in masks)
    return int((live + (live == 0) * sum(m.shape[1] for m in masks)).sum())


def small_bound(torch, nbytes_, B, H, Tq, S, s_live):
    """(ms, by, term, old_ms) of a head-dim-4 attention launch (D 4, S keys
    over every source, s_live = live_keys): the largest of its bytes over
    MEM_BW, its multiply-adds (4 x H x Tq x s_live x D flops) at 67 TFLOP/s
    and its exponentials (one a (row, live key) pair: H x Tq x s_live) at
    SFU_PER_CLOCK a clock on each SM at the card's maximum SM clock. The
    kernel runs fp32 on the CUDA cores in either dtype. by is "bytes" or
    "operations", term the largest term's name. old_ms is the earlier
    yardstick: bytes, or 4 B H Tq S D flops over every key at 67 TFLOP/s."""
    pairs = float(H * Tq * s_live)
    sfu = SFU_PER_CLOCK * torch.cuda.get_device_properties(0).multi_processor_count * sm_clock_hz()
    terms = {"bytes": nbytes_ / MEM_BW, "multiply-adds": 16.0 * pairs / PEAK["fp32"], "exponentials": pairs / sfu}
    term = max(terms, key=terms.get)
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term,
            bound(nbytes_, 16.0 * B * H * Tq * S, "fp32")[0])


def small_masks(torch, dev, g, B, S):
    """(B, S) key masks: rows 0 .. B - 3 live up to a length drawn from [S/2,
    S] (as the ASR's), row B - 2 live at its ends with the middle dead (dead
    tiles between live ones), row B - 1 fully masked (a uniform average)."""
    j = torch.arange(S, device=dev)
    m = j[None] < torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)[:, None]
    m[-2] = (j < S // 10) | (j >= 7 * S // 10)
    m[-1] = False
    return m


def attention_parent(kernels, parent):
    """st_attention of `parent`'s csrc/attention.cu (another checkout with the
    same C interface, for example a `git archive` of the parent commit),
    built here with the package's nvcc flags, as a function of (q, k, v,
    key_mask, out)."""
    import ctypes

    from smalltts_tpu_torch.ops.kernels import attention as A

    so = os.path.join(kernels.BUILD_DIR, "libattention_parent.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so,
                          os.path.join(parent, "smalltts_tpu_torch", "csrc", "attention.cu")], capture_output=True, text=True)
    check(res.returncode == 0, f"the parent's attention.cu does not build: {res.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    lib.st_attention.argtypes, lib.st_attention.restype = kernels.SIGNATURES["attention"]["st_attention"]

    def run(q, k, v, m, out):
        args, _masks = A.st_args(q, k, v, m, None, None, None, None, out)
        check(lib.st_attention(*args) == 0, "the parent's attention kernel did not launch")
        return out

    return run


def attn_small_phase(torch, dev, entries, parent=None, sweep=False):
    """Phase A, head dim 4: attn_small_kernel (fp32 on the CUDA cores, either
    dtype) against attention_plain (DISTILL_FWD_TOL: 1e-5 fp32, 2e-2 bf16).

    - The ASR's (2, 16, 1024) with its key mask (lengths from [S/2, S]),
      fp32 and bf16: device ms beside plain, scaled_dot_product_attention,
      the restated bound (small_bound) and its ratio to the kernel's time.
    - Lengths that are no multiple of the 64-key tile or the 4-lane group,
      Tq 1, 37, 130 against S 1, 63, 65, 1031, at B 3 (small_masks: a
      length-masked row, one with dead tiles between live ones, one fully
      masked); two sources with the gate (S 65 + 130: a row with keys only
      in the second, a fully masked row); q/k/v views not aligned to a
      whole key (rows 5 values apart: element copies), each dtype. Each one
      launch.
    - attention_backward (PyTorch ops) at the ASR shape, fp32 as the runs
      send it: device ms a call (every kernel of the call).
    - With `parent` (a checkout, built here: attention_parent), its kernel
      against this one at the ASR shape in both dtypes, held against plain
      and timed in turns (parent, this, this, parent); with `sweep`, S = Tq
      in 256-4096 and B x H in 8-128 (B 2), fp32, every key live, timed in
      the same turns (this tree alone without `parent`), each row with the
      bound and the kernel's share of it.
    The rows go into the attention entry of `entries` ("head_dim_4"), the
    kernels line's."""
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels import attention as A

    print("phase A, head dim 4: attn_small_kernel vs plain (1e-5 fp32, 2e-2 bf16); SFU bound at "
          f"{sm_clock_hz() / 1e6:.0f} MHz x {torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
    g = torch.Generator(device=dev).manual_seed(15)
    run_parent = attention_parent(kernels, parent) if parent else None
    tol = {torch.float32: DISTILL_FWD_TOL["float32"], torch.bfloat16: DISTILL_FWD_TOL["bfloat16"]}

    def held(label, dtype, q, k, v, m, **two):
        kernels.reset_launches()
        got = A.fused_attention(q, k, v, m, **two)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES.get("attention", 0) == 1, f"attention D=4 {label}: not one launch")
        want = A.attention_plain(q, k, v, m, **two)
        abs_e = float((got.float() - want.float()).abs().max())
        rel_e = abs_e / float(want.float().abs().max())
        check(bool(torch.isfinite(got).all()) and rel_e <= tol[dtype],
              f"attention D=4 {label} {dtype}: rel err {rel_e:.3e}")
        return got, abs_e, rel_e

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    rows, edges = [], []
    B, H, S = 2, 16, 1024
    for dtype in (torch.float32, torch.bfloat16):
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v = (rnd((B, H, S, 4), dtype) for _ in range(3))
        m = torch.arange(S, device=dev)[None] < torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)[:, None]
        got, abs_e, rel_e = held(f"asr {kind}", dtype, q, k, v, m)
        ms, wall, clock = timed(lambda: A.fused_attention(q, k, v, m), 20, ATTN_SMALL)
        check(clock in DEVICE_CLOCKS, f"attention D=4 asr {kind}: no device-clock time")
        plain_ms = timed(lambda: A.attention_plain(q, k, v, m), 10)[0]
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None, None, :]),
                       20)[0]
        s_live = live_keys(m)
        b_ms, b_by, term, old_ms = small_bound(torch, nbytes(q, k, v, m, got), B, H, S, S, s_live)
        row = dict(shape=f"asr B={B} H={H} Tq={S} S={S} D=4", dtype=kind, live_keys=s_live, max_abs_err=abs_e,
                   rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, bound_term=term, bound_share=b_ms / ms, old_bound_ms=old_ms)
        if run_parent:
            out_p = torch.empty_like(got)
            run_parent(q, k, v, m, out_p)
            torch.cuda.synchronize()
            want = A.attention_plain(q, k, v, m)
            p_rel = float((out_p.float() - want.float()).abs().max() / want.float().abs().max())
            check(p_rel <= tol[dtype], f"the parent's D=4 kernel {kind}: rel err {p_rel:.3e}")
            fns = {"parent": lambda: run_parent(q, k, v, m, out_p), "this": lambda: A.fused_attention(q, k, v, m)}
            turns = {"parent": [], "this": []}
            for name in ("parent", "this", "this", "parent"):
                turns[name].append(timed(fns[name], 20, ATTN_SMALL)[0])
            row.update(parent_rel_err=p_rel, parent_ms=turns["parent"], this_ms=turns["this"],
                       speedup=_median(turns["parent"]) / _median(turns["this"]))
        if dtype == torch.float32:  # the backward the ASR step runs, in PyTorch ops
            dout = rnd((B, H, S, 4), dtype)
            row["backward_ms"], row["backward_wall_ms"], row["backward_clock"] = timed(
                lambda: A.attention_backward(q, k, v, m, got, dout), 10)
        rows.append(row)
        print("  " + json.dumps(row), flush=True)

        for Tq in (1, 37, 130):
            for S_ in (1, 63, 65, 1031):
                q, k, v = rnd((3, 4, Tq, 4), dtype), rnd((3, 4, S_, 4), dtype), rnd((3, 4, S_, 4), dtype)
                _, abs_e, rel_e = held(f"Tq={Tq} S={S_} {kind}", dtype, q, k, v, small_masks(torch, dev, g, 3, S_))
                edges.append(dict(shape=f"B=3 H=4 Tq={Tq} S={S_}", dtype=kind, max_abs_err=abs_e, rel_err=rel_e))
        q = rnd((3, 4, 37, 4), dtype)
        k, v, k2, v2 = rnd((3, 4, 65, 4), dtype), rnd((3, 4, 65, 4), dtype), rnd((3, 4, 130, 4), dtype), rnd((3, 4, 130, 4), dtype)
        m1, m2 = small_masks(torch, dev, g, 3, 65), small_masks(torch, dev, g, 3, 130)
        m1[1] = False  # row 1: keys only in the second source
        _, abs_e, rel_e = held(f"two sources, gated {kind}", dtype, q, k, v, m1, k2=k2, v2=v2, key_mask2=m2,
                               gate=rnd(q.shape, dtype))
        edges.append(dict(shape="B=3 H=4 Tq=37 S=65 + 130, gated", dtype=kind, max_abs_err=abs_e, rel_err=rel_e))
        buf = rnd((3, 3, 4, 130, 5), dtype)  # q, k, v rows 5 values apart: not aligned to a whole key
        _, abs_e, rel_e = held(f"unaligned views {kind}", dtype, *(buf[i, ..., :4] for i in range(3)),
                               small_masks(torch, dev, g, 3, 130))
        edges.append(dict(shape="B=3 H=4 Tq=S=130, rows 5 apart", dtype=kind, max_abs_err=abs_e, rel_err=rel_e))
    print(f"  {len(edges)} edge cases within tolerance, worst rel err "
          f"{max(e['rel_err'] for e in edges if e['dtype'] == 'fp32'):.3e} fp32, "
          f"{max(e['rel_err'] for e in edges if e['dtype'] == 'bf16'):.3e} bf16", flush=True)

    swept = []
    if sweep:
        for S_ in (256, 512, 1024, 2048, 4096):
            for H_ in (4, 16, 64):
                q, k, v = (rnd((2, H_, S_, 4), torch.float32) for _ in range(3))
                m = torch.ones((2, S_), dtype=torch.bool, device=dev)
                got = A.fused_attention(q, k, v, m)
                if 2 * H_ * S_ * S_ <= 2 ** 30:
                    want = A.attention_plain(q, k, v, m)
                    rel_e = float((got - want).abs().max() / want.abs().max())
                    check(rel_e <= tol[torch.float32], f"attention D=4 sweep S={S_} H={H_}: rel err {rel_e:.3e}")
                    del want
                else:
                    rel_e = None
                fns = {"this": lambda: A.fused_attention(q, k, v, m)}
                if run_parent:
                    out_p = torch.empty_like(got)
                    fns["parent"] = lambda: run_parent(q, k, v, m, out_p)
                turns = {n: [] for n in fns}
                for name in ("parent", "this", "this", "parent"):
                    if name in fns:
                        turns[name].append(timed(fns[name], 10, ATTN_SMALL)[0])
                b_ms, b_by, term, old_ms = small_bound(torch, nbytes(q, k, v, m, got), 2, H_, S_, S_, live_keys(m))
                row = dict(S=S_, BH=2 * H_, rel_err=rel_e, ms=_median(turns["this"]), this_ms=turns["this"],
                           bound_ms=b_ms, bound_by=b_by, bound_term=term, bound_share=b_ms / _median(turns["this"]),
                           old_bound_ms=old_ms)
                if run_parent:
                    row.update(parent_ms=turns["parent"], speedup=_median(turns["parent"]) / row["ms"])
                swept.append(row)
                print("  sweep " + json.dumps(row), flush=True)
                del q, k, v, got
    for e in entries:
        if e["name"] == "attention":
            e["head_dim_4"] = dict(kernel="attn_small_kernel", asr=rows, edge_cases=edges, sweep=swept)


def attn_small_only(torch):
    """`--attn-small`: attention.cu built alone, then attn_small_phase with
    the sweep; with `--attn-small-parent DIR`, DIR's kernel beside this one
    in every timed row. Prints every row."""
    from smalltts_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.load("attention")
    print(f"build: attention {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = ptxas_report(os.path.join(kernels.BUILD_DIR, "attention.log"))
    small = {n: r for n, r in ptxas.items() if n.startswith("attn_small_kernel")}
    print(f"  ptxas (attn_small_kernel; the whole run fails on a spill): {json.dumps(small)}", flush=True)
    attn_small_phase(torch, dev, [], parent=_arg("--attn-small-parent"), sweep=True)
    return 0


CTC_SRC = "smalltts_tpu_torch/csrc/ctc.cu"
# no pallas_call: the JAX trainers run optax.ctc_loss inside their jitted steps (XLA's loop)
CTC_REPLACES = "smalltts_tpu/train/asr_train.py:34"
CTC_LOSS_TOL = 1e-5  # each loss relative to itself: expf/log1pf against PyTorch's, an ulp a step
CTC_GRAD_TOL = 1e-4  # max|diff| / max|plain| of the gradient w.r.t. the logits
CTC_ROUTE = ("CUDA. Forward: one block a sequence, one state a thread up to 512 states, 2-8 above; "
             "padded frames in runs without a barrier, their flags carried as bits 64 frames ahead. "
             "Backward: one launch; factor blocks compute the six exp multipliers of every state across the "
             "card, one chain block a sequence runs only the adjoint's products and sums over multipliers "
             "brought in by cp.async.bulk, 8 frames a copy")
# switch_below / switch_above: N + 1 = 512 states (one a thread in both kernels: the forward's 512
# threads, the backward's 256 consumers of 2) and one more (two a forward thread, four a consumer);
# long: T = 2500, past the backward's ring of frames in flight many times
CTC_CASES = ("trainer", "feasible", "repeats", "infeasible", "n384", "padded_inside", "switch_below",
             "switch_above", "n512", "n4095", "long", "b8")
# (T, N, K, frames, label counts) of the generated cases
CTC_SHAPES = {
    "feasible": (400, 100, 60, [400, 300, 250], [100, 80, 50]),
    "repeats": (400, 100, 60, [400, 300, 250], [100, 80, 50]),
    "infeasible": (400, 100, 60, [400, 60, 100], [100, 80, 90]),
    "n384": (1024, 384, None, [1024, 900], [384, 300]),
    "padded_inside": (400, 100, 60, [400, 400, 300], [100, 80, 50]),
    "switch_below": (600, None, 60, [600, 500], [None, 150]),
    "switch_above": (600, None, 60, [600, 500], [None, 150]),
    "n512": (1100, 512, 60, [1100, 800], [512, 300]),
    "n4095": (4200, 4095, 60, [4200, 3000], [4095, 2000]),
    "long": (2500, 600, 60, [2500, 2100], [600, 250]),
    "b8": (400, 100, 60, [400, 390, 370, 350, 300, 250, 200, 120], [100, 95, 90, 80, 60, 50, 30, 0]),
}


def ctc_case(name, seed=0):
    """(logits (B, T, K), logit_pad, labels, label_pad) as numpy: the
    trainers' shape (2, 1024, 198) with the dummy loader's lengths (the
    ASR's 4x upsampled latent frames), or a batch of the named kind
    (CTC_SHAPES; N = 384 is the serving contract's phoneme bucket;
    padded_inside has padded frames inside feasible samples, which keep
    their states; the switch cases sit at either side of the kernels'
    switch from one state a thread to several, N + 1 = 512 and 513; long
    runs past the backward's frames in flight)."""
    import numpy as np

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.text.vocab import phoneme_len

    rs = np.random.RandomState(seed)
    if name == "trainer":
        batch = dummy_batch(np.random.default_rng(seed), DummyDataConfig(batch_size=2))
        frames, labels, labs = 4 * batch["latents_lengths"], batch["phonemes"], batch["phonemes_lengths"]
        T, K = 4 * 256, phoneme_len
    else:
        T, N, K, frames, labs = CTC_SHAPES[name]
        K = K or phoneme_len
        if N is None:
            N = 511 if name == "switch_below" else 512
            labs = [N if n is None else n for n in labs]
        labels = rs.randint(1, K, (len(frames), N)).astype(np.int32)
        if name in ("repeats", "infeasible"):  # labels 7i and 7i + 1 equal
            labels[:, 1::7] = labels[:, 0::7][:, :labels[:, 1::7].shape[1]]
        labels = np.where(np.arange(N)[None] < np.asarray(labs)[:, None], labels, 0).astype(np.int32)
    logit_pad = (np.arange(T)[None] >= np.asarray(frames)[:, None]).astype(np.float32)
    if name == "padded_inside":
        logit_pad[0, 100:140] = 1.0
        logit_pad[1, 0:10] = 1.0
    if name == "b8":
        logit_pad[2, 50:80] = 1.0
    label_pad = (np.arange(labels.shape[1])[None] >= np.asarray(labs)[:, None]).astype(np.float32)
    logits = (2.0 * rs.randn(len(frames), T, K)).astype(np.float32)
    return logits, logit_pad, labels, label_pad


def ctc_inputs(torch, logits, logit_pad, labels, label_pad):
    """The recurrence's inputs as ops/losses.ctc_loss makes them: (lp_emit,
    lp_phi, pad, repeat, labellens), and the log-probs."""
    import torch.nn.functional as F

    B, T, _ = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    lp_phi = logprobs[:, :, 0].contiguous()
    lp_emit = torch.gather(logprobs, 2, labels.long()[:, None, :].expand(B, T, N)).contiguous()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    labellens = (N - label_pad.sum(dim=1)).to(torch.int32)
    return (lp_emit, lp_phi, logit_pad, repeat, labellens), logprobs


def ptxas_ctc(log_path: str) -> dict:
    """Registers and spill bytes of each CTC kernel instance in an nvcc
    `-Xptxas -v` log, by the kernel's name and template argument."""
    import re

    out, name = {}, None
    for line in open(log_path):
        m = re.search(r"Compiling entry function '\w*?(ctc_[a-z]+_kernel)(I(?:L\w+?E)+E)?", line)
        if m:
            args = re.findall(r"L\w(\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = dict(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def ctc_phase(torch, dev, entries, parent=None):
    """Phase A, CTC: ops/losses.ctc_loss with the CTC kernels against the
    same call under kernels.force_plain() (the plain versions on the card),
    fp32, at every CTC_CASES batch: the trainers' shape (2, 1024, 198) over
    198 labels with the dummy loader's lengths, a feasible, a repeated-label
    and an infeasible batch (loss ~1e5), 384 labels, padded frames inside
    samples, N at either side of the kernels' switch from one state a
    thread to several, N = 512 and 4095, T = 2500 and B = 8:
    each loss within CTC_LOSS_TOL of the plain one relative to itself, the
    gradient w.r.t. the logits within CTC_GRAD_TOL of the largest plain
    value; exactly one launch of each kernel a call. ptxas must report no
    spill in any CTC kernel. Then, at the trainers' shape and at N = 384
    (see ctc_times), each kernel's device time, the backward's factor blocks
    and chains alone, the plain versions', F.ctc_loss's, the bytes bound and
    the chain floor (the last three through ctc_probe). With `parent` (a checkout of the previous kernels),
    loss, alpha and d_emit must equal its kernels' bit for bit at the
    trainers' shape and N = 384 (ctc_parent_check). The two kernels' entries
    get their launches from the train asr phase."""
    import contextlib

    import torch.nn.functional as F

    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels import ctc as C
    from smalltts_tpu_torch.ops.losses import ctc_loss

    t_phase = time.perf_counter()
    ptxas = ptxas_ctc(os.path.join(kernels.BUILD_DIR, "ctc.log"))
    print(f"phase A, CTC: ptxas (ctc.cu): {json.dumps(ptxas)}", flush=True)
    check(len(ptxas) >= 8 and not any(r["spill_stores"] or r["spill_loads"] for r in ptxas.values()),
          f"a CTC kernel spills, or is missing from the build log: {ptxas}")
    print(f"  ctc_loss kernels vs force_plain, fp32 (loss {CTC_LOSS_TOL} relative to itself, gradient "
          f"{CTC_GRAD_TOL} of the largest plain value)", flush=True)
    rows, timing = [], {}
    for name in CTC_CASES:
        t_case = time.perf_counter()
        logits, logit_pad, labels, label_pad = (torch.as_tensor(a, device=dev) for a in ctc_case(name))
        B, T, _ = logits.shape
        N = labels.shape[1]
        out = []
        for plain in (False, True):
            x = logits.clone().requires_grad_(True)
            kernels.reset_launches()
            with kernels.force_plain() if plain else contextlib.nullcontext():
                loss = ctc_loss(x, logit_pad, labels, label_pad)
                (loss * torch.arange(1, B + 1, device=dev)).sum().backward()
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
            check(counts == ({} if plain else {"ctc_forward": 1, "ctc_backward": 1}), f"ctc {name}: launches {counts}")
            out.append((loss.detach(), x.grad))
        (lk, gk), (lp, gp) = out
        loss_err = float(((lk - lp).abs() / lp.abs()).max())
        grad_abs = float((gk - gp).abs().max())
        grad_err = grad_abs / float(gp.abs().max())
        check(bool(torch.isfinite(lk).all() and torch.isfinite(gk).all()), f"ctc {name}: not finite")
        check(loss_err <= CTC_LOSS_TOL and grad_err <= CTC_GRAD_TOL,
              f"ctc {name}: loss rel err {loss_err:.3e}, gradient rel err {grad_err:.3e}")
        if name == "infeasible":
            check(float(lk[1]) > 5e4 and float(lk[2]) > 5e4, f"ctc infeasible: losses {lk.tolist()}")
        row = dict(case=name, shape=[B, T, logits.shape[2], N], backward_per=C.backward_per(N), loss=lk.tolist() if B <= 3 else None,
                   loss_abs_err=float((lk - lp).abs().max()), loss_rel_err=loss_err, grad_abs_err=grad_abs,
                   grad_rel_err=grad_err)
        if name in ("trainer", "n384"):
            row.update(ctc_times(torch, F, C, kernels, logits, logit_pad, labels, label_pad))
            timing[name] = row
        row["case_s"] = time.perf_counter() - t_case
        rows.append(row)
        print("  " + json.dumps(row), flush=True)
        del logits, x, out
        torch.cuda.empty_cache()
    bits = ctc_parent_check(torch, dev, C, kernels, parent) if parent else None
    head = timing["trainer"]
    for which in ("forward", "backward"):
        entries.append(dict(name=f"ctc_{which}", route="cuda", source=CTC_SRC, replaces=CTC_REPLACES,
                            replaces_note="optax.ctc_loss in the JAX trainers' jitted steps; no pallas_call",
                            route_note=CTC_ROUTE, launches=None,
                            max_abs_err=head["loss_abs_err" if which == "forward" else "grad_abs_err"],
                            **{k: head[f"{which}_{k}"] for k in ("ms", "wall_ms", "clock", "plain_ms", "bound_ms",
                                                                   "bound_by", "library_ms", "step_us_per_frame",
                                                                   "chain_floor_ms", "chain_floor_ns_per_frame",
                                                                   "chain_floor_threads")},
                            shape=head["shape"], chained_frames=head["chained_frames"],
                            n384={k: timing["n384"][f"{which}_{k}"] for k in
                                  ("ms", "plain_ms", "bound_ms", "library_ms", "step_us_per_frame", "chain_floor_ms",
                                   "chain_floor_ns_per_frame", "chain_floor_threads")},
                            phases={k: {c: timing[c][f"backward_{k}_ms"] for c in timing}
                                    for k in ("factors", "chains")} if which == "backward" else None,
                            cases=rows if which == "forward" else None, ptxas=ptxas if which == "forward" else None,
                            parent_bits=bits))
    print(f"  phase A, CTC: {time.perf_counter() - t_phase:.2f} s", flush=True)


CODEC_SRC = "smalltts_tpu_torch/csrc/codec.cu"


def codec_pointwise_phase(torch, dev, entries, B=32, t=80):
    """Phase A, codec: the codec decoder's pointwise pass (csrc/codec.cu) at
    the offline cell's largest batch (B 32, t 80) of CodecConfig(), on the
    passes that move the most bytes: stage 3's and stage 4's first residual
    pass (x kept, the next unit's snake at dilation 3: borders 9), the
    stage 3 -> 4 depth-to-time pass (r 5) and the head (tanh, r 8). Each
    equal bit for bit to its plain version (force_plain) and to the
    channel-last op chain it replaces (models/codec.py's ops from the
    convolution's output to the next convolution's padded input), one launch
    a call; its device ms beside its bytes at 3.35 TB/s and the op chain's
    device ms."""
    import math

    import torch.nn.functional as F

    from smalltts_tpu_torch.models import codec as M
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels.codec import codec_pointwise

    t_phase = time.perf_counter()
    cfg = M.CodecConfig()
    ch, st = cfg.channels, cfg.strides
    rate = [t * math.prod(st[:i]) for i in range(len(st))]
    g = torch.Generator(device=dev).manual_seed(23)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g, device=dev)  # noqa: E731
    cases = (("stage 3 residual", ch[3], ch[3], rate[3], 1, "res", (9, 9)),
             ("stage 4 residual", ch[4], ch[4], rate[4], 1, "res", (9, 9)),
             ("stage 3 -> 4 depth to time", ch[4] * st[3], ch[4], rate[3], st[3], "x", (3, 3)),
             ("head", st[-1], 1, rate[4], st[-1], "head", (0, 0)))
    print(f"phase A, codec: codec_pointwise at B {B}, t {t} against plain (force_plain) and the channel-last op "
          "chain, bit for bit", flush=True)
    rows = []
    for label, cr, C, T, r, kind, pad in cases:
        y, bias = rnd(B, cr, T), rnd(cr, s=0.1)
        x = rnd(B, C, T * r) if kind == "res" else None
        la = rnd(C, s=0.3) if kind != "head" else None
        alpha = torch.exp(la) if la is not None else None
        args = dict(r=r, tanh=kind == "head", keep=True, alpha=alpha, pad=pad)
        run = lambda: codec_pointwise(y, bias, x, **args)  # noqa: E731

        def chain():  # the channel-last decode's ops between the two convolutions
            v = (y.float() + bias.float()[:, None]).transpose(1, 2)
            if kind == "res":
                v = x.transpose(1, 2) + v
            if kind == "head":
                v = torch.tanh(v)
                return v.reshape(B, 1, -1), None
            if r > 1:
                v = M._depth_to_time(v, r)
            return v, F.pad(M.snake(v, la).transpose(1, 2), pad)

        kernels.reset_launches()
        got = run()
        torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(launched == {"codec_pointwise": 1}, f"codec {label}: launches {launched}")
        with kernels.force_plain():
            plain = run()
        old_v, old_s = chain()
        want = (old_v if kind == "head" else old_v.transpose(1, 2), old_s)
        for name, ref in (("plain", plain), ("op chain", want)):
            for a_, b_ in zip(got, ref):
                check((a_ is None) == (b_ is None) and (a_ is None or torch.equal(a_, b_.contiguous())),
                      f"codec {label}: the kernel differs from the {name}")
        ms, wall, clock = timed(run, 20, ("codec_pointwise_kernel",))
        chain_ms = timed(chain, 10)[0]
        moved = nbytes(y) + (nbytes(x) if x is not None else 0) + sum(nbytes(o) for o in got if o is not None)
        row = dict(case=label, y=list(y.shape), r=r, pad=list(pad), ms=ms, wall_ms=wall, clock=clock,
                   bytes=moved, bound_ms=moved / MEM_BW * 1e3, bound_share=moved / MEM_BW * 1e3 / ms,
                   plain_ms=chain_ms)
        print("  " + json.dumps(row), flush=True)
        rows.append(row)
        del y, x, got, plain, old_v, old_s, want
        torch.cuda.empty_cache()
    head = rows[1]
    entries.append(dict(name="codec_pointwise", route="cuda", source=CODEC_SRC, replaces=None,
                        replaces_note="XLA's fusions around the codec's convolutions; no pallas_call",
                        max_abs_err=0.0, launches=None, **{k: head[k] for k in (
                            "ms", "wall_ms", "clock", "plain_ms", "bound_ms")}, bound_by="bytes", cases=rows))
    print(f"  phase A, codec: {time.perf_counter() - t_phase:.2f} s", flush=True)


def codec_pointwise_only(torch):
    """`--codec-pointwise`: the codec source built alone, then phase A, codec."""
    from smalltts_tpu_torch.ops import kernels

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.load("codec")
    with open(os.path.join(kernels.BUILD_DIR, "codec.log")) as f:
        ptxas = [ln.strip() for ln in f if "spill" in ln or "Used" in ln]
    print(f"build: codec {time.perf_counter() - t0:.2f} s; ptxas: {json.dumps(ptxas)}", flush=True)
    entries = []
    codec_pointwise_phase(torch, torch.device("cuda"), entries)
    print(json.dumps({"kernels": entries}))
    return 0


def ctc_consumers(N, per):
    """The backward chain's consumer threads: ceil((N + 1) / per), to a whole warp."""
    return -(-(-(-(N + 1) // per)) // 32) * 32


_ctc_probe = {}
_ctc_probe_lock = threading.Lock()


def ctc_probe():
    """The timing build of the CTC source, csrc/ctc_probe.cu (ctc.cu with
    CTC_PROBE, and the floor kernel), compiled with the package's nvcc
    flags into its build directory once per content of the sources; the
    package never loads it. main() starts it beside the kernels' build."""
    import ctypes
    import hashlib

    from smalltts_tpu_torch.ops import kernels

    with _ctc_probe_lock:
        if "lib" not in _ctc_probe:
            srcs = [os.path.join(kernels.CSRC, f) for f in ("ctc_probe.cu", "ctc.cu", "sm90_common.cuh")]
            h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
            for path in srcs:
                with open(path, "rb") as f:
                    h.update(f.read())
            os.makedirs(kernels.BUILD_DIR, exist_ok=True)
            so = os.path.join(kernels.BUILD_DIR, f"libctc_probe_{h.hexdigest()[:16]}.so")
            if not os.path.exists(so):
                res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so + ".tmp", srcs[0]],
                                     capture_output=True, text=True)
                check(res.returncode == 0, f"ctc_probe.cu does not build: {res.stderr[-2000:]}")
                os.replace(so + ".tmp", so)
            lib = ctypes.CDLL(so)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.st_ctc_backward_phases.argtypes, lib.st_ctc_backward_phases.restype = [P] * 11 + [I] * 5 + [P], I
            lib.st_ctc_floor.argtypes, lib.st_ctc_floor.restype = [P, P, I, I, I, P], I
            lib.st_ctc_error.argtypes, lib.st_ctc_error.restype = [I], ctypes.c_char_p
            _ctc_probe["lib"] = lib
        return _ctc_probe["lib"]


def ctc_floor_ms(torch, kernels, threads, mode, frames_chained, frames=8192):
    """frames_chained x the ns a frame of ctc_floor_kernel (mode 0: the
    forward's two lae and one exchange; 1: the backward's adjoint step and
    one exchange) at `threads` threads, the block's own, in ms: the least
    time the chain of those frames takes."""
    lib = ctc_probe()
    out = torch.zeros((1,), dtype=torch.float32, device="cuda")
    sink = torch.empty((threads,), dtype=torch.float32, device="cuda")
    ns = []
    for _ in range(3):
        kernels.check(lib, "ctc", lib.st_ctc_floor(out.data_ptr(), sink.data_ptr(), threads, frames, mode,
                                                    torch.cuda.current_stream().cuda_stream), "ctc_floor")
        torch.cuda.synchronize()
        ns.append(float(out[0]))
    return min(ns) * frames_chained / 1e6, min(ns)


def ctc_times(torch, F, C, kernels, logits, logit_pad, labels, label_pad):
    """Device ms of each CTC kernel, the backward's factor blocks alone and
    its chains alone (ctc_probe, over factors already computed), its plain
    version's (one call, CUDA events) and F.ctc_loss's forward and backward
    on the same log-probs; the bytes bound and the chain floor, at one
    case's shape. The chain floor counts the frames a chain runs: the
    unpadded frames of the batch's longest sequence (padded runs take no
    exchange), at one frame's floor measured at the block's own threads."""
    B, T, _ = logits.shape
    N = labels.shape[1]
    args, logprobs = ctc_inputs(torch, logits, logit_pad, labels, label_pad)
    loss, alpha = C.ctc_forward(*args)
    g = torch.ones_like(loss)
    per = C.backward_per(N)
    d_emit, d_phi = C.backward_launch(g, *args, alpha, per)
    res = {}
    for which, fn, plain, ins, outs in (
            ("forward", lambda: C.ctc_forward(*args), lambda: C.ctc_forward_plain(*args), args, (alpha, loss)),
            ("backward", lambda: C.ctc_backward(g, *args, alpha), lambda: C.ctc_backward_plain(g, *args, alpha),
             (g,) + args + (alpha,), (d_emit, d_phi))):
        # the device clock (device_ms: the profiler, or where its traces drop every record, CUDA events
        # around 10 launches queued behind a spin kernel; one kernel a call)
        ms, wall, clock = timed(fn, 10, (f"ctc_{which}_kernel",))
        # the plain version, a launch-bound loop of ~10 (forward) and ~30 (backward) ops a frame: one
        # call's CUDA-event time (no trace: tracing its ~10^4 launches made later traces drop records)
        plain_ms = time_ms(plain, iters=1, warmup=1)
        b_ms, b_by = bound(nbytes(*ins) + nbytes(*outs), 0.0, "fp32")
        res.update({f"{which}_ms": ms, f"{which}_wall_ms": wall, f"{which}_clock": clock,
                    f"{which}_plain_ms": plain_ms, f"{which}_bound_ms": b_ms,
                    f"{which}_bound_by": b_by, f"{which}_step_us_per_frame": ms * 1e3 / T})
    # the backward's two kinds of blocks alone (ctc_probe): the factor blocks (the chains exit at once),
    # and the chains over the factors a whole launch computed (no flag to wait for)
    probe, stream = ctc_probe(), torch.cuda.current_stream().cuda_stream
    fac = torch.empty((B * T * 6 * (-(-(N + 1) // 8) * 8),), dtype=torch.float32, device=logits.device)
    ptrs = [x.contiguous().data_ptr() for x in (g,) + args + (alpha,)]

    def phases(n):
        sync = torch.zeros((1 + B * T,), dtype=torch.int32, device=logits.device)
        kernels.check(probe, "ctc", probe.st_ctc_backward_phases(
            *ptrs, fac.data_ptr(), sync.data_ptr(), d_emit.data_ptr(), d_phi.data_ptr(), B, T, N, per, n, stream),
            "ctc_backward phases")

    phases(3)
    res["backward_factors_ms"] = timed(lambda: phases(1), 10, ("ctc_backward_kernel",))[0]
    phases(3)
    res["backward_chains_ms"] = timed(lambda: phases(2), 10, ("ctc_backward_kernel",))[0]
    # the chain floors: the frames each chain runs (the longest sequence's unpadded frames), a frame of
    # the forward's two lae and of the backward's adjoint step, each with one exchange through shared
    # memory, at the threads of the kernel's block (the backward's consumers)
    chained = int((logit_pad == 0).sum(dim=1).max())
    for which, threads, mode in (("forward", min(512, -(-(N + 1) // 32) * 32), 0),
                                 ("backward", ctc_consumers(N, per), 1)):
        floor_ms, ns = ctc_floor_ms(torch, kernels, threads, mode, chained)
        res.update({f"{which}_chain_floor_ms": floor_ms, f"{which}_chain_floor_ns_per_frame": ns,
                    f"{which}_chain_floor_threads": threads})
    res["chained_frames"] = chained
    # the library call: F.ctc_loss on (T, B, K) log-probs, per-sample losses; its backward alone
    lp_t = logprobs.detach().transpose(0, 1).requires_grad_(True)
    targets, in_lens = labels.long(), (T - logit_pad.sum(dim=1)).long()
    tgt_lens = args[4].long()
    lib_fwd = lambda: F.ctc_loss(lp_t, targets, in_lens, tgt_lens, reduction="none")  # noqa: E731
    lib_loss = lib_fwd()
    res["forward_library_ms"] = timed(lib_fwd, 20)[0]
    res["backward_library_ms"] = timed(lambda: torch.autograd.grad(lib_loss.sum(), lp_t, retain_graph=True), 20)[0]
    # F.ctc_loss's per-sample losses, None where it gives inf (an infeasible sample): the kernels line is strict JSON
    res["library_loss"] = [v if v != float("inf") else None for v in lib_loss.tolist()]
    return res


def ctc_parent_check(torch, dev, C, kernels, parent):
    """The kernels of `parent` (a checkout of the previous csrc/ctc.cu, built
    here with the same nvcc flags) against this checkout's on the same
    inputs, at the trainers' shape and N = 384: loss, alpha and d_emit must
    be equal bit for bit (the arithmetic of every state is unchanged); d_phi
    may differ by the order of its sum over the states."""
    import ctypes

    src = os.path.join(parent, "smalltts_tpu_torch", "csrc", "ctc.cu")
    so = os.path.join(kernels.BUILD_DIR, "libctc_parent.so")
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    check(res.returncode == 0, f"the parent's ctc.cu does not build: {res.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.st_ctc_forward.argtypes, lib.st_ctc_forward.restype = [P] * 7 + [I, I, I, P], I
    lib.st_ctc_backward.argtypes, lib.st_ctc_backward.restype = [P] * 9 + [I, I, I, P], I
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in ("trainer", "n384"):
        logits, logit_pad, labels, label_pad = (torch.as_tensor(a, device=dev) for a in ctc_case(name))
        args, _ = ctc_inputs(torch, logits, logit_pad, labels, label_pad)
        B, T, N = args[0].shape
        loss, alpha = C.forward_launch(*args)
        g = torch.linspace(0.5, 2.0, B, device=dev)
        d_emit, d_phi = C.backward_launch(g, *args, alpha, C.backward_per(N))
        p_loss, p_alpha = torch.empty_like(loss), torch.empty_like(alpha)
        p_emit, p_phi = torch.empty_like(d_emit), torch.empty_like(d_phi)
        ptrs = [x.data_ptr() for x in args]
        check(lib.st_ctc_forward(*ptrs, p_alpha.data_ptr(), p_loss.data_ptr(), B, T, N, stream) == 0,
              "parent ctc_forward")
        check(lib.st_ctc_backward(g.data_ptr(), *ptrs, alpha.data_ptr(), p_emit.data_ptr(), p_phi.data_ptr(), B, T,
                                  N, stream) == 0, "parent ctc_backward")
        torch.cuda.synchronize()
        out[name] = dict(loss_equal=bool(torch.equal(loss, p_loss)), alpha_equal=bool(torch.equal(alpha, p_alpha)),
                         d_emit_equal=bool(torch.equal(d_emit, p_emit)),
                         d_phi_max_abs_diff=float((d_phi - p_phi).abs().max()),
                         d_phi_max_abs=float(p_phi.abs().max()))
        # both kernels of each tree, timed in turns on the same inputs: parent, this, this, parent
        fwd = {"parent": lambda: lib.st_ctc_forward(*ptrs, p_alpha.data_ptr(), p_loss.data_ptr(), B, T, N, stream),
               "this": lambda: C.forward_launch(*args)}
        bwd = {"parent": lambda: lib.st_ctc_backward(g.data_ptr(), *ptrs, alpha.data_ptr(), p_emit.data_ptr(),
                                                     p_phi.data_ptr(), B, T, N, stream),
               "this": lambda: C.backward_launch(g, *args, alpha, C.backward_per(N))}
        for which, fns in (("forward", fwd), ("backward", bwd)):
            ms = {k: [] for k in fns}
            for k in ("parent",) + tuple(fns)[1:] + tuple(fns)[1:][::-1] + ("parent",):
                ms[k].append(timed(fns[k], 10, (f"ctc_{which}_kernel",))[0])
            out[name][f"{which}_ms"] = ms
        print(f"  bit for bit against the parent's kernels, {name}: {json.dumps(out[name])}", flush=True)
        check(out[name]["loss_equal"] and out[name]["alpha_equal"] and out[name]["d_emit_equal"],
              f"ctc {name}: not bit-equal to the parent's kernels: {out[name]}")
    return out


def ctc_only(torch):
    """`--ctc`: phase A, CTC alone (the CTC source and ctc_probe built
    alone, together), then ctc_sweep; with `--ctc-parent DIR`, also the
    bit-for-bit check against the kernels of DIR. Prints every row."""
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels import ctc as C

    dev = torch.device("cuda")
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    probe = threading.Thread(target=ctc_probe)
    probe.start()
    kernels.load("ctc")
    probe.join()
    print(f"build: ctc and ctc_probe {time.perf_counter() - t0:.2f} s", flush=True)
    entries = []
    ctc_phase(torch, dev, entries, parent=_arg("--ctc-parent"))
    ctc_sweep(torch, dev, C, kernels)
    return 0


def ctc_sweep(torch, dev, C, kernels):
    """Device ms of the forward kernel at B 2, T 1024 over N, beside the
    forward's chain floor a frame at its block's threads, and of the
    backward over the states a consumer thread at N 198, 384 and 1024:
    where one block stops being bound by its chain, and where each PER
    belongs. Random log-probs, every label position in use, no padding."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for N in (198, 256, 320, 384, 448, 511, 512, 768, 1024):
        B, T = 2, 1024
        lp = torch.log_softmax(2.0 * torch.randn((B, T, 61), generator=gen, device=dev), dim=-1)
        labels = torch.randint(1, 61, (B, N), generator=gen, device=dev)
        args, _ = ctc_inputs(torch, lp, torch.zeros((B, T), device=dev), labels.to(torch.int32),
                             torch.zeros((B, N), device=dev))
        ms = timed(lambda: C.forward_launch(*args), 10, ("ctc_forward_kernel",))[0]
        threads = min(512, -(-(N + 1) // 32) * 32)
        rows.append(dict(kernel="forward", N=N, threads=threads, ms=ms, us_per_frame=ms * 1e3 / T,
                         floor_us_per_frame=ctc_floor_ms(torch, kernels, threads, 0, 1)[1] / 1e3))
        if N in (198, 384, 1024):
            loss, alpha = C.forward_launch(*args)
            g = torch.ones_like(loss)
            for per in (1, 2, 4, 8):
                if ctc_consumers(N, per) > 512:
                    continue
                ms = timed(lambda: C.backward_launch(g, *args, alpha, per), 10, ("ctc_backward_kernel",))[0]
                rows.append(dict(kernel="backward", N=N, per=per, ms=ms, us_per_frame=ms * 1e3 / T))
    for r in rows:
        print("  sweep " + json.dumps(r), flush=True)
    return rows


# the ASR step's parameter gradients, kernels against plain, rel-L2 per module. The CTC's log-alphas
# of a 1024-frame sequence reach some -5e3, where an fp32 ulp is ~5e-4, and every derivative of the
# recurrence is exp(a - out) of two such values: the gradients carry that rounding, so an ulp of
# change in the ASR's inputs or in an attention's sums moves them by ~1e-4 (the phase prints the
# plain step's own move under a one-ulp nudge of its latents). A wrong kernel moves them by O(1).
ASR_GRAD_TOL = 1e-3


class CaptureGrads:
    """An optimizer that records the gradients and leaves the params."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        from smalltts_tpu_torch.utils import checkpoint as ckpt

        self.grads = grads
        return ckpt.map_pytree(lambda t: t.new_zeros(t.shape), grads), state


def module_grad_rel_l2(got, want):
    """{module: rel-L2 of its gradient leaves} over the first two path parts."""
    from smalltts_tpu_torch.utils import checkpoint as ckpt

    fg, fw = ckpt.flatten_pytree(got), ckpt.flatten_pytree(want)
    sums = {}
    for n, gr in fg.items():
        mod = "/".join(n.split("/")[:2])
        a, c = sums.get(mod, (0.0, 0.0))
        sums[mod] = (a + float((gr - fw[n]).norm()) ** 2, c + float(fw[n].norm()) ** 2)
    return {mod: (a / max(c, 1e-60)) ** 0.5 for mod, (a, c) in sums.items() if c > 0}


def aux_trainer_phase(torch, dev, entries, which):
    """Phase train asr / train sv: the port's train_asr (ASRConfig()) or
    train_sv (SVConfig(), CodecConfig(), the fallback teacher) at full
    width, batch 2, the dummy loader, seed 0: 5 steps with one save (the
    last, into a temporary directory that is removed). The counters, reset
    just before: the ASR step's 7 attention launches (the conformer's head
    dim 4, fp32) and one of each CTC kernel a step; the SV step launches
    the codec's 27 pointwise passes (its decode without grad) and no other
    kernel of the port. The loss finite, the BatchNorm running statistics
    moved from the init, the save reloading as train_distill reads it,
    equal to the returned params. Median step ms of steps 2-5 and latent
    frames a second (batch x 256), peak max_memory_allocated; one more step
    profiled (host dispatch, wall, device busy, idle share, kernels a step,
    the CTC and attention kernels' device ms). The ASR step against the
    same step under kernels.force_plain(): loss within 1e-5 relative, each
    module's gradient within ASR_GRAD_TOL rel-L2, beside the plain step's
    own move when its latents go one ulp up. After train sv, sv_teacher_embed
    at VOXCELEB_ECAPA on seed-0 random weights over the decoded 24 kHz
    batch: (2, 192), finite."""
    import contextlib
    import shutil
    import statistics
    import tempfile

    import numpy as np

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.models.asr import ASRConfig, init_asr
    from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, init_codec
    from smalltts_tpu_torch.models.sv import SVConfig, init_sv
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.train import asr_train as AT
    from smalltts_tpu_torch.train import sv_train as ST
    from smalltts_tpu_torch.train.optim import aux_optimizer
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.convert import params_from_jax

    t_phase = time.perf_counter()
    asr = which == "asr"
    cfg = ASRConfig() if asr else SVConfig()
    codec_cfg = CodecConfig()
    steps, b = 5, 2
    print(f"phase train {which}: {'train_asr, ASRConfig()' if asr else 'train_sv, SVConfig(), CodecConfig(), the fallback teacher'}"
          f", batch {b}, dummy loader, seed 0: {steps} steps with a save", flush=True)
    init = (init_asr if asr else init_sv)(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    codec = None if asr else init_codec(torch.Generator(device=dev).manual_seed(1), codec_cfg, device=dev)
    stamps, losses = [], []

    def on_step(step, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss))

    tmp = tempfile.mkdtemp(prefix=f"{which}_smoke_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if asr:
            params = AT.train_asr(AT.ASRTrainConfig(num_steps=steps, batch_size=b, save_every=steps - 1), cfg, seed=0,
                                  checkpoint_dir=tmp, device=dev, on_step=on_step, log_every=10 ** 9)
        else:
            params = ST.train_sv(ST.SVTrainConfig(num_steps=steps, batch_size=b, save_every=steps - 1), cfg, codec_cfg,
                                 seed=0, checkpoint_dir=tmp, device=dev, on_step=on_step, log_every=10 ** 9)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        # the SV step decodes its latents without grad: the codec's 27 pointwise passes a step
        want = ({"attention": cfg.conformer.num_layers * steps, "ctc_forward": steps, "ctc_backward": steps} if asr
                else {"codec_pointwise": CODEC_PASSES * steps})
        check(launches == want, f"train {which}: launches {launches}, want {want}")
        check(all(np.isfinite(losses)), f"train {which}: losses {losses}")
        fi, fp = ckpt.flatten_pytree(init), ckpt.flatten_pytree(params)
        stats = [k for k in fi if k.endswith(("/mean", "/var"))]
        moved = sum(not torch.equal(fi[k], fp[k]) for k in stats)
        check(moved == len(stats) > 0, f"train {which}: {moved} of {len(stats)} BatchNorm statistics moved")
        back = ckpt.flatten_pytree(params_from_jax(ckpt.load_pytree(os.path.join(tmp, "checkpoint_latest.npz")), cfg))
        check(back.keys() == fp.keys() and all(torch.equal(back[k], fp[k].cpu()) for k in fp),
              f"train {which}: the save does not reload equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_ms = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
    med = statistics.median(step_ms)
    row = dict(config="ASRConfig()" if asr else "SVConfig(), CodecConfig(), fallback teacher", batch=b, steps=steps,
               losses=losses, step_ms=step_ms, step_ms_median=med, latent_frames_per_s=b * 256 / (med / 1e3),
               wall_s=wall_s, peak_memory_bytes=peak, launches=launches, batchnorm_stats_moved=moved)

    # one more step profiled, on the trained state
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             dummy_batch(np.random.default_rng(7), DummyDataConfig(batch_size=b)).items() if k != "texts"}
    tx, _ = aux_optimizer(params, 200_000, clip_norm=None if asr else 5.0)
    opt = tx.init(params)
    if asr:
        step = AT.make_asr_step(cfg, tx)
        one = lambda: step(params, opt, batch)  # noqa: E731
    else:
        teacher_fn, teacher_p = ST.make_fallback_teacher(cfg.emb_dim, device=dev)
        step = ST.make_sv_step(cfg, codec_cfg, tx, teacher_fn)
        one = lambda: step(params, opt, codec, teacher_p, batch)  # noqa: E731
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    dispatch = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy, kern = profile_batch(lambda: (one(), torch.cuda.synchronize()))
    wall = statistics.median(walls)
    row["profile"] = dict(dispatch_ms=dispatch, wall_ms=walls, device_busy_ms=busy, idle_share=1.0 - busy / wall,
                          kernels=sum(c for _, _, c in kern),
                          ctc_kernel_ms={m: sum(t for k, t, _ in kern if m in k) for m in
                                         ("ctc_forward_kernel", "ctc_backward_kernel")},
                          attention_kernel_ms=sum(t for k, t, _ in kern if any(m in k for m in ATTN_KERNELS)),
                          top=[dict(kernel=k[:90], ms=t, count=c) for k, t, c in kern[:8]])

    if asr:  # kernels against plain: one step's loss and gradients; the plain step's rounding floor beside
        lat = batch["latents"]
        nudged = dict(batch, latents=torch.where(lat != 0, torch.nextafter(lat, torch.full_like(lat, float("inf"))),
                                                 lat))
        res = []
        for plain, b_ in ((False, batch), (True, batch), (True, nudged)):
            cap = CaptureGrads()
            with kernels.force_plain() if plain else contextlib.nullcontext():
                _, _, loss = AT.make_asr_step(cfg, cap)(params, {}, b_)
            res.append((float(loss), cap.grads))
        (lk, gk), (lp, gp), (_, gn) = res
        loss_err = abs(lk - lp) / max(abs(lp), 1e-30)
        worst = max(module_grad_rel_l2(gk, gp).values())
        floor = max(module_grad_rel_l2(gn, gp).values())
        print(f"  train asr kernels vs plain: loss rel err {loss_err:.3e} (tolerance 1e-5), worst module gradient "
              f"rel-L2 {worst:.3e} (tolerance {ASR_GRAD_TOL}); the plain step with its latents one ulp up: "
              f"{floor:.3e}", flush=True)
        check(loss_err <= 1e-5 and worst <= ASR_GRAD_TOL,
              f"train asr kernels vs plain: loss {loss_err:.3e}, worst module gradient {worst:.3e}")
        row["kernels_vs_plain"] = dict(loss=lk, loss_rel_err=loss_err, grad_rel_l2_worst=worst,
                                       plain_one_ulp_grad_rel_l2_worst=floor)
        for e in entries:
            if e["name"].startswith("ctc_"):
                e["launches"] = launches.get(e["name"], 0)
                e["launches_per_asr_step"] = e["launches"] / steps
    else:  # the waveform teacher at the voxceleb ECAPA's width over the decoded batch
        from smalltts_tpu_torch.models.sv_teacher import VOXCELEB_ECAPA, init_sv_teacher, make_teacher_fn

        teacher = init_sv_teacher(torch.Generator(device=dev).manual_seed(0), VOXCELEB_ECAPA, device=dev)
        fn, _ = make_teacher_fn(teacher)
        with torch.no_grad():
            audio = codec_decode(codec, batch["latents"], codec_cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb = fn(teacher, audio, batch["latents_lengths"] * codec_cfg.hop)
            torch.cuda.synchronize()
        check(emb.shape == (b, 192) and bool(torch.isfinite(emb).all()), f"sv_teacher_embed: {tuple(emb.shape)}")
        row["sv_teacher_embed"] = dict(audio=list(audio.shape), emb=list(emb.shape), wall_ms=(time.perf_counter() - t0) * 1e3)
    print(f"  train {which}: {json.dumps(row)}", flush=True)
    e = next(e for e in entries if e["name"] == "ctc_forward")
    e[f"train_{which}"] = row
    torch.cuda.empty_cache()
    print(f"  phase train {which}: {time.perf_counter() - t_phase:.2f} s", flush=True)


def corpus_phase(entries, timeout_s=600):
    """Phase train corpus: write_corpus of 16 utterances into a temporary
    directory, then `python -m smalltts_tpu_torch.train.asr_train --data-dir
    DIR --steps 2` in its own process, which encodes the corpus with a
    random-init native codec on the card (it warns so) and trains; its exit
    code must be 0 and it must log step 0."""
    import shutil
    import tempfile

    import smalltts_tpu_torch
    from smalltts_tpu_torch.data.synthetic import write_corpus

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.abspath(smalltts_tpu_torch.__file__)))
    tmp = tempfile.mkdtemp(prefix="corpus_smoke_")
    try:
        utts = write_corpus(os.path.join(tmp, "corpus"), n_utts=16, n_speakers=4, seed=0)
        cmd = [sys.executable, "-m", "smalltts_tpu_torch.train.asr_train", "--data-dir", os.path.join(tmp, "corpus"),
               "--steps", "2", "--checkpoint-dir", os.path.join(tmp, "ckpt")]
        print(f"phase train corpus: {len(utts)} utterances written; {' '.join(cmd[1:])}", flush=True)
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout_s)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tail = (res.stdout + res.stderr)[-1500:]
    print("  " + tail.replace("\n", "\n  "), flush=True)
    check(res.returncode == 0 and "step 0: asr_ctc=" in res.stdout, f"train corpus: exit {res.returncode}")
    check("random-init codec" in res.stderr, "train corpus: no random-init codec warning")
    e = next(e for e in entries if e["name"] == "ctc_forward")
    e["train_corpus"] = dict(utterances=len(utts), rc=res.returncode, seconds=secs)
    print(f"  phase train corpus: {time.perf_counter() - t_phase:.2f} s", flush=True)


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
      into a temporary directory that is removed) and 2 in bf16: the
      attention launches of each iteration, counted, equal to what
      distill_attention_launches derives (step 0's gates are shut: `step >
      0`), one launch of each CTC kernel an iteration with the ASR's gate
      open and no other kernel, and no attention shape that was not held
      against plain above; the metrics finite; student, scorer and disc
      changed; the teacher bit-equal to its start; the saved npz files
      reload equal. Peak max_memory_allocated. Then, on the trained state,
      3 more iterations step by step, the first with the gates shut: each
      step's launches, in all and by shape (the conformers' against the
      derived counts), and the median ms of the last 2; in fp32 one
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
        """(n device-clock times (ms) of fn's kernel from separate calls of
        `timed`, their clocks joined by "+"); a call with no device-clock
        reading is taken again, up to 2n calls, and fewer than n device
        readings fail the run."""
        got, clocks = [], set()
        for _ in range(2 * n):
            ms, _, clock = timed(fn, 20, ATTN_KERNELS)
            if clock in DEVICE_CLOCKS:
                got.append(ms)
                clocks.add(clock)
                if len(got) == n:
                    break
        check(len(got) == n, f"attention: {len(got)} of {n} device-clock times")
        return got, "+".join(sorted(clocks))

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
        ms_runs, clock = device_times(lambda: A.fused_attention(q, k, v, m))
        plain_ms = timed(lambda: A.attention_plain(q, k, v, m), 10)[0]
        lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None, None, :]),
                       20)[0]
        extra = {}
        if D_ == 4:  # exponentials, multiply-adds over the live keys, or bytes; the old yardstick beside
            b_ms, b_by, extra["bound_term"], extra["old_bound_ms"] = small_bound(
                torch, nbytes(q, k, v, m, got), B, H, Tq, S, live_keys(m))
        else:
            b_ms, b_by = bound(nbytes(q, k, v, m, got), 4.0 * B * H * Tq * S * D_, attn_kind(dtype, D_))
        row = dict(shape=f"{label} B={B} H={H} D={D_}", key=shape_key(B, H, Tq, S, D_, kind), dtype=kind, max_abs_err=abs_e,
                   rel_err=rel_e, grad_rel_err=grad_err, ms=statistics.median(ms_runs), ms_runs=ms_runs,
                   clock=clock, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, **extra)
        rows.append(row)
        print("  attention at the distiller's shapes: " + json.dumps(row), flush=True)
        del q, k, v, dout, got, want
    attn["head_dims"] = list(A.HEAD_DIMS)
    attn["padded_head_dims"] = dict(A.PADDED_HEAD_DIMS)
    attn["distill_shapes"] = rows
    for D_bad in (12, 32):  # any other head dim still raises
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
    batch = batch_of(11)
    dgen = torch.Generator(device=dev).manual_seed(12)
    sd, dd, scd = D.student_draws(dgen, batch), D.disc_draws(dgen, batch), D.scorer_draws(dgen, batch, 1)
    tcfg = D.DistillConfig(asr_start_step=0, sv_start_step=0, scorer_updates=1)
    res = []
    for plain in (False, True):
        txs = (CaptureGrads(), CaptureGrads(), CaptureGrads())
        with kernels.force_plain() if plain else contextlib.nullcontext():
            _, _, carry, metrics = D.make_student_step(cfg, disc_cfg, asr_cfg, sv_cfg, txs[0], tcfg)(
                teacher, {}, teacher, teacher, disc, asr, sv, batch, 1, sd)
            _, _, d_loss = D.make_disc_step(cfg, disc_cfg, txs[1])(disc, {}, teacher, batch, carry, dd)
            _, _, s_loss = D.make_scorer_step(cfg, txs[2], 1)(teacher, {}, teacher, batch, carry, scd)
        res.append(({**{k: float(v) for k, v in metrics.items()}, "disc_loss": float(d_loss),
                     "scorer_loss": float(s_loss)},
                    {n: t.grads for n, t in zip(("student", "disc", "scorer"), txs)}))
        del carry, txs
    (mk, gk), (mp_, gp) = res
    loss_err = {k: abs(mk[k] - mp_[k]) / max(abs(mp_[k]), 1e-30) for k in mk}
    grad_err = {net: module_grad_rel_l2(g_, gp[net]) for net, g_ in gk.items()}
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

    # the CTC loss alone at the student step's shape (the CTC kernels): host time of its forward and
    # backward, synchronized, median of 3
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
        """Three more iterations on the trained state, step by step (each
        step synchronized and timed, its attention launches counted, in all
        and by shape): the first at step 0 (the gates shut), two at step 10
        (open; the step ms medians are theirs). With `profile` one more
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
        for i, step in enumerate((0, 10, 10)):
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
            steps = 3 if save else 2  # train_distill saves at a step past 1
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
            # the CTC kernels: one of each a student step with the ASR's gate open
            want_ctc = sum(s > tcfg.asr_start_step for s in range(steps))
            check(iter_launches == want_iter and set(launches) == {"attention", "ctc_forward", "ctc_backward"}
                  and launches["ctc_forward"] == launches["ctc_backward"] == want_ctc,
                  f"train distill {dtype}: attention launches by iteration {iter_launches}, want {want_iter}; "
                  f"all launches {launches}, want {want_ctc} of each CTC kernel")
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
                       ctc_launches={k: launches[k] for k in ("ctc_forward", "ctc_backward")},
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
    for e in entries:
        if e["name"].startswith("ctc_"):
            e["launches_train_distill"] = {k: r["ctc_launches"][e["name"]] for k, r in runs.items()}
    attn["launches_train_distill"] = {k: r["attention_launches_by_iteration"] for k, r in runs.items()}
    del teacher, disc, asr, sv
    torch.cuda.empty_cache()
    print(f"  attention launches an iteration by shape: "
          f"{json.dumps({r['key']: r['launches_per_iteration'] for r in rows})}", flush=True)
    print(f"  phase train distill: {time.perf_counter() - t_phase:.2f} s", flush=True)


# IMF training, kernels against plain over one fp32 step: the loss, and each module's gradient rel-L2
# (fp32 sums in another order, as the distill phase bounds them)
IMF_LOSS_TOL = 1e-4
IMF_GRAD_TOL = 1e-4
# the bf16 teacher's rollout (float32 activations over bf16 weights, as in JAX) against the plain versions:
# fp32 sums in another order through 4 substeps of 12 layers
IMF_ROLLOUT_TOL = 1e-4
# unprofiled iterations timed a variant, after its first
IMF_TIMED = 3


def imf_launches(cfg, disc_cfg, tc, data):
    """Attention launches of one IMF iteration (student step, then the disc
    or scorer step), derived from the configs: {(B, H, Tq, S, D):
    launches}. A backbone forward launches one a text, style and DiT layer;
    a cached denoise (the split layout) one a DiT layer; the backward
    launches none (PyTorch ops). The student step: the student's
    conditioning (text, style), the teacher's rollout_substeps denoises
    (and one more with roll-in or the boundary pair on), the student's
    forward with grad; with gan_weight the teacher's style encoder, the
    full-interval student forward, the teacher's backbone forward on the
    fake and the discriminator, then the disc step's teacher backbone
    forward and discriminator at batch 4; with dmd_weight the composition's
    focus_num_steps student forwards, the teacher's 3x CFG backbone forward
    and the scorer's, then dmd_scorer_updates scorer forwards."""
    b, P, R, T = data.batch_size, data.max_phonemes, data.max_ref, data.max_latents
    L = cfg.dit.n_blocks
    text = lambda n: (n, cfg.text.num_heads, P, P, cfg.text.head_dim)  # noqa: E731
    style = lambda n: (n, cfg.style.num_heads, R, R, cfg.style.head_dim)  # noqa: E731
    dit = lambda n: (n, cfg.dit.heads, T, T + R + P, cfg.dit.head_dim)  # noqa: E731
    s_disc = disc_cfg.num_tail_layers * T + R + P
    disc = lambda n: (n, disc_cfg.conformer.num_heads, s_disc, s_disc,  # noqa: E731
                      disc_cfg.model_dim // disc_cfg.conformer.num_heads)
    attn = {}

    def add(key, n):
        attn[key] = attn.get(key, 0) + n

    def backbone(n):
        add(text(n), cfg.text.num_layers)
        add(style(n), cfg.style.num_layers)
        add(dit(n), L)

    teacher_denoises = tc.rollout_substeps + (tc.boundary_prob > 0)
    add(text(b), cfg.text.num_layers)
    add(style(b), cfg.style.num_layers)
    add(dit(b), L * (teacher_denoises + (tc.rollin_prob > 0) + 1))  # + the roll-in's and the loss's student
    if tc.gan_weight > 0:
        add(style(b), cfg.style.num_layers)
        add(dit(b), L)
        backbone(b)
        add(disc(b), disc_cfg.conformer.num_layers)
        backbone(b)
        add(disc(2 * b), disc_cfg.conformer.num_layers)
    if tc.dmd_weight > 0:
        add(dit(b), L * tc.focus_num_steps)
        backbone(3 * b)
        backbone(b)
        for _ in range(tc.dmd_scorer_updates):
            backbone(b)
    return attn


def imf_phase(torch, dev, entries):
    """Phase train imf: IMF training through the port's train_imf at full
    width (the default BackboneConfig, 328M, no remat as in the JAX
    package; DiscriminatorConfig(960, 960)), batch 2, the dummy loader,
    seed-0 random weights (the zero-init leaves re-drawn) as the teacher.

    - Kernels against kernels.force_plain(): one fp32 make_imf_step step
      from the same student (r_gate drawn) and draws, with an optimizer that
      records the gradients: the loss within IMF_LOSS_TOL, each module's
      gradient within IMF_GRAD_TOL rel-L2.
    - The bf16 teacher's rollout (4 substeps, the split tree) against its
      plain versions: IMF_ROLLOUT_TOL rel-L2, exactly 4 x 12 attention
      launches and no other kernel.
    - train_imf, IMF_TIMED + 2 iterations each: plain fp32 (a save at the
      last) and bf16 (the teacher, so the student, in bf16), adversarial
      (gan_weight 1e-3) and DMD (dmd_weight 1.0, 2 scorer updates) in
      fp32. Each iteration's attention launches by shape equal
      imf_launches' and nothing else launches (no attention shape that the
      distill phase did not hold against plain), the losses finite, the
      teacher unchanged, the frozen leaves equal to the teacher's. The ms
      of the IMF_TIMED unprofiled iterations after the first (median, min,
      max), peak max_memory_allocated, and the last iteration profiled
      (device busy, kernels; the idle share 1 - busy / that median). The
      saved fp32 student reloads equal and is served once by
      SmallTTS(checkpoint=...) as IMF-2."""
    import contextlib
    import shutil
    import statistics
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.backbone import BackboneConfig, encode_conditions, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.discriminator import DiscriminatorConfig
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.masking import length_mask
    from smalltts_tpu_torch.ops.precision import cast_floats
    from smalltts_tpu_torch.train import imf as I
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.convert import params_from_jax

    attn = next(e for e in entries if e["name"] == "attention")
    t_phase = time.perf_counter()
    cfg = BackboneConfig()
    disc_cfg = DiscriminatorConfig(transformer_dim=cfg.hidden_dim, ref_dim=cfg.hidden_dim)
    data = DummyDataConfig(batch_size=2)
    print("phase train imf: train_imf, default BackboneConfig (teacher and student), DiscriminatorConfig(960, 960), "
          "batch 2, seed 0, dummy loader", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    teacher = redraw_zero_init(init_backbone(gen, cfg, device=dev), gen)

    def batch_of(seed):
        return {k: torch.as_tensor(v, device=dev) for k, v in dummy_batch(np.random.default_rng(seed), data).items()
                if k != "texts"}

    # ------------------------------------------------------------ kernels vs plain, one fp32 step
    batch = batch_of(31)
    tc = I.ImfConfig()
    student = I.init_imf_student(teacher)
    student["r_gate"] = 0.1 * torch.randn(student["r_gate"].shape, generator=gen, device=dev)
    draws = I.imf_draws(torch.Generator(device=dev).manual_seed(32), batch, tc)
    res = []
    for plain in (False, True):
        tx = CaptureGrads()
        with kernels.force_plain() if plain else contextlib.nullcontext():
            _, _, loss = I.make_imf_step(cfg, tx, tc)(student, {}, teacher, batch, draws)
        res.append((float(loss), tx.grads))
    (lk, gk), (lp, gp) = res
    loss_err = abs(lk - lp) / abs(lp)
    grad_err = module_grad_rel_l2(gk, gp)
    worst = max(grad_err.values())
    print(f"  kernels vs plain, one fp32 step: loss {lk:.6f} against {lp:.6f}, relative error {loss_err:.3e} "
          f"(tolerance {IMF_LOSS_TOL}); worst module gradient rel-L2 {worst:.3e} (tolerance {IMF_GRAD_TOL}): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in grad_err.items()})}", flush=True)
    check(np.isfinite(lk) and loss_err <= IMF_LOSS_TOL, f"imf loss kernels vs plain: {lk} against {lp}")
    check(worst <= IMF_GRAD_TOL, f"imf gradients kernels vs plain: {grad_err}")
    frozen = [k for k, g_ in ckpt.flatten_pytree(gk).items() if set(k.split("/")) & set(I.IMF_FROZEN)]
    check(frozen and all(not ckpt.flatten_pytree(gk)[k].any() for k in frozen), "imf: a frozen leaf got a gradient")
    attn["imf_kernels_vs_plain"] = dict(loss=lk, loss_rel_err=loss_err, grad_rel_l2=grad_err)
    del res, gk, gp, student

    # ------------------------------------------------------------ the bf16 rollout against plain
    t16 = cast_floats(teacher, torch.bfloat16)
    mask = length_mask(batch["latents_lengths"], data.max_latents)
    with torch.no_grad():
        cond = encode_conditions(t16, cfg, batch["ref_latents"], batch["ref_latents_lengths"], batch["phonemes"],
                                 length_mask(batch["phonemes_lengths"], data.max_phonemes))
    x_t = torch.randn(batch["latents"].shape, generator=gen, device=dev)
    t_, r_ = torch.tensor([0.9, 0.6], device=dev), torch.tensor([0.3, 0.02], device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = I.teacher_rollout(t16, cfg, x_t, mask, t_, r_, cond, tc.rollout_substeps)
    torch.cuda.synchronize()
    roll_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want_roll = {"attention": cfg.dit.n_blocks * tc.rollout_substeps}
    with kernels.force_plain():
        want = I.teacher_rollout(t16, cfg, x_t, mask, t_, r_, cond, tc.rollout_substeps)
    roll_err = float((got - want).norm() / want.norm())
    print(f"  bf16 teacher's rollout ({tc.rollout_substeps} substeps) against plain: rel-L2 {roll_err:.3e} "
          f"(tolerance {IMF_ROLLOUT_TOL}); launches {json.dumps(roll_launches)}", flush=True)
    check(bool(torch.isfinite(got).all()) and roll_err <= IMF_ROLLOUT_TOL, f"imf bf16 rollout rel-L2 {roll_err:.3e}")
    check(roll_launches == want_roll, f"imf bf16 rollout launches {roll_launches}, want {want_roll}")
    attn["imf_bf16_rollout_vs_plain"] = dict(rel_l2=roll_err, launches=roll_launches)
    del t16, cond, got, want
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ train_imf
    held = {r["key"] for r in attn.get("distill_shapes", [])}
    start = {k: t.clone() for k, t in ckpt.flatten_pytree(teacher).items()}
    tmp = tempfile.mkdtemp(prefix="imf_smoke_")
    runs = {}
    try:
        steps = IMF_TIMED + 2  # the first, the timed, the profiled
        for name, dtype, extra in (("plain fp32", torch.float32, {}), ("plain bf16", torch.bfloat16, {}),
                                   ("adv fp32", torch.float32, {"gan_weight": 1e-3}),
                                   ("dmd fp32", torch.float32, {"dmd_weight": 1.0})):
            tc = I.ImfConfig(num_steps=steps, batch_size=data.batch_size,
                             save_every=steps - 1 if name == "plain fp32" else 10 ** 9, **extra)
            want_attn = imf_launches(cfg, disc_cfg, tc, data)
            stamps, counts, shapes, metrics_seen = [], [], [], []
            prof = torch_profile(activities=[ProfilerActivity.CUDA])

            def on_step(step, metrics):
                torch.cuda.synchronize()
                if step == steps - 1:
                    prof.stop()
                stamps.append(time.perf_counter())
                counts.append(dict(kernels.LAUNCHES))
                shapes.append({k: n for k, n in kernels.SHAPE_LAUNCHES.items() if k[0] == "attention"})
                metrics_seen.append({k: float(v) for k, v in metrics.items()})
                if step == steps - 2:  # the last iteration profiled, device activity only
                    prof.start()
                    stamps.append(time.perf_counter())

            teacher_p = cast_floats(teacher, dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            student, loss = I.train_imf(tc, cfg, checkpoint_dir=tmp, teacher_params=teacher_p, seed=0, device=dev,
                                        log_every=10 ** 9, on_step=on_step)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            # per iteration: the launches by name and the attention's by shape, dtype summed
            iters, iter_shapes = [], []
            for prev, cur, sp, sc in zip([{}] + counts, counts, [{}] + shapes, shapes):
                iters.append({k: n - prev.get(k, 0) for k, n in cur.items() if n - prev.get(k, 0)})
                by = {}
                for (_, key), n in sc.items():
                    if n - sp.get(("attention", key), 0):
                        by[key[:5]] = by.get(key[:5], 0) + n - sp.get(("attention", key), 0)
                        kind = "bf16" if key[5] == torch.bfloat16 else "fp32"
                        check(f"B={key[0]} H={key[1]} Tq={key[2]} S={key[3]} D={key[4]} {kind}" in held,
                              f"train imf {name}: attention at {key} was not held against plain")
                iter_shapes.append(by)
            want_iter = {"attention": sum(want_attn.values())}
            check(all(it == want_iter for it in iters), f"train imf {name}: launches by iteration {iters}, "
                                                        f"want {want_iter}")
            check(all(by == want_attn for by in iter_shapes), f"train imf {name}: attention by shape {iter_shapes}, "
                                                              f"want {want_attn}")
            check(all(np.isfinite(v) for m in metrics_seen for v in m.values()) and np.isfinite(loss),
                  f"train imf {name}: metrics {metrics_seen}")
            flat = ckpt.flatten_pytree(student)
            check(all(torch.equal(t, start[k].to(dtype)) for k, t in ckpt.flatten_pytree(teacher_p).items()),
                  f"train imf {name}: the teacher changed")
            frozen = [k for k in start if set(k.split("/")) & set(I.IMF_FROZEN)]
            check(all(torch.equal(flat[k], start[k].to(dtype)) for k in frozen),
                  f"train imf {name}: a frozen leaf moved")
            check(sum(not torch.equal(flat[k], start[k].to(dtype)) for k in start) > 0 and bool(flat["r_gate"].any()),
                  f"train imf {name}: the student did not change")
            kern = [(e.key, _dev_us(e) / 1e3, e.count) for e in prof.key_averages() if _dev_us(e) > 0]
            busy = sum(t for _, t, _ in kern)
            step_ms = [(b_ - a_) * 1e3 for a_, b_ in zip(stamps[:-2], stamps[1:-2])]  # after the first, unprofiled
            check(len(step_ms) == IMF_TIMED, f"train imf {name}: {len(step_ms)} timed iterations")
            prof_ms = (stamps[-1] - stamps[-2]) * 1e3
            med = statistics.median(step_ms)
            # the idle share against the unprofiled iterations' wall: the profiler slows the host ~3x
            row = dict(dtype=str(dtype).split(".")[-1], batch=data.batch_size, iterations=steps, metrics=metrics_seen,
                       iteration_ms=step_ms, iteration_ms_median=med, iteration_ms_min=min(step_ms),
                       iteration_ms_max=max(step_ms), wall_s=wall_s, peak_memory_bytes=peak,
                       launches_per_iteration=iters[0],
                       attention_by_shape={"B={} H={} Tq={} S={} D={}".format(*k): n for k, n in want_attn.items()},
                       profiled_iteration=dict(wall_ms=prof_ms, device_busy_ms=busy, idle_share=1.0 - busy / med,
                                               kernels=sum(c for _, _, c in kern),
                                               attention_kernel_ms=sum(t for k_, t, _ in kern
                                                                       if any(m in k_ for m in ATTN_KERNELS)),
                                               top=[dict(kernel=k_[:90], ms=t, count=c) for k_, t, c in
                                                    sorted(kern, key=lambda r: -r[1])[:8]]))
            row["latent_frames_per_s"] = data.batch_size * data.max_latents / (med / 1e3)
            if name == "plain fp32":
                path = os.path.join(tmp, "imf_student_latest.npz")
                back = ckpt.flatten_pytree(params_from_jax(ckpt.load_pytree(path), cfg))
                check(back.keys() == flat.keys() and all(torch.equal(back[k], flat[k].cpu()) for k in flat),
                      "train imf: imf_student_latest.npz does not reload equal")
                kernels.reset_launches()
                tts = SmallTTS(checkpoint=path, pcm16_out=True, seed=0)
                durations, waves, ids = serve_requests()
                out = tts.synthesize(tts.encode_reference(waves[0]), ids[0], durations[0])
                torch.cuda.synchronize()
                served = {k: v for k, v in kernels.LAUNCHES.items() if v}
                check(tts.sampler == "imf" and tts.num_steps == 2 and out.dtype == np.int16
                      and int(np.abs(out).max()) > 0 and all(served.get(k, 0) > 0 for k in SCAN_KERNELS),
                      f"train imf: the saved student served as {tts.sampler}-{tts.num_steps}, launches {served}")
                row["served"] = dict(sampler=f"{tts.sampler}-{tts.num_steps}", samples=int(out.shape[-1]),
                                     launches=served)
                del tts
            print(f"  train_imf {name}: {json.dumps(row)}", flush=True)
            runs[name] = row
            del student, flat, teacher_p, prof
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    attn["train_imf"] = runs
    attn["launches_train_imf"] = {k: r["launches_per_iteration"].get("attention", 0) for k, r in runs.items()}
    print("  train_imf iteration ms (median, min, max of the timed): " + json.dumps(
        {k: [r["iteration_ms_median"], r["iteration_ms_min"], r["iteration_ms_max"]] for k, r in runs.items()}),
        flush=True)
    del teacher
    torch.cuda.empty_cache()
    print(f"  phase train imf: {time.perf_counter() - t_phase:.2f} s", flush=True)


# ------------------------------------------------------------------ the codec trainers and the tools

CODEC_LOSS_TOL = 1e-5  # card against CPU, fp32: the convolutions and FFTs sum in another order
CODEC_STEP_TOL = 1e-4  # rel-L2 of the whole tree of updated params
# each leaf's rel-L2: the snake log_alpha leaves are zero at init, so after one step they hold AdamW's first
# updates alone, g / (|g| + eps), and an element whose gradient is near zero may take the other sign (up to
# 7.6e-3 between the two packages on the CPU, tests/test_torch_codec_train.py); small biases share it
CODEC_LEAF_TOL = 2e-2
# whole-tree rel-L2 of the gradient, card against CPU: fp32 rounding magnified by the log of small STFT
# magnitudes (the two packages differ by 1e-5-1e-4 a leaf on the CPU); TF32's 10-bit mantissa anywhere in
# the convolutions' backward would move it by orders of magnitude more
CODEC_GRAD_TOL = 1e-3
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")  # cuDNN's forward and backward


class RecordGrads:
    """An optimizer wrapper that keeps the gradients of its last update."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.tx.update(grads, state, params)


def profile_step(fn):
    """(device busy ms, [(kernel, ms, count)], [(op, device ms, count)]) of
    one call of `fn` under torch.profiler: kernels by their own device time,
    aten ops by the device time of everything they launch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    avgs = prof.key_averages()
    kern = sorted(((e.key, _dev_us(e) / 1e3, e.count) for e in avgs
                   if str(getattr(e, "device_type", "")).endswith("CUDA") and _dev_us(e) > 0), key=lambda r: -r[1])
    total = lambda e: float(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0) or 0)  # noqa: E731
    ops = sorted(((e.key, total(e) / 1e3, e.count) for e in avgs if e.key.startswith("aten::") and total(e) > 0),
                 key=lambda r: -r[1])
    return sum(r[1] for r in kern), kern, ops


def step_profile(torch, one, n_walls=3):
    """Host dispatch, wall ms (median of `n_walls`), device busy, idle
    share, kernels and the top kernels and aten ops of one call of `one`
    (warmed up first)."""
    import statistics

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    dispatch = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    walls = []
    for _ in range(n_walls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy, kern, ops = profile_step(lambda: (one(), torch.cuda.synchronize()))
    wall = statistics.median(walls)
    conv_rank = {n: next((i for i, (k, _, _) in enumerate(ops) if k == n), None) for n in CONV_OPS}
    return dict(dispatch_ms=dispatch, wall_ms=walls, device_busy_ms=busy, idle_share=1.0 - busy / wall,
                kernels=sum(c for _, _, c in kern), conv_op_rank=conv_rank,
                conv_ms={n: next((t for k, t, _ in ops if k == n), 0.0) for n in CONV_OPS},
                top_kernels=[dict(kernel=k[:90], ms=t, count=c) for k, t, c in kern[:8]],
                top_ops=[dict(op=k, ms=t, count=c) for k, t, c in ops[:12]])


def check_conv_ops(row, label):
    """cuDNN's convolution forward and backward among the step's 12 aten ops
    with the most device time."""
    ranks = row["conv_op_rank"]
    check(all(r is not None and r < 12 for r in ranks.values()), f"{label}: cuDNN convolution ops ranked {ranks}")


def timed_steps(stamps, first, n=5):
    """The ms of steps first .. first + n - 1 from the stamps taken after each
    step, and their median."""
    import statistics

    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])][first - 1:first - 1 + n]
    return ms, statistics.median(ms)


def codec_train_phase(torch, dev, entries):
    """Phase train codec: train_codec at CodecConfig() (77.6M params) and
    CodecTrainConfig()'s batch 8 x 25,600 samples, fp32, the dummy audio,
    seed 0: 7 steps with a save at step 6 (save_every lowered; into a
    temporary directory that is removed). No kernel of the port launches
    (the codec reaches no pallas_call: cuDNN's convolutions with TF32 off,
    torch.fft). The losses finite; the save reloads equal to the returned
    params with codec_meta's config. Median ms of steps 1-5, peak
    max_memory_allocated, one more step profiled (dispatch, wall, busy, idle
    share, top kernels and aten ops: cuDNN's convolution forward and
    backward among the top 12). Then one step from the same weights and
    batch on the card and on the CPU, with PyTorch's default
    cudnn.allow_tf32 = True left on: loss within CODEC_LOSS_TOL, gradient
    within CODEC_GRAD_TOL, updated params within CODEC_STEP_TOL (each leaf
    CODEC_LEAF_TOL); beside it, what the check guards against: the card's
    gradient with _Conv1dF32 bypassed, so that cuDNN computes the training
    convolutions in TF32 (PyTorch's default)."""
    import shutil
    import tempfile

    import numpy as np

    from smalltts_tpu_torch.models.codec import CodecConfig, init_codec
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.train import codec_train as CT
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import codec_config_from_meta
    from smalltts_tpu_torch.utils.convert import params_from_jax

    t_phase = time.perf_counter()
    cfg, tc = CodecConfig(), CT.CodecTrainConfig(num_steps=7, save_every=6)
    print(f"phase train codec: train_codec, CodecConfig(), batch {tc.batch_size} x {tc.segment_samples} samples, "
          "fp32, dummy audio, seed 0: 7 steps with a save at step 6", flush=True)
    stamps, losses = [], []

    def on_step(step, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss))

    tmp = tempfile.mkdtemp(prefix="codec_smoke_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        params = CT.train_codec(tc, cfg, seed=0, checkpoint_dir=tmp, log_every=10 ** 9, device=dev, on_step=on_step)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(not launches, f"train codec launched kernels of the port: {launches}")
        check(all(np.isfinite(losses)), f"train codec: losses {losses}")
        path = os.path.join(tmp, "checkpoint_latest.npz")
        check(codec_config_from_meta(ckpt.load_meta(path)) == cfg, "train codec: the save's codec_meta")
        back = ckpt.flatten_pytree(params_from_jax(ckpt.load_pytree(path), cfg))
        fp = ckpt.flatten_pytree(params)
        check(back.keys() == fp.keys() and all(torch.equal(back[k], fp[k].cpu()) for k in fp),
              "train codec: the save does not reload equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_ms, med = timed_steps(stamps, 1)
    n_params = sum(t.numel() for t in fp.values())
    row = dict(config="CodecConfig()", params=n_params, batch=tc.batch_size, segment_samples=tc.segment_samples,
               steps=7, losses=losses, step_ms=step_ms, step_ms_median=med,
               save_step_ms=(stamps[6] - stamps[5]) * 1e3,
               audio_seconds_per_s=tc.batch_size * tc.segment_samples / 24_000 / (med / 1e3), wall_s=wall_s,
               peak_memory_bytes=peak)

    tx = CT.codec_optimizer(params, tc)
    opt = tx.init(params)
    step = CT.make_codec_step(cfg, tc, tx)
    audio = torch.from_numpy(next(CT.dummy_audio_iter(tc.batch_size, tc.segment_samples, seed=1))).to(dev)
    row["profile"] = step_profile(torch, lambda: step(params, opt, audio))
    check_conv_ops(row["profile"], "train codec")
    del params, opt, tx, step
    torch.cuda.empty_cache()

    # the same step on the card and on the CPU, TF32 left at PyTorch's default for cuDNN
    check(torch.backends.cudnn.allow_tf32, "cudnn.allow_tf32 is not at PyTorch's default (True)")
    init = init_codec(torch.Generator().manual_seed(0), cfg)
    batch = torch.from_numpy(next(CT.dummy_audio_iter(tc.batch_size, tc.segment_samples, seed=2)))
    res = {}
    for d in ("cpu", dev):
        p = ckpt.map_pytree(lambda t: t.to(d), init)
        rec = RecordGrads(CT.codec_optimizer(p, tc))
        t0 = time.perf_counter()
        new, _, loss, _ = CT.make_codec_step(cfg, tc, rec)(p, rec.init(p), batch.to(d))
        res[str(d)] = (float(loss), ckpt.flatten_pytree(ckpt.map_pytree(lambda t: t.cpu(), new)),
                       ckpt.flatten_pytree(ckpt.map_pytree(lambda t: t.cpu(), rec.grads)), time.perf_counter() - t0)
    (l_cpu, p_cpu, g_cpu, s_cpu), (l_dev, p_dev, g_dev, _) = res["cpu"], res[str(dev)]
    from smalltts_tpu_torch.ops import nn as pnn

    pnn._Conv1dF32.apply = lambda h, w, dilation, groups: torch.nn.functional.conv1d(h, w, None, dilation=dilation,
                                                                                   groups=groups)
    try:  # the convolutions in TF32, forward and backward: what _Conv1dF32 keeps out
        p = ckpt.map_pytree(lambda t: t.to(dev), init)
        rec = RecordGrads(CT.codec_optimizer(p, tc))
        CT.make_codec_step(cfg, tc, rec)(p, rec.init(p), batch.to(dev))
        g_tf32 = ckpt.flatten_pytree(ckpt.map_pytree(lambda t: t.cpu(), rec.grads))
    finally:
        del pnn._Conv1dF32.apply

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))

    cat = lambda flat: torch.cat([v.reshape(-1) for v in flat.values()])  # noqa: E731
    zero = {k for k, v in ckpt.flatten_pytree(init).items() if not bool(v.any())}
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    grad_err = rel_l2(cat(g_dev), cat(g_cpu))
    tf32_err = rel_l2(cat(g_tf32), cat(g_cpu))
    whole = rel_l2(cat(p_dev), cat(p_cpu))
    leaves = {k: rel_l2(p_dev[k], p_cpu[k]) for k in p_cpu}
    worst = max(v for k, v in leaves.items() if k not in zero)
    worst_zero = max(v for k, v in leaves.items() if k in zero)
    print(f"  one step, card against CPU from the same weights and batch (cudnn.allow_tf32 True): loss rel err "
          f"{loss_err:.3e} (tolerance {CODEC_LOSS_TOL}), gradient rel-L2 {grad_err:.3e} ({CODEC_GRAD_TOL}; with "
          f"the convolutions in TF32 {tf32_err:.3e}), params rel-L2 {whole:.3e} whole ({CODEC_STEP_TOL}), worst "
          f"leaf {worst:.3e} nonzero at init, {worst_zero:.3e} zero-init log_alpha ({CODEC_LEAF_TOL}); the CPU "
          f"step took {s_cpu:.2f} s", flush=True)
    check(loss_err <= CODEC_LOSS_TOL and grad_err <= CODEC_GRAD_TOL and whole <= CODEC_STEP_TOL
          and max(worst, worst_zero) <= CODEC_LEAF_TOL and zero
          and all("log_alpha" in k.split("/")[-1] for k in zero), "train codec: the card's step against the CPU's")
    row["card_vs_cpu"] = dict(batch=tc.batch_size, loss=l_dev, loss_rel_err=loss_err, grad_rel_l2=grad_err,
                              grad_rel_l2_convolutions_in_tf32=tf32_err, params_rel_l2=whole,
                              params_rel_l2_worst_leaf=worst, params_rel_l2_worst_zero_init_leaf=worst_zero,
                              cpu_step_s=s_cpu)
    print(f"  train codec: {json.dumps(row)}", flush=True)
    print(f"  phase train codec: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return row


def parse_final(stdout):
    """The metrics dict of a codec_distill CLI's last line, `final: {...}`."""
    import ast

    line = next((ln for ln in reversed(stdout.splitlines()) if ln.startswith("final: ")), None)
    check(line is not None, "the codec_distill CLI printed no final metrics")
    try:
        return ast.literal_eval(line[len("final: "):])
    except ValueError:  # nan or inf is no literal
        raise AssertionError(f"codec_distill CLI: non-finite metrics: {line}") from None


def codec_distill_phase(torch, dev, entries, tmp, timeout_s=600):
    """Phase train codec distill. The teacher: a second CodecConfig() codec
    (seed 2) exported by onnxtorch.export (fp32, dynamic batch and time axes)
    into `tmp`/assets, and a copy of its decoder alone into
    `tmp`/assets_decoder_only. The command line `python -m
    smalltts_tpu_torch.train.codec_distill --assets DIR --steps 7
    --save-every 6` runs on each directory, the two processes together: exit
    0, finite final metrics (enc_mse with the encoder graph only), the
    checkpoint saved. Then in this process, for each teacher: train_codec_distill
    at CodecConfig() and CodecDistillConfig()'s batch 4 x 22,400 samples,
    7 steps: median ms of steps 2-6, peak memory; one more step profiled
    (cuDNN's convolutions among the top ops) and the teacher's share of its
    device time (the teacher's encode and decode alone, profiled).
    Returns (the rows, the distilled checkpoint of the run with the encoder)."""
    import numpy as np

    import smalltts_tpu_torch
    from smalltts_tpu_torch.models.codec import CodecConfig, init_codec
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.train import codec_distill as CD

    t_phase = time.perf_counter()
    cfg = CodecConfig()
    print("phase train codec distill: the teacher a seed-2 CodecConfig() codec exported by onnxtorch.export; "
          "the student CodecConfig(), batch 4 x 22,400 samples, fp32", flush=True)
    dirs = {"encoder": os.path.join(tmp, "assets"), "decoder_only": os.path.join(tmp, "assets_decoder_only")}
    for d in dirs.values():
        os.makedirs(d)
    t0 = time.perf_counter()
    tp = init_codec(torch.Generator(device=dev).manual_seed(2), cfg, device=dev)
    with kernels.force_plain():
        for name, module, example, axes in (
                ("encoder", CodecEncoder(tp, cfg), torch.zeros((1, 1, 4 * cfg.hop), device=dev), {0: "b", 2: "t"}),
                ("decoder", CodecDecoder(tp, cfg), torch.zeros((1, 4, 64), device=dev), {0: "b", 1: "t"})):
            with open(os.path.join(dirs["encoder"], f"{name}.onnx"), "wb") as f:
                f.write(export(module, (example,), dynamic_axes={"x": axes}, input_names=["x"]))
    del tp
    shutil.copyfile(os.path.join(dirs["encoder"], "decoder.onnx"), os.path.join(dirs["decoder_only"], "decoder.onnx"))
    export_s = time.perf_counter() - t0
    root = os.path.dirname(os.path.dirname(os.path.abspath(smalltts_tpu_torch.__file__)))
    procs = {}
    for kind, d in dirs.items():
        cmd = [sys.executable, "-m", "smalltts_tpu_torch.train.codec_distill", "--assets", d, "--steps", "7",
               "--save-every", "6", "--checkpoint-dir", os.path.join(tmp, f"ckpt_{kind}")]
        print(f"  exported in {export_s:.2f} s; {' '.join(cmd[1:])}", flush=True)
        procs[kind] = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rows = {}
    t0 = time.perf_counter()
    for kind, proc in procs.items():
        out, errs = proc.communicate(timeout=timeout_s)
        print("  " + (out + errs)[-800:].replace("\n", "\n  "), flush=True)
        check(proc.returncode == 0, f"codec_distill CLI ({kind}): exit {proc.returncode}")
        final = parse_final(out)
        check(all(np.isfinite(v) for v in final.values()) and ("enc_mse" in final) == (kind == "encoder"),
              f"codec_distill CLI ({kind}): final {final}")
        saved = os.path.join(tmp, f"ckpt_{kind}", "codec_distilled.npz")
        check(os.path.isfile(saved), f"codec_distill CLI ({kind}): no checkpoint")
        rows[kind] = dict(cli_final=final, cli_rc=proc.returncode)
    cli_s = time.perf_counter() - t0

    for kind, d in dirs.items():
        teacher = OnnxCodec(os.path.join(d, "encoder.onnx") if kind == "encoder" else None,
                            os.path.join(d, "decoder.onnx"), device=dev)
        stamps, metrics = [], []

        def on_step(step, m):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            metrics.append({k: float(v) for k, v in m.items()})

        dc = CD.CodecDistillConfig(num_steps=7, save_every=10 ** 9)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        params, last = CD.train_codec_distill(dc, cfg, teacher=teacher, seed=0, checkpoint_dir=tmp,
                                              log_every=10 ** 9, device=dev, on_step=on_step)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(not launches, f"train codec distill launched kernels of the port: {launches}")
        check(all(np.isfinite(v) for m in metrics for v in m.values()), f"train codec distill ({kind}): {metrics}")
        step_ms, med = timed_steps(stamps, 2)
        samples = int(dc.seconds_per_sample * 24_000) // cfg.hop * cfg.hop
        tp_, dec, enc = CD._teacher_fns(teacher)
        tx, _ = CD.distill_optimizer(params, dc)
        opt = tx.init(params)
        step = CD.make_codec_distill_step(cfg, dc, dec, enc, tx)
        audio = torch.from_numpy(next(CD.synthetic_audio_iter(dc.batch_size, samples, seed=1))).to(dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        prof = step_profile(torch, lambda: step(params, opt, tp_, audio, gen))
        check_conv_ops(prof, f"train codec distill ({kind})")
        lat = torch.randn((dc.batch_size, samples // cfg.hop, cfg.latent_dim), generator=gen, device=dev)

        def teacher_only():
            with torch.no_grad():
                dec(tp_, enc(tp_, audio) if enc is not None else lat)
            torch.cuda.synchronize()

        teacher_only()
        t_busy = profile_step(teacher_only)[0]
        prof["teacher_busy_ms"] = t_busy
        prof["teacher_share"] = t_busy / prof["device_busy_ms"]
        rows[kind].update(batch=dc.batch_size, samples=samples, steps=7, losses=[m["loss"] for m in metrics],
                          last_metrics=metrics[-1], step_ms=step_ms,
                          step_ms_median=med, audio_seconds_per_s=dc.batch_size * samples / 24_000 / (med / 1e3),
                          peak_memory_bytes=peak, profile=prof)
        print(f"  train codec distill ({kind}): {json.dumps(rows[kind])}", flush=True)
        del teacher, params, opt, tx, step, tp_, dec, enc, teacher_only
        torch.cuda.empty_cache()
    print(f"  phase train codec distill: {time.perf_counter() - t_phase:.2f} s (the two command lines together "
          f"{cli_s:.2f} s)", flush=True)
    return rows, os.path.join(tmp, "ckpt_encoder", "codec_distilled.npz")


def codec_serve_and_tools_phases(torch, dev, entries, codec_ckpt, tmp):
    """Phase serve trained codec: SmallTTS(codec_checkpoint=the distilled
    .npz) on the seed-0 backbone, its codec config read from codec_meta, one
    padded batch (8, r 64, p 384, t 40) through its CUDA graph (captured
    first, the counters reset before the replay): int16 waveforms of t x
    hop samples, not all zero, and one batch's exact launches (attention 68:
    48 DiT, 12 style, 8 text; the scan's 384).

    Phase tools: `python -m smalltts_tpu_torch.scripts.profile --runs 1`'s
    main in this process (a default SmallTTS, one traced batch of 8 at 5 s):
    its Chrome trace holds the attention kernel's name and the annotated
    synthesize_padded range; compiled_cost and utilization of one codec
    decode of the distilled codec at (8, 40, 64) against the card's peaks
    (device_peaks: an unknown card raises); eval_quality --roundtrip
    --synthetic 1 on the distilled codec, finite numbers."""
    import numpy as np

    from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.scripts import eval_quality
    from smalltts_tpu_torch.scripts import profile as profile_script
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils import flops

    t_phase = time.perf_counter()
    print(f"phase serve trained codec: SmallTTS(codec_checkpoint={os.path.basename(codec_ckpt)}) on the seed-0 "
          "backbone, bf16, one padded batch through its CUDA graph", flush=True)
    tts = full_width_tts(torch, dev, codec_checkpoint=codec_ckpt)
    check(tts.codec_cfg == CodecConfig() and tts.onnx_codec is None, f"codec config {tts.codec_cfg}")
    saved = ckpt.load_pytree(codec_ckpt)["dec_out"]["b"]
    check(torch.equal(tts.codec_params["dec_out"]["b"].cpu(), torch.from_numpy(saved)), "the distilled codec's weights")
    args = padded_batch(tts)
    tts.synthesize_padded(*args)  # captured
    kernels.reset_launches()
    out = tts.synthesize_padded(*args)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    per = tts.num_steps * tts.cfg.dit.n_blocks
    want = {"attention": 68, "adaln_modulate": 2 * per, "qk_norm_rope": per, "gemm_bias": per, "gemm_swiglu": per,
            "gemm_residual": 2 * per, "codec_pointwise": CODEC_PASSES}
    check(launches == want, f"serve trained codec: launches {launches}, want {want}")
    check(out.dtype == np.int16 and out.shape == (8, 1, args[5] * CodecConfig().hop) and int(np.abs(out).max()) > 0,
          f"serve trained codec: {out.dtype} {out.shape}")
    timing = graph_timing(torch, tts, args)
    row = dict(batch=list(bucket_key(args)), launches=launches, peak_abs=int(np.abs(out).max()),
               **{k: timing[k] for k in ("dispatch_ms_median", "wall_ms_median", "graph_span_ms")})
    print(f"  serve trained codec: {json.dumps(row)}", flush=True)
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["serve_trained_codec"] = row
    print(f"  phase serve trained codec: {time.perf_counter() - t_phase:.2f} s", flush=True)

    t_phase = time.perf_counter()
    print("phase tools: scripts.profile --runs 1 (trace), compiled_cost / utilization of a codec decode, "
          "scripts.eval_quality --roundtrip --synthetic 1", flush=True)
    tr = os.path.join(tmp, "trace")
    check(profile_script.main(["--out", tr, "--runs", "1", "--batch", "8", "--duration", "5"]) == 0, "profile")
    files = os.listdir(tr)
    check(len(files) == 1, f"profile wrote {files}")
    with open(os.path.join(tr, files[0])) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    attn = sorted({n[:60] for n in names if any(m in n for m in ATTN_KERNELS)})
    check(attn and "synthesize_padded" in names, f"the trace: attention kernels {attn}, annotation "
          f"{'synthesize_padded' in names}")
    lat = torch.randn((8, 40, 64), generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    with torch.inference_mode():
        cost = flops.compiled_cost(codec_decode, tts.codec_params, lat, tts.codec_cfg)
        ms, ev_ms, clock = timed(lambda: codec_decode(tts.codec_params, lat, tts.codec_cfg), 10)
    util = flops.utilization(cost["flops"], cost["bytes"], ms / 1e3)
    peaks = flops.device_peaks()
    del tts
    torch.cuda.empty_cache()
    q_out = os.path.join(tmp, "quality.json")
    check(eval_quality.main(["--roundtrip", "--synthetic", "1", "--codec", "native", "--codec-checkpoint", codec_ckpt,
                             "--out", q_out]) == 0, "eval_quality")
    with open(q_out) as f:
        quality = json.load(f)
    rt = quality["roundtrip"]
    check(rt["n"] == 1 and np.isfinite(rt["mel_distance"]) and np.isfinite(rt["snr_db"]), f"eval_quality {rt}")
    tools = dict(trace_file_bytes=os.path.getsize(os.path.join(tr, files[0])), trace_attention_kernels=attn,
                 codec_decode=dict(latents=[8, 40, 64], ms=ms, clock=clock, events_ms=ev_ms, **cost, **util),
                 device_peaks=peaks,
                 eval_quality_roundtrip=rt)
    print(f"  tools: {json.dumps(tools)}", flush=True)
    torch.cuda.empty_cache()
    print(f"  phase tools: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return row, tools


def codec_only(torch):
    """`--codec`: the kernels built, then the codec phases alone (train
    codec, train codec distill, serve trained codec, tools). Prints every
    row."""
    from smalltts_tpu_torch.ops import kernels

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    codec_phases(torch, torch.device("cuda"), [dict(name="attention"), dict(name="fused_dit_scan")])
    return 0


def codec_phases(torch, dev, entries):
    """Phases train codec, train codec distill, serve trained codec and
    tools, in one temporary directory that is removed."""
    t0 = time.perf_counter()
    train = codec_train_phase(torch, dev, entries)
    tmp = tempfile.mkdtemp(prefix="codec_distill_smoke_")
    try:
        distill, codec_ckpt = codec_distill_phase(torch, dev, entries, tmp)
        serve, tools = codec_serve_and_tools_phases(torch, dev, entries, codec_ckpt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for e in entries:
        if e["name"] == "attention":
            e["codec_phases"] = dict(seconds=time.perf_counter() - t0, port_kernel_launches_in_training=0,
                                     train_codec_step_ms=train["step_ms_median"],
                                     train_codec_distill_step_ms={k: v["step_ms_median"] for k, v in distill.items()})


def profile_batch(fn):
    """(device busy ms, [(kernel, ms, count)] by time) of one call of `fn`
    under torch.profiler."""
    busy, kern, _ = profile_step(fn)
    return busy, kern


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


def asr_worker(torch, steps=10):
    """One turn of --asr-compare, in a process of its own: builds the kernels
    the ASR step launches (attention, ctc) of the package on sys.path and
    times its step as phase train asr profiles it (ASRConfig(), batch 2,
    the dummy batch of seed 7, seed-0 weights, the step not applied): two
    warm-up steps, the host dispatch of one, the wall of `steps` steps each
    synchronized, and one step under torch.profiler (device busy, the CTC
    kernels' and the attention kernel's device ms, the attention's share of
    busy); then the CTC wrappers' host time a call at the trainers' shape
    (100 calls queued, no sync). Prints one JSON line."""
    import numpy as np

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.models.asr import ASRConfig, init_asr
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.train import asr_train as AT
    from smalltts_tpu_torch.train.optim import aux_optimizer

    dev = torch.device("cuda")
    for name in ("attention", "ctc"):
        kernels.load(name)
    cfg = ASRConfig()
    params = init_asr(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             dummy_batch(np.random.default_rng(7), DummyDataConfig(batch_size=2)).items() if k != "texts"}
    tx, _ = aux_optimizer(params, 200_000, clip_norm=None)
    opt = tx.init(params)
    step = AT.make_asr_step(cfg, tx)
    for _ in range(2):
        step(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, batch)
    dispatch = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy, kern = profile_batch(lambda: (step(params, opt, batch), torch.cuda.synchronize()))
    attn_ms = sum(t for k, t, _ in kern if any(m in k for m in ATTN_KERNELS))
    attn_n = sum(c for k, _, c in kern if any(m in k for m in ATTN_KERNELS))
    from smalltts_tpu_torch.ops.kernels import ctc as C

    args, _ = ctc_inputs(torch, *(torch.as_tensor(a, device=dev) for a in ctc_case("trainer")))
    loss, alpha = C.ctc_forward(*args)
    g = torch.ones_like(loss)
    host_us = {}
    for name, fn in (("ctc_forward", lambda: C.ctc_forward(*args)),
                     ("ctc_backward", lambda: C.ctc_backward(g, *args, alpha))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us[name] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
    print(json.dumps({"ctc_host_us_per_call": host_us, "dispatch_ms": dispatch, "wall_ms": walls, "wall_ms_median": _median(walls),
                      "device_busy_ms": busy, "idle_share": 1.0 - busy / _median(walls),
                      "kernels": sum(c for _, _, c in kern),
                      "ctc_kernel_ms": {m: sum(t for k, t, _ in kern if m in k)
                                        for m in ("ctc_forward_kernel", "ctc_backward_kernel")},
                      "attention_kernel_ms": attn_ms, "attention_launches": attn_n,
                      "attention_share": attn_ms / busy}), flush=True)
    return 0


def asr_compare(other, blocks=2):
    """--asr-compare DIR: the ASR step of the package in DIR against this
    checkout's, `blocks` runs of the turns DIR, this, this, DIR, each turn
    `python3 chip_smoke.py --asr-worker TREE` in a fresh process
    (asr_worker). Prints each turn and each tree's medians."""
    trees = {"parent": os.path.abspath(other), "change": os.path.dirname(os.path.abspath(__file__))}
    print(f"card: {card_line()}", flush=True)
    res = {n: [] for n in trees}
    for _ in range(blocks):
        for name in ("parent", "change", "change", "parent"):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--asr-worker", trees[name]],
                               capture_output=True, text=True, timeout=600)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                raise RuntimeError(f"asr-compare: the {name} worker failed (exit {p.returncode}):\n{p.stderr[-3000:]}")
            res[name].append(json.loads(lines[-1]))
            print(f"turn {name}: {lines[-1]}", flush=True)
    summary = {name: {"wall_ms_median": _median([x for t in turns for x in t["wall_ms"]]),
                      "wall_ms_turn_medians": [t["wall_ms_median"] for t in turns],
                      "dispatch_ms": [t["dispatch_ms"] for t in turns],
                      "device_busy_ms": [t["device_busy_ms"] for t in turns],
                      "idle_share": [t["idle_share"] for t in turns],
                      "ctc_kernel_ms": [t["ctc_kernel_ms"] for t in turns],
                      "attention_kernel_ms": [t["attention_kernel_ms"] for t in turns],
                      "attention_share": [t["attention_share"] for t in turns],
                      "ctc_host_us_per_call": [t["ctc_host_us_per_call"] for t in turns]}
               for name, turns in res.items()}
    print(json.dumps({"asr_compare": summary}))
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


# ------------------------------------------------------------------ phase parallel

PARALLEL_TIMEOUT_S = 600
# tp = 2 latents against the single-process run on the same noise: fp32 (the split layout, the fp32 attention
# kernel and cuBLAS's fp32 products) rounds its partial sums in another order only; bf16 and int8 (the fused
# scan) round each rank's partial product to bf16 before the sum, one more rounding a row-parallel product, and
# are held at the int8 gate's bound
TP_FP32_TOL, TP_BF16_TOL = 1e-4, 5e-2
# the dp = 2 teacher step against the single-process B2 step: the loss (its sums split over two ranks) and the
# params after AdamW (each gradient the sum of the ranks' parts; the tests' 1e-5)
DP_LOSS_TOL, DP_PARAMS_TOL = 2e-4, 1e-5


def parallel_only(torch):
    """`--parallel`: the kernels built, then phase parallel alone."""
    from smalltts_tpu_torch.ops import kernels

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    parallel_phase(torch, torch.device("cuda"), [dict(name="attention"), dict(name="fused_dit_scan")])
    return 0


def run_ranks(mode, world, timeout_s=PARALLEL_TIMEOUT_S):
    """`world` rank processes of this script (`--parallel-worker MODE OUT`),
    joined through the SMALLTTS_* variables, all on card 0. Every rank is
    reaped before a failure is reported; their output is printed, and each
    rank's result (JSON) returned."""
    s = __import__("socket").socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    tmp = tempfile.mkdtemp(prefix=f"smoke_{mode}_")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SMALLTTS_", "MASTER_", "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
    env.update(SMALLTTS_COORDINATOR=f"127.0.0.1:{port}", SMALLTTS_NUM_PROCESSES=str(world),
               SMALLTTS_LOCAL_DEVICE_IDS="0")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker", mode,
                               os.path.join(tmp, f"rank{r}.json")], env={**env, "SMALLTTS_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout_s)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + f"\n(killed at {timeout_s} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.strip():
                print(f"  [{mode} rank {r}] {line}", flush=True)
        f = os.path.join(tmp, f"rank{r}.json")
        results.append(json.load(open(f)) if os.path.exists(f) else None)
    shutil.rmtree(tmp, ignore_errors=True)
    for r, (p, res) in enumerate(zip(procs, results)):
        check(p.returncode == 0 and res is not None and "error" not in res,
              f"{mode} rank {r} failed (rc {p.returncode}): {res and res.get('error')}")
    return results


def parallel_worker(torch):
    """One rank of phase parallel: joins the job the environment describes
    and runs `mode`'s checks; writes its results as JSON to OUT."""
    import traceback

    import torch.distributed as dist

    from smalltts_tpu_torch.parallel import multihost

    i = sys.argv.index("--parallel-worker")
    mode, out = sys.argv[i + 1], sys.argv[i + 2]
    t0 = time.perf_counter()
    res = {}
    try:
        res["info"] = multihost.initialize_from_env("nccl" if mode == "nccl1" else "gloo")
        res.update(nccl_world1(torch) if mode == "nccl1" else gloo_two_ranks(torch))
    except Exception:  # noqa: BLE001 -- reported to the parent, which fails the run
        res["error"] = traceback.format_exc()
        print(res["error"], flush=True)
    res["wall_s"] = time.perf_counter() - t0
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(out, "w") as f:
        json.dump(res, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if "error" in res else 0


def scan_counts(launches, n_b, num_steps=4, n_blocks=12, sfx="", echo=False):
    """Checks the exact launch counts of n_b batches of the scan (as their
    graph replays make them, or counted eagerly): num_steps scans a batch of
    n_blocks layers, each two adaLNs, qkvg, the q/k norm, w13 and two
    residuals (+ one attention): 384 a batch at 4 x 12; none of the other
    weight type's GEMMs. Returns the total."""
    per = n_b * num_steps * n_blocks
    other = "_w8" if not sfx else ""
    want = {"adaln_modulate": 2 * per, "qk_norm_rope": per, f"gemm_bias{sfx}": per, f"gemm_swiglu{sfx}": per,
            f"gemm_residual{sfx}": 2 * per, **{n + other: 0 for n in GEMMS}}
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"scan launch counts {json.dumps(got)}, want {json.dumps(want)}")
    total = sum(got.values()) + got["qk_norm_rope"]  # + the attention launch of each layer
    check(total == 8 * per, f"scan launches {total} for {n_b} batches")
    if echo:
        print(f"  scan launch counts as expected for {n_b} batches: {total} ({total // n_b} a batch), "
              f"{json.dumps(want)}", flush=True)
    return total


def nccl_world1(torch):
    """NCCL at world size 1: SmallTTS(mesh=) at 328M, bf16, batch 8 (8, r 64,
    p 384, t 40), its bucket a CUDA graph with the dp all-gather captured in
    it, against SmallTTS() on the same noise; the launches of one batch."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.parallel import multihost

    dev = torch.device("cuda")
    mesh = multihost.auto_mesh()
    check(mesh is not None and (mesh.backend, mesh.dp, mesh.tp) == ("nccl", 1, 1), f"auto_mesh gave {mesh}")
    tts = full_width_tts(torch, dev)
    tts_m = full_width_tts(torch, dev, mesh=mesh)
    check(tts_m.graphs, "NCCL at world size 1: the pipeline must capture its CUDA graphs")
    args = padded_batch(tts)
    g = torch.Generator(device=dev).manual_seed(5)
    diffs = []
    for i in range(3):  # the first call captures; the next two replay with new noise
        n = torch.randn((4, 8, args[5], 64), generator=g, device=dev).to(torch.bfloat16)
        if i == 2:
            kernels.reset_launches()
        got = tts_m.synthesize_padded(*args, noises=n)
        if i == 2:
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = tts.synthesize_padded(*args, noises=n)
        diffs.append(int((got != want).sum()))
        check(int(np.abs(want).max()) > 0, "an all-zero waveform")
    print(f"NCCL world 1, SmallTTS(mesh=make_mesh(1, 1)) vs SmallTTS(), batch (8, 64, 384, 40), same noise: "
          f"{diffs} int16 samples differ (tolerance 0: the all-gather of one rank is a copy); graphs "
          f"{tts_m.compile_cache_size()}", flush=True)
    check(diffs == [0, 0, 0] and tts_m.compile_cache_size() == 1, f"NCCL world-1 audio differs: {diffs}")
    check(launches.get("attention", 0) == 68, f"attention launches {launches.get('attention')}, want 68")
    n_scan = scan_counts(launches, 1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tts_m.synthesize_padded(*args, fetch=False)
        torch.cuda.synchronize()
    nccl = sorted({e.key[:60] for e in prof.key_averages() if "nccl" in e.key.lower() or "memcpy32" in e.key})
    timing = {name: graph_timing(torch, t, args) for name, t in (("mesh", tts_m), ("no mesh", tts))}
    spans = {k: v["graph_span_ms"] for k, v in timing.items()}
    print(f"  launches of one batch (its graph's counts): attention {launches['attention']}, scan {n_scan}; "
          f"collective kernels in the replay's trace: {nccl}; graph span ms {json.dumps(spans)}; "
          f"card {card_line()}", flush=True)
    return {"nccl_world1": dict(int16_diffs=diffs, launches=launches, scan_launches=n_scan, trace_collectives=nccl,
                                graph_span_ms=spans, graphs=tts_m.compile_cache_size())}


def attention_shapes(kernels):
    """The eager attention launches counted by shape: [B, H, Tq, S, D, dtype, launches]."""
    return [[*shape[:5], str(shape[5]).split(".")[-1], n] for (name, shape), n in sorted(
        kernels.SHAPE_LAUNCHES.items(), key=str) if name == "attention"]


def _bits_equal_across(torch, tensors, root=0, other=1):
    """Whether rank `other`'s tensors equal rank `root`'s bit for bit: each
    broadcast from `other` and compared as bytes on `root`; the answer
    broadcast back."""
    import torch.distributed as dist

    same = True
    for t in tensors:
        mine = t.reshape(-1)
        buf = mine.clone()
        dist.broadcast(buf, src=other)
        same = same and torch.equal(buf.view(torch.uint8), mine.view(torch.uint8))
    flag = torch.tensor([float(same)], device=tensors[0].device)
    dist.broadcast(flag, src=root)
    return bool(flag.item())


def gloo_collectives(torch, dist, dev):
    """Which collectives gloo runs on CUDA tensors here (the port relies on
    all_reduce, broadcast and all_gather), each checked on known values,
    and a 256 MB fp32 all-reduce's wall ms (through host memory)."""
    rank, out = dist.get_rank(), {}
    full = lambda v, n=1000, dt=torch.float32: torch.full((n,), float(v), device=dev, dtype=dt)  # noqa: E731

    def all_reduce(dt, n=1000):
        t = full(rank + 1, n, dt)
        dist.all_reduce(t)
        return float(t.float().sum()), 3.0 * n

    def broadcast():
        t = full(rank, 10)
        dist.broadcast(t, src=1)
        return float(t.sum()), 10.0

    def all_gather():
        parts = [torch.empty(8, dtype=torch.uint8, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((8,), rank + 1, dtype=torch.uint8, device=dev))
        return float(torch.cat(parts).sum()), 24.0

    def all_gather_into_tensor():
        o = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(o, full(rank + 1, 8))
        return float(o.sum()), 24.0

    def reduce_scatter_tensor():
        o = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(o, torch.ones(16, device=dev))
        return float(o.sum()), 16.0

    for name, fn in (("all_reduce fp32", lambda: all_reduce(torch.float32)),
                     ("all_reduce bf16", lambda: all_reduce(torch.bfloat16)), ("broadcast", broadcast),
                     ("all_gather", all_gather), ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor)):
        try:
            got, want = fn()
            out[name] = got == want
        except RuntimeError as exc:  # a collective the backend lacks: reported, and the port must not use it
            out[name] = f"unsupported: {exc}"[:200]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce(torch.float32, 1 << 26)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["all_reduce_256MB_ms"] = walls
    return out


def gloo_two_ranks(torch):
    """Two ranks on the one card, gloo over CUDA tensors: gloo's collectives
    on CUDA tensors; (a) a dp = 2 teacher step at 328M in fp32, global
    batch 2; (b) SmallTTS and its latents at tp = 2, eager; the attention
    launches of each by local shape."""
    import numpy as np
    import torch.distributed as dist

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.infer.sampler import sample_latents
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.parallel import comm
    from smalltts_tpu_torch.parallel.mesh import global_draws, make_mesh, shard_params, use
    from smalltts_tpu_torch.train.ema import ema_init
    from smalltts_tpu_torch.train.optim import adamw
    from smalltts_tpu_torch.train.teacher import make_teacher_step, teacher_draws
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree

    dev = torch.device("cuda")
    rank = dist.get_rank()
    card = card_line()
    coll = gloo_collectives(torch, dist, dev)
    print(f"gloo on CUDA tensors, two ranks on the one card: {json.dumps(coll)}; card {card}", flush=True)
    check(all(coll[k] is True for k in ("all_reduce fp32", "all_reduce bf16", "broadcast", "all_gather")),
          f"gloo lacks a collective the port uses: {json.dumps(coll)}")
    out = {"gloo_collectives": coll}

    # (a) dp = 2: each rank one row of the global batch of 2
    dp2 = make_mesh(dp=2, tp=1)
    cfg = BackboneConfig()
    gb = torch.Generator(device=dev).manual_seed(0)
    params = redraw_zero_init(init_backbone(gb, cfg, device=dev), gb)
    glob = {k: torch.from_numpy(v).to(dev) for k, v in dummy_batch(np.random.default_rng(0), DummyDataConfig(2)).items()
            if k != "texts"}
    local = {k: dp2.rows(v) for k, v in glob.items()}
    draws = global_draws(teacher_draws, torch.Generator(device=dev).manual_seed(1), local, dp2)
    tx = adamw(params, 1e-4, clip_norm=1.0)
    step = make_teacher_step(cfg, tx, mesh=dp2)
    opt, ema = tx.init(params), ema_init(params)
    torch.cuda.synchronize()
    kernels.reset_launches()
    p1, o1, e1, loss = step(params, opt, ema, local, draws, np.float32(0.9))
    torch.cuda.synchronize()
    teacher_shapes = attention_shapes(kernels)
    losses = [torch.zeros(1, device=dev) for _ in range(2)]
    dist.all_gather(losses, loss.reshape(1))
    same = _bits_equal_across(torch, list(flatten_pytree(p1).values()) + list(flatten_pytree(o1["mu"]).values())
                              + list(flatten_pytree(e1).values()))
    step_ms = []
    p, o, e = p1, o1, e1
    for _ in range(3):
        t0 = time.perf_counter()
        p, o, e, _ = step(p, o, e, local, draws, np.float32(0.9))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del p, o, e
    grads = [torch.zeros_like(t) for t in flatten_pytree(params).values()]
    ar_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comm.all_reduce_grads(grads, dp2)
        torch.cuda.synchronize()
        ar_ms.append((time.perf_counter() - t0) * 1e3)
    del grads
    single = None
    if rank == 0:  # the single-process B2 step on the same draws
        step1 = make_teacher_step(cfg, tx)
        gdraws = teacher_draws(torch.Generator(device=dev).manual_seed(1), glob)
        sp, _, _, sloss = step1(params, opt, ema, glob, gdraws, np.float32(0.9))
        fa, fb = flatten_pytree(p1), flatten_pytree(sp)
        rels = {k: float((fa[k].float() - fb[k].float()).norm() / fb[k].float().norm().clamp_min(1e-30)) for k in fb}
        worst = max(rels, key=rels.get)
        single = dict(loss=float(sloss), loss_rel=abs(float(loss) - float(sloss)) / abs(float(sloss)),
                      params_rel_l2_worst=rels[worst], worst_leaf=worst)
        del sp
    dist.barrier()
    out["teacher_dp2"] = dict(losses=[float(x) for x in losses], bit_identical_across_ranks=same, step_ms=step_ms,
                              step_ms_median=_median(step_ms), allreduce_ms=ar_ms, allreduce_ms_median=_median(ar_ms),
                              allreduce_share=_median(ar_ms) / _median(step_ms), grad_bytes=4 * sum(
                                  t.numel() for t in flatten_pytree(params).values()),
                              attention_shapes=teacher_shapes, single=single, card=card)
    print(f"(a) dp=2 teacher step, 328M fp32, global batch 2 (one row a rank): losses {out['teacher_dp2']['losses']}, "
          f"params/moments/EMA bit-identical across ranks: {same}; step {_median(step_ms):.1f} ms a rank, the "
          f"gloo all-reduce of the gradients {_median(ar_ms):.1f} ms of it (through host memory: not a multi-card "
          f"number); vs single process: {json.dumps(single)}; card {card}", flush=True)
    check(losses[0].item() == losses[1].item() and same, "dp=2 ranks disagree")
    if single is not None:
        check(single["loss_rel"] <= DP_LOSS_TOL and single["params_rel_l2_worst"] <= DP_PARAMS_TOL,
              f"dp=2 step vs single process: {json.dumps(single)}")
    del p1, o1, e1, opt, ema, params
    torch.cuda.empty_cache()

    # (b) tp = 2: the same seed-0 weights served, each rank 4 of the DiT's 8 heads
    tp2 = make_mesh(dp=1, tp=2)
    tts = full_width_tts(torch, dev)
    args = padded_batch(tts)
    ref, ref_lens, ph, ph_lens, seq_lens, t_bucket = args
    tt = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    inputs = lambda dt: (tt(ref, dt), tt(ref_lens, torch.int32), tt(ph, torch.int64), tt(ph_lens, torch.int32),  # noqa: E731
                         tt(seq_lens, torch.int32))
    noises = torch.randn((4, 8, t_bucket, 64), generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    rows = {}

    def latents(params, dtype, mesh):
        with torch.inference_mode(), use(mesh):
            return sample_latents(params, cfg, *inputs(dtype), num_steps=4, noises=noises.to(dtype))

    for label, opts in (("bf16", {}), ("int8", dict(w8_modulation=True, w8_stream=True))):
        one = full_width_tts(torch, dev, **opts) if opts else tts
        two = full_width_tts(torch, dev, mesh=tp2, **opts)
        check(not two.graphs, "gloo: the tp pipeline must run eagerly")
        want = latents(one.params, torch.bfloat16, None)
        kernels.reset_launches()
        got = latents(two.params, torch.bfloat16, tp2)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        shapes = attention_shapes(kernels)
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        t0 = time.perf_counter()
        audio = two.synthesize_padded(*args, noises=noises.to(torch.bfloat16))
        wall = (time.perf_counter() - t0) * 1e3
        ref_audio = one.synthesize_padded(*args, noises=noises.to(torch.bfloat16))
        n_diff = int((audio != ref_audio).sum())
        heads = two.params["dit"]["blocks"]["attn"]["q_norm"]["scale"].shape[-2]
        rows[label] = dict(latents_rel_l2=rel, launches=launches, attention_shapes=shapes, local_heads=heads,
                           eager_batch_wall_ms=wall, int16_samples_differing=n_diff, card=card)
        print(f"(b) tp=2 SmallTTS {label}, 328M, batch (8, 64, 384, {t_bucket}), eager under gloo: latents rel-L2 "
              f"{rel:.3e} vs the single process (tolerance {TP_BF16_TOL}); {n_diff} of {audio.size} int16 samples "
              f"differ; DiT heads a rank {heads}; launches {json.dumps(launches)}; attention by local shape "
              f"{json.dumps(shapes)}; batch {wall:.1f} ms wall; card {card}", flush=True)
        check(rel <= TP_BF16_TOL and bool(torch.isfinite(got).all()), f"tp=2 {label} latents rel-L2 {rel:.3e}")
        check(launches.get("attention", 0) == 68, f"tp=2 {label}: attention launches {launches.get('attention')}")
        scan_counts(launches, 1, sfx="_w8" if opts else "")
        if opts:
            check(launches.get("w8_matmul_all_layers", 0) == 1, f"tp=2 int8: {json.dumps(launches)}")
        del two
        if opts:
            del one
        torch.cuda.empty_cache()
    # fp32 on the split layout: the fp32 attention kernel and cuBLAS's fp32 products, row-parallel in PyTorch ops
    gs = torch.Generator(device=dev).manual_seed(0)
    split = redraw_zero_init(init_backbone(gs, cfg, device=dev), gs)
    want = latents(split, torch.float32, None)
    kernels.reset_launches()
    got = latents(shard_params(split, tp2), torch.float32, tp2)
    torch.cuda.synchronize()
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    shapes = attention_shapes(kernels)
    rows["fp32_split"] = dict(latents_rel_l2=rel, attention_shapes=shapes, card=card,
                              launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    print(f"(b) tp=2 fp32 latents on the split layout: rel-L2 {rel:.3e} vs the single process (tolerance "
          f"{TP_FP32_TOL}); attention by local shape {json.dumps(shapes)}; card {card}", flush=True)
    check(rel <= TP_FP32_TOL and bool(torch.isfinite(got).all()), f"tp=2 fp32 latents rel-L2 {rel:.3e}")
    out["tp2"] = rows
    return out


def shard_kernels(torch, dev, shapes):
    """(c) each kernel that the tp = 2 and dp = 2 runs launched, at the
    shapes they launched it, against its plain version at phase A/B's
    tolerances, timed (device clock, plain, library, bound): the scan's
    four products and qk_norm_rope at the tp = 2 shard of the served (8,
    40) batch, bf16 and int8 weights, and attention at every (B, H, Tq, S,
    D, dtype) the ranks counted."""
    from smalltts_tpu_torch.models.dit import DiTConfig, fuse_serving_projections, init_dit, quantize_stream_weights
    from smalltts_tpu_torch.models.dit import rope_cos_sin
    from smalltts_tpu_torch.ops.kernels import attention as A
    from smalltts_tpu_torch.ops.kernels import dit_block as K
    from smalltts_tpu_torch.parallel.mesh import make_mesh, shard_params

    g = torch.Generator(device=dev).manual_seed(3)
    randn = lambda shape, dtype=torch.bfloat16, s=1.0: (s * torch.randn(shape, generator=g, device=dev)).to(dtype)  # noqa: E731

    def err(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max()), float((got - want).abs().max() / want.abs().max())

    cfg = DiTConfig()
    B, T, H, hd, F = 8, 40, cfg.hidden_dim, cfg.head_dim, cfg.ff_dim
    M = B * T
    layout = make_mesh(dp=1, tp=2, devices=range(2))  # rank 0's shard; no collective runs here
    fused = fuse_serving_projections({"dit": init_dit(g, cfg, torch.bfloat16, dev)})
    blocks = shard_params(fused, layout)["dit"]
    qblocks = shard_params(quantize_stream_weights(fused), layout)["dit"]  # quantized whole, then sharded
    heads = blocks["blocks"]["attn"]["q_norm"]["scale"].shape[-2]
    inner, f_loc = heads * hd, F // 2
    h_, x_, mid = randn((B, T, H)), randn((B, T, H), s=2.0), randn((B, T, f_loc))
    att = randn((B, T, inner))
    gate = randn((B, H), s=0.5)
    mask = torch.arange(T, device=dev)[None] < torch.randint(T // 2, T + 1, (B,), generator=g, device=dev)[:, None]
    cos, sin = rope_cos_sin(cfg, T, dev)
    rows = []

    def row(name, label, kfn, pfn, lfn, nbytes_, flops, tol, match, kind="bf16"):
        got, want = kfn(), pfn()
        abs_e, rel_e = err(got, want)
        check(rel_e <= tol, f"tp=2 shard {name} {label}: rel err {rel_e:.3e}")
        ms, wall, clock = timed(kfn, 10, match)
        b_ms, b_by = bound(nbytes_, flops, kind)
        r = dict(name=name, shape=label, max_abs_err=abs_e, rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock,
                 plain_ms=timed(pfn, 10)[0], bound_ms=b_ms, bound_by=b_by,
                 library_ms=timed(lfn, 10)[0] if lfn else None)
        print(f"  (c) {json.dumps(r)}", flush=True)
        rows.append(r)

    for sfx, bl in (("", blocks["blocks"]), ("_w8", qblocks["blocks"])):
        a_, f_ = bl["attn"], bl["ff"]
        w = lambda lin: (lin["w_q"][0], lin["scale"][0]) if "w_q" in lin else (lin["w"][0], None)  # noqa: E731
        lb = lambda lin: nbytes(*(lin[k][0] for k in ("w", "w_q", "scale", "b") if k in lin))  # noqa: E731
        (wq, sq), (wo, so), (w13, s13), (w2, s2) = w(a_["qkvg"]), w(a_["to_out"]), w(f_["w13"]), w(f_["w2"])
        lib_w = lambda name: blocks["blocks"][name[0]][name[1]]["w"][0]  # noqa: E731
        row("gemm_bias" + sfx, f"qkvg M={M} K={H} N={4 * inner}", lambda: K.gemm_bias(h_, wq, a_["qkvg"]["b"][0], sq),
            lambda: K.gemm_bias_plain(h_, wq, a_["qkvg"]["b"][0], sq),
            lambda: torch.addmm(blocks["blocks"]["attn"]["qkvg"]["b"][0], h_.view(M, H), lib_w(("attn", "qkvg"))),
            nbytes(h_) + lb(a_["qkvg"]) + M * 4 * inner * 2, 2.0 * M * H * 4 * inner, 2e-2,
            KERNEL_NAMES["gemm_bias" + sfx])
        row("gemm_swiglu" + sfx, f"w13 M={M} K={H} N={2 * f_loc} (out {f_loc})",
            lambda: K.gemm_swiglu(h_, w13, f_["w13"]["b"][0], s13), lambda: K.gemm_swiglu_plain(h_, w13, f_["w13"]["b"][0], s13),
            lambda: torch.addmm(blocks["blocks"]["ff"]["w13"]["b"][0], h_.view(M, H), lib_w(("ff", "w13"))),
            nbytes(h_) + lb(f_["w13"]) + M * f_loc * 2, 2.0 * M * H * 2 * f_loc, 2e-2,
            KERNEL_NAMES["gemm_swiglu" + sfx])
        row("gemm_residual" + sfx, f"to_out M={M} K={inner} N={H}, row-masked",
            lambda: K.gemm_residual(att, wo, None, x_.clone(), gate, mask, so),
            lambda: K.gemm_residual_plain(att, wo, None, x_.clone(), gate, mask, so),
            lambda: torch.mm(att.view(M, inner), lib_w(("attn", "to_out"))),
            nbytes(att, gate, mask) + lb(a_["to_out"]) + 2 * M * H * 2, 2.0 * M * inner * H, 2e-2,
            KERNEL_NAMES["gemm_residual" + sfx])
        row("gemm_residual" + sfx, f"w2 M={M} K={f_loc} N={H}",
            lambda: K.gemm_residual(mid, w2, f_["w2"]["b"][0], x_.clone(), gate, None, s2),
            lambda: K.gemm_residual_plain(mid, w2, f_["w2"]["b"][0], x_.clone(), gate, None, s2),
            lambda: torch.addmm(blocks["blocks"]["ff"]["w2"]["b"][0], mid.view(M, f_loc), lib_w(("ff", "w2"))),
            nbytes(mid, gate) + lb(f_["w2"]) + 2 * M * H * 2, 2.0 * M * f_loc * H, 2e-2,
            KERNEL_NAMES["gemm_residual" + sfx])
    q0 = randn((B, T, 4 * inner))
    qs, ks = blocks["blocks"]["attn"]["q_norm"]["scale"][0], blocks["blocks"]["attn"]["k_norm"]["scale"][0]
    row("qk_norm_rope", f"M={M} heads={heads} D={hd} rot={cos.shape[1]}",
        lambda: K.qk_norm_rope(q0.clone(), qs, ks, cos, sin), lambda: K.qk_norm_rope_plain(q0.clone(), qs, ks, cos, sin),
        None, 2 * 2 * M * 2 * inner + nbytes(qs, ks, cos, sin), 0.0, 2e-2, KERNEL_NAMES["qk_norm_rope"])
    for b_, h2, tq, s_, d_, dt in sorted(shapes):  # one key source of S keys (the two sources' sum)
        dtype = getattr(torch, dt)
        q, k, v = randn((b_, h2, tq, d_), dtype), randn((b_, h2, s_, d_), dtype), randn((b_, h2, s_, d_), dtype)
        km = torch.arange(s_, device=dev)[None] < torch.randint(s_ // 2, s_ + 1, (b_,), generator=g, device=dev)[:, None]
        row("attention", f"B={b_} H={h2} Tq={tq} S={s_} D={d_} {dt}",
            lambda: A.fused_attention(q, k, v, km), lambda: A.attention_plain(q, k, v, km),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=km[:, None, None, :]),
            nbytes(q, k, v, km, q), 4.0 * b_ * h2 * tq * s_ * d_, 1e-5 if dtype == torch.float32 else 2e-2,
            ATTN_KERNELS, attn_kind(dtype, d_))
    return rows


def parallel_phase(torch, dev, entries):
    """Phase parallel: NCCL at world size 1 (SmallTTS(mesh=) with its
    collective in the CUDA graph), two gloo ranks on the one card (dp = 2
    teacher step, tp = 2 SmallTTS), the kernels at the shard shapes those
    launched, and the four-rank dry run on CPU ranks. The per-kernel rows
    go into the `kernels` line (`tp2_shard_shapes` and `parallel` of the
    attention and fused_dit_scan entries)."""
    t_phase = time.perf_counter()
    card = card_line()
    print(f"phase parallel: the port's data and tensor parallelism (smalltts_tpu_torch/parallel); card {card}",
          flush=True)
    nccl = run_ranks("nccl1", 1)[0]
    t_nccl = time.perf_counter() - t_phase
    gloo = run_ranks("gloo2", 2)
    t_gloo = time.perf_counter() - t_phase - t_nccl
    shapes = {tuple(s[:6]) for res in gloo for run in [res["teacher_dp2"], *res["tp2"].values()]
              for s in run["attention_shapes"]}
    print(f"(c) the kernels at the shard shapes the ranks launched ({len(shapes)} attention shapes), against plain; "
          f"card {card}", flush=True)
    rows = shard_kernels(torch, dev, shapes)
    dry_s = dry_run_phase()
    wall = time.perf_counter() - t_phase
    peak = max(r["peak_gb"] for r in [nccl] + gloo)
    summary = dict(seconds=wall, nccl_world1_s=t_nccl, gloo_two_ranks_s=t_gloo, dryrun_s=dry_s, peak_gb_a_rank=peak,
                   card=card, nccl_world1=nccl["nccl_world1"], gloo_collectives=gloo[0]["gloo_collectives"],
                   teacher_dp2=gloo[0]["teacher_dp2"],
                   tp2={k: {m: v[m] for m in ("latents_rel_l2", "launches", "attention_shapes") if m in v}
                        for k, v in gloo[0]["tp2"].items()})
    for e in entries:
        if e["name"] in ("attention", "fused_dit_scan"):
            e["tp2_shard_shapes"] = [r for r in rows if (r["name"] == "attention") == (e["name"] == "attention")]
        if e["name"] == "attention":
            e["parallel"] = summary
    print(f"  phase parallel: {wall:.2f} s (NCCL world 1 {t_nccl:.1f} s, two gloo ranks {t_gloo:.1f} s, dry run "
          f"{dry_s:.1f} s), peak {peak:.2f} GB a rank; card {card}", flush=True)


def dry_run_phase():
    """The four-rank dry run (smalltts_tpu_torch.scripts.dryrun_multihost)
    on CPU ranks: the dp and dp x tp losses within 2e-4 of one process's.
    Returns its seconds."""
    t0 = time.perf_counter()
    dry = subprocess.run([sys.executable, "-m", "smalltts_tpu_torch.scripts.dryrun_multihost"], capture_output=True,
                         text=True, timeout=PARALLEL_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(__file__)),
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    dry_s = time.perf_counter() - t0
    check(dry.returncode == 0, f"dryrun_multihost failed: {dry.stderr[-2000:]}")
    dry_res = json.loads(dry.stdout.strip().splitlines()[-1])
    check(dry_res["ok"] is True and dry_res["rel_diff_tp1"] < 2e-4 and dry_res["rel_diff_tp2"] < 2e-4,
          f"dryrun_multihost: {dry.stdout[-1000:]}")
    print(f"dry run, 4 gloo ranks on the CPU: {json.dumps({k: dry_res[k] for k in ('loss_dp', 'loss_dp_tp', 'single_process_loss', 'rel_diff_tp1', 'rel_diff_tp2', 'tp_ckpt_leaves')})}, "
          f"{dry_s:.1f} s", flush=True)
    return dry_s


# ------------------------------------------------------------------ head dim 16

# the tiny configurations' attention (head dim 16) at the demo loop's shapes, batch 2: the DiT's joint
# self + ref + text keys as one source (4 heads), the ASR conformer's 4x-upsampled frames (4 heads), the
# text encoder's tokens (2 heads)
D16_SHAPES = (("demo dit T=40 + ref 8 + text 16", 2, 4, 40, 64, 16), ("demo asr T=36", 2, 4, 36, 36, 16),
              ("demo text P=16", 2, 2, 16, 16, 16),
              # head dim 8, zero-padded into the head-dim-16 instance: the tiny discriminator's conformer (4 heads
              # of 8) at the corpus harness's real and fake halves (B 12)
              ("corpus disc conformer", 12, 4, 52, 52, 8))


def attn_d16_phase(torch, dev, entries):
    """Phase A, head dim 16: attn_tf32_kernel<16> (fp32) and
    attn_mma_kernel<16> (bf16) against attention_plain at the demo loop's
    shapes, and head dim 8 zero-padded into them at the corpus harness's
    discriminator shape (D16_SHAPES; one row of each batch fully masked;
    the wall time of the head-dim-8 rows holds the padding copies, their
    device time the kernel alone), at the phase's
    tolerances (1e-5 fp32, 2e-2 bf16), timed on the device clock beside the
    plain version, scaled_dot_product_attention and the bound (bytes, or
    4 B H Tq S D flops at the dtype's peak, as row 1's). The rows go into
    the attention entry as `head_dim_16`."""
    from smalltts_tpu_torch.ops.kernels import attention as A

    t_phase = time.perf_counter()
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    g = torch.Generator(device=dev).manual_seed(16)
    print("phase A, head dim 16: attention kernel vs plain at the demo loop's shapes (tolerance: max|diff|/max|plain| "
          "<= 1e-5 fp32, 2e-2 bf16)", flush=True)
    rows = []
    for label, B, H, T, S, D in D16_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, H, T, D), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, H, S, D), generator=g, device=dev).to(dtype) for _ in range(2))
            m = torch.arange(S, device=dev)[None] < torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)[:, None]
            m[-1] = False  # a fully-masked row: a uniform average
            got = A.fused_attention(q, k, v, m)
            want = A.attention_plain(q, k, v, m)
            abs_e = float((got.float() - want.float()).abs().max())
            rel_e = abs_e / float(want.float().abs().max())
            check(rel_e <= tol[dtype], f"attention D={D} {label} {dtype}: rel err {rel_e:.3e}")
            ms, wall, clock = timed(lambda: A.fused_attention(q, k, v, m), 20, ATTN_KERNELS)
            check(clock in DEVICE_CLOCKS, f"attention D={D} {label} {dtype}: no device-clock time")
            plain_ms = timed(lambda: A.attention_plain(q, k, v, m), 20)[0]
            lib_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=m[:, None, None, :]), 20)[0]
            b_ms, b_by = bound(nbytes(q, k, v, m, got), 4.0 * B * H * T * S * D, attn_kind(dtype, D))
            row = dict(shape=f"{label} B={B} H={H} Tq={T} S={S} D={D}", dtype=str(dtype).split(".")[-1],
                       kernel="attn_mma_kernel<16>" if dtype == torch.bfloat16 else "attn_tf32_kernel<16>",
                       max_abs_err=abs_e, rel_err=rel_e, ms=ms, wall_ms=wall, clock=clock, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            rows.append(row)
            print("  " + json.dumps(row), flush=True)
    for e in entries:
        if e["name"] == "attention":
            e["head_dim_16"] = rows
    print(f"  phase A, head dim 16: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return rows


# ------------------------------------------------------------------ scripts

DEMO_ARGV = ["--codec-steps", "30", "--teacher-steps", "60", "--asr-steps", "40", "--sv-steps", "20",
             "--sample-steps", "8"]
X402_TEST_KEY = "d15c0"  # a fixed test wallet key, as the x402 tests use


def run_script(name, main, argv, stdin=None):
    """main(argv) of a script in this process, its standard output captured
    (and echoed, shortened): (exit code, output, seconds)."""
    import contextlib
    import io

    buf, old_stdin = io.StringIO(), sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        sys.stdin = old_stdin
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    shown = out.strip() if len(out) < 1500 else out.strip()[:400] + " ... " + out.strip()[-1000:]
    print(f"  {name}: exit {rc} in {secs:.2f} s\n    " + shown.replace("\n", "\n    "), flush=True)
    return rc, out, secs


def int16_wav(path):
    """(samples int16, sample rate) of a mono 16-bit wav written by the scripts."""
    import numpy as np

    body = open(path, "rb").read()
    channels, rate, bits = wav_format(body)
    check(body[:4] == b"RIFF" and (channels, bits) == (1, 16), f"{path}: {channels} channels, {bits} bits")
    return np.frombuffer(body[44:], np.int16), rate


def scripts_phase(torch, dev, entries):
    """Phase scripts: the port's entry points (smalltts_tpu_torch/scripts),
    each main() in this process on the card, at full width (the default
    BackboneConfig and CodecConfig) on the seed-0 weights with the zero-init
    leaves re-drawn (the velocity head among them):
    - test_checkpoint on the weights saved as an npz: exit 0 and the cached
      split within 1e-4 of the full forward; on a copy with one key removed,
      exit 1; then --convert (the npz with backbone_meta);
    - clone with --checkpoint the converted npz and --transcription: an int16
      wav of estimate_duration's frames, not silent, and one batch's served
      launches from its CUDA graph's replay (68 attention, 384 scan); its
      wall time, and a second synthesize's (graph replayed) real-time factor;
    - interactive on two stdin lines, batch on a two-wav manifest (8 files,
      a batch of more than one request), tryme in a directory without assets
      (random weights, its warning), phonemize as a process of its own;
    - import_codec on a seed-3 CodecConfig() codec exported by
      onnxtorch.export: a finite SNR and the initializers saved;
    - test_x402 against the port's TTSServer (--payments local) on the clone
      pipeline, with a fixed test key: a signed payment, 200 and a RIFF body;
    - bench_serving twice: 8 process clients x 4 requests (32: p50, p95),
      and --stream --sentences 2 with 4 x 2;
    - demo_quality_loop with small budgets (DEMO_ARGV): every summary value
      finite, attention launches at head dim 16 and CTC launches. Prints
      each stage's seconds."""
    import numpy as np

    from smalltts_tpu_torch.data.bucketing import HOP_SIZE, frames_for_duration
    from smalltts_tpu_torch.data.synthetic import synth_speech
    from smalltts_tpu_torch.infer import pipeline
    from smalltts_tpu_torch.infer.pipeline import estimate_duration
    from smalltts_tpu_torch.models.backbone import init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import CodecConfig, init_codec
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.scripts import (
        batch,
        bench_serving,
        clone,
        demo_quality_loop,
        import_codec,
        interactive,
        test_checkpoint,
        test_x402,
        tryme,
    )
    from smalltts_tpu_torch.serving.audio_io import encode_wav
    from smalltts_tpu_torch.serving.server import TTSServer
    from smalltts_tpu_torch.serving.x402 import X402Config
    from smalltts_tpu_torch.text import get_token_ids
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.convert import params_to_jax

    t_phase = time.perf_counter()
    print("phase scripts: the port's entry points in this process on the card, default BackboneConfig/CodecConfig, "
          "seed-0 weights (zero-init leaves re-drawn)", flush=True)
    tmp = tempfile.mkdtemp(prefix="smoke_scripts_")
    made = []  # every SmallTTS a script builds, to read its graphs' launch counts
    base = pipeline.SmallTTS

    class Tracked(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    pipeline.SmallTTS = Tracked
    cwd, env = os.getcwd(), dict(os.environ)
    result = dict(card=card_line())
    try:
        cfg = test_checkpoint.default_config("backbone")  # BackboneConfig(), the one the validator holds
        gb = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        npz = os.path.join(tmp, "seed0.npz")
        ckpt.save_pytree(npz, params_to_jax(redraw_zero_init(init_backbone(gb, cfg, device=dev), gb)))
        print(f"  seed-0 weights saved as an npz in {time.perf_counter() - t0:.2f} s", flush=True)

        # ---- test_checkpoint, its full forward timed (the first call, fp32, (2, 24) frames) by a wrapper
        from smalltts_tpu_torch.models import backbone as backbone_module

        forward, forward_ms = backbone_module.backbone_forward, []

        def timed_forward(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = forward(*a, **k)
            torch.cuda.synchronize()
            forward_ms.append((time.perf_counter() - t0) * 1e3)
            return res

        backbone_module.backbone_forward = timed_forward
        try:
            rc, out, secs = run_script("test_checkpoint", test_checkpoint.main, [npz])
        finally:
            backbone_module.backbone_forward = forward
        check(rc == 0 and "cached-inference path OK" in out and out.rstrip().endswith("checkpoint valid"),
              f"test_checkpoint: exit {rc}")
        result["test_checkpoint_s"] = secs
        result["test_checkpoint_forward_ms"] = forward_ms[0]
        result["cached_split_max_abs_diff"] = float(out.split("max |diff| = ")[1].split(")")[0])
        flat = ckpt.flatten_pytree(ckpt.load_pytree(npz))
        dropped = sorted(flat)[len(flat) // 2]
        missing = os.path.join(tmp, "missing.npz")
        ckpt.save_pytree(missing, ckpt.unflatten_pytree({k: v for k, v in flat.items() if k != dropped}))
        del flat
        rc, out, _ = run_script("test_checkpoint (a key removed)", test_checkpoint.main, [missing])
        check(rc == 1 and "missing keys: 1" in out and f"  - {dropped}" in out, f"test_checkpoint missing: exit {rc}")
        os.unlink(missing)
        conv = os.path.join(tmp, "converted.npz")
        rc, out, _ = run_script("test_checkpoint --convert", test_checkpoint.main, [npz, "--convert", conv])
        check(rc == 0 and ckpt.load_meta(conv) is not None, f"test_checkpoint --convert: exit {rc}")
        os.unlink(npz)

        # ---- clone
        ref = os.path.join(tmp, "ref.wav")
        with open(ref, "wb") as f:
            f.write(encode_wav(synth_speech("a reference voice for the smoke run", speaker=1, seed=3), 24_000))
        text = "The quick brown fox jumps over the lazy dog."
        out_wav = os.path.join(tmp, "clone.wav")
        made.clear()
        rc, out, secs = run_script("clone", clone.main, ["--wav", ref, "--text", text, "--transcription",
                                                          "A reference voice for the smoke run.", "--checkpoint",
                                                          conv, "--out", out_wav])
        check(rc == 0 and len(made) == 1, f"clone: exit {rc}")
        tts = made[0]
        check(tts.cfg == cfg, "clone: the converted checkpoint's config is not the default")
        launches, n_replays = graph_launches(tts, {})
        check(n_replays == 1 and launches.get("attention") == 68, f"clone: {n_replays} replays, {launches}")
        scan_counts(launches, 1, tts.num_steps, tts.cfg.dit.n_blocks, echo=True)
        samples, rate = int16_wav(out_wav)
        duration = estimate_duration(text)
        check(rate == 24_000 and samples.size == frames_for_duration(duration) * HOP_SIZE
              and int(np.abs(samples).max()) > 0, f"clone: {samples.size} samples at {rate} Hz")
        tokens = get_token_ids("A reference voice for the smoke run.") + get_token_ids(text)
        ref_lat = tts.encode_reference(synth_speech("a reference voice for the smoke run", speaker=1, seed=3))
        t0 = time.perf_counter()
        tts.synthesize(ref_lat, tokens, duration)
        warm_s = time.perf_counter() - t0
        result["clone"] = dict(wall_s=secs, audio_s=duration, rtf_wall=secs / duration, synthesize_warm_s=warm_s,
                               rtf_warm=warm_s / duration, launches_a_batch=launches)
        print(f"  clone: {json.dumps(result['clone'])}", flush=True)

        # ---- test_x402, against the clone's pipeline behind the port's server (local payments)
        import asyncio

        srv = TTSServer(tts=tts, x402_cfg=X402Config(mode="local"), max_batch=8)
        loop = asyncio.new_event_loop()
        server = loop.run_until_complete(asyncio.start_server(srv._serve_conn, "127.0.0.1", 0))
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        try:
            os.makedirs(os.path.join(tmp, "x402"))
            os.chdir(os.path.join(tmp, "x402"))
            os.environ.update(SERVER_URL=f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}", DURATION="2.0",
                              PRIVATE_KEY=X402_TEST_KEY)
            rc, out, secs = run_script("test_x402", test_x402.main, [])
            check(rc == 0 and out.startswith("402: ") and "signed EIP-3009 payment" in out, f"test_x402: exit {rc}")
            x402_samples, rate = int16_wav("output.wav")
            check(rate == 24_000 and x402_samples.size > 0, "test_x402: output.wav")
            result["test_x402_s"] = secs
        finally:
            os.chdir(cwd)
            os.environ.clear()
            os.environ.update(env)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(10)
            server.close()
            if srv._batcher is not None:
                srv._batcher.close()
        del tts, srv
        made.clear()
        torch.cuda.empty_cache()

        # ---- interactive
        rc, out, secs = run_script("interactive", interactive.main,
                                   ["--checkpoint", conv, "--out-dir", os.path.join(tmp, "interactive")],
                                   stdin="Good morning, how are you?\nThe weather is lovely today.\n")
        rtfs = [float(line.split("(rtf ")[1].rstrip(")")) for line in out.splitlines() if "(rtf " in line]
        check(rc == 0 and len(rtfs) == 2 and all(np.isfinite(rtfs)), f"interactive: exit {rc}, rtf {rtfs}")
        for i in range(2):
            s, _ = int16_wav(os.path.join(tmp, "interactive", f"interactive_{i}.wav"))
            check(int(np.abs(s).max()) > 0, "interactive: a silent wav")
        result["interactive"] = dict(wall_s=secs, rtf=rtfs)
        made.clear()
        torch.cuda.empty_cache()

        # ---- batch
        mdir = os.path.join(tmp, "manifest")
        os.makedirs(mdir)
        for name, spk in (("a.wav", 0), ("b.wav", 2)):
            with open(os.path.join(mdir, name), "wb") as f:
                f.write(encode_wav(synth_speech(f"speaker {spk} says hello", speaker=spk, seed=spk), 24_000))
        with open(os.path.join(mdir, "transcriptions.json"), "w") as f:
            json.dump({"a.wav": "speaker zero says hello", "b.wav": "speaker two says hello"}, f)
        rc, out, secs = run_script("batch", batch.main, ["--manifest", os.path.join(mdir, "transcriptions.json"),
                                                          "--out", os.path.join(tmp, "batch"), "--checkpoint", conv])
        names = sorted(os.listdir(os.path.join(tmp, "batch")))
        check(rc == 0 and names == sorted(f"{w}_{i}_gen.wav" for w in "ab" for i in range(4)), f"batch: {names}")
        for n in names:
            s, _ = int16_wav(os.path.join(tmp, "batch", n))
            check(int(np.abs(s).max()) > 0, f"batch: {n} is silent")
        classes = {key[0]: g.replays for key, g in made[0]._graphs.items()}
        check(max(classes) > 1, f"batch: no batch of more than one request ({classes})")
        result["batch"] = dict(wall_s=secs, files=len(names), graph_replays_by_batch_class=classes)
        made.clear()
        torch.cuda.empty_cache()

        # ---- tryme, without assets
        os.makedirs(os.path.join(tmp, "tryme"))
        os.chdir(os.path.join(tmp, "tryme"))
        os.environ["SMALLTTS_ASSETS"] = os.path.join(tmp, "no_assets")
        try:
            rc, out, secs = run_script("tryme", tryme.main, ["Hello from the smoke run."])
            s, _ = int16_wav(os.path.join("out", "tryme.wav"))
            check(rc == 0 and s.size > 0, f"tryme: exit {rc}")
        finally:
            os.chdir(cwd)
            os.environ.clear()
            os.environ.update(env)
        result["tryme_s"] = secs
        made.clear()
        torch.cuda.empty_cache()

        # ---- phonemize, a process of its own
        import smalltts_tpu_torch

        root = os.path.dirname(os.path.dirname(os.path.abspath(smalltts_tpu_torch.__file__)))
        res = subprocess.run([sys.executable, "-m", "smalltts_tpu_torch.scripts.phonemize", "Hello", "world."],
                             cwd=root, capture_output=True, text=True, timeout=120)
        check(res.returncode == 0 and json.loads(res.stdout) == get_token_ids("Hello world."),
              f"phonemize: {res.returncode} {res.stdout[:200]!r} {res.stderr[-500:]}")
        print(f"  phonemize: {res.stdout.strip()[:120]}", flush=True)

        # ---- import_codec, on a codec exported by onnxtorch.export
        cdir = os.path.join(tmp, "codec")
        os.makedirs(cdir)
        ccfg = CodecConfig()
        cp = init_codec(torch.Generator(device=dev).manual_seed(3), ccfg, device=dev)
        with kernels.force_plain():
            for name, module, example, axes in (
                    ("encoder", CodecEncoder(cp, ccfg), torch.zeros((1, 1, 4 * ccfg.hop), device=dev), {0: "b", 2: "t"}),
                    ("decoder", CodecDecoder(cp, ccfg), torch.zeros((1, 4, 64), device=dev), {0: "b", 1: "t"})):
                with open(os.path.join(cdir, f"{name}.onnx"), "wb") as f:
                    f.write(export(module, (example,), dynamic_axes={"x": axes}, input_names=["x"]))
        del cp
        # 0.8 s: a whole number of hops (6), which the exported native encoder needs (the published one pads)
        rc, out, secs = run_script("import_codec", import_codec.main,
                                   ["--assets", cdir, "--save", os.path.join(tmp, "codec_import", "c"),
                                    "--roundtrip-seconds", "0.8"])
        snr = float(out.split("round-trip SNR vs input: ")[1].split(" dB")[0])
        check(rc == 0 and np.isfinite(snr) and all(os.path.isfile(os.path.join(tmp, "codec_import", f"c_{s}.npz"))
                                                    for s in ("enc", "dec")), f"import_codec: exit {rc}, SNR {snr}")
        result["import_codec"] = dict(wall_s=secs, snr_db=snr)
        torch.cuda.empty_cache()

        # ---- bench_serving
        lines = {}
        for label, argv, n_req in (("32 requests", ["--clients", "8", "--requests", "4", "--duration", "5",
                                                    "--max-batch", "8", "--proc-clients"], 32),
                                   ("stream", ["--stream", "--sentences", "2", "--clients", "4", "--requests", "2"], 8)):
            rc, out, secs = run_script(f"bench_serving {label}", bench_serving.main, argv)
            line = json.loads(out.strip().splitlines()[-1])
            check(rc == 0 and line["requests"] == n_req and 0 < line["latency_p50_ms"] <= line["latency_p95_ms"],
                  f"bench_serving {label}: {line}")
            if label == "stream":
                check(0 < line["ttfb_p50_ms"] <= line["ttfb_p95_ms"], f"bench_serving stream: {line}")
            lines[label] = dict(line, wall_s=secs)
            made.clear()
            torch.cuda.empty_cache()
        result["bench_serving"] = lines

        # ---- demo_quality_loop
        kernels.reset_launches()
        rc, out, secs = run_script("demo_quality_loop", demo_quality_loop.main, DEMO_ARGV)
        summary = json.loads(out.strip().splitlines()[-1])

        def finite(x):
            return all(finite(v) for v in x.values()) if isinstance(x, dict) else (
                isinstance(x, bool) or bool(np.isfinite(x)))

        d16 = {str(shape[:4]) + " " + str(shape[5]).split(".")[-1]: n for (name, shape), n
               in kernels.SHAPE_LAUNCHES.items() if name == "attention" and shape[4] == 16}
        ctc = {n: kernels.LAUNCHES.get(n, 0) for n in ("ctc_forward", "ctc_backward")}
        check(rc == 0 and finite(summary) and set(summary) == {"codec", "tts", "asr", "sv", "total_seconds"},
              f"demo_quality_loop: exit {rc}, {summary}")
        check(sum(d16.values()) > 0 and all(ctc.values()), f"demo_quality_loop: head dim 16 {d16}, CTC {ctc}")
        marks = [(float(line[1:].split("s]")[0]), line.split("] ")[1].split(":")[0]) for line in out.splitlines()
                 if line.startswith("[")]
        stages = {name: round(t - t_prev, 3) for (t_prev, _), (t, name) in zip(marks, marks[1:])}
        result["demo_quality_loop"] = dict(argv=DEMO_ARGV, wall_s=secs, stage_s=stages, summary=summary,
                                           attention_launches_d16=d16, ctc_launches=ctc)
        print(f"  demo_quality_loop stage seconds: {json.dumps(stages)}; attention launches at head dim 16 "
              f"(B, H, Tq, S dtype): {json.dumps(d16)}; CTC launches {json.dumps(ctc)}", flush=True)
    finally:
        pipeline.SmallTTS = base
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    print(f"  phase scripts: {json.dumps(result)}", flush=True)
    for e in entries:
        if e["name"] == "attention":
            e["scripts"] = dict(clone_launches_a_batch=result["clone"]["launches_a_batch"]["attention"],
                                demo_launches_d16=sum(d16.values()), seconds=result["seconds"])
        elif e["name"] in ctc:
            e["launches_scripts_demo"] = ctc[e["name"]]
    return result


def scripts_only(torch):
    """`--scripts`: the kernels built, phase A at head dim 16, then phase
    scripts alone. Prints every row."""
    from smalltts_tpu_torch.ops import kernels

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    dev = torch.device("cuda")
    entries = [dict(name="attention"), dict(name="ctc_forward"), dict(name="ctc_backward")]
    attn_d16_phase(torch, dev, entries)
    scripts_phase(torch, dev, entries)
    print(json.dumps({"kernels": entries}))
    return 0


# ------------------------------------------------------------------ certify, A/B, IMF corpus

# SmallTTS's sampler against the imported graphs (fp32) on the same noise, rel-L2 of the waveform: in fp32 on
# the split layout, sums in another order and the 3xTF32 attention (IMPORTED_TOL, as the imported phase holds
# the graphs to the torch modules); in bf16 through the scan kernels, the bf16 weights and activations through
# 4 steps, held as the int8 path is held to bf16 (W8_VS_BF16_TOL). A wiring fault (a wrong noise slot, frame or
# mask) gives O(1)
CERTIFY_VS_IMPORTED_TOL = {"fp32 split": IMPORTED_TOL, "bf16 scan": W8_VS_BF16_TOL}
# the IMF phase's cut step counts: codec, teacher, DMD2, IMF (the harness's defaults: 300, 800, 150, 400)
IMF_CUT = dict(codec_steps=20, teacher_steps=40, dmd_steps=10, imf_steps=20)


def certify_fixture(torch, dev, root, inputs):
    """The rest of the assets tree certify reads, beside the four graphs
    that the imported phase (or certify_graphs) wrote into `root`: the
    seed-0 backbone (zero-init leaves re-drawn, the graphs' weights) as
    dmd/student_latest.npz (backbone_meta) and as the reference-layout
    teacher_checkpoints/seed0.pt, and the graphs' reference latents
    (`inputs`, imported_inputs) as tryme/latents.npy. Returns the backbone
    params and (R, tokens, S, duration)."""
    import numpy as np

    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_meta
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.torch_convert import backbone_state_dict

    for sub in ("tryme", "teacher_checkpoints"):
        os.makedirs(os.path.join(root, sub))
    cfg = BackboneConfig()
    gb = torch.Generator(device=dev).manual_seed(0)
    bp = redraw_zero_init(init_backbone(gb, cfg, device=dev), gb)
    ref, tokens, duration = inputs["ref"], inputs["tokens"], inputs["duration"]
    np.save(os.path.join(root, "tryme", "latents.npy"), ref)
    jax_layout = params_to_jax(bp)
    ckpt.save_pytree(os.path.join(root, "dmd", "student_latest.npz"), jax_layout, meta=backbone_meta(cfg))
    torch.save(backbone_state_dict(jax_layout), os.path.join(root, "teacher_checkpoints", "seed0.pt"))
    del jax_layout
    torch.cuda.empty_cache()
    return bp, (ref.shape[0], tokens, max(1, int(duration * 24_000 / 3_200)), duration)


def certify_graphs(torch, dev, root):
    """`--certify`'s four graphs, without the onnx phases' checks: the
    seed-1 CodecConfig() codec and the seed-0 backbone's condition encoder
    and denoiser at the imported phase's inputs, exported by the helpers
    that phase uses into `root`. Returns those inputs."""
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import CodecConfig, init_codec
    from smalltts_tpu_torch.onnxtorch.export import ConditionEncoder, Denoiser

    ccfg = CodecConfig()
    export_codec_graphs(torch, dev, root, init_codec(torch.Generator(device=dev).manual_seed(1), ccfg, device=dev),
                        ccfg)
    cfg = BackboneConfig()
    gb = torch.Generator(device=dev).manual_seed(0)
    bp = redraw_zero_init(init_backbone(gb, cfg, device=dev), gb)
    _, inputs = imported_inputs()
    export_backbone_graphs(torch, dev, root, ConditionEncoder(bp, cfg), Denoiser(bp, cfg), inputs["ref"],
                           inputs["tokens"], int(inputs["duration"] * 24_000 / 3_200))
    torch.cuda.empty_cache()
    return inputs


def certify_only(torch, dev, entries):
    """`--certify`'s phase: certify_graphs into a directory of its own, then
    phase certify on it."""
    root = tempfile.mkdtemp(prefix="smoke_graphs_")
    try:
        return certify_phase(torch, dev, entries, root, certify_graphs(torch, dev, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def certify_phase(torch, dev, entries, root, inputs):
    """Phase certify: smalltts_tpu_torch.scripts.certify at full width on a
    fixture tree in `root`, the four graphs already there and the rest made
    here (certify_fixture), the whole run as a user
    makes it: every stage passes but espeak_goldens, which skips (no espeak
    on the card), and the quality stage, whose mel reading against the
    imported audio is a reading on random weights with noise of its own
    (it passes under certify's 2.0, or fails on that assertion alone, with
    the reading in its error). The quality stage's launches are counted (set
    to 0 just before it): the attention kernel and every scan kernel, at
    least one batch's (68, 384). Then SmallTTS's sampler and codec on the
    same weights, in fp32 on the split layout and in bf16 through the scan
    kernels, with the imported stage's RandomState(7) noises injected at its
    frames, the S frames of latents decoded alone as the imported pipeline
    decodes them, against the imported audio (CERTIFY_VS_IMPORTED_TOL rel-L2
    of the waveform); a run
    without assets (every stage skips, main exits 0) and a corrupt decoder
    (codec_parity fails, main exits 1). Prints every stage's status and
    seconds."""
    import numpy as np

    from smalltts_tpu_torch.data.bucketing import (
        LATENT_BUCKETS,
        SERVING_PHONEME_BUCKETS,
        SERVING_REF_BUCKETS,
        pad_to,
        pick_bucket,
    )
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.infer.sampler import sample_latents
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.scripts import certify

    t_phase = time.perf_counter()
    print("phase certify: smalltts_tpu_torch.scripts.certify on a full-width fixture tree (the CodecConfig() codec and "
          "the seed-0 328M backbone exported with the published contracts, as an npz and a reference .pt)", flush=True)
    tmp = tempfile.mkdtemp(prefix="smoke_certify_")
    stages0, env = list(certify.STAGES), dict(os.environ)
    hub = sys.modules.get("huggingface_hub")
    sys.modules["huggingface_hub"] = None  # certify's assets stage must find no hub to download from
    os.environ.pop(certify.REFERENCE_SRC_VAR, None)  # checkpoint_parity's oracle skips (no reference tree here)
    result = dict(card=card_line())
    try:
        t0 = time.perf_counter()
        bp, (R, tokens, S, duration) = certify_fixture(torch, dev, root, inputs)
        result["fixture_s"] = time.perf_counter() - t0
        print(f"  fixture made in {result['fixture_s']:.2f} s: R {R}, P {len(tokens)}, S {S}", flush=True)
        ctxs, launches = [], {}

        def wrap(name, fn):
            def stage(ctx):
                if name == "quality":
                    kernels.reset_launches()
                try:
                    return fn(ctx)
                finally:
                    if name == "quality":
                        launches.update({k: v for k, v in kernels.LAUNCHES.items() if v})
                    ctxs.append(ctx)

            return name, stage

        certify.STAGES = [wrap(n, f) for n, f in stages0]
        report = certify.run_certification(root, os.path.join(tmp, "CERTIFY.json"), device="cuda",
                                           ctx_extra={"tokens": tokens, "duration": duration})
        certify.STAGES = stages0
        st = report["stages"]
        result["stages"] = {n: dict(status=e["status"], elapsed_s=e["elapsed_s"],
                                    **{k: e[k] for k in ("reason", "error", "mel_distance_native_vs_imported",
                                                         "sv_similarity", "roundtrip_mel_distance", "roundtrip_snr_db",
                                                         "latent_shape", "hop", "decode_shape", "samples",
                                                         "forward_rms", "oracle_cross_check", "seconds", "rms")
                                       if k in e}) for n, e in st.items()}
        print(f"  report: {report['summary']}; {json.dumps(result['stages'])}", flush=True)
        want = {n: "pass" for n, _ in stages0}
        want["espeak_goldens"] = "skip"
        quality_fail = (st["quality"]["status"] == "fail"
                        and "native pipeline diverges from imported reference graphs (mel" in st["quality"]["error"])
        if quality_fail:
            want["quality"] = "fail"
        check({n: e["status"] for n, e in st.items()} == want, f"certify statuses {json.dumps(result['stages'])}")
        check(st["checkpoint_parity"]["oracle_cross_check"].startswith("skipped: reference source unavailable"),
              f"certify checkpoint_parity: {st['checkpoint_parity']}")
        result["quality_outcome"] = "fail: mel over the threshold" if quality_fail else "pass"
        result["quality_launches"] = launches
        check(launches.get("attention", 0) >= 68 and all(launches.get(n, 0) >= 1 for n in SCAN_KERNELS),
              f"certify quality launched {launches}: the attention and scan kernels are missing")

        # SmallTTS's sampler and codec on the same weights, with the imported stage's noises at its frames, against
        # the imported audio: its S frames of latents decoded alone, as the imported pipeline decodes them
        ctx = ctxs[-1]
        codec = OnnxCodec(os.path.join(root, "codec", "encoder.onnx"), os.path.join(root, "codec", "decoder.onnx"),
                          device=dev)
        rb, pb, tb = (pick_bucket(R, SERVING_REF_BUCKETS), pick_bucket(len(tokens), SERVING_PHONEME_BUCKETS),
                      pick_bucket(S, LATENT_BUCKETS))
        noises = torch.zeros((4, 1, tb, 64), device=dev)
        noises[:, :, :S] = torch.from_numpy(ctx["imported_noises"]).to(dev)
        ph = torch.zeros((1, pb), dtype=torch.int64, device=dev)
        ph[0, :len(tokens)] = torch.tensor(tokens, device=dev)
        want_a = np.asarray(ctx["imported_audio"]).reshape(-1)
        rels = {}
        for label, opts in (("fp32 split", dict(dtype=torch.float32, fused_block=False)), ("bf16 scan", {})):
            tts = SmallTTS(bp, codec=codec, device=dev, **opts)
            with torch.inference_mode():
                lat = sample_latents(tts.params, tts.cfg, torch.from_numpy(pad_to(ctx["imported_ref"], rb, 0)[None]).to(
                    dev, tts.dtype), torch.tensor([R], device=dev), ph, torch.tensor([len(tokens)], device=dev),
                    torch.tensor([S], device=dev), num_steps=4, noises=noises.to(tts.dtype))
                got = tts._decode(lat[:, :S].float()).reshape(-1).cpu().numpy()
            rels[label] = float(np.linalg.norm(got - want_a) / np.linalg.norm(want_a))
            del tts
        result["smalltts_vs_imported_rel_l2"] = rels
        print(f"  SmallTTS's sampler and codec vs the imported graphs (fp32), the imported stage's noises, {S} frames: "
              f"waveform rel-L2 {json.dumps(rels)} (tolerance {json.dumps(CERTIFY_VS_IMPORTED_TOL)})", flush=True)
        check(all(rels[k] <= CERTIFY_VS_IMPORTED_TOL[k] for k in rels), f"SmallTTS vs imported: {rels}")
        del codec, bp, ctxs
        torch.cuda.empty_cache()

        # no assets; a corrupt decoder
        empty = os.path.join(tmp, "empty")
        out = os.path.join(tmp, "c.json")
        rc = certify.main(["--assets-root", empty, "--out", out, "--device", "cuda"])
        none = json.load(open(out))
        check(rc == 0 and {e["status"] for e in none["stages"].values()} == {"skip"} and none["ok"],
              f"certify without assets: exit {rc}, {none['summary']}")
        bad = os.path.join(tmp, "bad")
        os.makedirs(os.path.join(bad, "codec"))
        with open(os.path.join(bad, "codec", "decoder.onnx"), "wb") as f:
            f.write(b"not a model")
        rc = certify.main(["--assets-root", bad, "--out", out, "--stages", "codec_parity", "--device", "cuda"])
        corrupt = json.load(open(out))["stages"]["codec_parity"]
        check(rc == 1 and corrupt["status"] == "fail", f"certify, a corrupt decoder: exit {rc}, {corrupt}")
        result["no_assets"] = none["summary"]
        result["corrupt_decoder"] = dict(exit=rc, error=corrupt["error"][:120])
    finally:
        certify.STAGES = stages0
        if hub is None:
            sys.modules.pop("huggingface_hub", None)
        else:
            sys.modules["huggingface_hub"] = hub
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(tmp, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t_phase
    print(f"  phase certify: {json.dumps(result)}", flush=True)
    for e in entries:
        if e["name"] == "attention":
            e["certify"] = dict(quality_launches=launches.get("attention", 0), seconds=result["seconds"])
        elif e["name"] == "fused_dit_scan":
            e["certify"] = dict(quality_launches={n: launches.get(n, 0) for n in SCAN_KERNELS},
                                quality_outcome=result["quality_outcome"],
                                smalltts_vs_imported_rel_l2=result["smalltts_vs_imported_rel_l2"])
    return result


def ab_phase(torch, dev, entries):
    """Phase ab: both A/B scripts (smalltts_tpu_torch/scripts/
    ab_fused_block{,_e2e}.py) at their default cells, in this process, each
    with the launch counts set to 0 just before it: the split layout against
    the scan kernels, one denoise pass (8x40, 1x40, 8x120 at K 16) and the
    whole served synthesis (5 s x 8 and x 32 at K 16). Every line must time
    both arms (split_ms and fused_ms positive, finite) with a finite sum_rel;
    the attention kernel and every scan kernel must have launched in each
    script (the split arm launches the attention kernel alone)."""
    import math

    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.scripts import ab_fused_block, ab_fused_block_e2e

    t_phase = time.perf_counter()
    print("phase ab: the DiT block scan kernels against the split layout (PyTorch ops), one denoise pass and the "
          "served synthesis, full width, bf16, CUDA graphs timed by CUDA events", flush=True)
    result = dict(card=card_line())
    for name, main in (("ab_fused_block", ab_fused_block.main), ("ab_fused_block_e2e", ab_fused_block_e2e.main)):
        kernels.reset_launches()
        rc, out, secs = run_script(name, main, [])
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        lines = [json.loads(line) for line in out.strip().splitlines()]
        check(rc == 0 and len(lines) == (3 if name == "ab_fused_block" else 2), f"{name}: exit {rc}, {len(lines)} lines")
        for line in lines:
            check(all(isinstance(line.get(k), float) and math.isfinite(line[k]) and line[k] > 0
                      for k in ("split_ms", "fused_ms")) and math.isfinite(line["sum_rel"]), f"{name}: {line}")
        check(launches.get("attention", 0) > 0 and all(launches.get(n, 0) > 0 for n in SCAN_KERNELS),
              f"{name}: launches {launches}")
        result[name] = dict(lines=lines, seconds=secs, launches=launches)
        torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    print(f"  phase ab: {json.dumps(result)}", flush=True)
    for e in entries:
        if e["name"] == "fused_dit_scan":
            e["ab"] = {n: [{k: v for k, v in line.items() if k != "k"} for line in result[n]["lines"]]
                       for n in ("ab_fused_block", "ab_fused_block_e2e")}
        elif e["name"] == "attention":
            e["ab_launches"] = {n: result[n]["launches"].get("attention", 0) for n in ("ab_fused_block",
                                                                                       "ab_fused_block_e2e")}
    return result


def imf_exp_phase(torch, dev, entries):
    """Phase imf: the corpus experiments (exp_imf_boundary with p = 0.25,
    exp_imf_source's `base`) on the card at cut step counts (IMF_CUT), each
    with the launch counts set to 0 just before it: every printed mel and
    cosine finite, the codec floor line first, and the attention kernel at
    head dim 16 launched."""
    import math

    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.scripts import exp_imf_boundary, exp_imf_source
    from smalltts_tpu_torch.scripts import imf_corpus as H

    t_phase = time.perf_counter()
    print(f"phase imf: the IMF corpus experiments on the synthetic corpus, the tiny models in fp32, cut to {IMF_CUT} "
          "steps", flush=True)
    orig = H.build_corpus_and_models, H.train_dmd2, H.train_imf_student
    H.build_corpus_and_models = functools.partial(orig[0], codec_steps=IMF_CUT["codec_steps"],
                                                  teacher_steps=IMF_CUT["teacher_steps"])
    H.train_dmd2 = lambda *a, steps=None, **k: orig[1](*a, steps=IMF_CUT["dmd_steps"], **k)
    H.train_imf_student = lambda *a, steps=None, **k: orig[2](*a, steps=IMF_CUT["imf_steps"], **k)
    result = dict(card=card_line(), steps=IMF_CUT)
    try:
        for name, main, argv in (("exp_imf_boundary", exp_imf_boundary.main, ["0.25"]),
                                 ("exp_imf_source", exp_imf_source.main, ["base"])):
            kernels.reset_launches()
            rc, out, secs = run_script(name, main, argv)
            lines = out.strip().splitlines()
            d16 = sum(n for (k, shape), n in kernels.SHAPE_LAUNCHES.items() if k == "attention" and shape[4] == 16)
            mels = [float(line.split("mel=")[1].split()[0]) for line in lines if "mel=" in line]
            svs = [float(line.split("sv=")[1]) for line in lines if "sv=" in line]
            check(rc == 0 and lines[0].startswith("codec floor mel=") and len(mels) == len(lines)
                  and len(svs) == len(lines) - 1 and all(math.isfinite(v) for v in mels + svs) and d16 > 0,
                  f"{name}: exit {rc}, {lines}, head-dim-16 attention launches {d16}")
            result[name] = dict(lines=lines, seconds=secs, attention_launches_d16=d16,
                                launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    finally:
        H.build_corpus_and_models, H.train_dmd2, H.train_imf_student = orig
    result["seconds"] = time.perf_counter() - t_phase
    print(f"  phase imf: {json.dumps(result)}", flush=True)
    for e in entries:
        if e["name"] == "attention":
            e["imf_corpus"] = {n: result[n]["attention_launches_d16"] for n in ("exp_imf_boundary", "exp_imf_source")}
    return result


def imf_quality_only(torch):
    """`--imf-quality`: the kernels built, then tests/test_torch_imf_quality.py
    (the corpus test's assertions at the harness's step counts: codec 300,
    teacher 800, DMD2 150, IMF 400) on the card in a process of its own,
    RUN_SLOW=1; prints its result line and pytest's outcome, and exits with
    pytest's code."""
    from smalltts_tpu_torch.ops import kernels

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-s", "-p", "no:cacheprovider",
                          "tests/test_torch_imf_quality.py"], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "RUN_SLOW": "1"}, timeout=3000)
    secs = time.perf_counter() - t0
    print(res.stdout[-6000:], flush=True)
    print(res.stderr[-2000:], file=sys.stderr, flush=True)
    print(f"imf quality: pytest exit {res.returncode} in {secs:.1f} s", flush=True)
    return res.returncode


def phase_only(torch, phase, entries):
    """`--certify` / `--ab` / `--imf`: the kernels built, then that phase alone."""
    from smalltts_tpu_torch.ops import kernels

    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    phase(torch, torch.device("cuda"), entries)
    print(json.dumps({"kernels": entries}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())

"""A/B the hand-written DiT block scan against the split layout (port of
scripts/ab_fused_block.py).

    python -m smalltts_tpu_torch.scripts.ab_fused_block [--cells 8x40 1x40 8x120] [--k 16] [--device cuda]

Times the graph the scan kernels replace, one denoise pass (`denoise_step`:
12 blocks over the cross-K/V cache, the modulations computed in the call),
in two arms on the same seed-0 weights at full width (BackboneConfig(),
bf16 on the card, cast_floating):

- `split`: the split layout of training, the blocks through `_block_core`
  layer by layer, the projections in `torch.matmul`, the attention through
  the attention kernel (the JAX script's `xla` arm);
- `fused`: fuse_serving_projections, the whole scan through the
  hand-written kernels of ops/kernels/dit_block.py (its `pallas` arm).

Each arm chains K passes on the device, x <- x + 1e-3 * denoise_step(x),
as the JAX script's lax.scan does, so that dispatch cancels. On the card
the K-pass chain and a single pass are each recorded as one CUDA graph and
timed by CUDA events around their replays, three times each:
ms = (min K-pass - min single pass) / (K - 1). On the CPU the same two
functions are timed eagerly by the host clock.

One JSON line a cell (B x T latent frames; R = 64 reference frames, P = 128
phonemes): `cell`, `k`, `<arm>_ms`, `<arm>_mfu` and `<arm>_hbm_frac`
(utils/flops: the FLOPs and argument bytes of one pass, counted once on the
plain versions of the kernels, since FlopCounterMode sees no hand-written
kernel, over the arm's time and the card's published peaks; absent where
the device has no published peaks), `sum_rel` (|sum split - sum fused| /
|sum split| of the single pass's output), `speedup` (split_ms / fused_ms).
The timed arms always run their kernels: a failed build or launch ends the
run. Departures from the JAX script: no `fits_vmem` (the scan has no
on-chip memory budget to fit), and the zero-init leaves (adaLN modulation,
final norm, velocity head) are re-drawn from the seed, so that the outputs
the cross-check compares are not all zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

R_FRAMES, P_TOKENS = 64, 128


def default_config():
    """The model both arms run (the default BackboneConfig, full width)."""
    from smalltts_tpu_torch.models.backbone import BackboneConfig

    return BackboneConfig()


def seeded_weights(cfg, dev, seed: int = 0):
    """init_backbone(seed) with the zero-init leaves re-drawn, fp32."""
    import torch

    from smalltts_tpu_torch.models.backbone import init_backbone, redraw_zero_init

    g = torch.Generator(device=dev).manual_seed(seed)
    return redraw_zero_init(init_backbone(g, cfg, device=dev), g)


def make_arms(params) -> dict:
    """{"split": the split layout as it is, "fused": fuse_serving_projections of it}."""
    from smalltts_tpu_torch.models.dit import fuse_serving_projections

    return {"split": params, "fused": fuse_serving_projections(params)}


class Timed:
    """fn() -> a 0-d tensor, timed as it will run: on the card, captured once
    as a CUDA graph (after an eager run of `warm`, default fn, on a side
    stream, where the kernels are built and set up and cuDNN picks its
    algorithms) whose replays are timed by CUDA events and add the launches
    counted while it was captured to kernels.LAUNCHES; on the CPU, run
    eagerly and timed by the host clock. A call -> (value, ms)."""

    def __init__(self, fn, dev, warm=None):
        import torch

        from smalltts_tpu_torch.ops import kernels

        self.fn, self.graph, self.launches = fn, None, {}
        if dev.type != "cuda":
            return
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            (warm or fn)()
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with kernels.recording() as self.launches, torch.cuda.graph(self.graph):
            self.out = fn()

    def __call__(self):
        import torch

        from smalltts_tpu_torch.ops import kernels

        if self.graph is None:
            t0 = time.perf_counter()
            out = float(self.fn())
            return out, (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        kernels.add_launches(self.launches)
        return float(self.out), start.elapsed_time(end)


def per_pass_ms(one: Timed, many: Timed, k: int, reps: int = 3) -> float:
    """(min K-pass - min single pass) / (K - 1), single and K-pass timed in
    turns."""
    t1s, tks = [], []
    for _ in range(reps):
        t1s.append(one()[1])
        tks.append(many()[1])
    return max(min(tks) - min(t1s), 1e-9) / (k - 1)


def make_inputs(cfg, params, B: int, T: int, dev, dtype):
    """The JAX script's inputs from RandomState(0): the conditions encoded
    from (B, R, 64) reference latents and (B, P) phonemes (P - 9 valid), x
    (B, T, 64) with T - 2 valid frames, t = 0.7."""
    import torch

    from smalltts_tpu_torch.models.backbone import encode_conditions
    from smalltts_tpu_torch.ops.masking import length_mask

    rng = np.random.RandomState(0)
    ref = torch.from_numpy(rng.randn(B, R_FRAMES, cfg.latent_dim).astype(np.float32)).to(dev, dtype)
    ref_lens = torch.full((B,), R_FRAMES, dtype=torch.int32, device=dev)
    ph = torch.from_numpy(rng.randint(1, 150, (B, P_TOKENS)).astype(np.int64)).to(dev)
    ph_mask = length_mask(torch.full((B,), P_TOKENS - 9, dtype=torch.int32, device=dev), P_TOKENS)
    with torch.inference_mode():
        cond = encode_conditions(params, cfg, ref, ref_lens, ph, ph_mask)
    x = torch.from_numpy(rng.randn(B, T, cfg.latent_dim).astype(np.float32)).to(dev, dtype)
    mask = length_mask(torch.full((B,), T - 2, dtype=torch.int32, device=dev), T)
    t = torch.full((B,), 0.7, dtype=torch.float32, device=dev)
    return cond, x, mask, t


def run_cell(cfg, arms, B: int, T: int, k: int, dev, dtype) -> dict:
    import torch

    from smalltts_tpu_torch.models.backbone import denoise_step
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.utils.flops import compiled_cost, utilization

    cond, x, mask, t = make_inputs(cfg, arms["split"], B, T, dev, dtype)
    out = {"cell": f"{B}x{T}", "k": k}
    sums = {}
    for name, p in arms.items():
        def one(p=p):
            return denoise_step(p, cfg, x, mask, t, cond).float().sum()

        def many(p=p):
            c = x
            for _ in range(k):
                c = c + 1e-3 * denoise_step(p, cfg, c, mask, t, cond).to(c.dtype)
            return c.float().sum()

        with torch.inference_mode():
            one_t, many_t = Timed(one, dev), Timed(many, dev, warm=one)
            ms = per_pass_ms(one_t, many_t, k)
            sums[name] = one_t()[0]
            with kernels.force_plain():  # FLOPs of the same function, counted on the plain versions
                cost = compiled_cost(lambda p_: denoise_step(p_, cfg, x, mask, t, cond), p)
        out[f"{name}_ms"] = round(ms, 3)
        if cost:
            try:
                u = utilization(cost["flops"], cost["bytes"], ms / 1e3, dev if dev.type == "cuda" else "cpu")
            except ValueError:  # no published peaks for this device
                u = None
            if u:
                out[f"{name}_mfu"] = u["mfu"]
                out[f"{name}_hbm_frac"] = u["hbm_frac"]
        del one_t, many_t
    out["sum_rel"] = round(abs(sums["split"] - sums["fused"]) / (abs(sums["split"]) + 1e-9), 6)
    out["speedup"] = round(out["split_ms"] / out["fused_ms"], 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A/B the DiT block scan kernels against the split layout")
    ap.add_argument("--cells", nargs="*", default=["8x40", "1x40", "8x120"],
                    help="BxT latent cells (R=64, P=128 fixed)")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from smalltts_tpu_torch.utils.checkpoint import cast_floating
    from smalltts_tpu_torch.utils.transfer import resolve_device

    dev = resolve_device(args.device)
    cfg = default_config()
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    arms = make_arms(cast_floating(seeded_weights(cfg, dev), dtype))
    for cell in args.cells:
        B, T = (int(v) for v in cell.split("x"))
        print(json.dumps(run_cell(cfg, arms, B, T, args.k, dev, dtype)))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

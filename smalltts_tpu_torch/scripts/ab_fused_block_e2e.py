"""End-to-end A/B of the DiT block scan kernels inside the served synthesis
graph (port of scripts/ab_fused_block_e2e.py).

    python -m smalltts_tpu_torch.scripts.ab_fused_block_e2e [--cells 5x8 5x32] [--k 16] [--device cuda]

Unlike ab_fused_block (one denoise pass, its modulations computed in the
call), this times the whole synthesis function SmallTTS serves: text and
style encoding, the 4-step sampler with its modulations hoisted, and the
codec decode, in two arms on the same seed-0 weights (zero-init leaves
re-drawn, as in ab_fused_block):

- `split`: SmallTTS(fused_block=False), the blocks in PyTorch ops on the
  split layout (the JAX script's `xla` arm);
- `fused`: SmallTTS(), the scan kernels (its `pallas` arm).

As bench.py's in-graph probe, each of K iterations perturbs both
conditioning inputs (the reference latents by 1e-3 noise, each phoneme id
by 0-2 places) and draws fresh sampler noise, so nothing is invariant
across iterations; all of it is drawn before the timing. On the card the
K-iteration chain and a single iteration are each recorded as one CUDA
graph, as SmallTTS records one per bucket, and timed by CUDA events:
ms = (min K - min 1) / (K - 1). On the CPU they run eagerly, timed by
the host clock.

One JSON line a cell (DURATION x BATCH): `cell`, `k`, `t_bucket`,
`split_ms`, `fused_ms`, `sum_rel` (|sum split - sum fused| / |sum split|
of one iteration's audio), `speedup` (split_ms / fused_ms).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from smalltts_tpu_torch.scripts.ab_fused_block import Timed, per_pass_ms, seeded_weights

TOKEN_IDS = list(range(1, 31))


def default_configs():
    """(BackboneConfig, CodecConfig) the arms serve: the defaults, full width."""
    from smalltts_tpu_torch.models.backbone import BackboneConfig
    from smalltts_tpu_torch.models.codec import CodecConfig

    return BackboneConfig(), CodecConfig()


def build_arms(dev) -> dict:
    """{"split": SmallTTS(fused_block=False), "fused": SmallTTS()} on the same weights."""
    from smalltts_tpu_torch.infer.pipeline import SmallTTS

    cfg, codec_cfg = default_configs()
    weights = seeded_weights(cfg, dev)
    return {name: SmallTTS(weights, cfg=cfg, codec_cfg=codec_cfg, seed=0, fused_block=fused, device=dev)
            for name, fused in (("split", False), ("fused", True))}


def run_cell(arms: dict, dur: float, bs: int, k: int) -> dict:
    import torch

    from smalltts_tpu_torch.data.bucketing import (
        LATENT_BUCKETS,
        SERVING_PHONEME_BUCKETS,
        SERVING_REF_BUCKETS,
        frames_for_duration,
        pad_to,
        pick_bucket,
    )

    ref_frames = frames_for_duration(2.0)
    ref_lat = np.random.RandomState(0).randn(ref_frames, 64).astype(np.float32)
    seq = frames_for_duration(dur)
    t_bucket = pick_bucket(seq, LATENT_BUCKETS)
    r_bucket = pick_bucket(ref_frames, SERVING_REF_BUCKETS)
    p_bucket = pick_bucket(len(TOKEN_IDS), SERVING_PHONEME_BUCKETS)
    out = {"cell": f"{dur:g}x{bs}", "k": k, "t_bucket": t_bucket}
    sums = {}
    for name, tts in arms.items():
        dev, dtype = tts.device, tts.dtype
        g = torch.Generator(device=dev).manual_seed(0)
        ref = torch.from_numpy(np.repeat(pad_to(ref_lat, r_bucket, 0)[None], bs, axis=0)).to(dev, dtype)
        ref_lens = torch.full((bs,), ref_frames, dtype=torch.int32, device=dev)
        ph = torch.zeros((bs, p_bucket), dtype=torch.int64, device=dev)
        ph[:, :len(TOKEN_IDS)] = torch.tensor(TOKEN_IDS, device=dev)
        ph_lens = torch.full((bs,), len(TOKEN_IDS), dtype=torch.int32, device=dev)
        seq_lens = torch.full((bs,), seq, dtype=torch.int32, device=dev)
        refs = [ref + 1e-3 * torch.randn(ref.shape, generator=g, device=dev).to(dtype) for _ in range(k)]
        phs = [torch.where(ph > 0, 1 + (ph - 1 + torch.randint(0, 3, ph.shape, generator=g, device=dev)) % 196, ph)
               for _ in range(k)]
        noises = [tts._noises(bs, t_bucket) for _ in range(k)]

        def chain(n):
            def run():
                total = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(n):
                    audio = tts._synthesize_fn(tts.params, tts.codec_params, refs[i], ref_lens, phs[i], ph_lens,
                                               seq_lens, noises[i], t_bucket=t_bucket)
                    total = total + audio.float().sum()
                return total

            return run

        with torch.inference_mode():
            one, many = Timed(chain(1), dev), Timed(chain(k), dev, warm=chain(1))
            out[f"{name}_ms"] = round(per_pass_ms(one, many, k), 3)
            sums[name] = one()[0]
        del one, many
    out["sum_rel"] = round(abs(sums["split"] - sums["fused"]) / (abs(sums["split"]) + 1e-9), 6)
    out["speedup"] = round(out["split_ms"] / out["fused_ms"], 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="end-to-end A/B of the DiT block scan kernels in the served graph")
    ap.add_argument("--cells", nargs="*", default=["5x8", "5x32"], help="DURxBATCH cells (duration seconds x batch)")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    from smalltts_tpu_torch.utils.transfer import resolve_device

    arms = build_arms(resolve_device(args.device))
    for cell in args.cells:
        dur_s, bs_s = cell.split("x")
        print(json.dumps(run_cell(arms, float(dur_s), int(bs_s), args.k)))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

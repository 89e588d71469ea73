"""Trace served synthesis batches with torch.profiler.

    python -m smalltts_tpu_torch.scripts.profile [--out out/trace] [--duration 5.0] [--batch 8]
        [--runs 5] [--checkpoint C] [--device cuda]

Builds SmallTTS (seeded random weights unless --checkpoint), runs one batch
of `--batch` random references and phonemes at the latent bucket of
`--duration` seconds outside the trace (on the card this captures the
bucket's CUDA graph), then traces `--runs` more, each an annotated
`synthesize_padded` range, and writes the Chrome trace into `--out`
(utils.profiling.trace).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Trace served synthesis batches.")
    ap.add_argument("--out", default="out/trace")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    from smalltts_tpu_torch.data.bucketing import (
        LATENT_BUCKETS,
        SERVING_PHONEME_BUCKETS,
        SERVING_REF_BUCKETS,
        frames_for_duration,
        pick_bucket,
    )
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.utils.profiling import annotate, trace

    tts = SmallTTS(checkpoint=args.checkpoint, device=args.device)
    seq = frames_for_duration(args.duration)
    t_bucket = pick_bucket(seq, LATENT_BUCKETS)
    r_bucket, p_bucket = SERVING_REF_BUCKETS[0], SERVING_PHONEME_BUCKETS[0]
    bs = args.batch
    rng = np.random.RandomState(0)
    inputs = (rng.randn(bs, r_bucket, tts.cfg.latent_dim).astype(np.float32), np.full((bs,), r_bucket, np.int32),
              rng.randint(1, 100, (bs, p_bucket)).astype(np.int32), np.full((bs,), 30, np.int32),
              np.full((bs,), seq, np.int32))
    tts.synthesize_padded(*inputs, t_bucket)  # captured (on the card) outside the trace
    with trace(args.out) as prof:
        out = None
        for _ in range(args.runs):
            with annotate("synthesize_padded"):
                out = tts.synthesize_padded(*inputs, t_bucket, fetch=False)
        out.cpu()
    print(f"trace written to {prof.trace_file} ({args.runs} runs of {args.duration}s x batch {bs})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

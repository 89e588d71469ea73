"""Corpus experiment: does the MeanFlow boundary condition (train r = t
against the teacher's instantaneous velocity with probability p) fix the
IMF student's weak instantaneous path without costing few-step quality?
(Port of scripts/exp_imf_boundary.py.)

Reuses the synthetic-corpus harness (smalltts_tpu_torch/scripts/imf_corpus.py):
train codec -> teacher once, then one IMF student per boundary_prob,
scoring the mel distance (to the ground truth; the codec floor printed)
and the SV cosine of IMF-2, IMF-1 and the checkpoint served through the
gated DMD-4 recurrence. The p = 0.0 column is the baseline.

usage: python -m smalltts_tpu_torch.scripts.exp_imf_boundary [--device D] [p ...]
  (default p: 0.0 0.25 0.5; the models run on the card unless --device cpu)
"""

from __future__ import annotations

import sys


def split_device(argv):
    """(argv without `--device D`, D or None). Raises SystemExit(2) on a bare --device."""
    argv = list(argv)
    if "--device" not in argv:
        return argv, None
    i = argv.index("--device")
    if i + 1 == len(argv):
        raise SystemExit("--device needs a value")
    return argv[:i] + argv[i + 2:], argv[i + 1]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] in (["-h"], ["--help"]):
        print(__doc__.strip())
        return 0
    argv, device = split_device(argv)
    probs = [float(a) for a in argv] or [0.0, 0.25, 0.5]

    from smalltts_tpu_torch.scripts import imf_corpus as H
    from smalltts_tpu_torch.train.imf import ImfConfig

    utts, cp, batch, teacher, cfg, codec_cfg = H.build_corpus_and_models(device=device)
    embed = H.sv_embed_fn(batch["latents"].device)
    floor = H.codec_floor(utts)
    print(f"codec floor mel={floor:.3f}", flush=True)
    for p in probs:
        student = H.train_imf_student(teacher, batch, cfg, imf_cfg=ImfConfig(rollout_substeps=4, boundary_prob=p))
        s = H.Samplers(batch, cfg)
        for name, fn in (("imf_2", s.imf(student, 2)), ("imf_1", s.imf(student, 1)), ("under_dmd4", s.dmd4(student))):
            mel, sv = H.evaluate(utts, cp, codec_cfg, embed, fn)
            print(f"p={p:.2f} {name}: mel={mel:.3f} (excess {mel - floor:+.3f}) sv={sv:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

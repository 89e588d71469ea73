"""Corpus experiment: what closes the IMF few-step mel gap? (Port of
scripts/exp_imf_source.py.)

On this corpus the JAX package's runs measured IMF-2 mel excess 0.336
against DMD-4's 0.039, 8x off the floor. Two hypotheses for why, each with a lever:

  1. TARGET ERROR — the integral target (x_t - x_r)/(t - r) inherits the
     teacher rollout's discretization error (substeps=4 over a ~0.5
     interval is teacher-8-step territory, which is not at floor).
     Lever: `sub12` raises rollout_substeps 4 -> 12.
  2. SOURCE CURVATURE — the teacher's flow is curved, so its average
     velocity varies strongly with x; the DMD-4 student's field was
     explicitly trained so 4 BIG steps land on the data manifold
     (straighter flow => easier integral). Lever: `dmd` distills the
     interval student FROM the DMD-4 student (init + rollout source),
     the reference's own few-step generator
     (src/scripts/train/dmd2/distill.py).
  3. TRAINING-MASS MISMATCH — uniform (t, r) spends most gradient steps
     on intervals the 2-step sampler never evaluates. Lever: `focus`
     trains 50% of samples on the exact serving-grid intervals
     (ImfConfig.focus_prob).

Grid: baseline, each lever alone, and the combinations. Scores mel
(vs ground truth, codec floor printed) + SV cosine for IMF-2 / IMF-1,
plus dmd_student_4 as the anchor, on the synthetic-corpus
harness (smalltts_tpu_torch/scripts/imf_corpus.py).

usage: python -m smalltts_tpu_torch.scripts.exp_imf_source [--device D] [config ...]
  (configs: every CONFIGS key below, or `all`; --help prints the live list;
  the models run on the card unless --device cpu)
"""

from __future__ import annotations

import sys

# EVERY config pins focus_prob EXPLICITLY: ImfConfig.focus_prob's default
# flipped to 0.5 mid-round (the wave-1/2 policy win), which silently turned
# any later config that omitted it into a focus stack. Waves 3-4 were run
# with that drift — the numbers are valid but the labels weren't: measured
# "rollin"/"rollin_long"/"dmdgrad" were focus0.5+lever stacks, and
# "focus_dmdgrad" duplicated "dmdgrad". The *_pure
# configs below close the single-lever holes.
CONFIGS = {
    # name: (source, ImfConfig kwargs)
    "base": ("teacher", dict(rollout_substeps=4, focus_prob=0.0)),
    "sub12": ("teacher", dict(rollout_substeps=12, focus_prob=0.0)),
    "dmd": ("dmd", dict(rollout_substeps=4, focus_prob=0.0)),
    "dmd_sub12": ("dmd", dict(rollout_substeps=12, focus_prob=0.0)),
    "focus": ("teacher", dict(rollout_substeps=4, focus_prob=0.5)),
    # named for what it measures: dmd source + sub12 + focus (the old
    # "dmd_focus" label hid the substeps lever)
    "dmd_sub12_focus": ("dmd", dict(rollout_substeps=12, focus_prob=0.5)),
    # round-4 second wave (after the first grid measured focus=0.5 the
    # winner at IMF-2 excess 0.208 and refuted the dmd source):
    "focus1": ("teacher", dict(rollout_substeps=4, focus_prob=1.0)),
    "gan": ("teacher", dict(rollout_substeps=4, focus_prob=0.0,
                            gan_weight=1e-3)),
    "focus_gan": ("teacher",
                  dict(rollout_substeps=4, focus_prob=0.5, gan_weight=1e-3)),
    # round-4 wave 3: is the remaining gap training-BUDGET-limited or
    # method-limited? Same best config, 3x the steps (grid runs use 400).
    "focus_long": ("teacher", dict(rollout_substeps=4, focus_prob=0.5), 1200),
    # round-4 wave 4: backward-simulation roll-in — train the second
    # serving interval on the student's OWN first-step output (the state
    # the 2-step sampler actually feeds it; reference distill.py:248-287).
    # focus_rollin AS MEASURED was focus0.5+rollin0.5 (the default drift);
    # rollin_pure is the single lever.
    "rollin_pure": ("teacher", dict(rollout_substeps=4, focus_prob=0.0,
                                    rollin_prob=0.5)),
    "focus_rollin": ("teacher",
                     dict(rollout_substeps=4, focus_prob=0.5,
                          rollin_prob=0.5)),
    "focus_rollin25": ("teacher",
                       dict(rollout_substeps=4, focus_prob=0.5,
                            rollin_prob=0.25)),
    # round-4 wave 5a: does the ~0.2 plateau move when the BEST targeting
    # configs get the 3x budget?
    "focus1_long": ("teacher",
                    dict(rollout_substeps=4, focus_prob=1.0), 1200),
    "focus_rollin_long": ("teacher",
                          dict(rollout_substeps=4, focus_prob=0.5,
                               rollin_prob=0.5), 1200),
    # round-4 wave 5b: the untried weapon CLASS — distribution matching on
    # the served composition (the reference's core DMD gradient,
    # make_imf_dmd_steps). Targeting schemes plateaued at ~0.2; the
    # residual is the pure-noise first interval, which only a
    # distributional signal can sharpen (its input distribution is
    # already exactly right at train time).
    "dmdgrad_pure": ("teacher", dict(rollout_substeps=4, focus_prob=0.0,
                                     dmd_weight=1.0)),
    "focus_dmdgrad": ("teacher",
                      dict(rollout_substeps=4, focus_prob=0.5,
                           dmd_weight=1.0)),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] in (["-h"], ["--help"]):
        print(__doc__.strip())
        print(f"\nconfigs: {' '.join(CONFIGS)} all")
        return 0
    from smalltts_tpu_torch.scripts.exp_imf_boundary import split_device

    argv, device = split_device(argv)
    names = argv or ["all"]
    if names == ["all"]:
        names = list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        raise SystemExit(f"unknown configs {unknown}; choose from {list(CONFIGS)}")

    from smalltts_tpu_torch.scripts import imf_corpus as H
    from smalltts_tpu_torch.train.imf import ImfConfig

    utts, cp, batch, teacher, cfg, codec_cfg = H.build_corpus_and_models(device=device)
    embed = H.sv_embed_fn(batch["latents"].device)
    floor = H.codec_floor(utts)
    print(f"codec floor mel={floor:.3f}", flush=True)
    s = H.Samplers(batch, cfg)

    dmd_student = None
    if any(CONFIGS[n][0] == "dmd" for n in names):
        dmd_student = H.train_dmd2(teacher, batch, cfg)
        mel, sv = H.evaluate(utts, cp, codec_cfg, embed, s.dmd4(dmd_student))
        print(f"anchor dmd_student_4: mel={mel:.3f} (excess {mel - floor:+.3f}) sv={sv:.3f}", flush=True)

    for name in names:
        source_name, kwargs, *rest = CONFIGS[name]
        steps = rest[0] if rest else 400
        source = teacher if source_name == "teacher" else dmd_student
        student = H.train_imf_student(source, batch, cfg, steps=steps, imf_cfg=ImfConfig(**kwargs))
        for sname, fn in (("imf_2", s.imf(student, 2)), ("imf_1", s.imf(student, 1))):
            mel, sv = H.evaluate(utts, cp, codec_cfg, embed, fn)
            print(f"{name} {sname}: mel={mel:.3f} (excess {mel - floor:+.3f}) sv={sv:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

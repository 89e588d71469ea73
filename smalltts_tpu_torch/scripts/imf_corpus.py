"""The synthetic-corpus quality harness of the whole training chain (port of
tests/test_imf_quality.py's harness).

In-repo and asset-free: a corpus of 2 synthetic speakers x 3 texts
(data/synthetic.py), a tiny codec trained on it (300 steps), its latents
in one padded batch holding the whole corpus, a flow-matching teacher
trained on that batch (800 steps), then a DMD2 student (150 steps) and an
IMF student (400 steps) distilled from the teacher. Each sampler is scored
on every utterance by the mel distance of its decoded audio to the ground
truth (the codec's own round trip is the floor) and the cosine of a
random-feature waveform ECAPA's speaker embeddings:

    teacher 32-step      the quality anchor
    teacher 4-step       the serving recurrence undistilled
    DMD2 student 4-step  the reference-parity serving path
    IMF student on the DMD-4 recurrence (the r_gate embedding gate)
    IMF student 2-step / 1-step

    python -m smalltts_tpu_torch.scripts.imf_corpus [--codec-steps 300] [--teacher-steps 800]
        [--dmd-steps 150] [--imf-steps 400] [--device cuda]

`quality_on_corpus` runs that comparison and prints each result (and, from
the command line, one JSON line of them with the floor and the seconds);
tests/test_torch_imf_quality.py holds it to the corpus test's bounds. The
IMF experiments (exp_imf_boundary, exp_imf_source) reuse the pieces. Step
counts are keyword arguments. The models are the tiny configurations of
demo_quality_loop (head dim 16 in every attention), in fp32; everything
runs on `device` (None means the card). The draws come from
torch.Generators seeded with the JAX harness's key numbers; the two
packages' random streams differ, so their runs agree in distribution, not
number for number.

On the card the training forwards and the samplers run the attention
kernel at head dim 16 (fp32, 3xTF32); the DMD2 run keeps the ASR gate shut
(its CTC loss never runs) as the JAX harness does.
"""

from __future__ import annotations

import numpy as np

from smalltts_tpu_torch.models.conformer import ConformerConfig
from smalltts_tpu_torch.models.discriminator import DiscriminatorConfig
from smalltts_tpu_torch.scripts.demo_quality_loop import (
    TINY_ASR64,
    TINY_BACKBONE,
    TINY_CODEC,
    TINY_SV64,
    TINY_SV_TEACHER,
)

SR = 24_000
TEXTS = ["blue moon light", "red sun down fall", "green leaf wind song"]
SPEAKERS = (0, 1)
REF_FRAMES = 8
TINY_DISC = DiscriminatorConfig(latent_dim=64, transformer_dim=TINY_BACKBONE.hidden_dim,
                                ref_dim=TINY_BACKBONE.hidden_dim, model_dim=32, num_tail_layers=2,
                                conformer=ConformerConfig(input_dim=32, num_heads=4, ffn_dim=64, num_layers=2,
                                                          depthwise_conv_kernel_size=7, use_group_norm=True))


def _tokens(text):
    return np.asarray([max(1, ord(c) % 150) for c in text], np.int32)


def _gen(dev, seed: int):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def _copy(tree):
    from smalltts_tpu_torch.utils.checkpoint import map_pytree

    return map_pytree(lambda t: t.clone(), tree)


class _Finite:
    """Accumulates torch.isfinite of values on the device; `check` syncs once."""

    def __init__(self):
        self.ok = None

    def add(self, *values):
        import torch

        for v in values:
            f = torch.isfinite(v).all()
            self.ok = f if self.ok is None else self.ok & f

    def check(self, what: str):
        assert self.ok is None or bool(self.ok), f"{what}: a non-finite loss"


def corpus():
    """The 6 utterances: {"wav" (cut to whole hops), "text", "speaker", "tokens"}."""
    from smalltts_tpu_torch.data.synthetic import synth_speech

    hop = TINY_CODEC.hop
    utts = []
    for s in SPEAKERS:
        for text in TEXTS:
            wav = synth_speech(text, speaker=s, seed=0)
            wav = wav[: (len(wav) // hop) * hop]
            utts.append({"wav": wav, "text": text, "speaker": s, "tokens": _tokens(text)})
    return utts


def padded_batch(utts) -> dict:
    """One fixed padded batch holding the whole corpus (numpy): latents,
    their lengths, the first REF_FRAMES latent frames as the reference,
    phonemes and their lengths."""
    t_max = max(u["latents"].shape[0] for u in utts)
    p_max = max(len(u["tokens"]) for u in utts)
    b = len(utts)
    batch = {
        "latents": np.zeros((b, t_max, 64), np.float32),
        "latents_lengths": np.zeros((b,), np.int32),
        "ref_latents": np.zeros((b, REF_FRAMES, 64), np.float32),
        "ref_latents_lengths": np.full((b,), REF_FRAMES, np.int32),
        "phonemes": np.zeros((b, p_max), np.int32),
        "phonemes_lengths": np.zeros((b,), np.int32),
    }
    for i, u in enumerate(utts):
        T = u["latents"].shape[0]
        batch["latents"][i, :T] = u["latents"]
        batch["latents_lengths"][i] = T
        batch["ref_latents"][i] = u["latents"][:REF_FRAMES]
        batch["phonemes"][i, : len(u["tokens"])] = u["tokens"]
        batch["phonemes_lengths"][i] = len(u["tokens"])
    return batch


def batch_tensors(batch: dict, dev) -> dict:
    """The padded batch on `dev`: phonemes int64, lengths int32, latents fp32."""
    import torch

    return {k: torch.from_numpy(v).to(dev, torch.int64 if k == "phonemes" else None) for k, v in batch.items()}


def build_corpus_and_models(codec_steps: int = 300, teacher_steps: int = 800, device=None, codec_params=None):
    """Train the codec on fixed-length slices of every utterance, encode the
    corpus (each utterance's latents and its codec round trip, the floor),
    then train the teacher on the padded batch. `codec_params` replaces the
    codec's seeded init. -> (utts, codec params, batch (tensors on the
    device), teacher params, cfg, codec_cfg)."""
    import torch

    from smalltts_tpu_torch.models.backbone import init_backbone
    from smalltts_tpu_torch.models.codec import codec_decode, codec_encode, init_codec
    from smalltts_tpu_torch.train.codec_train import CodecTrainConfig, make_codec_step
    from smalltts_tpu_torch.train.ema import ema_init
    from smalltts_tpu_torch.train.optim import adamw
    from smalltts_tpu_torch.train.teacher import make_teacher_step, teacher_draws
    from smalltts_tpu_torch.utils.transfer import resolve_device

    dev = resolve_device(device)
    hop = TINY_CODEC.hop
    utts = corpus()

    # ---- codec: fixed-length slices of every utterance; optax.adamw's default weight decay (1e-4)
    slice_len = (min(len(u["wav"]) for u in utts) // hop) * hop
    aud = torch.from_numpy(np.stack([u["wav"][:slice_len] for u in utts])[:, None]).to(dev)
    cp = init_codec(_gen(dev, 0), TINY_CODEC, device=dev) if codec_params is None else codec_params
    tx_c = adamw(cp, 3e-4, weight_decay=1e-4, clip_norm=1.0)
    oc = tx_c.init(cp)
    step_c = make_codec_step(TINY_CODEC, CodecTrainConfig(lr=3e-4), tx_c)
    finite = _Finite()
    for _ in range(codec_steps):
        cp, oc, loss, _ = step_c(cp, oc, aud)
        finite.add(loss)
    finite.check("codec")

    with torch.no_grad():
        for u in utts:
            lat = codec_encode(cp, torch.from_numpy(u["wav"][None, None]).to(dev), TINY_CODEC)
            u["latents"] = lat[0].cpu().numpy()
            u["rec_floor"] = codec_decode(cp, lat, TINY_CODEC)[0, 0].cpu().numpy()
    batch = batch_tensors(padded_batch(utts), dev)

    # ---- teacher
    params = init_backbone(_gen(dev, 1), TINY_BACKBONE, device=dev)
    tx = adamw(params, 2e-3, clip_norm=1.0)
    o = tx.init(params)
    ema = ema_init(params)
    st = make_teacher_step(TINY_BACKBONE, tx)
    g = _gen(dev, 2)
    finite = _Finite()
    for _ in range(teacher_steps):
        params, o, ema, loss = st(params, o, ema, batch, teacher_draws(g, batch))
        finite.add(loss)
    finite.check("teacher")
    return utts, cp, batch, params, TINY_BACKBONE, TINY_CODEC


def train_dmd2(teacher, batch, cfg, steps: int = 150):
    """A short DMD2 run: the auxiliary losses (CTC, SV, GAN) are the
    reference's real-data refinements, noise from untrained models at this
    scale, so this keeps the distribution-matching core and the scorer."""
    from smalltts_tpu_torch.models.asr import init_asr
    from smalltts_tpu_torch.models.discriminator import init_discriminator
    from smalltts_tpu_torch.models.sv import init_sv
    from smalltts_tpu_torch.train.distill import (
        DistillConfig,
        make_scorer_step,
        make_student_step,
        scorer_draws,
        student_draws,
    )
    from smalltts_tpu_torch.train.optim import adamw

    dev = batch["latents"].device
    dc = DistillConfig(asr_start_step=10**9, sv_start_step=10**9, gan_weight=0.0, scorer_updates=2)
    g = _gen(dev, 3)
    student, scorer = _copy(teacher), _copy(teacher)
    asr = init_asr(g, TINY_ASR64, device=dev)
    sv = init_sv(g, TINY_SV64, device=dev)
    disc = init_discriminator(g, TINY_DISC, device=dev)
    tx_s = adamw(student, 5e-5, weight_decay=1e-4)
    tx_sc = adamw(scorer, 5e-5, weight_decay=1e-4)
    s_opt, sc_opt = tx_s.init(student), tx_sc.init(scorer)
    student_step = make_student_step(cfg, TINY_DISC, TINY_ASR64, TINY_SV64, tx_s, dc)
    scorer_step = make_scorer_step(cfg, tx_sc, dc.scorer_updates)
    finite = _Finite()
    for i in range(steps):
        student, s_opt, carry, metrics = student_step(student, s_opt, teacher, scorer, disc, asr, sv, batch, i,
                                                      student_draws(g, batch))
        scorer, sc_opt, sc_loss = scorer_step(scorer, sc_opt, student, batch, carry,
                                              scorer_draws(g, batch, dc.scorer_updates))
        finite.add(metrics["st_pseudo"], sc_loss)
    finite.check("dmd2")
    return student


def train_imf_student(teacher, batch, cfg, steps: int = 400, imf_cfg=None):
    """An IMF student from `teacher`: the base interval loss, with the
    adversarial (gan_weight) or DMD (dmd_weight) term where the config asks;
    clip 1.0 then AdamW 3e-4 on every leaf."""
    from smalltts_tpu_torch.models.discriminator import init_discriminator
    from smalltts_tpu_torch.train.distill import disc_draws
    from smalltts_tpu_torch.train.imf import (
        ImfConfig,
        imf_draws,
        imf_scorer_draws,
        init_imf_student,
        make_imf_adv_steps,
        make_imf_dmd_steps,
        make_imf_step,
    )
    from smalltts_tpu_torch.train.optim import adamw

    dev = batch["latents"].device
    imf_cfg = imf_cfg or ImfConfig(rollout_substeps=4)
    student = init_imf_student(teacher)
    tx = adamw(student, 3e-4, weight_decay=1e-4, clip_norm=1.0)
    opt = tx.init(student)
    g = _gen(dev, 4)
    finite = _Finite()
    if imf_cfg.dmd_weight > 0.0:
        scorer = _copy(teacher)
        tx_sc = adamw(scorer, 3e-4, weight_decay=1e-4, clip_norm=1.0)
        opt_sc = tx_sc.init(scorer)
        sstep, scstep = make_imf_dmd_steps(cfg, tx, tx_sc, imf_cfg)
        for _ in range(steps):
            student, opt, carry, m = sstep(student, opt, teacher, scorer, batch, imf_draws(g, batch, imf_cfg))
            scorer, opt_sc, sc_loss = scstep(scorer, opt_sc, batch, carry,
                                             imf_scorer_draws(g, batch, imf_cfg.dmd_scorer_updates))
            finite.add(m["imf_loss"], m["dmd_loss"], sc_loss)
    elif imf_cfg.gan_weight > 0.0:
        disc = init_discriminator(_gen(dev, 5), TINY_DISC, device=dev)
        tx_d = adamw(disc, 3e-4, weight_decay=1e-4, clip_norm=1.0)
        opt_d = tx_d.init(disc)
        sstep, dstep = make_imf_adv_steps(cfg, TINY_DISC, tx, tx_d, imf_cfg)
        for _ in range(steps):
            student, opt, carry, m = sstep(student, opt, teacher, disc, batch, imf_draws(g, batch, imf_cfg))
            disc, opt_d, d_loss = dstep(disc, opt_d, teacher, batch, carry, disc_draws(g, batch))
            finite.add(m["imf_loss"], d_loss)
    else:
        step = make_imf_step(cfg, tx, imf_cfg)
        for _ in range(steps):
            student, opt, loss = step(student, opt, teacher, batch, imf_draws(g, batch, imf_cfg))
            finite.add(loss)
    finite.check("imf")
    return student


def sv_embed_fn(device=None, sv_params=None):
    """Random-feature waveform ECAPA (TINY_SV_TEACHER, seed 7, or
    `sv_params`): wav (24 kHz) -> its unit-norm speaker embedding. It
    separates the synthetic speakers."""
    import torch

    from smalltts_tpu_torch.models.sv_teacher import init_sv_teacher, resample_24k_to_16k, sv_teacher_embed
    from smalltts_tpu_torch.utils.transfer import resolve_device

    dev = resolve_device(device)
    if sv_params is None:
        sv_params = init_sv_teacher(_gen(dev, 7), TINY_SV_TEACHER, device=dev)

    def embed(wav):
        a16 = resample_24k_to_16k(torch.from_numpy(np.asarray(wav, np.float32)[None, None, :]).to(dev))
        with torch.no_grad():
            e = sv_teacher_embed(sv_params, a16, cfg=TINY_SV_TEACHER)[0].cpu().numpy()
        return e / (np.linalg.norm(e) + 1e-9)

    return embed


def codec_floor(utts) -> float:
    """Mean mel distance of the codec's own round trip: the synthesis floor."""
    from smalltts_tpu_torch.utils.metrics import mel_distance

    return float(np.mean([mel_distance(u["wav"][: len(u["rec_floor"])], u["rec_floor"]) for u in utts]))


def evaluate(utts, cp, codec_cfg, embed, sample_fn):
    """sample_fn(i, T, gen) -> latents (1, T, 64) of utterance i, `gen` a
    torch.Generator seeded 100 + i; each decoded and scored against the
    ground truth -> (mean mel distance, mean speaker cosine)."""
    import torch

    from smalltts_tpu_torch.models.codec import codec_decode
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree
    from smalltts_tpu_torch.utils.metrics import mel_distance

    dev = next(iter(flatten_pytree(cp).values())).device
    mels, svs = [], []
    for i, u in enumerate(utts):
        T = u["latents"].shape[0]
        lat = torch.as_tensor(sample_fn(i, T, _gen(dev, 100 + i))).to(dev, torch.float32)
        with torch.no_grad():
            audio = codec_decode(cp, lat, codec_cfg)[0, 0].cpu().numpy()
        gt = u["wav"][: len(audio)]
        audio = audio[: len(gt)]
        mels.append(mel_distance(gt, audio))
        svs.append(float(embed(gt) @ embed(audio)))
    return float(np.mean(mels)), float(np.mean(svs))


class Samplers:
    """The harness's samplers over the padded batch: each a sample_fn for
    `evaluate`, its noise drawn from the generator it is given."""

    def __init__(self, batch, cfg):
        self.batch, self.cfg = batch, cfg
        self.t_max = int(batch["latents"].shape[1])
        self.dev = batch["latents"].device

    def cond(self, params, i):
        from smalltts_tpu_torch.models.backbone import encode_conditions
        from smalltts_tpu_torch.ops.masking import length_mask

        b = self.batch
        return encode_conditions(params, self.cfg, b["ref_latents"][i:i + 1], b["ref_latents_lengths"][i:i + 1],
                                 b["phonemes"][i:i + 1],
                                 length_mask(b["phonemes_lengths"][i:i + 1], b["phonemes"].shape[1]))

    def _noise(self, n, gen):
        import torch

        return torch.randn((n, 1, self.t_max, self.cfg.latent_dim), generator=gen, device=self.dev)

    def _len(self, T):
        import torch

        return torch.full((1,), T, dtype=torch.int32, device=self.dev)

    def dmd4(self, params):
        """The 4-step serving recurrence on `params` (gated by r_gate where the params carry it)."""
        import torch

        from smalltts_tpu_torch.infer.sampler import _sample_loop

        def fn(i, T, gen):
            with torch.no_grad():
                return _sample_loop(params, self.cfg, self.cond(params, i), self._len(T), self.t_max, 4,
                                    self._noise(4, gen))[:, :T]

        return fn

    def imf(self, student, k):
        """IMF-k from one start noise."""
        import torch

        from smalltts_tpu_torch.train.imf import imf_sample

        def fn(i, T, gen):
            with torch.no_grad():
                return imf_sample(student, self.cfg, self.cond(student, i), self._len(T), self.t_max,
                                  self._noise(1, gen)[0], num_steps=k)[:, :T]

        return fn

    def teacher(self, params, num_steps=32):
        """The many-step teacher sampler, CFG scales 1."""
        import torch

        from smalltts_tpu_torch.infer.teacher_sampler import make_teacher_sampler

        sampler = make_teacher_sampler(self.cfg, num_steps=num_steps, cfg_scale_text=1.0, cfg_scale_speaker=1.0)
        b = self.batch

        def fn(i, T, gen):
            with torch.no_grad():
                return sampler(params, b["ref_latents"][i:i + 1], b["ref_latents_lengths"][i:i + 1],
                               b["phonemes"][i:i + 1], b["phonemes_lengths"][i:i + 1], self._len(T),
                               self._noise(num_steps, gen), self.t_max)[:, :T]

        return fn


def quality_on_corpus(device=None, codec_steps: int = 300, teacher_steps: int = 800, dmd_steps: int = 150,
                      imf_steps: int = 400):
    """The corpus comparison: teacher 32- and 4-step, the DMD2 student's
    4-step, the IMF student on the DMD-4 recurrence, IMF-2 and IMF-1.
    Prints the floor and each result -> (results {name: (mel, sv)}, floor)."""
    utts, cp, batch, teacher, cfg, codec_cfg = build_corpus_and_models(codec_steps, teacher_steps, device)
    dmd_student = train_dmd2(teacher, batch, cfg, steps=dmd_steps)
    imf_student = train_imf_student(teacher, batch, cfg, steps=imf_steps)
    embed = sv_embed_fn(batch["latents"].device)
    s = Samplers(batch, cfg)
    results = {
        "teacher_32": evaluate(utts, cp, codec_cfg, embed, s.teacher(teacher)),
        "teacher_4": evaluate(utts, cp, codec_cfg, embed, s.dmd4(teacher)),
        "dmd_student_4": evaluate(utts, cp, codec_cfg, embed, s.dmd4(dmd_student)),
        "imf_under_dmd4": evaluate(utts, cp, codec_cfg, embed, s.dmd4(imf_student)),
        "imf_2": evaluate(utts, cp, codec_cfg, embed, s.imf(imf_student, 2)),
        "imf_1": evaluate(utts, cp, codec_cfg, embed, s.imf(imf_student, 1)),
    }
    floor = codec_floor(utts)
    print(f"\ncodec floor mel={floor:.3f}")
    for name, (mel, sv) in results.items():
        print(f"{name}: mel={mel:.3f} sv={sv:.3f}")
    return results, floor


def main(argv=None) -> int:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description="the synthetic-corpus quality comparison of the training chain")
    ap.add_argument("--codec-steps", type=int, default=300)
    ap.add_argument("--teacher-steps", type=int, default=800)
    ap.add_argument("--dmd-steps", type=int, default=150)
    ap.add_argument("--imf-steps", type=int, default=400)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    results, floor = quality_on_corpus(args.device, args.codec_steps, args.teacher_steps, args.dmd_steps,
                                       args.imf_steps)
    print(json.dumps({"floor": floor, **{k: {"mel": m, "excess": m - floor, "sv": sv} for k, (m, sv) in
                                         results.items()}, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

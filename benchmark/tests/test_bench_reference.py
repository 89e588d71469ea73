"""The plain reference against smalltts_tpu_torch at tiny widths on the CPU
(both in float32), and the FLOP functions against FlopCounterMode on the
reference. The tests may import the program; the reference may not."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import flops as F
from reference import model as ref
from tiny import TINY_MODEL

M = ref.model_cfg(TINY_MODEL)


def _weights(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ref.make_params(ref.backbone_shapes(M), g, torch.float32, "cpu"), \
        ref.make_params(ref.codec_decoder_shapes(M), g, torch.float32, "cpu")


def _program_cfgs():
    from harness.serve import program_configs

    return program_configs(TINY_MODEL)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_param_shapes_are_the_programs_layout():
    from smalltts_tpu_torch.models.backbone import init_backbone
    from smalltts_tpu_torch.models.codec import init_codec
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree

    bcfg, ccfg = _program_cfgs()
    prog = flatten_pytree(init_backbone(torch.Generator().manual_seed(0), bcfg))
    mine = {p: s for p, s, _ in ref.backbone_shapes(M)}
    assert {k: tuple(v.shape) for k, v in prog.items()} == mine
    codec = {k: tuple(v.shape) for k, v in flatten_pytree(init_codec(torch.Generator().manual_seed(0), ccfg)).items()
             if k.startswith("dec")}
    assert codec == {p: s for p, s, _ in ref.codec_decoder_shapes(M)}


def test_synthesis_matches_the_program_in_float32():
    """Conditioning, the 4-step DMD loop and the codec decode, float32 on
    both sides: equal to rounding."""
    from smalltts_tpu_torch.infer.pipeline import SmallTTS

    w, c = _weights()
    bcfg, ccfg = _program_cfgs()
    tts = SmallTTS(ref.nest(w), ref.nest(c), cfg=bcfg, codec_cfg=ccfg, codec="native", dtype=torch.float32,
                   device="cpu")
    r = np.random.default_rng(0)
    b, rb, pb, tb = 3, 64, 128, 40
    refs = r.standard_normal((b, rb, 64)).astype(np.float32)
    rl = np.array([64, 23, 40], np.int32)
    for i, n in enumerate(rl):
        refs[i, n:] = 0
    pl = np.array([100, 7, 128], np.int32)
    ph = np.zeros((b, pb), np.int32)
    for i, n in enumerate(pl):
        ph[i, :n] = r.integers(1, 198, n)
    sl = np.array([40, 15, 33], np.int32)
    noise = torch.randn((4, b, tb, 64), generator=torch.Generator().manual_seed(1))
    got = tts.synthesize_padded(refs, rl, ph, pl, sl, tb, noises=noise)[:, 0]
    t = torch.as_tensor
    with torch.no_grad():
        lat = ref.sample_latents(ref.nest(w), M, t(refs), t(rl).long(), t(ph).long(), t(pl).long(), t(sl).long(), tb,
                                 noise, ref.Prec(torch.float32))
        want = ref.codec_decode(ref.nest(c), M, lat).numpy()
    for i in range(b):
        n = sl[i] * M.hop
        assert _rel(got[i, :n], want[i, :n]) < 1e-4


def test_teacher_loss_and_gradients_match_the_program_in_float32():
    from smalltts_tpu_torch.train.teacher import TeacherTrainConfig, teacher_loss
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, unflatten_pytree

    from harness.train import make_batch
    from tiny import tiny_cell

    cell = tiny_cell("train-teacher-b96")
    w, _ = _weights(3)
    batch, draws, _ = make_batch(cell.traffic, 5, 0, 64, 198, torch.device("cpu"))
    bcfg, _ = _program_cfgs()
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss = teacher_loss(unflatten_pytree(leaves), bcfg, batch, draws, TeacherTrainConfig(compute_dtype="float32"))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)))
    ref_w = {k: v.clone() for k, v in w.items()}
    new, _, rloss, rgrads = ref.teacher_step(ref_w, ref.adam_init(ref_w), batch, draws, M, ref.Prec(torch.float32),
                                             rows_per_block=3, clip=math.inf)
    assert float(rloss) == pytest.approx(float(loss.detach()), rel=1e-5)
    for k, g in grads.items():
        g = torch.zeros_like(w[k]) if g is None else g
        denom = max(float(torch.linalg.vector_norm(g)), 1e-6)
        assert float(torch.linalg.vector_norm(g - rgrads[k])) / denom < 1e-3, k
    assert flatten_pytree(ref.nest(new)).keys() == w.keys()


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flop_functions_match_flopcounter_on_the_reference():
    w, c = _weights()
    p = ref.nest(w)
    P = ref.Prec(torch.float32)
    r, ph, t = 23, 17, 30
    lat = torch.randn(1, r, 64)
    ids = torch.randint(1, 198, (1, ph))
    with torch.no_grad():
        assert _count(lambda: ref.style_encoder(p["style_encoder"], M, lat, torch.tensor([r]), P)) == F.style_flops(M, r)
        full = torch.ones(1, ph, dtype=torch.bool)
        assert _count(lambda: ref.text_encoder(p["phoneme_embedding"], M, ids, full, P)) == F.text_flops(M, ph)
        seq, _ = ref.style_encoder(p["style_encoder"], M, lat, torch.tensor([r]), P)
        emb = ref.text_encoder(p["phoneme_embedding"], M, ids, full, P)
        assert _count(lambda: ref.cross_kv(p["dit"], M, seq, emb, full, P)) == F.cross_kv_flops(M, r, ph)
        kv = ref.cross_kv(p["dit"], M, seq, emb, full, P)
        x = torch.randn(1, t, 64)
        te = ref.time_embedding(p["time_embedding"], torch.tensor([0.5]), M.time_embed_dim)
        n = _count(lambda: ref.velocity(p, M, x, torch.ones(1, t, dtype=torch.bool), te, kv,
                                        torch.ones(1, r + ph, dtype=torch.bool), P))
        assert n == F.dit_eval_flops(M, t, r + ph) + F.conditioning_flops(M)
        assert _count(lambda: ref.codec_decode(ref.nest(c), M, torch.randn(1, t, 64))) == F.codec_decode_flops(M, t)
    assert F.teacher_row_flops(M, r, ph, t) == 3 * (F.style_flops(M, r) + F.text_flops(M, ph) + F.cross_kv_flops(M, r, ph)
                                                    + F.dit_eval_flops(M, t, r + ph) + F.conditioning_flops(M))


def test_batch_launches_count_the_programs_kernels():
    """One served batch launches 12 style, 8 text and 48 DiT attention
    kernels, 8 scan kernels a layer and step, and one kernel per codec
    convolution: the published model's counts."""
    full = ref.model_cfg({**TINY_MODEL, "dit": {**TINY_MODEL["dit"], "n_blocks": 12},
                          "text": {**TINY_MODEL["text"], "num_layers": 8}, "style": {**TINY_MODEL["style"], "num_layers": 12}})
    l = F.batch_launches(full, 8, 64, 128, 40, [30] * 8, [50] * 8, [38] * 8)
    assert len(l["attention"]) == 12 + 8 + 48
    assert len(l["scan"]) == 7 * 48  # attention is counted in its own class
    assert len(l["codec_conv"]) == 27
    f, b = l["scan"][1]
    assert f == 2 * 8 * 40 * 64 * 256  # qkvg: M x H x 4H

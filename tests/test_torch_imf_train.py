"""The port's IMF trainer (smalltts_tpu_torch/train/imf.py) and its cached
DiT on the split layout (models/dit.dit_forward_cached) against the JAX
package, on the CPU, with the tiny backbone of tests/tiny.py, a tiny
discriminator, the same weights (JAX inits carried across by
params_from_jax, the backbones' zero-init leaves re-drawn) and the same
numpy batches. Random draws are JAX's (its key splits replicated here)
passed into the port.

Tolerances (tests/test_torch_distill.py's): fp32 outputs, targets and
losses 1e-5 relative to the largest value; gradients 1e-4 rel-L2 per leaf
(of jax.grad, or of the first AdamW step's first moment, which is 0.1 x
the clipped gradient); params after two AdamW steps 1e-6 rel-L2 per leaf,
the moments 1e-4 (they hold the gradients), a leaf that starts at zero
(r_gate, biases: the updates alone) 1e-4; bf16 outputs and losses 2e-2,
gradients 1e-1 rel-L2; the bf16 teacher's rollout (float32 activations
over bf16 weights in both packages) 5e-3.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu.data import dummy as JDD  # noqa: E402
from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS  # noqa: E402
from smalltts_tpu.models import backbone as JBK  # noqa: E402
from smalltts_tpu.models import conformer as JC  # noqa: E402
from smalltts_tpu.models import discriminator as JDi  # noqa: E402
from smalltts_tpu.models.codec import init_codec as j_init_codec  # noqa: E402
from smalltts_tpu.ops.masking import length_mask as j_length_mask  # noqa: E402
from smalltts_tpu.train import imf as JI  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils.config_io import backbone_meta  # noqa: E402
from smalltts_tpu_torch.infer.pipeline import SmallTTS  # noqa: E402
from smalltts_tpu_torch.models import backbone as PBK  # noqa: E402
from smalltts_tpu_torch.models import conformer as PC  # noqa: E402
from smalltts_tpu_torch.models import discriminator as PDi  # noqa: E402
from smalltts_tpu_torch.models.dit import fuse_serving_projections  # noqa: E402
from smalltts_tpu_torch.ops.masking import length_mask  # noqa: E402
from smalltts_tpu_torch.ops.precision import cast_floats  # noqa: E402
from smalltts_tpu_torch.train import imf as PI  # noqa: E402
from smalltts_tpu_torch.train.optim import value_and_grad  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax  # noqa: E402
from smalltts_tpu_torch.utils.torch_convert import backbone_state_dict  # noqa: E402

T = torch.from_numpy
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
J_DISC = JDi.DiscriminatorConfig(
    latent_dim=64, transformer_dim=TINY_BACKBONE.hidden_dim, ref_dim=TINY_BACKBONE.hidden_dim, model_dim=32,
    num_tail_layers=2, conformer=JC.ConformerConfig(input_dim=32, num_heads=4, ffn_dim=64, num_layers=2,
                                                    depthwise_conv_kernel_size=7, use_group_norm=True))
P_DISC = PDi.DiscriminatorConfig(**{**{f.name: getattr(J_DISC, f.name) for f in dataclasses.fields(J_DISC)},
                                    "conformer": PC.ConformerConfig(**dataclasses.asdict(J_DISC.conformer))})
DATA = dict(max_phonemes=10, min_phonemes=4, max_latents=16, min_latents=8, max_ref=8, min_ref=4)
# the JAX train_imf's frozen names (imf.py:610), written out: the port's IMF_FROZEN must equal them
J_FROZEN = ("style_encoder", "phoneme_embedding", "kv_ref", "kv_text", "k_norm_cross")


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def flat_j(tree):
    """{path: float32 array} of a JAX tree, optax's MaskedNode leaves left out."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(k.key) if hasattr(k, "key") else f"#{k.idx}" for k in path)
        out[name.replace("/#", "#")] = np.asarray(leaf, np.float32)  # pckpt.flatten_pytree's names
    return out


def flat_p(tree, cfg=None):
    return {k: to_np(v) for k, v in pckpt.flatten_pytree(params_to_jax(tree, cfg)).items()}


def compare_trees(port_tree, jax_tree, tol, what, cfg=None, start=None):
    """Every leaf JAX has within `tol` rel-L2, but a leaf that is zero in
    the tree `start` within 1e-4: after AdamW steps it holds the updates
    alone, which differ from optax's by up to 2e-5 relative (XLA's CPU pow
    of b2^count is an ulp off torch's; tests/test_torch_asr_sv_train.py's
    zero-init leaves likewise), and by 9e-5 in the conformer's in_proj bias,
    whose key third's gradient is rounding that Adam normalizes; every
    leaf's first gradient is held at 1e-4 beside. Returns the port's leaves
    JAX has not."""
    got, want = flat_p(port_tree, cfg), flat_j(jax_tree)
    assert set(want) <= set(got), set(want) - set(got)
    zero = {k for k, v in flat_j(start).items() if not v.any()} if start is not None else set()
    over = {k: rel_l2(got[k], want[k]) / (1e-4 if k in zero else tol) for k in want}
    worst = max(over, key=over.get)
    assert over[worst] <= 1.0, f"{what}: {worst} rel-L2 {rel_l2(got[worst], want[worst]):.3e}"
    return {k: v for k, v in got.items() if k not in want}


def redraw(params, seed):
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: x, params)
    for lin in (params["dit"]["blocks"]["attn_norm"]["linear"], params["dit"]["norm_out"]["linear"],
                params["velocity"]):
        for k in lin:
            lin[k] = jnp.asarray((0.2 if k == "w" else 0.5) * rs.randn(*lin[k].shape), jnp.float32)
    return params


def to_port(tree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg)


def copy_j(tree):
    return jax.tree.map(jnp.copy, tree)


@pytest.fixture(scope="module")
def nets():
    """JAX trees and their port counterparts: teacher, scorer, disc, and a
    student whose r_gate is drawn from N(0, 0.1)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    teacher = jax.jit(JBK.init_backbone, static_argnums=1)(ks[0], TINY_BACKBONE)
    j = {"teacher": redraw(teacher, 0), "scorer": redraw(teacher, 1), "disc": JDi.init_discriminator(ks[1], J_DISC)}
    j["gated"] = JI.init_imf_student(j["teacher"])
    j["gated"]["r_gate"] = jnp.asarray(0.1 * np.random.RandomState(5).randn(TINY_BACKBONE.hidden_dim), jnp.float32)
    cfgs = {"teacher": PCFG, "scorer": PCFG, "gated": PCFG, "disc": P_DISC}
    return j, {k: to_port(v, cfgs[k]) for k, v in j.items()}


def np_batch(seed=0, b=2):
    cfg = JDD.DummyDataConfig(batch_size=b, **DATA)
    return {k: v for k, v in JDD.dummy_batch(np.random.default_rng(seed), cfg).items() if k != "texts"}


def port(d):
    return {k: T(np.array(v)) for k, v in d.items()}


def conditions(jp, pp, batch):
    ph_len = batch["phonemes_lengths"]
    jc = JBK.encode_conditions(jp, TINY_BACKBONE, batch["ref_latents"], batch["ref_latents_lengths"],
                               batch["phonemes"], j_length_mask(ph_len, batch["phonemes"].shape[1]))
    pb = port(batch)
    pc = PBK.encode_conditions(pp, PCFG, pb["ref_latents"], pb["ref_latents_lengths"], pb["phonemes"],
                               length_mask(pb["phonemes_lengths"], batch["phonemes"].shape[1]))
    return jc, pc


def j_target_draws(key, shape, tc):
    """_interval_targets' draws from `key` (imf.py:186-221)."""
    b = shape[0]
    k_t, k_r, k_eps, k_b, k_f, k_fi = jax.random.split(key, 6)
    t = jax.random.uniform(k_t, (b,), minval=tc.t_floor + tc.min_interval, maxval=1.0)
    return {"t": t, "r": jax.random.uniform(k_r, (b,), minval=tc.t_floor, maxval=t - tc.min_interval),
            "eps": jax.random.normal(k_eps, shape), "boundary": jax.random.bernoulli(k_b, tc.boundary_prob, (b,)),
            "focus": jax.random.bernoulli(k_f, tc.focus_prob, (b,)),
            "idx": jax.random.randint(k_fi, (b,), 0, tc.focus_num_steps),
            "roll": jax.random.bernoulli(jax.random.fold_in(key, 7), tc.rollin_prob, (b,)),
            "x1_rollin": jax.random.normal(jax.random.fold_in(key, 8), shape)}


def j_step_draws(variant, key, shape, tc):
    """A student step's draws: the targets', then the adversarial step's ts
    and noise (imf.py:306-316) or the DMD step's x1, ts and noise (:437-450)."""
    if variant == "plain":
        return j_target_draws(key, shape, tc)
    if variant == "adv":
        k_tgt, k_ts, k_noise = jax.random.split(key, 3)
        extra = {}
    else:
        k_tgt, k_x1, k_ts, k_noise = jax.random.split(key, 4)
        extra = {"x1": jax.random.normal(k_x1, shape)}
    return {**j_target_draws(k_tgt, shape, tc), **extra, "ts": jax.random.uniform(k_ts, (shape[0],)),
            "noise": jax.random.normal(k_noise, shape)}


def j_scorer_draws(key, shape, n):
    ts, noise = [], []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(k1, (shape[0],))))
        noise.append(np.asarray(jax.random.normal(k2, shape)))
    return {"ts": np.stack(ts), "noise": np.stack(noise)}


def port_draws(d):
    return {k: T(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_layout_denoise_step_and_gradient_match_jax(nets, dtype):
    """The cached denoiser on an init_backbone (split) tree, which
    fused_dit_scan refused: denoise_step on the teacher and imf_velocity on
    the gated student against JAX's, and the gradient of a weighted sum of
    u with respect to every student leaf (the conditioning computed
    outside, so the frozen leaves get exactly zero)."""
    j, p = nets
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    cast_j = lambda tree: {**jax.tree.map(lambda a: a.astype(jd), tree), "r_gate": tree["r_gate"]}  # noqa: E731
    jt, jg = jax.tree.map(lambda a: a.astype(jd), j["teacher"]), cast_j(j["gated"])
    pt, pg = cast_floats(p["teacher"], td), {**cast_floats(p["gated"], td), "r_gate": p["gated"]["r_gate"]}
    assert "qkv_self" in pt["dit"]["blocks"]["attn"] and "qkvg" not in pt["dit"]["blocks"]["attn"]
    batch = np_batch(1)
    jc, pc = conditions(jg, pg, batch)
    rs = np.random.RandomState(2)
    x, w = (rs.randn(*batch["latents"].shape).astype(np.float32) for _ in range(2))
    t, r = np.array([0.7, 0.3], np.float32), np.array([0.2, 0.05], np.float32)
    jm = j_length_mask(batch["latents_lengths"], x.shape[1])
    pm = length_mask(T(batch["latents_lengths"]), x.shape[1])
    tol, grad_tol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 1e-1)
    want = jax.jit(JBK.denoise_step, static_argnums=1)(jt, TINY_BACKBONE, x, jm, t, jc)
    got = PBK.denoise_step(pt, PCFG, T(x), pm, T(t), pc)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"  # float32 x_t: float32 activations
    assert rel(to_np(got), want) <= tol and float(np.abs(np.asarray(want)).max()) > 1e-2

    def j_loss(params):
        return (JI.imf_velocity(params, TINY_BACKBONE, x, jm, t, r, jc).astype(jnp.float32) * w).sum()

    want_l, want_g = jax.jit(jax.value_and_grad(j_loss))(jg)
    got_l, _, got_g = value_and_grad(
        pg, lambda q: ((PI.imf_velocity(q, PCFG, T(x), pm, T(t), T(r), pc).float() * T(w)).sum(), None))
    assert abs(float(got_l) - float(want_l)) <= tol * abs(float(want_l))
    gj, gp = flat_j(want_g), flat_p(got_g)
    errs = {k: rel_l2(gp[k], gj[k]) for k in gj if np.abs(gj[k]).max() > 0}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= grad_tol, f"{worst}: gradient rel-L2 {errs[worst]:.3e}"
    frozen = [k for k in gp if set(k.split("/")) & set(J_FROZEN)]
    assert frozen and all(not gp[k].any() and not gj[k].any() for k in frozen)
    assert "r_gate" in errs


@pytest.mark.parametrize("layout,dtype", [("split", "float32"), ("split", "bfloat16"), ("fused", "float32")])
def test_teacher_rollout_matches_jax(nets, layout, dtype):
    """teacher_rollout (4 substeps) on the split teacher, and on its fused
    serving copy (the scan's plain versions on the CPU), against JAX's on
    the split tree: float32 activations over the params in both packages;
    1e-5, and in bf16 5e-3, where the conditioning (the encoders' bf16
    activations, their sums in another order) differs by up to 1.3e-3."""
    j, p = nets
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jt, pt = jax.tree.map(lambda a: a.astype(jd), j["teacher"]), cast_floats(p["teacher"], td)
    if layout == "fused":
        pt = fuse_serving_projections(pt)
        assert "qkvg" in pt["dit"]["blocks"]["attn"] and "w13" in pt["dit"]["blocks"]["ff"]
    batch = np_batch(2)
    jc, pc = conditions(jt, cast_floats(p["teacher"], td), batch)
    x = np.random.RandomState(3).randn(*batch["latents"].shape).astype(np.float32)
    t, r = np.array([0.9, 0.6], np.float32), np.array([0.3, 0.02], np.float32)
    jm = j_length_mask(batch["latents_lengths"], x.shape[1])
    want = JI.teacher_rollout(jt, TINY_BACKBONE, x, jm, t, r, jc, 4)
    got = PI.teacher_rollout(pt, PCFG, T(x), length_mask(T(batch["latents_lengths"]), x.shape[1]), T(t), T(r), pc, 4)
    assert got.dtype == torch.float32
    assert rel(to_np(got), want) <= (1e-5 if dtype == "float32" else 5e-3)


@pytest.mark.parametrize("case", ["focus", "rollin", "boundary"])
def test_interval_targets_match_jax(nets, case):
    """_interval_targets with focus (every sample on the serving grid),
    roll-in or the boundary pair on at probability 0.5 (the key chosen so
    that both outcomes occur in the batch of 4), 2 substeps, the gated
    student: x_t, t, r_eff, u_target 1e-5."""
    j, p = nets
    tc = JI.ImfConfig(rollout_substeps=2, focus_prob=1.0 if case == "focus" else 0.0,
                      rollin_prob=0.5 if case == "rollin" else 0.0, boundary_prob=0.5 if case == "boundary" else 0.0)
    ptc = PI.ImfConfig(**dataclasses.asdict(tc))
    batch = np_batch(5, b=4)
    key = jax.random.PRNGKey(1 if case == "rollin" else 0)
    draws = j_target_draws(key, batch["latents"].shape, tc)
    bits = {"focus": draws["idx"], "rollin": draws["roll"], "boundary": draws["boundary"]}[case]
    assert len(set(np.asarray(bits).tolist())) == 2, bits
    want = jax.jit(JI._interval_targets, static_argnums=(0, 1))(
        TINY_BACKBONE, tc, j["gated"], j["teacher"], jax.tree.map(jnp.asarray, batch), key)
    got = PI._interval_targets(PCFG, ptc, p["gated"], p["teacher"], port(batch), port_draws(draws))
    for k in ("x_t", "t", "r_eff", "u_target"):
        assert rel(to_np(got[k]), want[k]) <= 1e-5, k
    assert np.array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert not any(v.requires_grad for v in (got["u_target"], got["cond"].cross_k))


def j_student_tx(student, tc):
    """The JAX train_imf's student optimizer (imf.py:613-623)."""
    def trained(path, _):
        return not {str(getattr(q, "key", getattr(q, "idx", ""))) for q in path} & set(J_FROZEN)

    return optax.masked(optax.chain(optax.clip_by_global_norm(tc.grad_clip), optax.adamw(tc.lr)),
                        jax.tree_util.tree_map_with_path(trained, student))


def j_aux_tx(tc):
    return optax.chain(optax.clip_by_global_norm(tc.grad_clip), optax.adamw(tc.lr))


VARIANTS = {"plain": {}, "adv": {"gan_weight": 1.0}, "dmd": {"dmd_weight": 1.0}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_steps_match_jax(nets, variant, monkeypatch):
    """Two steps of make_imf_step, make_imf_adv_steps (with its disc step)
    or make_imf_dmd_steps (with its scorer step, 2 updates) from the
    teacher, with JAX's draws and optimizers (student: optax.masked over
    clip and adamw; disc and scorer: clip and adamw): the metrics and the
    carry 1e-5 each step; the first step's first moments (the gradients)
    1e-4; after both steps params 1e-6, moments 1e-4, the count 2. The GAN
    and DMD weights are 1.0 so that their gradients are not lost in the
    base loss's. The frozen leaves end bit-equal to the teacher's with zero
    moments. In the DMD step the composition's first interval runs without
    grad and its last with grad."""
    j, p = nets
    tc = JI.ImfConfig(rollout_substeps=2, **VARIANTS[variant])
    ptc = PI.ImfConfig(**dataclasses.asdict(tc))
    assert PI.IMF_FROZEN == J_FROZEN
    js, ps = JI.init_imf_student(j["teacher"]), PI.init_imf_student(p["teacher"])
    jtx, ptx = j_student_tx(js, tc), PI.imf_optimizer(ps, ptc, PI.IMF_FROZEN)
    jopt, popt = jtx.init(js), ptx.init(ps)
    aux_name = {"adv": "disc", "dmd": "scorer"}.get(variant)
    if aux_name:
        jaux, paux = copy_j(j[aux_name]), p[aux_name]
        jatx, patx = j_aux_tx(tc), PI.imf_optimizer(paux, ptc)
        jaopt, paopt = jatx.init(jaux), patx.init(paux)
    if variant == "plain":
        jstep, pstep = JI.make_imf_step(TINY_BACKBONE, jtx, tc), PI.make_imf_step(PCFG, ptx, ptc)
    elif variant == "adv":
        jstep, jaux_step = JI.make_imf_adv_steps(TINY_BACKBONE, J_DISC, jtx, jatx, tc)
        pstep, paux_step = PI.make_imf_adv_steps(PCFG, P_DISC, ptx, patx, ptc)
    else:
        jstep, jaux_step = JI.make_imf_dmd_steps(TINY_BACKBONE, jtx, jatx, tc)
        pstep, paux_step = PI.make_imf_dmd_steps(PCFG, ptx, patx, ptc)
        calls = []

        def recording(*a, _fn=PI.imf_velocity):
            out = _fn(*a)
            calls.append(out.requires_grad)
            return out
        monkeypatch.setattr(PI, "imf_velocity", recording)
    aux_cfg = P_DISC if variant == "adv" else None
    for i in range(2):
        batch = np_batch(10 + i)
        shape = batch["latents"].shape
        key, k_aux = jax.random.split(jax.random.PRNGKey(20 + i))
        draws = port_draws(j_step_draws(variant, key, shape, tc))
        bj, bp = jax.tree.map(jnp.asarray, batch), port(batch)
        if variant == "plain":
            js, jopt, jl = jstep(js, jopt, j["teacher"], bj, key)
            ps, popt, pl = pstep(ps, popt, p["teacher"], bp, draws)
            jm, pm = {"imf_loss": jl}, {"imf_loss": pl}
        else:
            js, jopt, jcarry, jm = jstep(js, jopt, j["teacher"], jaux, bj, key)
            calls.clear() if variant == "dmd" else None
            ps, popt, pcarry, pm = pstep(ps, popt, p["teacher"], paux, bp, draws)
            if variant == "dmd":  # base loss, composition's first interval (no grad), its last (grad)
                assert calls == [True, False, True], calls
            assert set(pcarry) == set(jcarry)
            for k in jcarry:
                assert rel(to_np(pcarry[k]), jcarry[k]) <= 1e-5, k
            if variant == "adv":
                jaux, jaopt, jal = jaux_step(jaux, jaopt, j["teacher"], bj, jcarry, k_aux)
                paux, paopt, pal = paux_step(paux, paopt, p["teacher"], bp, pcarry,
                                             {"noise": T(np.array(jax.random.normal(k_aux, shape)))})
            else:
                jaux, jaopt, jal = jaux_step(jaux, jaopt, bj, jcarry, k_aux)
                paux, paopt, pal = paux_step(paux, paopt, bp, pcarry, port_draws(j_scorer_draws(k_aux, shape, 2)))
            jm, pm = {**jm, "aux_loss": jal}, {**pm, "aux_loss": pal}
        assert set(pm) == set(jm)
        for k in jm:
            assert rel(to_np(pm[k]), jm[k]) <= 1e-5, (k, float(pm[k]), float(jm[k]))
        adam = jopt.inner_state[1][0]
        if i == 0:  # mu = 0.1 x the clipped gradient
            compare_trees(popt["mu"], adam.mu, 1e-4, f"{variant} student gradients")
            if aux_name:
                compare_trees(paopt["mu"], jaopt[1][0].mu, 1e-4, f"{aux_name} gradients", aux_cfg)
    assert int(popt["count"]) == int(adam.count) == 2
    compare_trees(ps, js, 1e-6, f"{variant} student after 2 AdamW steps", start=JI.init_imf_student(j["teacher"]))
    for m in ("mu", "nu"):
        frozen = compare_trees(popt[m], getattr(adam, m), 1e-4, f"{variant} student {m}")
        assert frozen and all(set(k.split("/")) & set(J_FROZEN) for k in frozen)
        assert not any(v.any() for v in frozen.values())
    teacher = pckpt.flatten_pytree(p["teacher"])
    frozen_leaves = [k for k in teacher if set(k.split("/")) & set(J_FROZEN)]
    assert frozen_leaves and all(torch.equal(pckpt.flatten_pytree(ps)[k], teacher[k]) for k in frozen_leaves)
    if aux_name:
        compare_trees(paux, jaux, 1e-6, f"{aux_name} after 2 AdamW steps", aux_cfg, start=j[aux_name])
        assert int(paopt["count"]) == (2 if variant == "adv" else 4)


def serve_batch():
    rs = np.random.RandomState(6)
    return (rs.randn(2, 16, 64).astype(np.float32), np.array([16, 9], np.int32),
            rs.randint(1, 198, size=(2, 24)).astype(np.int32), np.array([24, 13], np.int32),
            np.array([16, 11], np.int32))


def test_train_imf_saves_a_student_both_packages_serve(nets, tmp_path, capsys):
    """train_imf, 3 steps on the CPU from the teacher (a save at step 2,
    after the last update): the student npz carries r_gate and the backbone
    config, equals the returned student, and loads in the JAX SmallTTS and
    the port's, which both choose IMF-2 and serve equal latents (fp32,
    1e-5) on the same noise."""
    j, p = nets
    batches = iter([np_batch(30 + i) for i in range(3)])
    student, loss = PI.train_imf(PI.ImfConfig(num_steps=3, save_every=2, rollout_substeps=2), PCFG,
                                 checkpoint_dir=str(tmp_path), data_iter=batches, teacher_params=p["teacher"],
                                 device="cpu", log_every=1)
    assert np.isfinite(loss) and capsys.readouterr().out.count("imf_loss=") == 3
    path = str(tmp_path / "imf_student_latest.npz")
    back = pckpt.flatten_pytree(params_from_jax(pckpt.load_pytree(path), PCFG))
    assert all(torch.equal(back[k], v) for k, v in pckpt.flatten_pytree(student).items())
    assert float(student["r_gate"].abs().max()) > 0
    jc = jax.jit(j_init_codec, static_argnums=1)(jax.random.PRNGKey(1), TINY_CODEC)
    jtts = JSmallTTS(codec_params=jc, checkpoint=path, codec_cfg=TINY_CODEC, codec="native")
    ptts = SmallTTS(codec_params=to_port(jc, codec_config_from_dict(dataclasses.asdict(TINY_CODEC))),
                    checkpoint=path, codec_cfg=codec_config_from_dict(dataclasses.asdict(TINY_CODEC)), device="cpu")
    assert jtts.sampler == ptts.sampler == "imf" and jtts.num_steps == ptts.num_steps == 2
    ref, ref_len, ph, ph_len, seq = serve_batch()
    jcond = jax.jit(JBK.encode_conditions, static_argnums=1)(jtts.params, TINY_BACKBONE, ref, ref_len, ph,
                                                             j_length_mask(ph_len, ph.shape[1]))
    pcond = PBK.encode_conditions(ptts.params, PCFG, T(ref), T(ref_len), T(ph).long(),
                                  length_mask(T(ph_len), ph.shape[1]))
    key = jax.random.PRNGKey(7)
    want = jax.jit(JI.imf_sample, static_argnums=(1, 4, 6))(jtts.params, TINY_BACKBONE, jcond, jnp.asarray(seq), 16,
                                                           key, 2)
    noise = np.asarray(jax.random.normal(key, (2, 16, 64), jnp.float32))
    got = PI.imf_sample(ptts.params, PCFG, pcond, T(seq), 16, T(noise.copy()), 2)
    assert rel(got.numpy(), want) <= 1e-5 and float(np.abs(np.asarray(want)).max()) > 1e-2


@pytest.mark.parametrize("variant", ["adv", "dmd"])
def test_train_imf_variants_save_jax_sidecars(nets, variant, tmp_path):
    """train_imf with gan_weight (the discriminator from the seed's
    generator) or dmd_weight (the scorer from the teacher), 3 steps with a
    save: the metrics finite, and the sidecar holds, leaf for leaf, the
    shapes of the JAX package's tree for that config."""
    j, p = nets
    extra = {"gan_weight": 1e-3} if variant == "adv" else {"dmd_weight": 1.0}
    seen = []
    PI.train_imf(PI.ImfConfig(num_steps=3, save_every=2, rollout_substeps=1, **extra), PCFG,
                 checkpoint_dir=str(tmp_path), data_iter=iter([np_batch(40 + i) for i in range(3)]),
                 teacher_params=p["teacher"], device="cpu", log_every=10, on_step=lambda s, m: seen.append(m))
    assert len(seen) == 3 and all(np.isfinite(float(v)) for m in seen for v in m.values())
    if variant == "adv":
        name, ref = "imf_discriminator_latest.npz", JDi.init_discriminator(
            jax.random.PRNGKey(0), JDi.DiscriminatorConfig(transformer_dim=64, ref_dim=64, num_tail_layers=2))
        assert set(seen[0]) == {"imf_loss", "gan_loss", "disc_loss"}
    else:
        name, ref = "imf_scorer_latest.npz", j["teacher"]
        assert set(seen[0]) == {"imf_loss", "dmd_loss", "grad_mag", "scorer_loss"}
    got = {k: v.shape for k, v in flat_j(jckpt.load_pytree(str(tmp_path / name))).items()}
    assert got == {k: v.shape for k, v in flat_j(ref).items()}
    assert (tmp_path / "imf_student_latest.npz").exists()


def test_gan_and_dmd_together_raise_before_any_thread(nets, tmp_path):
    _, p = nets
    n = threading.active_count()
    with pytest.raises(ValueError, match="separate variants"):
        PI.train_imf(PI.ImfConfig(gan_weight=1e-3, dmd_weight=1.0), PCFG, checkpoint_dir=str(tmp_path),
                     teacher_params=p["teacher"], device="cpu")
    assert threading.active_count() == n and not list(tmp_path.iterdir())


def test_teacher_from_npz_or_reference_pt_and_the_cli(nets, tmp_path):
    """load_teacher (the CLI's --teacher) reads the JAX package's npz and a
    reference torch .pt to the same tree; the CLI exits 2 without one."""
    j, p = nets
    npz, pt = str(tmp_path / "teacher.npz"), str(tmp_path / "teacher.pt")
    jckpt.save_pytree(npz, j["teacher"], meta=backbone_meta(TINY_BACKBONE))
    torch.save(backbone_state_dict(params_to_jax(p["teacher"])), pt)
    want = pckpt.flatten_pytree(p["teacher"])
    for path in (npz, pt):
        got = pckpt.flatten_pytree(PI.load_teacher(path, PCFG))
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want), path
    with pytest.raises(SystemExit) as e:
        PI.main(["--teacher", str(tmp_path / "missing.npz"), "--checkpoint-dir", str(tmp_path)])
    assert e.value.code == 2

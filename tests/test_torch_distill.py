"""The port's DMD2 distiller (smalltts_tpu_torch/train/distill.py) against
the JAX package's, on the CPU, with the tiny backbone of tests/tiny.py, the
tiny discriminator, ASR (16 heads of 4: the attention's head dim 4) and SV,
the same weights (JAX inits carried across by params_from_jax, the
backbones' zero-init leaves re-drawn) and the same numpy batch. Random
draws are JAX's (its key splits replicated here) passed into the port.

To hold gradients, not only Adam's sign-like first step, single steps run
with plain SGD at rate 1e4 on both sides (optax.sgd(LR); the port's `SGD`
below), so old - new params is LR x the gradient (the rate keeps the
float32 rounding of the params out of that difference), and AdamW steps
compare the moments, which hold the gradients. Tolerances, fp32: metrics,
losses and the carry 1e-5 relative to the largest value; gradients 1e-4
rel-L2 per leaf (a backward through up to four backbone forwards, fp32 sums
in another order); params and moments after AdamW steps 1e-6 rel-L2 per
leaf (1e-4 where a leaf's gradient is zero but for rounding). bf16 (the
JAX bf16 path, the teacher stored in bf16): metrics 2e-2 relative, the
carry 2e-2 rel-L2 and the SGD gradients 1e-1 rel-L2 per leaf (bf16
roundings at other points of the two autograds; the values measured are
printed by test_bf16_iteration_against_jax).
"""

import dataclasses
import os
import sys

# tests/test_certify.py puts scripts/ first on sys.path when it is collected,
# and scripts/profile.py then shadows the standard library's `profile`, which
# torch.utils.checkpoint (dit_forward with remat) imports on its first call
# through torch._dynamo and cProfile. Load the standard library's here.
_SCRIPTS = os.path.realpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
_PATH = list(sys.path)
sys.path[:] = [p for p in sys.path if os.path.realpath(p or ".") != _SCRIPTS]
import cProfile  # noqa: E402,F401
sys.path[:] = _PATH

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE  # noqa: E402

from smalltts_tpu.data import dummy as JDD  # noqa: E402
from smalltts_tpu.models import asr as JA  # noqa: E402
from smalltts_tpu.models import backbone as JBK  # noqa: E402
from smalltts_tpu.models import conformer as JC  # noqa: E402
from smalltts_tpu.models import discriminator as JDi  # noqa: E402
from smalltts_tpu.models import sv as JSV  # noqa: E402
from smalltts_tpu.ops.precision import cast_floats as j_cast_floats  # noqa: E402
from smalltts_tpu.train import distill as JDS  # noqa: E402
from smalltts_tpu.train import optim as JO  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils import config_io as jcio  # noqa: E402
from smalltts_tpu_torch.models import asr as PA  # noqa: E402
from smalltts_tpu_torch.models import conformer as PC  # noqa: E402
from smalltts_tpu_torch.models import discriminator as PDi  # noqa: E402
from smalltts_tpu_torch.models import sv as PSV  # noqa: E402
from smalltts_tpu_torch.ops.precision import cast_floats  # noqa: E402
from smalltts_tpu_torch.train import distill as PDS  # noqa: E402
from smalltts_tpu_torch.train import optim as PO  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax  # noqa: E402

T = torch.from_numpy
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
# tests/test_distill.py's tiny discriminator and SV; the ASR at 16 heads of 4
J_DISC = JDi.DiscriminatorConfig(
    latent_dim=64, transformer_dim=TINY_BACKBONE.hidden_dim, ref_dim=TINY_BACKBONE.hidden_dim, model_dim=32,
    num_tail_layers=2, conformer=JC.ConformerConfig(input_dim=32, num_heads=4, ffn_dim=64, num_layers=2,
                                                    depthwise_conv_kernel_size=7, use_group_norm=True))
J_DISC_BN = dataclasses.replace(J_DISC, conformer=dataclasses.replace(J_DISC.conformer, use_group_norm=False))
J_ASR = JA.ASRConfig(input_dim=64, conformer=JC.ConformerConfig(input_dim=64, num_heads=16, ffn_dim=64, num_layers=2,
                                                                depthwise_conv_kernel_size=9))
J_SV = JSV.SVConfig(input_dim=64, emb_dim=8, channels=(24, 24, 24, 24, 72), attention_channels=8, res2net_scale=4,
                    se_channels=8)
DATA = dict(max_phonemes=10, min_phonemes=4, max_latents=16, min_latents=8, max_ref=8, min_ref=4)


def port_cfg(jcfg, module):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if "conformer" in d:
        d["conformer"] = PC.ConformerConfig(**dataclasses.asdict(d["conformer"]))
    return getattr(module, type(jcfg).__name__)(**d)


P_DISC, P_DISC_BN, P_ASR, P_SV = (port_cfg(J_DISC, PDi), port_cfg(J_DISC_BN, PDi), port_cfg(J_ASR, PA),
                                  port_cfg(J_SV, PSV))


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
    return jckpt.flatten_pytree(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))


def flat_p(tree, cfg=None):
    return {k: to_np(v) for k, v in pckpt.flatten_pytree(params_to_jax(tree, cfg)).items()}


def compare_trees(port_tree, jax_tree, tol, what, cfg=None):
    got, want = flat_p(port_tree, cfg), flat_j(jax_tree)
    assert set(got) == set(want), set(got) ^ set(want)
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} rel-L2 {errs[worst]:.3e} > {tol}"
    return errs[worst]


def compare_grads(port_old, port_new, jax_old, jax_new, tol, what, cfg=None):
    """old - new of the port's SGD step against JAX's: the gradients."""
    po, pn, jo, jn = flat_p(port_old, cfg), flat_p(port_new, cfg), flat_j(jax_old), flat_j(jax_new)
    errs = {k: rel_l2(po[k] - pn[k], jo[k] - jn[k]) for k in jo if np.abs(jo[k] - jn[k]).max() > 0}
    assert errs, f"{what}: no leaf has a gradient"
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} gradient rel-L2 {errs[worst]:.3e} > {tol}"
    for k in jo:  # a leaf JAX leaves unchanged, the port leaves unchanged
        if k not in errs:
            assert np.array_equal(po[k], pn[k]), k
    return errs[worst]


LR = 1e4


class SGD:
    """optax.sgd(LR) in the port's optimizer interface: updates = -LR grads."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return pckpt.map_pytree(lambda g: -LR * g, grads), state


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


@pytest.fixture(scope="module")
def nets():
    """JAX trees and their port counterparts: teacher, student, scorer, disc
    (GroupNorm and BatchNorm), ASR, SV."""
    ks = jax.random.split(jax.random.PRNGKey(0), 7)
    j = {name: redraw(JBK.init_backbone(ks[i], TINY_BACKBONE), i)
         for i, name in enumerate(("teacher", "student", "scorer"))}
    j["disc"] = JDi.init_discriminator(ks[3], J_DISC)
    j["disc_bn"] = JDi.init_discriminator(ks[4], J_DISC_BN)
    j["asr"] = JA.init_asr(ks[5], J_ASR)
    j["sv"] = JSV.init_sv(ks[6], J_SV)
    cfgs = {"teacher": PCFG, "student": PCFG, "scorer": PCFG, "disc": P_DISC, "disc_bn": P_DISC_BN, "asr": P_ASR,
            "sv": P_SV}
    return j, {k: to_port(v, cfgs[k]) for k, v in j.items()}


def np_batch(seed=0, b=2):
    cfg = JDD.DummyDataConfig(batch_size=b, **DATA)
    return {k: v for k, v in JDD.dummy_batch(np.random.default_rng(seed), cfg).items() if k != "texts"}


def port(d):
    return {k: T(np.array(v)) for k, v in d.items()}


def j_student_draws(key, shape):
    ks = jax.random.split(key, 5)
    b = shape[0]
    return {"idx": jax.random.randint(ks[0], (b,), 0, len(JDS.TIMESTEPS) - 1),
            "noise_prev": jax.random.normal(ks[1], shape), "noise_cur": jax.random.normal(ks[2], shape),
            "ts": jax.random.uniform(ks[3], (b,)), "noise_t": jax.random.normal(ks[4], shape)}


def j_scorer_draws(key, shape, n):
    out = {"noise_z": [], "ts": [], "noise_t": []}
    for k in jax.random.split(key, n):
        k1, k2, k3 = jax.random.split(k, 3)
        out["noise_z"].append(jax.random.normal(k1, shape))
        out["ts"].append(jax.random.uniform(k2, (shape[0],)))
        out["noise_t"].append(jax.random.normal(k3, shape))
    return {k: np.stack([np.asarray(a) for a in v]) for k, v in out.items()}


def copy_j(tree):
    return jax.tree.map(jnp.copy, tree)


def run_student(nets, step, train_cfg, j_tx, p_tx, batch_seed=0, key=1, dtype="float32"):
    """One student step on both sides from the same state and draws; the
    teacher stored in `dtype` on both. Returns (JAX (student, opt, carry,
    metrics), port (student, opt, carry, metrics), the port's x_t records)."""
    j, p = nets
    batch = np_batch(batch_seed)
    kk = jax.random.PRNGKey(key)
    draws = port(j_student_draws(kk, batch["latents"].shape))
    teacher_j, teacher_p = j["teacher"], p["teacher"]
    if dtype != "float32":
        teacher_j, teacher_p = j_cast_floats(teacher_j, jnp.bfloat16), cast_floats(teacher_p, torch.bfloat16)
    cfg_j = dataclasses.replace(TINY_BACKBONE, dit=dataclasses.replace(TINY_BACKBONE.dit, remat=train_cfg[1]))
    cfg_p = dataclasses.replace(PCFG, dit=dataclasses.replace(PCFG.dit, remat=train_cfg[1]))
    jcfg = JDS.DistillConfig(compute_dtype=dtype, **train_cfg[0])
    pcfg = PDS.DistillConfig(compute_dtype=dtype, **train_cfg[0])
    jstep = JDS.make_student_step(cfg_j, J_DISC, J_ASR, J_SV, j_tx, jcfg)
    pstep = PDS.make_student_step(cfg_p, P_DISC, P_ASR, P_SV, p_tx, pcfg)
    js = copy_j(j["student"])
    jout = jstep(js, j_tx.init(js), teacher_j, j["scorer"], j["disc"], j["asr"], j["sv"],
                 jax.tree.map(jnp.asarray, batch), jnp.asarray(step), kk)
    pout = pstep(p["student"], p_tx.init(p["student"]), teacher_p, p["scorer"], p["disc"], p["asr"], p["sv"],
                 port(batch), step, draws)
    return jout, pout


METRICS = ("st_pseudo", "st_gan", "st_asr", "st_sv", "dmd_grad_mag")


@pytest.mark.parametrize("case", ["gates_shut", "gates_open", "gates_open_gan1_remat"])
def test_student_step_gradients_match_jax(nets, case, monkeypatch):
    """Step 0 at the default starts (5000 / 7000): no ASR or SV forward runs
    and both metrics are 0.0; step 10000: both gates open. The third case
    weighs the GAN loss 1.0 (its gradient reaches the student only through
    x_t and the frozen discriminator) and remats the DiT blocks."""
    j, p = nets
    step = 0 if case == "gates_shut" else 10_000
    train_cfg = ({"gan_weight": 1.0}, True) if case.endswith("remat") else ({}, False)
    ran = {"asr": 0, "sv": 0}
    for name, fn in (("asr", PDS.asr_forward), ("sv", PDS.sv_forward)):
        def counted(*a, _fn=fn, _name=name, **kw):
            ran[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(PDS, f"{name}_forward", counted)
    noised = []  # apply_noise's results where its x0 carries a gradient: the update's x_t

    def recording(x, t, noise, _fn=PDS.apply_noise):
        out = _fn(x, t, noise)
        if x.requires_grad:
            noised.append(out[0])
        return out
    monkeypatch.setattr(PDS, "apply_noise", recording)
    (js, _, jc, jm), (ps, _, pc, pm) = run_student(nets, step, train_cfg, optax.sgd(LR), SGD())
    for k in METRICS:
        assert rel(to_np(pm[k]), jm[k]) <= 1e-5, (k, float(pm[k]), float(jm[k]))
    if case == "gates_shut":
        assert float(pm["st_asr"]) == float(pm["st_sv"]) == float(jm["st_asr"]) == 0.0 and float(jm["st_sv"]) == 0.0
        assert ran == {"asr": 0, "sv": 0}
    else:
        assert float(pm["st_asr"]) > 0 and float(pm["st_sv"]) > 0 and ran == {"asr": 1, "sv": 2}
    assert set(pc) == set(jc)
    for k in jc:
        assert rel(to_np(pc[k]), np.asarray(jc[k], np.float32)) <= 1e-5, k
    # the carry's x_t is the update's (from the x0 with grad), detached
    assert len(noised) == 1 and pc["x_t"].data_ptr() == noised[0].data_ptr() and not pc["x_t"].requires_grad
    compare_grads(p["student"], ps, j["student"], js, 1e-4, f"{case} student gradients")
    # the frozen nets get no gradient and are unchanged
    for name in ("disc", "asr", "sv", "teacher", "scorer"):
        for v in pckpt.flatten_pytree(p[name]).values():
            assert not v.requires_grad and v.grad is None, name


def test_student_step_adamw_matches_jax(nets):
    j, p = nets
    (js, jopt, _, jm), (ps, popt, _, pm) = run_student(
        nets, 10_000, ({}, False), JO.distill_optimizer(j["student"]), PO.distill_optimizer(p["student"]))
    compare_trees(ps, js, 1e-6, "student after AdamW")
    adam = jopt.inner_states["train"].inner_state[0][0]
    assert int(popt["count"]) == int(adam.count) == 1
    compare_trees(popt["mu"], adam.mu, 1e-4, "mu")
    compare_trees(popt["nu"], adam.nu, 1e-4, "nu")


def synthetic_carry(seed, b=2, t=16, r=8):
    rs = np.random.RandomState(seed)
    return {"ts": rs.rand(b).astype(np.float32), "t_cur": np.array([0.75, 0.5], np.float32),
            "feats_fake": rs.randn(b, TINY_BACKBONE.dit.n_blocks, t, TINY_BACKBONE.hidden_dim).astype(np.float32),
            "x_t": rs.randn(b, t, 64).astype(np.float32), "x0_prev": rs.randn(b, t, 64).astype(np.float32),
            "ref_seq": rs.randn(b, r, TINY_BACKBONE.hidden_dim).astype(np.float32),
            "ref_mask": np.arange(r)[None] < np.array([r, 5])[:, None]}


@pytest.mark.parametrize("norm", ["groupnorm", "batchnorm"])
def test_disc_step_matches_jax(nets, norm):
    """The discriminator's LSGAN step on [real | fake]. GroupNorm (the
    default) with SGD: loss and gradients; BatchNorm (tests/test_distill.py
    ::test_disc_step_updates_batchnorm_running_stats's case) with AdamW: the
    forward's new running stats survive the update."""
    j, p = nets
    name, jcfg, pcfg = ("disc", J_DISC, P_DISC) if norm == "groupnorm" else ("disc_bn", J_DISC_BN, P_DISC_BN)
    batch, carry, key = np_batch(3), synthetic_carry(4), jax.random.PRNGKey(2)
    noise = np.asarray(jax.random.normal(key, batch["latents"].shape))
    if norm == "groupnorm":
        jtx, ptx = optax.sgd(LR), SGD()
    else:
        jtx, ptx = JO.distill_optimizer(j[name]), PO.distill_optimizer(p[name])
    jd, _, jl = JDS.make_disc_step(TINY_BACKBONE, jcfg, jtx)(copy_j(j[name]), jtx.init(j[name]), j["scorer"],
                                                              jax.tree.map(jnp.asarray, batch),
                                                              jax.tree.map(jnp.asarray, carry), key)
    pd, _, pl = PDS.make_disc_step(PCFG, pcfg, ptx)(p[name], ptx.init(p[name]), p["scorer"], port(batch),
                                                    port(carry), {"noise": T(noise)})
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    if norm == "groupnorm":
        compare_grads(p[name], pd, j[name], jd, 1e-4, "disc gradients", pcfg)
    else:
        # 1e-4: the depthwise conv's bias before a training-mode BatchNorm has a zero gradient, whose
        # rounding noise Adam normalizes (4.6e-5 measured there; 1e-6 elsewhere)
        compare_trees(pd, jd, 1e-4, "disc after AdamW", pcfg)
        stats = [k for k in flat_j(jd) if k.endswith(("/mean", "/var"))]
        assert stats
        moved = sum(float(np.abs(flat_p(pd, pcfg)[k] - flat_p(p[name], pcfg)[k]).sum()) for k in stats)
        assert moved > 1e-8, "BN running stats did not update on a disc step"
        for k in stats:
            assert rel(flat_p(pd, pcfg)[k], flat_j(jd)[k]) <= 1e-5, k
    assert all(not v.requires_grad for v in pckpt.flatten_pytree(pd).values())


def test_scorer_step_two_updates_match_jax(nets):
    j, p = nets
    batch, carry, key = np_batch(5), synthetic_carry(6), jax.random.PRNGKey(3)
    draws = port(j_scorer_draws(key, batch["latents"].shape, 2))
    jtx, ptx = JO.distill_optimizer(j["scorer"]), PO.distill_optimizer(p["scorer"])
    jsc, jopt, jl = JDS.make_scorer_step(TINY_BACKBONE, jtx, n_updates=2)(
        copy_j(j["scorer"]), jtx.init(j["scorer"]), j["student"], jax.tree.map(jnp.asarray, batch),
        jax.tree.map(jnp.asarray, carry), key)
    psc, popt, pl = PDS.make_scorer_step(PCFG, ptx, n_updates=2)(
        p["scorer"], ptx.init(p["scorer"]), p["student"], port(batch), port(carry), draws)
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert int(popt["count"]) == 2
    compare_trees(psc, jsc, 1e-6, "scorer after 2 updates")
    compare_trees(popt["mu"], jopt.inner_states["train"].inner_state[0][0].mu, 1e-4, "scorer mu")
    # the moments hold both updates' gradients, the second taken at the first update's params
    compare_trees(popt["nu"], jopt.inner_states["train"].inner_state[0][0].nu, 1e-4, "scorer nu")


def test_bf16_iteration_against_jax(nets):
    """One iteration (student, disc, scorer steps) in bf16 on both sides,
    the same draws, the teacher stored in bf16: metrics within 2e-2
    relative, the carry and the disc's and scorer's SGD gradients within
    2e-2 and 1e-1 rel-L2 (bf16 roundings at other points; the values
    measured are in CHANGES.md)."""
    j, p = nets
    (js, _, jc, jm), (ps, _, pc, pm) = run_student(nets, 10_000, ({}, False), optax.sgd(LR), SGD(), batch_seed=7,
                                                   key=8, dtype="bfloat16")
    errs = {k: rel(to_np(pm[k]), jm[k]) for k in METRICS}
    errs.update({k: rel_l2(to_np(pc[k]), np.asarray(jc[k], np.float32))
                 for k in ("x0_prev", "x_t", "feats_fake", "ref_seq")})
    print("bf16 metrics (relative) and carry (rel-L2):", {k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= 2e-2, errs
    student_err = compare_grads(p["student"], ps, j["student"], js, 1e-1, "bf16 student gradients")
    batch = np_batch(7)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, batch["latents"].shape))
    jtx = optax.sgd(LR)
    jd, _, jl = JDS.make_disc_step(TINY_BACKBONE, J_DISC, jtx, "bfloat16")(
        copy_j(j["disc"]), jtx.init(j["disc"]), j["scorer"], jax.tree.map(jnp.asarray, batch), jc, key)
    pd, _, pl = PDS.make_disc_step(PCFG, P_DISC, SGD(), "bfloat16")(p["disc"], {}, p["scorer"], port(batch), pc,
                                                                    {"noise": T(noise)})
    assert abs(float(pl) - float(jl)) <= 2e-2 * abs(float(jl))
    disc_err = compare_grads(p["disc"], pd, j["disc"], jd, 1e-1, "bf16 disc gradients", P_DISC)
    # the scorer's update on the student before this step's SGD (rate 1e4 would wreck it)
    key = jax.random.PRNGKey(10)
    draws = port(j_scorer_draws(key, batch["latents"].shape, 1))
    jsc, _, jl = JDS.make_scorer_step(TINY_BACKBONE, jtx, 1, "bfloat16")(
        copy_j(j["scorer"]), jtx.init(j["scorer"]), j["student"], jax.tree.map(jnp.asarray, batch), jc, key)
    psc, _, pl = PDS.make_scorer_step(PCFG, SGD(), 1, "bfloat16")(p["scorer"], {}, p["student"], port(batch), pc,
                                                                  draws)
    assert abs(float(pl) - float(jl)) <= 2e-2 * abs(float(jl))
    scorer_err = compare_grads(p["scorer"], psc, j["scorer"], jsc, 1e-1, "bf16 scorer gradients")
    print(f"bf16 gradients rel-L2, worst leaf: student {student_err:.3e}, disc {disc_err:.3e}, "
          f"scorer {scorer_err:.3e}")


def test_train_distill_saves_jax_loadable_checkpoints(nets, tmp_path):
    """Three iterations (a save at step 2) from params_override on the CPU:
    the metrics finite, student, scorer and disc changed, the teacher
    untouched; the saved npz files load in JAX's load_pytree and hold the
    returned trees, and JAX's discriminator_forward on the loaded disc gives
    the port's output."""
    j, p = nets
    before = {k: {n: v.clone() for n, v in pckpt.flatten_pytree(p[k]).items()} for k in ("teacher", "disc")}
    rng = np.random.default_rng(0)
    data = JDD.DummyDataConfig(batch_size=2, **DATA)

    def loader():
        while True:
            yield JDD.dummy_batch(rng, data)

    cfg = PDS.DistillConfig(num_steps=3, save_every=2, asr_start_step=0, sv_start_step=0, scorer_updates=1)
    override = {k: p[k] for k in ("teacher", "asr", "sv", "disc")}
    student, scorer, disc, metrics = PDS.train_distill(cfg, PCFG, P_DISC, P_ASR, P_SV, data_iter=loader(),
                                                       params_override=override, checkpoint_dir=str(tmp_path),
                                                       device="cpu")
    assert set(metrics) == {"st_pseudo", "st_gan", "st_asr", "st_sv", "dmd_grad_mag", "disc_loss", "scorer_loss"}
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["st_asr"] > 0 and metrics["st_sv"] > 0
    teacher = pckpt.flatten_pytree(p["teacher"])
    assert all(torch.equal(teacher[n], v) for n, v in before["teacher"].items())
    for tree, ref in ((student, before["teacher"]), (scorer, before["teacher"]), (disc, before["disc"])):
        flat = pckpt.flatten_pytree(tree)
        assert any(not torch.equal(flat[n], v) for n, v in ref.items())
    for name, tree, cfg_ in (("student", student, PCFG), ("scorer", scorer, PCFG), ("discriminator", disc, P_DISC)):
        path = str(tmp_path / f"{name}_latest.npz")
        jtree = jckpt.load_pytree(path)
        if name != "discriminator":
            assert jcio.backbone_config_from_meta(jckpt.load_meta(path)) == TINY_BACKBONE
        back = pckpt.flatten_pytree(params_from_jax(pckpt.load_pytree(path), cfg_))
        assert back.keys() == pckpt.flatten_pytree(tree).keys()
    # the saved disc is the disc after step 2, the last step: equal to the returned one
    back = params_from_jax(pckpt.load_pytree(str(tmp_path / "discriminator_latest.npz")), P_DISC)
    assert all(torch.equal(a, b) for a, b in zip(pckpt.flatten_pytree(back).values(),
                                                 pckpt.flatten_pytree(disc).values()))
    rs = np.random.RandomState(11)
    args = (rs.randn(2, 2, 16, 64).astype(np.float32), rs.randn(2, 16, 64).astype(np.float32),
            rs.randn(2, 8, 64).astype(np.float32), np.ones((2, 8), bool), np.ones((2, 16), bool),
            rs.randint(1, 198, (2, 10)).astype(np.int32), rs.rand(2).astype(np.float32))
    want, _ = JDi.discriminator_forward(jax.tree.map(jnp.asarray, jtree), J_DISC, *args)
    got, _ = PDi.discriminator_forward(disc, P_DISC, *map(T, args))
    assert rel(to_np(got), want) <= 1e-5
    import json

    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in records] == [0]  # one record every 50 steps


def test_train_distill_runs_on_the_card_by_default(nets, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, p = nets
    with pytest.raises(RuntimeError, match="CUDA"):
        PDS.train_distill(PDS.DistillConfig(num_steps=1), PCFG, P_DISC, P_ASR, P_SV,
                          params_override={k: p[k] for k in ("teacher", "asr", "sv", "disc")})
    # the command line: without the checkpoints it says so and exits non-zero
    with pytest.raises(SystemExit) as exc:
        PDS.main(["--teacher", str(tmp_path / "none.npz"), "--asr", str(tmp_path / "a.npz"), "--sv",
                  str(tmp_path / "s.npz"), "--steps", "1"])
    assert exc.value.code not in (0, None) and "--teacher" in capsys.readouterr().err
    for name in ("t.npz", "a.npz", "s.npz"):
        (tmp_path / name).write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):  # with them it runs on the card
        PDS.main(["--teacher", str(tmp_path / "t.npz"), "--asr", str(tmp_path / "a.npz"), "--sv",
                  str(tmp_path / "s.npz"), "--steps", "1"])

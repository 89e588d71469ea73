"""The port's training path (smalltts_tpu_torch.train, models.dit.dit_forward,
models.backbone.backbone_forward/cfg_velocity, the attention's backward,
infer.teacher_sampler) against the JAX package's, on the CPU in fp32 with
the tiny configs of tests/tiny.py, the same weights (converted with
utils.convert.params_from_jax, the zero-init leaves re-drawn so every leaf
gets a gradient) and the same numpy inputs. Random draws are JAX's (its key
splits replicated here) passed into the port; no torch stream is compared
with a JAX one.

Tolerances, each relative: forwards 1e-5 of the largest output and the
attention's gradients 1e-5 (fp32 sums in another order); the loss's
gradients 1e-4 rel-L2 per leaf (the same, through a backward of ~200 ops),
and 5e-2 in the bf16 compute view (bf16 roundings of the cotangents taken
at other points by the two autograds); the optimizer's params, moments and
schedule 1e-6 over 5 updates, its updates 1e-4 (XLA's CPU pow of b^count
is not torch's: 1 - b2^count differs by one float32 ulp of b2^count, up to
2e-5 of it); the three teacher steps' params and EMA 1e-6 rel-L2 per leaf,
moments 1e-4.
"""

import dataclasses
import json
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
from smalltts_tpu.infer.teacher_sampler import make_teacher_sampler as j_make_sampler  # noqa: E402
from smalltts_tpu.models import backbone as JBK  # noqa: E402
from smalltts_tpu.models import dit as JD  # noqa: E402
from smalltts_tpu.ops import nn as jnn  # noqa: E402
from smalltts_tpu.ops import masking as JM  # noqa: E402
from smalltts_tpu.ops import schedule as JS  # noqa: E402
from smalltts_tpu.train import ema as JE  # noqa: E402
from smalltts_tpu.train import optim as JO  # noqa: E402
from smalltts_tpu.train import teacher as JT  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils import config_io as jcio  # noqa: E402
from smalltts_tpu_torch.data import dummy as PDD  # noqa: E402
from smalltts_tpu_torch.infer.teacher_sampler import make_teacher_sampler  # noqa: E402
from smalltts_tpu_torch.models import backbone as PBK  # noqa: E402
from smalltts_tpu_torch.models import dit as PD  # noqa: E402
from smalltts_tpu_torch.ops import masking as PM  # noqa: E402
from smalltts_tpu_torch.ops import nn  # noqa: E402
from smalltts_tpu_torch.ops import schedule as PS  # noqa: E402
from smalltts_tpu_torch.ops.kernels.attention import attention, attention_backward  # noqa: E402
from smalltts_tpu_torch.ops.precision import cast_floats  # noqa: E402
from smalltts_tpu_torch.train import ema as PE  # noqa: E402
from smalltts_tpu_torch.train import optim as PO  # noqa: E402
from smalltts_tpu_torch.train import teacher as PT  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, backbone_config_from_meta  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax, train_state_from_jax  # noqa: E402

PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
T = torch.from_numpy
DATA = dict(max_phonemes=12, min_phonemes=4, max_latents=24, min_latents=8, max_ref=10, min_ref=4)


def rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def compare_trees(port_tree, jax_tree, tol, what):
    """Every leaf of a port tree (converted to the JAX layout) within `tol`
    rel-L2 of the JAX tree's leaf."""
    got = pckpt.flatten_pytree(params_to_jax(port_tree))
    want = jckpt.flatten_pytree(jax.tree.map(np.asarray, jax_tree))
    assert set(got) == set(want), set(got) ^ set(want)
    errs = {k: rel_l2(to_np(got[k]), want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} rel-L2 {errs[worst]:.3e} > {tol}"
    return errs


def redraw(params, seed=0):
    """Seeded values for the zero-init leaves, on the JAX side (carried across by conversion)."""
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: x, params)
    for lin in (params["dit"]["blocks"]["attn_norm"]["linear"], params["dit"]["norm_out"]["linear"],
                params["velocity"]):
        for k in lin:
            lin[k] = jnp.asarray((0.2 if k == "w" else 0.5) * rs.randn(*lin[k].shape), jnp.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    jp = redraw(JBK.init_backbone(jax.random.PRNGKey(0), TINY_BACKBONE))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), PCFG)


def np_batch(seed=0, b=2):
    cfg = JDD.DummyDataConfig(batch_size=b, **DATA)
    return {k: v for k, v in JDD.dummy_batch(np.random.default_rng(seed), cfg).items() if k != "texts"}


def jax_draws(key, batch):
    """JAX teacher_loss's draws from `key`, its splits replicated."""
    k_drop, k_t, k_noise = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_drop)
    b = batch["latents"].shape[0]
    return {"text_u": jax.random.uniform(k1, (b,)), "speaker_u": jax.random.uniform(k2, (b,)),
            "t": jax.nn.sigmoid(jax.random.normal(k_t, (b,))),
            "noise": jax.random.normal(k_noise, batch["latents"].shape, jnp.float32)}


def port(tree):
    return {k: T(np.array(v)) for k, v in tree.items()}


# ------------------------------------------------------------------ forwards


@pytest.fixture(scope="module")
def fwd_inputs():
    rs = np.random.RandomState(1)
    B, Tl, R, P = 2, 16, 10, 12
    return dict(x=rs.randn(B, Tl, 64).astype(np.float32), ref=rs.randn(B, R, 64).astype(np.float32),
                ref_len=np.array([R, 6], np.int32), ph=rs.randint(1, 198, (B, P)).astype(np.int32),
                ph_mask=np.arange(P)[None] < np.array([9, P])[:, None],
                mask=np.arange(Tl)[None] < np.array([Tl, 11])[:, None], t=rs.rand(B).astype(np.float32))


def test_dit_forward_hidden_and_features(weights, fwd_inputs):
    jp, tp = weights
    d = fwd_inputs
    rs = np.random.RandomState(2)
    ref_seq = rs.randn(2, 10, 64).astype(np.float32)
    ph_emb = rs.randn(2, 12, 32).astype(np.float32)
    t_emb = rs.randn(2, 64).astype(np.float32)
    ref_mask = np.arange(10)[None] < np.array([10, 6])[:, None]
    jh, jf = JD.dit_forward(jp["dit"], TINY_BACKBONE.dit, d["x"], ref_seq, ref_mask, ph_emb, d["ph_mask"], t_emb,
                            d["mask"])
    ph, pf = PD.dit_forward(tp["dit"], PCFG.dit, T(d["x"]), T(ref_seq), T(ref_mask), T(ph_emb), T(d["ph_mask"]),
                            T(t_emb), T(d["mask"]))
    assert rel_max(to_np(ph), jh) <= 1e-5
    assert pf.shape == (2, PCFG.dit.n_blocks, 16, 64)
    assert rel_max(to_np(pf), jf) <= 1e-5


@pytest.mark.parametrize("remat", [False, True])
def test_backbone_forward_and_features(weights, fwd_inputs, remat):
    jp, tp = weights
    d = fwd_inputs
    args = (d["x"], d["ref"], d["ref_len"], d["mask"], d["ph"], d["ph_mask"], d["t"])
    jv, jf = JBK.backbone_forward(jp, TINY_BACKBONE, *args, return_features=True)
    cfg = dataclasses.replace(PCFG, dit=dataclasses.replace(PCFG.dit, remat=remat))
    pv, pf = PBK.backbone_forward(tp, cfg, *map(T, args), return_features=True)
    assert rel_max(to_np(pv), jv) <= 1e-5 and rel_max(to_np(pf), jf) <= 1e-5
    leaves = {k: v.clone().requires_grad_(True) for k, v in pckpt.flatten_pytree(tp).items()}
    v = PBK.backbone_forward(pckpt.unflatten_pytree(leaves), cfg, *map(T, args))
    assert torch.equal(v, pv)
    grads = torch.autograd.grad((v * v).sum(), list(leaves.values()))
    if remat:  # recomputing the blocks in the backward gives the same gradients
        plain = PBK.backbone_forward(pckpt.unflatten_pytree(leaves), PCFG, *map(T, args))
        for a, b in zip(grads, torch.autograd.grad((plain * plain).sum(), list(leaves.values()))):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)


def test_backbone_forward_checks_shapes(weights, fwd_inputs):
    _, tp = weights
    d = fwd_inputs
    with pytest.raises(AssertionError, match="latent dim"):
        PBK.backbone_forward(tp, PCFG, T(d["x"][..., :32]), T(d["ref"]), T(d["ref_len"]), T(d["mask"]),
                             T(d["ph"]), T(d["ph_mask"]), T(d["t"]))


def test_cfg_velocity(weights, fwd_inputs):
    jp, tp = weights
    d = fwd_inputs
    args = (d["x"], d["ref"], d["ref_len"], d["mask"], d["ph"], d["ph_mask"], d["t"])
    want = JBK.cfg_velocity(jp, TINY_BACKBONE, *args, cfg_scale_text=2.0, cfg_scale_speaker=1.5)
    got = PBK.cfg_velocity(tp, PCFG, *map(T, args), cfg_scale_text=2.0, cfg_scale_speaker=1.5)
    assert rel_max(to_np(got), want) <= 1e-5


# ----------------------------------------------------------------- attention


@pytest.mark.parametrize("D", [64, 120, 128])
def test_attention_backward_matches_jax_vjp(D):
    rs = np.random.RandomState(D)
    B, H, Tq, S = 3, 2, 12, 20
    q, k, v, dout = (rs.randn(B, H, n, D).astype(np.float32) for n in (Tq, S, S, Tq))
    mask = np.arange(S)[None] < rs.randint(1, S + 1, size=B)[:, None]
    mask[-1] = False  # one batch row with every key masked
    out, vjp = jax.vjp(lambda a, b, c: jnn.sdpa(a, b, c, key_mask=jnp.asarray(mask)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = attention_backward(T(q), T(k), T(v), T(mask), T(np.array(out)), T(dout))
    for g, w, name in zip(got, want, "qkv"):
        assert rel_max(to_np(g), w) <= 1e-5, name
    # the Function's gradients are attention_backward's, and its forward the plain attention
    qt, kt, vt = (T(a).requires_grad_(True) for a in (q, k, v))
    o = attention(qt, kt, vt, T(mask))
    assert rel_max(to_np(o), out) <= 1e-5
    o.backward(T(dout))
    for t, w, name in zip((qt, kt, vt), want, "qkv"):
        assert rel_max(to_np(t.grad), w) <= 1e-5, name
    assert float(qt.grad[-1].abs().max()) == 0.0 and float(kt.grad[-1].abs().max()) == 0.0


def test_matmul_f32_on_the_cpu_differentiates():
    rs = np.random.RandomState(0)
    x = T(rs.randn(3, 5, 8).astype(np.float32)).bfloat16().requires_grad_(True)
    w = T(rs.randn(8, 6).astype(np.float32)).bfloat16().requires_grad_(True)
    y = nn.matmul_f32(x, w)
    assert y.dtype == torch.float32
    y.backward(torch.ones_like(y))
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    want_dx = (torch.ones(3, 5, 6) @ w.float().t()).bfloat16()
    assert torch.equal(x.grad, want_dx)


@pytest.mark.parametrize("dilation", [1, 3])
def test_conv1d_f32_function_matches_autograd(dilation):
    """The card's float32 conv Function (TF32 off in forward and backward),
    called on the CPU: its output and gradients equal F.conv1d's autograd
    (1e-6 of the largest value)."""
    rs = np.random.RandomState(4)
    h = T(rs.randn(2, 8, 20).astype(np.float32))
    w = T(rs.randn(8, 2, 5).astype(np.float32))
    dy = T(rs.randn(2, 8, 20 - 4 * dilation).astype(np.float32))
    res = []
    for fn in (nn._Conv1dF32.apply, lambda a, b, d, g: torch.nn.functional.conv1d(a, b, dilation=d, groups=g)):
        leaves = [t.clone().requires_grad_(True) for t in (h, w)]
        y = fn(*leaves, dilation, 4)
        y.backward(dy)
        res.append([y.detach()] + [t.grad for t in leaves])
    for got, want in zip(*res):
        assert rel_max(to_np(got), to_np(want)) <= 1e-6


# ------------------------------------------------------- small ops and state


def test_masked_mse_schedule_and_cast():
    rs = np.random.RandomState(3)
    pred, target = rs.randn(2, 7, 4).astype(np.float32), rs.randn(2, 7, 4).astype(np.float32)
    mask = np.arange(7)[None] < np.array([7, 3])[:, None]
    assert rel_max(to_np(PM.masked_mse(T(pred), T(target), T(mask))), JM.masked_mse(pred, target, mask)) <= 1e-6
    assert float(PM.masked_mse(T(pred), T(target), T(np.zeros_like(mask)))) == 0.0  # count clamped at 1
    t = rs.rand(2).astype(np.float32)
    for g, w in zip(PS.apply_noise(T(pred), T(t), T(target)), JS.apply_noise(pred, t, target)):
        assert rel_max(to_np(g), w) <= 1e-6
    assert rel_max(to_np(PS.x_pred_from_velocity(T(pred), T(target), T(t))),
                   JS.x_pred_from_velocity(pred, target, t)) <= 1e-6
    lengths = torch.tensor([10, 1, 40], dtype=torch.int32)
    m = PS.random_cond_mask(torch.Generator().manual_seed(0), lengths, 48)
    spans = m.sum(1)
    assert m.shape == (3, 48) and bool((spans < torch.clamp_min(lengths // 2, 1) + 1).all())
    assert bool((m.int().diff(dim=1).clamp(min=0).sum(1) <= 1).all())  # one contiguous run
    tree = {"a": torch.ones(2), "b": {"c": torch.ones(2, dtype=torch.int32)}}
    cast = cast_floats(tree, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"]["c"].dtype == torch.int32


def test_ema_decay_matches_for_steps_0_to_2000():
    for step in range(2001):
        assert PE.ema_decay(step) == JE.ema_decay(step), step
        assert PE.ema_decay(step, 0.99) == JE.ema_decay(step, 0.99), step


def test_dummy_loader_matches():
    cfg_j, cfg_p = JDD.DummyDataConfig(batch_size=3), PDD.DummyDataConfig(batch_size=3)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_p)
    jit, pit = JDD.get_dummy_dataloader(3, 5), PDD.get_dummy_dataloader(3, 5)
    for _ in range(3):
        a, b = next(jit), next(pit)
        assert a.keys() == b.keys() and a["texts"] == b["texts"]
        for k in a:
            if k != "texts":
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_adamw_schedule_and_clip_match_optax():
    """5 updates with the teacher's chain (a warmup of 2 over 10 steps), a
    batch-norm `mean` leaf frozen, the third gradient scaled so the clip
    triggers."""
    rs = np.random.RandomState(4)
    params = {"w": rs.randn(6, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32),
              "bn": {"mean": rs.randn(5).astype(np.float32), "scale": rs.randn(5).astype(np.float32)}}
    jtx, jsched = JO.teacher_optimizer(jax.tree.map(jnp.asarray, params), num_steps=10, warmup=2)
    ptx, psched = PO.teacher_optimizer({k: T(v) if not isinstance(v, dict) else port(v)
                                        for k, v in params.items()}, num_steps=10, warmup=2)
    for step in range(12):
        assert rel_max(to_np(psched(step)), jsched(step)) <= 1e-6, step
    jp = jax.tree.map(jnp.asarray, params)
    pp = {k: T(v) if not isinstance(v, dict) else port(v) for k, v in params.items()}
    jstate, pstate = jtx.init(jp), ptx.init(pp)
    clipped = False
    for i in range(5):
        g = jax.tree.map(lambda x: (30.0 if i == 2 else 0.1) * rs.randn(*x.shape).astype(np.float32), params)
        gnorm = float(np.sqrt(sum(float((v ** 2).sum()) for k, v in pckpt.flatten_pytree(g).items()
                                  if not k.endswith("mean"))))
        clipped |= gnorm >= 1.0
        ju, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        pu, pstate = ptx.update({k: T(v) if not isinstance(v, dict) else port(v) for k, v in g.items()}, pstate, pp)
        jp, pp = optax.apply_updates(jp, ju), PO.apply_updates(pp, pu)
        assert float(pu["bn"]["mean"].abs().max()) == 0.0 and float(np.abs(ju["bn"]["mean"]).max()) == 0.0
        for k, w in jckpt.flatten_pytree(jax.tree.map(np.asarray, ju)).items():
            assert rel_max(to_np(pckpt.flatten_pytree(pu)[k]), w) <= 1e-4, (i, k)
        for k, w in jckpt.flatten_pytree(jax.tree.map(np.asarray, jp)).items():
            assert rel_max(to_np(pckpt.flatten_pytree(pp)[k]), w) <= 1e-6, (i, k)
        adam = jstate.inner_states["train"].inner_state[1][0]
        assert int(pstate["count"]) == int(adam.count) == i + 1
        for name in ("mu", "nu"):
            got = pckpt.flatten_pytree(pstate[name])
            for k, w in jckpt.flatten_pytree(getattr(adam, name)).items():
                if not k.endswith("mean"):  # frozen: optax keeps no moment there
                    assert rel_max(to_np(got[k]), w) <= 1e-6, (i, name, k)
    assert clipped


# -------------------------------------------------------------- the teacher


def test_teacher_loss_and_gradients_match_jax(weights):
    jp, tp = weights
    batch = np_batch(0)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, batch)
    cfg = JT.TeacherTrainConfig(text_cfg_drop=0.5, speaker_cfg_drop=0.5)
    jl, jg = jax.jit(jax.value_and_grad(JT.teacher_loss), static_argnums=(1, 4))(
        jp, TINY_BACKBONE, jax.tree.map(jnp.asarray, batch), key, cfg)
    leaves = pckpt.flatten_pytree(tp)
    req = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    pl = PT.teacher_loss(pckpt.unflatten_pytree(req), PCFG, port(batch), port(draws),
                         PT.TeacherTrainConfig(text_cfg_drop=0.5, speaker_cfg_drop=0.5))
    assert abs(float(pl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    grads = torch.autograd.grad(pl, list(req.values()))
    errs = compare_trees(pckpt.unflatten_pytree(dict(zip(req, grads))), jg, 1e-4, "fp32 grads")
    assert len(errs) == len(leaves)


def test_teacher_loss_bf16_compute_view(weights):
    jp, tp = weights
    batch = np_batch(1)
    key = jax.random.PRNGKey(4)
    draws = jax_draws(key, batch)
    jcfg = JT.TeacherTrainConfig(compute_dtype="bfloat16")
    jl, jg = jax.jit(jax.value_and_grad(JT.teacher_loss), static_argnums=(1, 4))(
        jp, TINY_BACKBONE, jax.tree.map(jnp.asarray, batch), key, jcfg)
    leaves = pckpt.flatten_pytree(tp)
    req = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    pl = PT.teacher_loss(pckpt.unflatten_pytree(req), PCFG, port(batch), port(draws),
                         PT.TeacherTrainConfig(compute_dtype="bfloat16"))
    assert abs(float(pl.detach()) - float(jl)) <= 1e-2 * abs(float(jl))
    grads = torch.autograd.grad(pl, list(req.values()))
    assert all(g.dtype == torch.float32 for g in grads)  # the masters' gradients
    compare_trees(pckpt.unflatten_pytree(dict(zip(req, grads))), jg, 5e-2, "bf16 grads")


def test_three_teacher_steps_match_jax(weights):
    """Three steps from the same state, the JAX run's state carried across by
    train_state_from_jax, with decays that exercise the EMA."""
    jp, _ = weights
    jtx, _ = JO.teacher_optimizer(jp, num_steps=100, warmup=1)
    jstate = jtx.init(jp)
    jema = JE.ema_init(jp)
    adam = jstate.inner_states["train"].inner_state[1][0]
    state = train_state_from_jax(*(jax.tree.map(np.asarray, t) for t in (jp, adam.mu, adam.nu)), adam.count,
                                 jax.tree.map(np.asarray, jema), 0, cfg=PCFG)
    ptx, _ = PO.teacher_optimizer(state["params"], num_steps=100, warmup=1)
    pp, pstate, pema = state["params"], state["opt_state"], state["ema"]
    jstep = JT.make_teacher_step(TINY_BACKBONE, jtx)
    pstep = PT.make_teacher_step(PCFG, ptx)
    jp = jax.tree.map(jnp.copy, jp)
    for i, decay in enumerate((0.0, 0.5, 0.9)):
        batch = np_batch(10 + i)
        key = jax.random.PRNGKey(20 + i)
        jp, jstate, jema, jl = jstep(jp, jstate, jema, jax.tree.map(jnp.asarray, batch), key, jnp.float32(decay))
        pp, pstate, pema, pl = pstep(pp, pstate, pema, port(batch), port(jax_draws(key, batch)), np.float32(decay))
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl)), i
    adam = jstate.inner_states["train"].inner_state[1][0]
    assert int(pstate["count"]) == int(adam.count) == 3
    compare_trees(pp, jp, 1e-6, "params")
    compare_trees(pema, jema, 1e-6, "ema")
    compare_trees(pstate["mu"], adam.mu, 1e-4, "mu")
    compare_trees(pstate["nu"], adam.nu, 1e-4, "nu")


def test_nan_batch_keeps_state_and_updates_ema(weights):
    _, tp = weights
    tx, _ = PO.teacher_optimizer(tp, num_steps=100, warmup=1)
    step = PT.make_teacher_step(PCFG, tx)
    params, state, ema = tp, tx.init(tp), PE.ema_init(tp)
    batch = port(np_batch(5))
    draws = PT.teacher_draws(torch.Generator().manual_seed(0), batch)
    params, state, ema, loss = step(params, state, ema, batch, draws)
    assert torch.isfinite(loss) and int(state["count"]) == 1
    ema = PE.ema_update(ema, PE.ema_init(params), 0.0)  # EMA = params, so an update is visible
    ema = {**ema, "velocity": {k: v + 1.0 for k, v in ema["velocity"].items()}}
    bad = dict(batch, latents=batch["latents"].clone())
    bad["latents"][0, 0, 0] = float("nan")
    before = [t.clone() for t in pckpt.flatten_pytree({"p": params, "s": state}).values()]
    params, state, ema2, loss = step(params, state, ema, bad, draws, np.float32(0.5))
    assert not torch.isfinite(loss)
    after = list(pckpt.flatten_pytree({"p": params, "s": state}).values())
    assert all(torch.equal(a, b) for a, b in zip(after, before)) and int(state["count"]) == 1
    want = 0.5 * ema["velocity"]["w"] + 0.5 * params["velocity"]["w"]
    assert torch.allclose(ema2["velocity"]["w"], want, rtol=0, atol=1e-7)
    params, state, ema, loss = step(params, state, ema2, batch, draws)
    assert torch.isfinite(loss) and int(state["count"]) == 2


def test_train_teacher_saves_loads_and_resumes(tmp_path):
    cfg = PT.TeacherTrainConfig(num_steps=3, batch_size=2, save_every=2)
    data = PDD.DummyDataConfig(batch_size=2, **DATA)
    rng = np.random.default_rng(0)

    def loader():
        while True:
            yield PDD.dummy_batch(rng, data)

    losses = []
    params, ema = PT.train_teacher(cfg, PCFG, data_iter=loader(), checkpoint_dir=str(tmp_path), log_every=1,
                                   device="cpu", on_step=lambda s, l: losses.append((s, float(l))))
    assert [s for s, _ in losses] == [0, 1, 2] and all(np.isfinite(l) for _, l in losses)
    path = str(tmp_path / "checkpoint_ema.npz")
    # the JAX package loads it, with its config from the metadata, and computes what the port computes
    jtree = jckpt.load_pytree(path)
    assert jcio.backbone_config_from_meta(jckpt.load_meta(path)) == TINY_BACKBONE
    ptree = params_from_jax(pckpt.load_pytree(path), backbone_config_from_meta(pckpt.load_meta(path)))
    for k, v in pckpt.flatten_pytree(ema).items():
        assert torch.equal(pckpt.flatten_pytree(ptree)[k], v), k  # decay 0 through step 101: EMA = params
        assert torch.equal(v, pckpt.flatten_pytree(params)[k]), k
    b = np_batch(7)
    mask = np.arange(24)[None] < b["latents_lengths"][:, None]
    ph_mask = np.arange(12)[None] < b["phonemes_lengths"][:, None]
    t = np.array([0.3, 0.8], np.float32)
    args = (b["latents"], b["ref_latents"], b["ref_latents_lengths"], mask, b["phonemes"], ph_mask, t)
    want = JBK.backbone_forward(jax.tree.map(jnp.asarray, jtree), TINY_BACKBONE, *args)
    assert rel_max(to_np(PBK.backbone_forward(ptree, PCFG, *map(T, args))), want) <= 1e-5
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in records] == [0, 1, 2] and records[0]["lr"] < 1e-9

    # resumed: the saved step (2) runs again, then step 3, from the saved state
    state = pckpt.load_train_state(str(tmp_path / "train_state.npz"))
    assert int(state["step"]) == 2 and int(state["opt_state"]["count"]) == 3
    losses.clear()
    PT.train_teacher(dataclasses.replace(cfg, num_steps=4, save_every=100), PCFG, data_iter=loader(),
                     checkpoint_dir=str(tmp_path), resume_from=str(tmp_path / "train_state.npz"), log_every=1,
                     device="cpu", on_step=lambda s, l: losses.append((s, float(l))))
    assert [s for s, _ in losses] == [2, 3]


def test_train_teacher_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.train_teacher(PT.TeacherTrainConfig(num_steps=1), PCFG)
    with pytest.raises(RuntimeError, match="CUDA"):  # the command line too
        PT.main(["--steps", "1", "--batch-size", "2", "--compute-dtype", "float32"])


def _sample_both(jp, tp, steps=4, dtype=None):
    """The JAX sampler and the port's on the same weights (cast to `dtype`
    on both sides where given) and inputs, with the JAX sampler's noise."""
    B, R, P, Tb = 2, 10, 12, 16
    rs = np.random.RandomState(6)
    ref = rs.randn(B, R, 64).astype(np.float32)
    ref_len = np.array([R, 6], np.int32)
    ph = rs.randint(1, 198, (B, P)).astype(np.int32)
    ph_len = np.array([9, P], np.int32)
    seq = np.array([Tb, 11], np.int32)
    key = jax.random.PRNGKey(9)
    j_ref, t_ref = jnp.asarray(ref), T(ref)
    if dtype is not None:
        from smalltts_tpu.ops.precision import cast_floats as j_cast_floats

        jp, tp = j_cast_floats(jp, jnp.bfloat16), cast_floats(tp, torch.bfloat16)
        j_ref, t_ref = j_ref.astype(jnp.bfloat16), t_ref.to(torch.bfloat16)
    want = j_make_sampler(TINY_BACKBONE, num_steps=steps)(jp, j_ref, ref_len, ph, ph_len, seq, key, t_bucket=Tb)
    noises, k = [], key  # the sampler's per-step draws, its key splits replicated
    for _ in range(steps):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, (B, Tb, 64), jnp.float32)))
    sample = make_teacher_sampler(PCFG, num_steps=steps)
    args = (tp, t_ref, T(ref_len), T(ph), T(ph_len), T(seq))
    return sample(*args, T(np.stack(noises)), Tb), np.asarray(want, np.float32), sample, args, noises, Tb


def test_teacher_sampler_matches_jax(weights):
    got, want, sample, args, noises, Tb = _sample_both(*weights)
    assert got.dtype == torch.float32 and rel_max(to_np(got), want) <= 1e-5
    assert float(got[1, 11:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="noises"):
        sample(*args, T(np.stack(noises[:3])), Tb)


def test_teacher_sampler_bf16_against_jax(weights):
    """bf16 params on both sides. The recurrence and the CFG combination are
    float32 in both; the port's denoiser runs in bf16 (the scan kernels'
    dtype) while the JAX one takes float32 activations from its float32
    x_t. Bound: 5e-2 rel-L2 over 32 steps (1.5e-2 measured on the CPU;
    1.6e-2 with the recurrence in bf16, so the denoiser's bf16 is most of it)."""
    got, want, *_ = _sample_both(*weights, steps=32, dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert rel_l2(to_np(got), want) <= 5e-2


def test_training_after_inference_mode_serving(weights, fwd_inputs):
    """The RoPE tables are cached on first use; made first under
    torch.inference_mode (as serving runs), they must still serve a later
    training step's backward."""
    from smalltts_tpu_torch.ops import rope

    _, tp = weights
    d = fwd_inputs
    rope.interleaved_cos_sin.cache_clear()
    rope.pair_cos_sin.cache_clear()
    args = [T(d[k]) for k in ("x", "ref", "ref_len", "mask", "ph", "ph_mask", "t")]
    with torch.inference_mode():
        PBK.backbone_forward(tp, PCFG, *args)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pckpt.flatten_pytree(tp).items()}
    v = PBK.backbone_forward(pckpt.unflatten_pytree(leaves), PCFG, *args)
    grads = torch.autograd.grad(v.square().sum(), list(leaves.values()))
    assert all(torch.isfinite(g).all() for g in grads)

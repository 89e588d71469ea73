"""The port's ASR and SV trainers (smalltts_tpu_torch/train/{asr_train,
sv_train}.py) against the JAX package's, on the CPU in fp32, with a tiny
ASR (16 heads of 4) and SV, tests/tiny.py's codec, the same weights (JAX
inits carried across by params_from_jax) and the same numpy batches; the SV
teacher is the fallback embedder with JAX's weight passed in (its own is a
torch.Generator's draw).

The steps run at the trainers' own schedules (AdamW, 4000 warmup steps
from 1e-6 of the peak), so two steps move the params by little, and the
Adam moments, which hold the gradients, are compared as well. Tolerances,
each relative to the JAX result: losses 1e-5; params and BatchNorm running
statistics after each step 1e-5 max-rel per leaf (to the leaf's largest
value), but a leaf the init set to zero (biases, norm shifts), whose values
are the AdamW updates alone, 1e-3 rel-L2: XLA's CPU pow of b2^count is an
ulp off PyTorch's, and the bias correction 1 / (1 - b2^count) magnifies
that to ~1e-4 of every update (more where a gradient is near Adam's eps);
the first moments 1e-4 rel-L2 per leaf (fp32 sums in another order, as
tests/test_torch_distill.py bounds gradients), the second 2e-4 (quadratic
in the gradient), but for leaves whose gradient is
zero but for rounding (the depthwise conv's bias, which the conformer's
BatchNorm removes: JAX's first moment under 1e-6 of the largest). The train_asr / train_sv runs (their own seeded inits) are
held to their saves: the checkpoint, read as train_distill reads it, equals
the params returned.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_CODEC  # noqa: E402

from smalltts_tpu.data import dummy as JDD  # noqa: E402
from smalltts_tpu.models import asr as JA  # noqa: E402
from smalltts_tpu.models import codec as JCo  # noqa: E402
from smalltts_tpu.models import conformer as JC  # noqa: E402
from smalltts_tpu.models import sv as JSV  # noqa: E402
from smalltts_tpu.train import asr_train as JAT  # noqa: E402
from smalltts_tpu.train import optim as JO  # noqa: E402
from smalltts_tpu.train import sv_train as JST  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu_torch.models import asr as PA  # noqa: E402
from smalltts_tpu_torch.models import codec as PCo  # noqa: E402
from smalltts_tpu_torch.models import conformer as PC  # noqa: E402
from smalltts_tpu_torch.models import sv as PSV  # noqa: E402
from smalltts_tpu_torch.train import asr_train as PAT  # noqa: E402
from smalltts_tpu_torch.train import optim as PO  # noqa: E402
from smalltts_tpu_torch.train import sv_train as PST  # noqa: E402
from smalltts_tpu_torch.train import utils as PTU  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax  # noqa: E402

J_ASR = JA.ASRConfig(input_dim=64, conformer=JC.ConformerConfig(input_dim=64, num_heads=16, ffn_dim=64, num_layers=2,
                                                                depthwise_conv_kernel_size=9))
J_SV = JSV.SVConfig(input_dim=64, emb_dim=8, channels=(24, 24, 24, 24, 72), attention_channels=8, res2net_scale=4,
                    se_channels=8)
DATA = JDD.DummyDataConfig(batch_size=2, max_phonemes=10, min_phonemes=4, max_latents=16, min_latents=8, max_ref=8,
                           min_ref=4)
TOL = 1e-5


def port_cfg(jcfg, module):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if "conformer" in d:
        d["conformer"] = PC.ConformerConfig(**dataclasses.asdict(d["conformer"]))
    return getattr(module, type(jcfg).__name__)(**d)


P_ASR, P_SV = port_cfg(J_ASR, PA), port_cfg(J_SV, PSV)
P_CODEC = PCo.CodecConfig(**dataclasses.asdict(TINY_CODEC))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


def flat_j(tree):
    return jckpt.flatten_pytree(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))


def flat_p(tree, cfg):
    return {k: v.detach().float().numpy() for k, v in pckpt.flatten_pytree(params_to_jax(tree, cfg)).items()}


def compare(port_tree, jax_tree, cfg, what, zero_init=()):
    """Leaves max-rel 1e-5; those in `zero_init` (the updates alone) 1e-3 rel-L2."""
    got, want = flat_p(port_tree, cfg), flat_j(jax_tree)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        err = rel_l2(got[k], want[k]) if k in zero_init else rel(got[k], want[k])
        assert err <= (1e-3 if k in zero_init else TOL), f"{what}: {k} error {err:.3e}"


def zero_leaves(jax_tree):
    return {k for k, v in flat_j(jax_tree).items() if v.size and not np.abs(v).max() > 0}


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: v for k, v in JDD.dummy_batch(rng, DATA).items() if k != "texts"} for _ in range(n)]


def port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_init(init, cfg, seed):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))


def test_asr_ctc_loss_matches_jax():
    jp = jax_init(JA.init_asr, J_ASR, 0)
    b = batches(1)[0]
    want, jnew = JAT.asr_ctc_loss(jp, J_ASR, b)
    got, pnew = PAT.asr_ctc_loss(params_from_jax(jp, P_ASR), P_ASR, port_batch(b))
    assert rel(got.detach(), want) <= TOL, (float(got), float(want))
    compare(pnew, jnew, P_ASR, "asr_ctc_loss new params (BatchNorm statistics moved)")  # no update: all at 1e-5
    moved = [k for k, v in flat_j(jnew).items() if k.endswith(("/mean", "/var")) and not np.array_equal(v, flat_j(jp)[k])]
    assert moved, "no BatchNorm statistic moved"


def _adam_state_j(state):
    """optax's multi_transform state -> (mu, nu) trees of the train branch."""
    def find(node):
        if hasattr(node, "mu"):
            return node
        if isinstance(node, tuple):
            return next((f for f in map(find, node) if f is not None), None)
        return None

    adam = find(state.inner_states["train"].inner_state)
    return adam.mu, adam.nu


def _check_moments(popt, jopt, cfg, what):
    """The port's Adam moments against optax's (the frozen statistics' are
    masked out of optax's state), each leaf with a gradient."""
    mu, nu = (flat_j(t) for t in _adam_state_j(jopt))
    got_mu, got_nu = flat_p(popt["mu"], cfg), flat_p(popt["nu"], cfg)
    top = max(float(np.abs(v).max()) for v in mu.values() if v.size)
    held = 0
    for k, m in mu.items():
        if not m.size or float(np.abs(m).max()) < 1e-6 * top:  # a frozen leaf, or a gradient of rounding only
            continue
        assert rel_l2(got_mu[k], m) <= 1e-4, f"{what} mu {k}: {rel_l2(got_mu[k], m):.3e}"
        # nu is quadratic in the gradient: twice its relative error
        assert rel_l2(got_nu[k], nu[k]) <= 2e-4, f"{what} nu {k}: {rel_l2(got_nu[k], nu[k]):.3e}"
        held += 1
    assert held > len(mu) // 2, (held, len(mu))


def test_two_asr_steps_match_jax():
    jp = jax_init(JA.init_asr, J_ASR, 1)
    tc = PAT.ASRTrainConfig()
    jtx, _ = JO.aux_optimizer(jp, tc.num_steps, tc.warmup)
    ptx, _ = PO.aux_optimizer(params_from_jax(jp, P_ASR), tc.num_steps, tc.warmup)
    jstep, pstep = JAT.make_asr_step(J_ASR, jtx), PAT.make_asr_step(P_ASR, ptx)
    jopt = jtx.init(jp)
    pp = params_from_jax(jp, P_ASR)
    popt = ptx.init(pp)
    zero = zero_leaves(jp)
    for i, b in enumerate(batches(2, seed=1)):
        jp, jopt, jl = jstep(jax.tree.map(jnp.asarray, jp), jopt, jax.tree.map(jnp.asarray, b))
        pp, popt, pl = pstep(pp, popt, port_batch(b))
        assert rel(pl, jl) <= TOL, (i, float(pl), float(jl))
        compare(pp, jp, P_ASR, f"asr step {i}: params and BatchNorm statistics", zero)
    _check_moments(popt, jopt, P_ASR, "asr")


def _sv_setup(seed):
    jp = jax_init(JSV.init_sv, J_SV, seed)
    jcodec = jax.tree.map(np.asarray, JCo.init_codec(jax.random.PRNGKey(seed + 1), TINY_CODEC))
    jteach, jtp = JST.make_fallback_teacher(J_SV.emb_dim)
    pteach, ptp = PST.make_fallback_teacher(P_SV.emb_dim)
    assert ptp["w"].shape == jtp["w"].shape  # the JAX package's (k, 1, emb) layout
    return jp, jcodec, (jteach, jtp), (pteach, {"w": torch.from_numpy(np.array(jtp["w"]))})


@pytest.mark.parametrize("nan_row", [False, True], ids=["finite", "nan_teacher_row"])
def test_two_sv_steps_match_jax(nan_row):
    """Two make_sv_step steps (codec decode, fallback teacher, clip 5); with
    nan_row the teacher's embedding of row 0 is NaN in both: that row
    leaves the loss, the other row's loss and update stay."""
    jp, jcodec, (jteach, jtp), (pteach, ptp) = _sv_setup(2)
    if nan_row:
        jteach_fn, pteach_fn = (lambda tp, a, lengths=None: jteach(tp, a, lengths).at[0].set(jnp.nan),
                                lambda tp, a, lengths=None: pteach(tp, a, lengths).index_fill(0, torch.tensor([0]),
                                                                                            float("nan")))
    else:
        jteach_fn, pteach_fn = jteach, pteach
    tc = PST.SVTrainConfig()
    jtx, _ = JO.aux_optimizer(jp, tc.num_steps, 4_000, clip_norm=tc.grad_clip)
    ptx, _ = PO.aux_optimizer(params_from_jax(jp, P_SV), tc.num_steps, 4_000, clip_norm=tc.grad_clip)
    jstep, pstep = JST.make_sv_step(J_SV, TINY_CODEC, jtx, jteach_fn), PST.make_sv_step(P_SV, P_CODEC, ptx, pteach_fn)
    jopt = jtx.init(jp)
    pp, pcodec = params_from_jax(jp, P_SV), params_from_jax(jcodec, P_CODEC)
    popt = ptx.init(pp)
    zero = zero_leaves(jp)
    for i, b in enumerate(batches(2, seed=2)):
        jp, jopt, jl = jstep(jax.tree.map(jnp.asarray, jp), jopt, jcodec, jtp, jax.tree.map(jnp.asarray, b))
        pp, popt, pl = pstep(pp, popt, pcodec, ptp, port_batch(b))
        assert np.isfinite(float(pl)) and rel(pl, jl) <= TOL, (i, float(pl), float(jl))
        compare(pp, jp, P_SV, f"sv step {i}: params and BatchNorm statistics", zero)
    _check_moments(popt, jopt, P_SV, "sv")


def test_fallback_teacher_matches_jax_with_its_weight():
    rs = np.random.RandomState(3)
    audio = (0.3 * rs.randn(2, 1, 3200 * 6)).astype(np.float32)
    lengths = np.array([3200 * 6, 3200 * 2], np.int32)
    jteach, jtp = JST.make_fallback_teacher(16)
    pteach, ptp = PST.make_fallback_teacher(16)
    assert ptp["w"].dtype == torch.float32 and abs(float(ptp["w"].std()) * 16 - 1) < 0.1  # N(0, 1) / 16
    w = {"w": torch.from_numpy(np.array(jtp["w"]))}
    for ln in (None, lengths):
        want = jteach(jtp, audio, None if ln is None else jnp.asarray(ln))
        got = pteach(w, torch.from_numpy(audio), None if ln is None else torch.from_numpy(ln))
        assert rel(got, want) <= TOL


def test_train_asr_and_train_sv_save_what_train_distill_loads(tmp_path):
    asr = PAT.train_asr(PAT.ASRTrainConfig(num_steps=3, save_every=2), P_ASR, checkpoint_dir=str(tmp_path / "asr"),
                        device="cpu", data_iter=iter(batches(3, seed=4)), log_every=1)
    sv = PST.train_sv(PST.SVTrainConfig(num_steps=3, save_every=2), P_SV, P_CODEC, checkpoint_dir=str(tmp_path / "sv"),
                      device="cpu", data_iter=iter(batches(3, seed=5)), log_every=1)
    for tree, cfg, name in ((asr, P_ASR, "asr"), (sv, P_SV, "sv")):
        path = tmp_path / name / "checkpoint_latest.npz"
        back = pckpt.flatten_pytree(params_from_jax(pckpt.load_pytree(str(path)), cfg))  # as train_distill loads it
        want = pckpt.flatten_pytree(tree)
        assert back.keys() == want.keys() and all(torch.equal(back[k], want[k]) for k in want), name
        jtree = jckpt.load_pytree(str(path))  # and the JAX package reads it as its own
        assert set(jckpt.flatten_pytree(jtree)) == set(flat_p(tree, cfg))
    init = PA.init_asr(torch.Generator().manual_seed(0), P_ASR)
    assert any(not torch.equal(a, b) for a, b in zip(pckpt.flatten_pytree(init).values(),
                                                     pckpt.flatten_pytree(asr).values()))


def test_train_utils_shim():
    lengths = torch.tensor([3, 5])
    assert torch.equal(PTU.get_mask(lengths, 6), torch.arange(6)[None] < lengths[:, None])
    gen = torch.Generator().manual_seed(0)
    m = PTU.get_random_cond(gen, torch.tensor([10, 8]), 12)
    assert m.shape == (2, 12) and m.dtype == torch.bool
    assert all(int(r.sum()) < n // 2 + 1 for r, n in zip(m, (10, 8)))
    for name in ("apply_noise", "get_alpha_sigma", "length_mask", "masked_mse", "x_pred_from_velocity"):
        assert callable(getattr(PTU, name))

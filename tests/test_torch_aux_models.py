"""The distiller's loss models and layers in the port (ops/nn.py's
batchnorm/groupnorm/embedding, ops/losses.py, models/{conformer,
discriminator,asr,sv}.py, the D = 4 attention, utils/convert.py for their
trees) against the JAX package's, on the CPU in fp32, with the same weights
(the JAX init carried across by params_from_jax) and the same numpy inputs.

Tolerances, each relative to the largest value of the JAX result: forwards,
new BatchNorm stats and input gradients 1e-5 (fp32 sums in another order);
ctc_loss against optax.ctc_loss 1e-5 in value and gradient, also on a
sample with no alignment, whose loss is ~1e5 (a float32 ulp there is
0.0078, so its values are compared relative to themselves at 1e-6)."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, "tests")
from smalltts_tpu.models import asr as JA  # noqa: E402
from smalltts_tpu.models import conformer as JC  # noqa: E402
from smalltts_tpu.models import discriminator as JDi  # noqa: E402
from smalltts_tpu.models import sv as JSV  # noqa: E402
from smalltts_tpu.ops import losses as JL  # noqa: E402
from smalltts_tpu.ops import nn as jnn  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu_torch.models import asr as PA  # noqa: E402
from smalltts_tpu_torch.models import conformer as PC  # noqa: E402
from smalltts_tpu_torch.models import discriminator as PDi  # noqa: E402
from smalltts_tpu_torch.models import sv as PSV  # noqa: E402
from smalltts_tpu_torch.ops import losses as PL  # noqa: E402
from smalltts_tpu_torch.ops import nn  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax  # noqa: E402

T = torch.from_numpy
TINY_CONF = dict(num_heads=4, ffn_dim=64, num_layers=2)
J_DISC = JDi.DiscriminatorConfig(latent_dim=64, transformer_dim=64, ref_dim=64, model_dim=32, num_tail_layers=2,
                                 conformer=JC.ConformerConfig(input_dim=32, depthwise_conv_kernel_size=7,
                                                              use_group_norm=True, **TINY_CONF))
J_ASR64 = JA.ASRConfig(input_dim=64, conformer=JC.ConformerConfig(input_dim=64, depthwise_conv_kernel_size=9,
                                                                  **TINY_CONF))
# the full ASR's 16 heads of 4: head dim 4, the attention kernel's new path
J_ASR_D4 = JA.ASRConfig(input_dim=64, conformer=JC.ConformerConfig(input_dim=64, num_heads=16, ffn_dim=64,
                                                                   num_layers=2, depthwise_conv_kernel_size=9))
J_SV64 = JSV.SVConfig(input_dim=64, emb_dim=8, channels=(24, 24, 24, 24, 72), attention_channels=8,
                      res2net_scale=4, se_channels=8)


def port_cfg(jcfg, module):
    """The port's config of the same values: the JAX dataclass's fields,
    nested conformer configs included."""
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if "conformer" in d:
        d["conformer"] = PC.ConformerConfig(**dataclasses.asdict(d["conformer"]))
    return getattr(module, type(jcfg).__name__)(**d)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def compare_trees(port_tree, jax_tree, cfg, tol):
    got = pckpt.flatten_pytree(params_to_jax(port_tree, cfg))
    want = jckpt.flatten_pytree(np_tree(jax_tree))
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert rel(to_np(got[k]), want[k]) <= tol, k


def lengths_mask(lengths, n):
    return np.arange(n)[None] < np.asarray(lengths)[:, None]


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("mode", ["train_masked", "train", "eval"])
def test_batchnorm_matches_jax(mode):
    rs = np.random.RandomState(0)
    x = (2.0 * rs.randn(3, 7, 5) + 1.0).astype(np.float32)
    mask = lengths_mask([7, 4, 1], 7) if mode == "train_masked" else None
    jp = jax.tree.map(np.asarray, jnn.init_batchnorm(5))
    jp["mean"], jp["var"] = rs.randn(5).astype(np.float32), (rs.rand(5) + 0.5).astype(np.float32)
    jp["scale"], jp["bias"] = rs.randn(5).astype(np.float32), rs.randn(5).astype(np.float32)
    train = mode != "eval"
    jy, jnew = jnn.batchnorm(jp, x, train, mask)
    py, pnew = nn.batchnorm({k: T(v) for k, v in jp.items()}, T(x), train, None if mask is None else T(mask))
    assert rel(to_np(py), jy) <= 1e-5
    for k in ("mean", "var", "scale", "bias"):
        assert rel(to_np(pnew[k]), jnew[k]) <= 1e-5, k
    if train:  # the running variance tracks the biased batch variance
        xs = x[mask] if mask is not None else x.reshape(-1, 5)
        assert np.allclose(to_np(pnew["var"]), 0.9 * jp["var"] + 0.1 * xs.var(axis=0), rtol=1e-5)
    init = nn.init_batchnorm(5)
    assert init["mean"].dtype == init["var"].dtype == torch.float32 and float(init["var"].sum()) == 5.0


def test_groupnorm_embedding_and_cosine_loss():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 8).astype(np.float32)
    scale, bias = rs.randn(8).astype(np.float32), rs.randn(8).astype(np.float32)
    mask = lengths_mask([9, 5], 9)
    for groups in (1, 2):
        for m in (None, mask):
            want = jnn.groupnorm(scale, bias, x, num_groups=groups, mask=m)
            got = nn.groupnorm(T(scale), T(bias), T(x), num_groups=groups, mask=None if m is None else T(m))
            assert rel(to_np(got), want) <= 1e-5, (groups, m is None)
    emb = {"w": rs.randn(11, 4).astype(np.float32)}
    ids = rs.randint(0, 11, (2, 6)).astype(np.int32)
    assert np.array_equal(to_np(nn.embedding({"w": T(emb["w"])}, T(ids))), np.asarray(jnn.embedding(emb, ids)))
    a, b = rs.randn(3, 8).astype(np.float32), rs.randn(3, 8).astype(np.float32)
    b[2] = 0.0  # the 1e-8 norm guard
    assert rel(to_np(PL.cosine_loss(T(a), T(b))), JL.cosine_loss(a, b)) <= 1e-6
    assert nn.mask_value(torch.float32) == jnn.mask_value(jnp.float32)
    assert nn.mask_value(torch.bfloat16) == jnn.mask_value(jnp.bfloat16)


CTC_CASES = {
    # (frames valid per sample, labels per sample, labels with repeats)
    "feasible": ([20, 14, 9], [5, 3, 4], False),
    "repeats": ([20, 14, 9], [5, 3, 4], True),
    "infeasible": ([20, 3, 5], [5, 4, 5], True),  # 3 frames for 4 labels; 5 frames for 5 labels with repeats
    # 384 label positions (the serving contract's phoneme bucket), most past the label count, where they
    # still run through the recurrence (optax pads only at the final gather)
    "n384": ([64, 50], [40, 20], True),
    # padded frames inside a feasible sample (and at the start of another): they keep the states
    "padded_inside": ([20, 20, 9], [5, 3, 4], False),
    # the boundaries the kernels branch on: one label position; 33 positions, most past the count; no
    # label in any sample (the loss reads phi[0]); one frame; a sample with every frame padded
    "n1": ([20, 14, 9], [1, 0, 1], False),
    "n33": ([40, 30, 25], [12, 5, 20], False),
    "no_labels": ([20, 14, 9], [0, 0, 0], False),
    "t1": ([1, 1, 1], [1, 0, 2], False),
    "all_padded": ([20, 0, 9], [5, 3, 4], False),
}
# (B, T, K, N) of each case
CTC_SHAPES = {"n384": (2, 64, 400, 384), "n1": (3, 20, 9, 1), "n33": (3, 40, 9, 33), "t1": (3, 1, 9, 5)}


@pytest.mark.parametrize("case", list(CTC_CASES))
def test_ctc_loss_matches_optax(case):
    frames, labs, repeats = CTC_CASES[case]
    rs = np.random.RandomState(len(case))
    B, Tn, K, N = CTC_SHAPES.get(case, (3, 20, 9, 5))
    logits = rs.randn(B, Tn, K).astype(np.float32)
    labels = rs.randint(1, K, (B, N)).astype(np.int32)
    if repeats:
        labels[:, 1] = labels[:, 0]
        labels[0, 3] = labels[0, 2]
    label_pad = 1.0 - lengths_mask(labs, N).astype(np.float32)
    labels = np.where(label_pad > 0, 0, labels).astype(np.int32)
    logit_pad = 1.0 - lengths_mask(frames, Tn).astype(np.float32)
    if case == "padded_inside":
        logit_pad[0, 6:9] = 1.0
        logit_pad[1, :4] = 1.0

    def jloss(x):
        return optax.ctc_loss(x, logit_pad, labels, label_pad)

    want = np.asarray(jloss(logits))
    want_g = np.asarray(jax.grad(lambda x: (jloss(x) * jnp.arange(1, B + 1)).sum())(logits))
    x = T(logits).requires_grad_(True)
    got = PL.ctc_loss(x, T(logit_pad), T(labels), T(label_pad))
    (got * torch.arange(1, B + 1)).sum().backward()
    assert np.all(np.isfinite(to_np(got))) and np.all(np.isfinite(to_np(x.grad)))
    assert np.allclose(to_np(got), want, rtol=1e-6, atol=1e-5), (to_np(got), want)
    assert rel(to_np(x.grad), want_g) <= 1e-5
    if case == "infeasible":  # finite, of the order of 1e5, where F.ctc_loss gives inf
        assert want[1] > 5e4 and want[2] > 5e4 and float(got[1].detach()) > 5e4
        lp = torch.log_softmax(T(logits), -1).transpose(0, 1)
        torch_ctc = torch.nn.functional.ctc_loss(lp, T(labels).long(), torch.tensor(frames), torch.tensor(labs),
                                                 reduction="none")
        assert not torch.isfinite(torch_ctc[1])
    # the input may be log-probs already: log_softmax is idempotent on them
    lp = torch.log_softmax(T(logits), -1)
    again = PL.ctc_loss(lp, T(logit_pad), T(labels), T(label_pad))
    assert np.allclose(to_np(again), want, rtol=1e-6, atol=1e-5)


def test_sdpa_head_dim_4_with_a_key_mask():
    rs = np.random.RandomState(2)
    B, H, Tq, S, D = 2, 16, 24, 24, 4
    q, k, v = (rs.randn(B, H, n, D).astype(np.float32) for n in (Tq, S, S))
    mask = lengths_mask([S, 9], S)
    want = jnn.sdpa(q, k, v, key_mask=mask)
    assert rel(to_np(nn.sdpa(T(q), T(k), T(v), key_mask=T(mask))), want) <= 1e-5
    jg = jax.grad(lambda a: (jnn.sdpa(a, k, v, key_mask=mask) ** 2).sum())(q)
    qt = T(q).requires_grad_(True)
    (nn.sdpa(qt, T(k), T(v), key_mask=T(mask)) ** 2).sum().backward()
    assert rel(to_np(qt.grad), jg) <= 1e-5


# ------------------------------------------------------------------ models


def _grad_check(jfn, pfn, x, tol=1e-5):
    """The forward and the gradient of sum(out * w) w.r.t. x, JAX against the port."""
    jout = jfn(x)
    w = np.random.RandomState(9).randn(*np.shape(jout)).astype(np.float32)
    jg = jax.grad(lambda a: (jfn(a) * w).sum())(x)
    xt = T(x).requires_grad_(True)
    pout = pfn(xt)
    (pout * T(w)).sum().backward()
    assert rel(to_np(pout), jout) <= tol
    assert rel(to_np(xt.grad), jg) <= tol
    return pout


@pytest.mark.parametrize("norm", ["groupnorm", "batchnorm"])
@pytest.mark.parametrize("pad_invariant", [True, False])
def test_conformer_matches_jax(norm, pad_invariant):
    jcfg = JC.ConformerConfig(input_dim=32, num_heads=4, ffn_dim=48, num_layers=2, depthwise_conv_kernel_size=7,
                              use_group_norm=norm == "groupnorm", pad_invariant=pad_invariant)
    pcfg = PC.ConformerConfig(**dataclasses.asdict(jcfg))
    jp = JC.init_conformer(jax.random.PRNGKey(3), jcfg)
    # a bare conformer tree converts as the ASR's conformer subtree
    tp = params_from_jax(np_tree({"conformer": jp}), port_cfg(JA.ASRConfig(input_dim=32, conformer=jcfg), PA))
    tp = tp["conformer"]
    rs = np.random.RandomState(4)
    x = rs.randn(2, 15, 32).astype(np.float32)
    mask = lengths_mask([15, 8], 15)
    train = norm == "batchnorm"
    _grad_check(lambda a: JC.conformer(jp, jcfg, a, mask, train)[0],
                lambda a: PC.conformer(tp, pcfg, a, T(mask), train)[0], x)
    _, jnew = JC.conformer(jp, jcfg, x, mask, train)
    _, pnew = PC.conformer(tp, pcfg, T(x), T(mask), train)
    for jl, pl in zip(jnew["layers"], pnew["layers"]):
        if train:
            for k in ("mean", "var"):
                assert rel(to_np(pl["conv"]["bn"][k]), jl["conv"]["bn"][k]) <= 1e-5, k
                assert not pl["conv"]["bn"][k].requires_grad


def test_discriminator_forward_matches_jax():
    pcfg = port_cfg(J_DISC, PDi)
    jp = JDi.init_discriminator(jax.random.PRNGKey(5), J_DISC)
    tp = params_from_jax(np_tree(jp), pcfg)
    rs = np.random.RandomState(6)
    B, L, Tn, R, P = 2, 3, 12, 6, 7
    feats = rs.randn(B, L, Tn, 64).astype(np.float32)
    noised = rs.randn(B, Tn, 64).astype(np.float32)
    ref_seq = rs.randn(B, R, 64).astype(np.float32)
    ref_mask, mask = lengths_mask([R, 3], R), lengths_mask([Tn, 7], Tn)
    ph = np.where(lengths_mask([P, 4], P), rs.randint(1, 198, (B, P)), 0).astype(np.int32)
    t = rs.rand(B).astype(np.float32)
    args = lambda f: (ref_seq, ref_mask, mask, ph, t) if f is None else tuple(map(f, (ref_seq, ref_mask, mask, ph, t)))  # noqa: E731
    # the student's gradient path: through the noised latents (x_t), and through the features
    _grad_check(lambda a: JDi.discriminator_forward(jp, J_DISC, feats, a, *args(None), train=True)[0],
                lambda a: PDi.discriminator_forward(tp, pcfg, T(feats), a, *args(T), train=True)[0], noised)
    _grad_check(lambda a: JDi.discriminator_forward(jp, J_DISC, a, noised, *args(None), train=True)[0],
                lambda a: PDi.discriminator_forward(tp, pcfg, a, T(noised), *args(T), train=True)[0], feats)


@pytest.mark.parametrize("jcfg", [J_ASR64, J_ASR_D4], ids=["heads4x16", "heads16x4"])
def test_asr_forward_matches_jax(jcfg):
    pcfg = port_cfg(jcfg, PA)
    jp = JA.init_asr(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(np_tree(jp), pcfg)
    assert tuple(tp["upsample"]["w"].shape) == (4, 1, 64)  # the upsample kernel is not transposed
    rs = np.random.RandomState(8)
    x = rs.randn(2, 10, 64).astype(np.float32)
    lengths = np.array([10, 6], np.int32)
    _grad_check(lambda a: JA.asr_forward(jp, jcfg, a, lengths)[0],
                lambda a: PA.asr_forward(tp, pcfg, a, T(lengths))[0], x)
    _, jlen, jnew = JA.asr_forward(jp, jcfg, x, lengths, train=True)
    _, plen, pnew = PA.asr_forward(tp, pcfg, T(x), T(lengths), train=True)
    assert np.array_equal(to_np(plen), np.asarray(jlen))
    compare_trees(pnew, jnew, pcfg, 1e-5)


@pytest.mark.parametrize("attn_bn", [False, True], ids=["plain", "attn_tdnn_bn"])
def test_sv_forward_matches_jax(attn_bn):
    pcfg = port_cfg(J_SV64, PSV)
    jp = np_tree(JSV.init_sv(jax.random.PRNGKey(9), J_SV64))
    rs = np.random.RandomState(10)
    if attn_bn:  # a converted checkpoint's attention TDNN BatchNorm, with non-trivial stats
        bn = np_tree(jnn.init_batchnorm(J_SV64.attention_channels))
        bn["mean"] = rs.randn(J_SV64.attention_channels).astype(np.float32)
        bn["var"] = (rs.rand(J_SV64.attention_channels) + 0.5).astype(np.float32)
        jp["asp"]["attn_tdnn_bn"] = bn
    tp = params_from_jax(jp, pcfg)
    x = rs.randn(2, 14, 64).astype(np.float32)
    lengths = np.array([14, 9], np.int32)
    _grad_check(lambda a: JSV.sv_forward(jp, J_SV64, a, lengths)[0],
                lambda a: PSV.sv_forward(tp, pcfg, a, T(lengths))[0], x)
    _, jnew = JSV.sv_forward(jp, J_SV64, x, lengths, train=True)
    _, pnew = PSV.sv_forward(tp, pcfg, T(x), T(lengths), train=True)
    compare_trees(pnew, jnew, pcfg, 1e-5)


# ------------------------------------------------------------- conversion


@pytest.mark.parametrize("model", ["disc", "asr", "sv"])
def test_conversion_round_trip_transposes_exactly_the_conv_leaves(model):
    jcfg, init, module = {"disc": (J_DISC, JDi.init_discriminator, PDi), "asr": (J_ASR_D4, JA.init_asr, PA),
                          "sv": (J_SV64, JSV.init_sv, PSV)}[model]
    pcfg = port_cfg(jcfg, module)
    jp = np_tree(init(jax.random.PRNGKey(11), jcfg))
    tp = params_from_jax(jp, pcfg)
    back = pckpt.flatten_pytree(params_to_jax(tp, pcfg))
    flat_j = jckpt.flatten_pytree(jp)
    assert set(back) == set(flat_j)
    for k, v in flat_j.items():
        assert back[k].dtype == torch.float32 and np.array_equal(to_np(back[k]), v), k
    # the port's own init has the layout the conversion gives
    own = pckpt.flatten_pytree(getattr(module, f"init_{'discriminator' if model == 'disc' else model}")(
        torch.Generator().manual_seed(0), pcfg))
    flat_t = pckpt.flatten_pytree(tp)
    assert set(own) == set(flat_t)
    for k in own:
        assert own[k].shape == flat_t[k].shape and own[k].dtype == flat_t[k].dtype, k
    # a (k, c_in, c_out) conv kernel comes over as (c_out, c_in, k); every other 3-D leaf (the ASR's
    # upsample kernel) as it is. A kernel with k == c_out (the disc's 1x1 `out` to one channel) reads the same.
    convs = {"disc": {"out/w"} | {f"enc/layers#{i}/conv/{c}/w" for i in range(2) for c in ("pw1", "dw", "pw2")},
             "asr": {f"conformer/layers#{i}/conv/{c}/w" for i in range(2) for c in ("pw1", "dw", "pw2")},
             "sv": {k for k in flat_j if np.ndim(flat_j[k]) == 3}}[model]
    assert model != "sv" or {"fc/w", "asp/attn1/w", "blocks#0/res2net#0/conv/w", "blocks#2/se2/w"} <= convs
    for k, v in flat_j.items():
        if np.ndim(v) == 3 and v.shape[0] != v.shape[2]:
            want = tuple(reversed(v.shape)) if k in convs else v.shape
            assert tuple(flat_t[k].shape) == want, k
            assert np.array_equal(to_np(flat_t[k]), v.transpose(2, 1, 0) if k in convs else v), k

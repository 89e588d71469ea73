"""The adaLN, q/k norm and gated-residual arithmetic of the port's DiT scan
(smalltts_tpu_torch/ops/kernels/dit_block.py) on the CPU, against the JAX
package's bf16 path (`_apply_adaln_zero`, `_self_qkv_gate`, `_ff`,
`_block_core`'s residual) at the model's width, 960; and the bf16 sigmoid,
mish, encoder attention gate and DiT attention gate, bit for bit against
the JAX functions under jax.jit.

In bf16 the JAX path rounds after every op; the port's plain versions, which
the card's kernels are held to bit for bit, round at the same points. The
products go through an identity weight where the point is the rounding
(the fp32 sum of one nonzero term is exact, so no sum order enters), and the
results must be bit-equal on >= 99.99% of elements and, on the rest,
within one bf16 ulp of the larger of the result and the term before the
last op (n * (1 + scale) for the adaLN, where + shift may cancel it): the
rest is the fp32 sum order of the row mean and variance (and of the q/k sum
of squares), which flips a rounding now and then. In fp32 each form is held
to 1e-5 relative with random weights.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from smalltts_tpu.models import dit as JD  # noqa: E402
from smalltts_tpu.models import encoder as JE  # noqa: E402
from smalltts_tpu.models.style_encoder import STYLE_ENCODER_CONFIG  # noqa: E402
from smalltts_tpu.models.text_encoder import TEXT_ENCODER_CONFIG  # noqa: E402
from smalltts_tpu.ops import nn as JN  # noqa: E402
from smalltts_tpu_torch.models import dit as PD  # noqa: E402
from smalltts_tpu_torch.models import encoder as PE  # noqa: E402
from smalltts_tpu_torch.ops import nn as PN  # noqa: E402
from smalltts_tpu_torch.ops.kernels import attention as A  # noqa: E402
from smalltts_tpu_torch.ops.kernels import dit_block as K  # noqa: E402

CFG = JD.DiTConfig()
PCFG = PD.DiTConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(PD.DiTConfig)})
H = CFG.hidden_dim
B, T = 2, 20
BIT_EQUAL = 0.9999


def to_jax(a, jd):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jd)


def to_torch(a, td):
    return torch.from_numpy(np.array(a, np.float32)).to(td)


def to_np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32), np.float64)


def assert_rounds_like(got, want, before=None):
    """>= 99.99% bit-equal, the rest within one bf16 ulp of the larger of
    |want| and |before|, the term before the last op."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    mag = np.abs(want) if before is None else np.maximum(np.abs(want), np.abs(to_np(before)))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all(), float((np.abs(got - want) / ulp).max())
    assert (got == want).mean() >= BIT_EQUAL, (got == want).mean()


def assert_rel(got, want, tol=1e-5):
    got, want = to_np(got), to_np(want)
    assert np.abs(got - want).max() / np.abs(want).max() < tol


def inputs(seed, dtype):
    """x (B, T, H) ~ N(0, 4), a modulation (B, 6H) ~ N(0, 0.25), as numpy."""
    rs = np.random.RandomState(seed)
    return (2.0 * rs.randn(B, T, H)).astype(np.float32), (0.5 * rs.randn(B, 6 * H)).astype(np.float32), rs


@pytest.mark.parametrize("B_,T_,H_", [(2, 20, 960), (8, 40, 960), (3, 16, 240)])
def test_adaln_bf16_rounds_where_jax_rounds(B_, T_, H_):
    """nn.layernorm_noaffine(x) * (1 + scale) + shift in bf16: the normalized
    value, 1 + scale, the product and the sum each rounded. One rounding of
    the fp32 expression differs on ~40% of elements."""
    rs = np.random.RandomState(B_ + H_)
    x, mod = (2.0 * rs.randn(B_, T_, H_)).astype(np.float32), (0.5 * rs.randn(B_, 6 * H_)).astype(np.float32)
    want = JD._apply_adaln_zero(to_jax(mod, jnp.bfloat16), to_jax(x, jnp.bfloat16))[0]
    xt, mt = to_torch(x, torch.bfloat16), to_torch(mod, torch.bfloat16)
    got = K.adaln_modulate_plain(xt, mt[:, :H_], mt[:, H_:2 * H_])
    assert got.dtype == torch.bfloat16
    assert_rounds_like(got, want, before=to_np(want) - to_np(mt[:, None, :H_]))


def qkvg_weights(rs, identity):
    """The qkvg leaf, the q/k norm scales: [I | I | I | I] or random."""
    w = np.tile(np.eye(H, dtype=np.float32), (1, 4)) if identity else \
        (rs.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    return w, (0.1 * rs.randn(4 * H)).astype(np.float32), (1 + 0.2 * rs.randn(2, CFG.heads, CFG.head_dim)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_qkvg_plain_matches_jax(dtype):
    """The adaLN, then the qkvg product and the q/k RMSNorm and RoPE
    against `_apply_adaln_zero` then `_self_qkv_gate`: bf16 on an identity
    weight, fp32 on a random one."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    x, mod, rs = inputs(1, np.float32)
    w, b, nsc = qkvg_weights(rs, identity=dtype == "bf16")
    blk = {"qkvg": {"w": to_jax(w, jd), "b": to_jax(b, jd)}, "q_norm": {"scale": to_jax(nsc[0], jd)},
           "k_norm": {"scale": to_jax(nsc[1], jd)}}
    norm = JD._apply_adaln_zero(to_jax(mod, jd), to_jax(x, jd))[0]
    q, k, v, gate = JD._self_qkv_gate(blk, CFG, norm, JD._rope_slice(CFG, T))
    xt, mt = to_torch(x, td), to_torch(mod, td)
    cos, sin = PD.rope_cos_sin(PCFG, T, "cpu")
    h = K.adaln_modulate_plain(xt, mt[:, :H], mt[:, H:2 * H])
    got = K.qk_norm_rope_plain(K.gemm_bias_plain(h, to_torch(w, td), to_torch(b, td)), to_torch(nsc[0], td),
                               to_torch(nsc[1], td), cos, sin)
    assert got.shape == (B, T, 4 * H) and got.dtype == td
    check = assert_rounds_like if dtype == "bf16" else assert_rel
    for i, want in enumerate((q, k, v)):
        check(got[..., i * H:(i + 1) * H].unflatten(-1, (CFG.heads, CFG.head_dim)).transpose(1, 2), want)
    check(got[..., 3 * H:], gate)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_swiglu_plain_matches_jax(dtype):
    """The adaLN with shift/scale_mlp, then the w13 form, against
    `_block_core`'s norm2 and silu(a) * b of `_ff`: bf16 on [I | I], fp32 on
    a random weight."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    x, mod, rs = inputs(2, np.float32)
    w = np.tile(np.eye(H, dtype=np.float32), (1, 2)) if dtype == "bf16" else \
        (rs.randn(H, 2 * H) / np.sqrt(H)).astype(np.float32)
    b = (0.1 * rs.randn(2 * H)).astype(np.float32)
    xj = to_jax(x, jd)
    _, _, shift, scale, _ = JD._apply_adaln_zero(to_jax(mod, jd), xj)
    norm = JN.layernorm_noaffine(xj) * (1 + scale[:, None]) + shift[:, None]  # _block_core's norm2
    ab = JN.linear({"w": to_jax(w, jd), "b": to_jax(b, jd)}, norm)
    a_, b_ = jnp.split(ab, 2, axis=-1)
    want = jax.nn.silu(a_) * b_
    xt, mt = to_torch(x, td), to_torch(mod, td)
    h = K.adaln_modulate_plain(xt, mt[:, 3 * H:4 * H], mt[:, 4 * H:5 * H])
    got = K.gemm_swiglu_plain(h, to_torch(w, td), to_torch(b, td))
    assert got.shape == (B, T, H) and got.dtype == td
    (assert_rounds_like if dtype == "bf16" else assert_rel)(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_gated_residual_bf16_rounds_where_jax_rounds(masked):
    """x + tanh(gate) * y (with y zeroed on masked rows, as `_attend` does)
    in bf16 on an identity weight: bit-equal to the JAX expression."""
    x, mod, rs = inputs(3, np.float32)
    a = rs.randn(B, T, H).astype(np.float32)
    mask = np.arange(T)[None] < np.array([T, 7])[:, None]
    gate = mod[:, 2 * H:3 * H]
    y = JN.linear({"w": to_jax(np.eye(H), jnp.bfloat16)}, to_jax(a, jnp.bfloat16))
    if masked:
        y = jnp.where(jnp.asarray(mask)[..., None], y, 0.0)
    want = to_jax(x, jnp.bfloat16) + jnp.tanh(to_jax(gate, jnp.bfloat16))[:, None] * y
    xt = to_torch(x, torch.bfloat16)
    K.gemm_residual_plain(to_torch(a, torch.bfloat16), to_torch(np.eye(H), torch.bfloat16), None, xt,
                          to_torch(gate, torch.bfloat16), torch.from_numpy(mask) if masked else None)
    assert np.array_equal(to_np(xt), to_np(want))


def bf16_pair(seed, shape=(8, 40, H)):
    """x ~ N(0, 4) in bf16, as a torch tensor and a JAX array of the same bits."""
    x = (2.0 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)
    return to_torch(x, torch.bfloat16), to_jax(x, jnp.bfloat16)


def test_sigmoid_bf16_bit_equal_to_jax():
    """nn.sigmoid's op chain is jax.nn.sigmoid in bf16; torch.sigmoid, which
    rounds once, differs on about a third of the elements."""
    xt, xj = bf16_pair(4)
    want = to_np(jax.jit(jax.nn.sigmoid)(xj))
    assert np.array_equal(to_np(PN.sigmoid(xt)), want)
    assert not np.array_equal(to_np(torch.sigmoid(xt)), want)


def test_mish_bf16_bit_equal_to_jax():
    """nn.mish (softplus as logaddexp(x, 0), each op rounded) is the JAX
    package's mish in bf16; F.softplus, which rounds once, is not."""
    xt, xj = bf16_pair(5)
    want = to_np(jax.jit(JN.mish)(xj))
    assert np.array_equal(to_np(PN.mish(xt)), want)
    assert not np.array_equal(to_np(xt * torch.tanh(torch.nn.functional.softplus(xt))), want)


@pytest.mark.parametrize("ecfg", [TEXT_ENCODER_CONFIG, STYLE_ENCODER_CONFIG], ids=["text", "style"])
def test_encoder_attention_gate_bf16_bit_equal_to_jax(ecfg):
    """The encoder's self-attention in bf16 at its own width (512): one token
    a row, so the softmax is exactly 1 and the attention output is v; wv and
    wo are identities and the gate weight a permutation, so every product is
    exact and what remains is out * sigmoid(gate)'s rounding."""
    m = ecfg.model_size
    rs = np.random.RandomState(6)
    x = (2.0 * rs.randn(320, 1, m)).astype(np.float32)
    w = {"wq": rs.randn(m, m) / np.sqrt(m), "wk": rs.randn(m, m) / np.sqrt(m), "wv": np.eye(m),
         "gate": np.eye(m)[rs.permutation(m)], "wo": np.eye(m)}
    norms = {"q_norm": np.ones(ecfg.head_dim), "k_norm": np.ones(ecfg.head_dim)}
    pj = {**{k: {"w": to_jax(v, jnp.bfloat16)} for k, v in w.items()},
          **{k: {"scale": to_jax(v, jnp.bfloat16)} for k, v in norms.items()}}
    pt = {**{k: {"w": to_torch(v, torch.bfloat16)} for k, v in w.items()},
          **{k: {"scale": to_torch(v, torch.bfloat16)} for k, v in norms.items()}}
    cos, sin = np.ones((1, ecfg.head_dim // 2), np.float32), np.zeros((1, ecfg.head_dim // 2), np.float32)
    mask = np.ones((320, 1), bool)
    want = jax.jit(lambda p, x: JE._self_attention(p, ecfg, x, jnp.asarray(mask), jnp.asarray(cos),
                                                   jnp.asarray(sin)))(pj, to_jax(x, jnp.bfloat16))
    pcfg = PE.EncoderConfig(**dataclasses.asdict(ecfg))
    got = PE._self_attention(pt, pcfg, to_torch(x, torch.bfloat16), torch.from_numpy(mask), torch.from_numpy(cos),
                             torch.from_numpy(sin))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_dit_attention_gate_bf16_bit_equal_to_jax(monkeypatch, splits):
    """attention_plain (splits None) and attention_split_plain with a gate
    against the JAX package's `_attend` on the same rounded attention output
    (its sdpa is replaced by that output; to_out is the identity): the
    output rounded to bf16, then sigmoid(gate) and the product, each op
    rounded. One rounding of the fp32 product differs on ~40% of elements."""
    rs = np.random.RandomState(7 + (splits or 0))
    heads, hd, Tq, S, S2 = CFG.heads, CFG.head_dim, 40, 40, 128
    q, k, v, gate = (to_torch(rs.randn(B, heads, n, hd).astype(np.float32), torch.bfloat16)
                     for n in (Tq, S, S, Tq))
    gate = (2.0 * gate.float()).to(torch.bfloat16)
    k2, v2 = (to_torch(rs.randn(B, heads, S2, hd).astype(np.float32), torch.bfloat16) for _ in range(2))
    m1 = torch.arange(S)[None] < torch.tensor([S, 23])[:, None]
    m2 = torch.arange(S2)[None] < torch.tensor([S2, 70])[:, None]
    attend = A.attention_plain if splits is None else (lambda *a, **kw: A.attention_split_plain(*a, **kw, splits=splits))
    out = attend(q, k, v, m1, k2, v2, m2)
    got = attend(q, k, v, m1, k2, v2, m2, gate=gate)
    assert out.dtype == got.dtype == torch.bfloat16
    monkeypatch.setattr(JD.nn, "sdpa", lambda *a, **kw: to_jax(to_np(out), jnp.bfloat16))
    gate_rows = to_jax(to_np(gate.transpose(1, 2).reshape(B, Tq, H)), jnp.bfloat16)
    p_attn = {"to_out": {"w": to_jax(np.eye(H), jnp.bfloat16)}}
    want = jax.jit(lambda g: JD._attend(p_attn, g, None, None, None, jnp.ones((B, Tq), bool), None))(gate_rows)
    assert np.array_equal(to_np(got.transpose(1, 2).reshape(B, Tq, H)), to_np(want))
    parent = (out.float() * torch.sigmoid(gate.float())).to(torch.bfloat16)  # one rounding of the fp32 product
    assert not np.array_equal(to_np(parent), to_np(got))

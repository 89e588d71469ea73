"""int8 serving in the port (smalltts_tpu_torch/ops/kernels/w8.py, the int8
GEMM of ops/kernels/dit_block.py, models/dit.py's quantizers) on the CPU,
where every wrapper takes its plain version, against the JAX package: the
Pallas w8 kernels in interpret mode, `w8_matmul_ref`, `nn.linear` with int8
leaves, `precompute_step_modulations` and the `_block_core` loop.

Inputs are made with numpy from a seed and handed to both. Tolerances:
- quantizers: identical int8 values and scales (the same arithmetic in the
  same dtype);
- fp32 products: 1e-5 relative to the largest value (fp32 sums in another
  order); the 12-layer scan 2e-5, the bound of the fp32 scan tests;
- bf16 results: within 1 bf16 ulp of each value (a sum in another order can
  land on the other side of a rounding boundary). The JAX reference is run
  as it stands: the port's silu is jax.nn.silu's op chain, each op rounded
  in bf16 (ops/nn.py::silu), so the silu itself adds no difference.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from smalltts_tpu.models import dit as JD  # noqa: E402
from smalltts_tpu.ops import nn as JN  # noqa: E402
from smalltts_tpu.ops.pallas import w8 as JW  # noqa: E402
from smalltts_tpu_torch.models import dit as PD  # noqa: E402
from smalltts_tpu_torch.ops import nn as PN  # noqa: E402
from smalltts_tpu_torch.ops.kernels import dit_block as K  # noqa: E402
from smalltts_tpu_torch.ops.kernels import w8 as W  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def to_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


def t_of(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def to_torch(tree, dtype=None):
    """A JAX tree -> torch leaves; floating leaves cast to `dtype` if given."""
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    t = t_of(to_np(tree))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of `want`, element by element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return bool((np.abs(got - want) <= ulp).all())


# ------------------------------------------------------------- (a) quantize_w8


@pytest.mark.parametrize("shape", [(96, 80), (3, 64, 48)])
def test_quantize_w8_matches_jax(shape):
    rs = np.random.RandomState(0)
    w = (0.05 * rs.randn(*shape)).astype(np.float32)
    w[..., 7] = 0.0  # an all-zero output channel: scale 1, values 0
    wq_j, s_j = JW.quantize_w8(jnp.asarray(w))
    wq_t, s_t = W.quantize_w8(torch.from_numpy(w))
    assert wq_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert np.all(s_t.numpy()[..., 7] == 1.0) and not wq_t.numpy()[..., 7].any()
    assert int(np.abs(wq_t.numpy()).max()) == 127


# ------------------------------------------------------------ (b) the products


def _operands(rs, m, k, n, lead=()):
    x = rs.randn(m, k).astype(np.float32)
    w_q, scale = JW.quantize_w8(jnp.asarray((0.05 * rs.randn(*lead, k, n)).astype(np.float32)))
    return x, np.asarray(w_q), np.asarray(scale)


# the shapes on which the card's routes branch: rows around the 8-, 32- and
# 64-row tiles, K that is no multiple of the 64-k tile, N a multiple of 8 only
# (136: no TMA) and of 16 (144)
ROUTE_SHAPES = [(m, k, n) for m in (1, 8, 9, 16, 65) for k in (96, 200) for n in (136, 144)]


@pytest.mark.parametrize("m,k,n", [(40, 96, 80), (8, 64, 48), (3, 32, 16)] + ROUTE_SHAPES)
def test_w8_matmul_matches_pallas(m, k, n):
    x, w_q, scale = _operands(np.random.RandomState(m), m, k, n)
    want = np.asarray(JW.w8_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), interpret=True))
    got = W.w8_matmul(t_of(x), t_of(w_q), t_of(scale))
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < RTOL


@pytest.mark.parametrize("m,k,n", [(16, 64, 48)] + [s for s in ROUTE_SHAPES if (s[1], s[2]) in ((96, 136), (200, 144))])
def test_w8_matmul_stacked_matches_pallas(m, k, n):
    L = 5
    x, w_q, scale = _operands(np.random.RandomState(4), m, k, n, lead=(L,))
    for idx in (0, 2, L - 1):  # the first and the last layer of the stack among them
        want = np.asarray(JW.w8_matmul_stacked(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale),
                                               jnp.int32(idx), interpret=True))
        for i in (idx, torch.tensor(idx, dtype=torch.int32), torch.tensor([idx])):
            assert rel_err(W.w8_matmul_stacked(t_of(x), t_of(w_q), t_of(scale), i).numpy(), want) < RTOL
    # an index past the stack is clamped, as the kernel clamps it
    top = W.w8_matmul_stacked(t_of(x), t_of(w_q), t_of(scale), torch.tensor(9))
    assert torch.equal(top, W.w8_matmul_stacked(t_of(x), t_of(w_q), t_of(scale), L - 1))


def test_w8_matmul_all_layers_matches_pallas():
    x, w_q, scale = _operands(np.random.RandomState(5), 4, 64, 96, lead=(3,))
    want = np.asarray(JW.w8_matmul_all_layers(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale),
                                              interpret=True))
    got = W.w8_matmul_all_layers(t_of(x), t_of(w_q), t_of(scale))
    assert got.shape == (3, 4, 96)
    assert rel_err(got.numpy(), want) < RTOL


@pytest.mark.parametrize("m,k,n", [(8, 96, 80), (1, 200, 144), (9, 200, 136), (16, 96, 136), (65, 96, 144)])
def test_w8_products_bf16_match_ref(m, k, n):
    """bf16 x: the fp32 sum of x times the int8 values, times the scale, one
    rounding to bf16, as w8_matmul_ref computes it in bf16."""
    x, w_q, scale = _operands(np.random.RandomState(6), m, k, n, lead=(3,))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = t_of(x, torch.bfloat16)
    for l in range(3):
        want = to_np(JW.w8_matmul_ref(xj, jnp.asarray(w_q[l]), jnp.asarray(scale[l])))
        got = W.w8_matmul(xt, t_of(w_q[l]), t_of(scale[l]))
        assert got.dtype == torch.bfloat16 and within_one_bf16_ulp(got.float().numpy(), want)
        assert within_one_bf16_ulp(W.w8_matmul_stacked(xt, t_of(w_q), t_of(scale), l).float().numpy(), want)
        assert within_one_bf16_ulp(W.w8_matmul_all_layers(xt, t_of(w_q), t_of(scale))[l].float().numpy(), want)


W8_K_TILE = 64  # k per stage of the tensor-core kernel: the unit its K is split in


def w8_split_plain(x, w_q, scale, splits):
    """The tensor-core kernel's K split and merge in plain PyTorch: the K
    tiles of 64 are shared out over `splits` ranks, rank r taking tiles
    [r * tiles // splits, (r + 1) * tiles // splits); each rank sums its part
    in fp32, and the partial sums are added in rank order before the scale
    and the one rounding."""
    K = x.shape[-1]
    tiles = -(-K // W8_K_TILE)
    acc = torch.zeros((*w_q.shape[:-2], x.shape[0], w_q.shape[-1]), dtype=torch.float32)
    for r in range(splits):
        k0, k1 = r * tiles // splits * W8_K_TILE, min((r + 1) * tiles // splits * W8_K_TILE, K)
        acc = acc + torch.matmul(x[:, k0:k1].float(), w_q[..., k0:k1, :].float())
    return (acc * scale.float().unsqueeze(-2)).to(x.dtype)


@pytest.mark.parametrize("tail", [0, 72])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_w8_split_plain_matches_ref(splits, tail):
    """The K split and merge of the tensor-core kernel, in plain PyTorch, at
    the splits the kernel's launcher can choose (a power of two up to 8 with
    2 k tiles or more a rank), K a multiple of the 64-k tile or with a ragged
    last tile: partial sums added in rank order. fp32 to RTOL of the unsplit
    product and of the Pallas kernel; bf16 within one ulp."""
    k = 2 * W8_K_TILE * splits + tail
    x, w_q, scale = _operands(np.random.RandomState(12 + splits), 9, k, 144, lead=(2,))
    got = w8_split_plain(t_of(x), t_of(w_q), t_of(scale), splits)
    assert got.shape == (2, 9, 144)
    assert rel_err(got.numpy(), W.w8_matmul_ref(t_of(x), t_of(w_q), t_of(scale)).numpy()) < RTOL
    want = np.asarray(JW.w8_matmul_all_layers(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), interpret=True))
    assert rel_err(got.numpy(), want) < RTOL
    if splits == 1:
        assert torch.equal(got, W.w8_matmul_ref(t_of(x), t_of(w_q), t_of(scale)))
    xb = t_of(x, torch.bfloat16)
    got16 = w8_split_plain(xb, t_of(w_q[0]), t_of(scale[0]), splits)
    assert got16.dtype == torch.bfloat16
    assert within_one_bf16_ulp(got16.float().numpy(), W.w8_matmul_ref(xb, t_of(w_q[0]), t_of(scale[0])).float().numpy())


# ------------------------------------------------- (c) quantize_stream_weights

CFG = JD.DiTConfig(latent_dim=16, phoneme_dim=16, hidden_dim=64, n_blocks=12, heads=4, rot_dim=8,
                   conv_groups=4)
PCFG = PD.DiTConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(PD.DiTConfig)})
STREAMS = (("attn", "qkvg"), ("attn", "to_out"), ("ff", "w13"), ("ff", "w2"))


def _fused_dit(seed=0):
    rs = np.random.RandomState(seed)
    p = JD.fuse_serving_projections({"dit": JD.init_dit(jax.random.PRNGKey(seed), CFG)})["dit"]
    h = CFG.hidden_dim
    p["blocks"]["attn_norm"] = {"linear": {
        "w": jnp.asarray(0.3 * rs.randn(CFG.n_blocks, h, 6 * h), jnp.float32),
        "b": jnp.asarray(0.1 * rs.randn(CFG.n_blocks, 6 * h), jnp.float32)}}
    p["blocks"]["ff"]["w2"]["w"] = p["blocks"]["ff"]["w2"]["w"].at[1, :, 5].set(0.0)  # a zero channel
    return p


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_stream_weights_matches_jax(dtype):
    """The quantizer computes in the tree's dtype, as the JAX package's does
    after its bf16 cast: bf16 arithmetic gives other int8 values than fp32."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = jax.tree.map(lambda a: a.astype(jd), _fused_dit())
    jq = JD.quantize_stream_weights({"dit": jp})["dit"]["blocks"]
    tp = {"blocks": {g: to_torch(jp["blocks"][g], td) for g in ("attn", "ff")}}
    tq = PD.quantize_stream_weights(tp)["blocks"]
    L = CFG.n_blocks
    for g, n in STREAMS:
        want_q, want_s = np.asarray(jq[g][n]["w_q"]), np.asarray(jq[g][n]["scale"])
        got_q, got_s = tq[g][n]["w_q"], tq[g][n]["scale"]
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        assert got_s.shape == (L, 1, got_q.shape[-1]) == want_s.shape
        np.testing.assert_array_equal(got_q.numpy(), want_q, err_msg=f"{g}/{n} {dtype}")
        np.testing.assert_array_equal(got_s.numpy(), want_s, err_msg=f"{g}/{n} {dtype}")
        assert ("b" in tq[g][n]) == ("b" in jq[g][n])
    assert tq["ff"]["w2"]["scale"][1, 0, 5] < 1e-11  # the 1e-12 floor, not quantize_w8's 1
    if dtype == "bf16":  # the trap: the same weights quantized in fp32 give other values
        f32 = PD.quantize_stream_weights({"blocks": {"ff": {"w2": {"w": tp["blocks"]["ff"]["w2"]["w"].float()}},
                                                     "attn": {}}})
        assert (f32["blocks"]["ff"]["w2"]["w_q"] != tq["ff"]["w2"]["w_q"]).any()


def test_quantize_stream_weights_needs_the_fused_layout():
    """The scan runs on the fused layout alone, so the split one is refused."""
    split = {"blocks": {g: to_torch(JD.init_dit(jax.random.PRNGKey(0), CFG)["blocks"][g]) for g in ("attn", "ff")}}
    assert "qkv_self" in split["blocks"]["attn"]
    with pytest.raises(ValueError, match="fuse_serving_projections"):
        PD.quantize_stream_weights(split)
    fused = PD.quantize_stream_weights(PD.fuse_serving_projections(split))["blocks"]
    assert all(fused[g][n]["w_q"].dtype == torch.int8 for g, n in STREAMS)


def test_silu_is_jax_op_chain_in_bf16():
    """nn.silu and the SwiGLU plain version give jax.nn.silu's bf16 values
    bit for bit: four roundings, where F.silu rounds once."""
    x = (4.0 * np.random.RandomState(10).randn(4096)).astype(np.float32)
    y = np.random.RandomState(11).randn(4096).astype(np.float32)
    xj, yj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y).astype(jnp.bfloat16)
    xt, yt = t_of(x, torch.bfloat16), t_of(y, torch.bfloat16)
    want = to_np(jax.nn.silu(xj))
    np.testing.assert_array_equal(PN.silu(xt).float().numpy(), want)
    assert (torch.nn.functional.silu(xt).float().numpy() != want).any()
    np.testing.assert_array_equal((PN.silu(xt) * yt).float().numpy(), to_np(jax.nn.silu(xj) * yj))
    np.testing.assert_allclose(PN.silu(t_of(x)).numpy(), np.asarray(jax.nn.silu(jnp.asarray(x))), rtol=1e-6)


def test_quantize_modulations_matches_jax():
    jp = _fused_dit()
    jq = JD.quantize_modulations({"dit": jp})["dit"]["blocks"]["attn_norm"]["linear"]
    lin = jp["blocks"]["attn_norm"]["linear"]
    tq = PD.quantize_modulations({"dit": {"blocks": to_torch({"attn_norm": {"linear": lin}})}})
    tq = tq["dit"]["blocks"]["attn_norm"]["linear"]
    np.testing.assert_array_equal(tq["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    assert tq["b"] is not None and tq["scale"].shape == (CFG.n_blocks, 6 * CFG.hidden_dim)


# --------------------------------------------------- (d) the int8 GEMM's plain


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_gemm_plain_matches_jax_linear(dtype):
    """The three epilogues with int8 leaves against the JAX expressions they
    replace: nn.linear dequantizes bf16(bf16(q) * bf16(scale))."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = jax.tree.map(lambda a: a.astype(jd), _fused_dit(1))
    blk_j = jax.tree.map(lambda a: a[3], JD.quantize_stream_weights({"dit": jp})["dit"]["blocks"])
    blk_t = {g: to_torch(blk_j[g]) for g in ("attn", "ff")}
    for g, n in STREAMS:
        lin = blk_t[g][n]
        if "b" in lin:
            lin["b"] = lin["b"].to(td)
    rs = np.random.RandomState(7)
    B, T, h = 2, 16, CFG.hidden_dim
    x = rs.randn(B, T, h).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jd), t_of(x, td)

    def check(got, want):
        got, want = got.float().numpy(), to_np(want)
        assert within_one_bf16_ulp(got, want) if dtype == "bf16" else rel_err(got, want) < RTOL

    q = blk_t["attn"]["qkvg"]
    check(K.gemm_bias_plain(xt, q["w_q"], q["b"], w_scale=q["scale"]), JN.linear(blk_j["attn"]["qkvg"], xj))
    check(PN.linear(q, xt), JN.linear(blk_j["attn"]["qkvg"], xj))
    w13 = blk_t["ff"]["w13"]
    ab = JN.linear(blk_j["ff"]["w13"], xj)
    a, b = jnp.split(ab, 2, axis=-1)
    check(K.gemm_swiglu_plain(xt, w13["w_q"], w13["b"], w_scale=w13["scale"]), jax.nn.silu(a) * b)
    mid = rs.randn(B, T, CFG.ff_dim).astype(np.float32)
    gate = rs.randn(B, h).astype(np.float32)
    res = rs.randn(B, T, h).astype(np.float32)
    w2 = blk_t["ff"]["w2"]
    want = jnp.asarray(res).astype(jd) + jnp.tanh(jnp.asarray(gate).astype(jd))[:, None] * JN.linear(
        blk_j["ff"]["w2"], jnp.asarray(mid).astype(jd))
    got = K.gemm_residual_plain(t_of(mid, td), w2["w_q"], w2["b"], t_of(res, td), t_of(gate, td),
                                w_scale=w2["scale"])
    check(got, want)
    out = blk_t["attn"]["to_out"]
    mask = np.arange(T)[None] < np.array([T, 9])[:, None]
    lin_j = JN.linear(blk_j["attn"]["to_out"], xj)
    want = jnp.asarray(res).astype(jd) + jnp.tanh(jnp.asarray(gate).astype(jd))[:, None] * jnp.where(
        jnp.asarray(mask)[..., None], lin_j, 0.0)
    got = K.gemm_residual_plain(xt, out["w_q"], None, t_of(res, td), t_of(gate, td), t_of(mask),
                                w_scale=out["scale"])
    check(got, want)


# ------------------------------------------- (e) the hoisted step modulations


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_precompute_step_modulations_w8_matches_jax(dtype):
    """fp32 to 1e-5. In bf16 both packages round the w8 product to bf16 and
    then round again after the fp32 bias; a single rounding of the fp32 sum
    gives other values, which the test shows."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = jax.tree.map(lambda a: a.astype(jd), _fused_dit(2))
    jq = JD.quantize_modulations({"dit": jp})["dit"]
    tp = to_torch({"emb_proj": jp["emb_proj"], "norm_out": jp["norm_out"],
                   "blocks": {"attn_norm": jp["blocks"]["attn_norm"]}}, td)
    tq = PD.quantize_modulations({"dit": tp})["dit"]
    t_embs = np.random.RandomState(8).randn(4, CFG.hidden_dim).astype(np.float32)
    want_m, want_f = JD.precompute_step_modulations(jq, jnp.asarray(t_embs).astype(jd))
    got_m, got_f = PD.precompute_step_modulations(tq, t_of(t_embs, td))
    assert got_m.shape == (CFG.n_blocks, 4, 6 * CFG.hidden_dim) and got_m.dtype == td
    if dtype == "fp32":
        assert rel_err(got_m.numpy(), to_np(want_m)) < RTOL
        assert rel_err(got_f.numpy(), to_np(want_f)) < RTOL
        return
    assert within_one_bf16_ulp(got_m.float().numpy(), to_np(want_m))
    # the double rounding is real: one rounding of the same fp32 sum differs
    lin = tq["blocks"]["attn_norm"]["linear"]
    s = PN.silu(PD._emb_proj(tq["emb_proj"], t_of(t_embs, td)))
    acc = torch.matmul(s.float(), lin["w_q"].float()) * lin["scale"][:, None, :]
    once = (acc + lin["b"].float()[:, None, :]).to(torch.bfloat16)
    want = to_np(want_m)
    # the port equals JAX but for rare sum-order flips; one rounding misses ~30% (measured)
    assert (got_m.float().numpy() != want).mean() <= 0.01 < (once.float().numpy() != want).mean()


# ---------------------------------------------------- (f) the 12-layer scan


def test_int8_scan_matches_block_core_loop():
    """The port's scan (plain) on its own w8_stream tree against the JAX
    `_block_core` loop on the JAX-quantized tree, fp32, 12 layers."""
    rs = np.random.RandomState(9)
    jp = JD.quantize_stream_weights({"dit": _fused_dit(3)})["dit"]
    B, T, R, P = 2, 16, 8, 12
    h = CFG.hidden_dim
    x = rs.randn(B, T, h).astype(np.float32)
    mods = np.array(JD._all_block_modulations(jp["blocks"], jnp.asarray(rs.randn(B, h).astype(np.float32))))
    kv = [(0.5 * rs.randn(CFG.n_blocks, B, CFG.heads, s, CFG.head_dim)).astype(np.float32) for s in (R, R, P, P)]
    mask = np.arange(T)[None, :] < np.array([T, T - 5])[:, None]
    ref_mask = np.arange(R)[None, :] < np.array([R, R - 3])[:, None]
    ph_mask = np.arange(P)[None, :] < np.array([P - 2, P])[:, None]
    joint = jnp.concatenate([mask, ref_mask, ph_mask], axis=1)
    rope = JD._rope_slice(CFG, T)
    want = jnp.asarray(x)
    for l in range(CFG.n_blocks):
        blk = jax.tree.map(lambda a: a[l], jp["blocks"])
        want = JD._block_core(blk, CFG, want, jnp.asarray(mods[l]), jnp.asarray(mask), joint, rope,
                              tuple(jnp.asarray(c[l]) for c in kv))
    fp = {"blocks": {g: to_torch(_fused_dit(3)["blocks"][g]) for g in ("attn", "ff")}}
    blocks = PD.quantize_stream_weights(fp)["blocks"]
    assert blocks["attn"]["qkvg"]["w_q"].dtype == torch.int8
    cos, sin = PD.rope_cos_sin(PCFG, T, "cpu")
    got = K.fused_dit_scan(t_of(x), t_of(mods), t_of(mask), t_of(np.concatenate([kv[0], kv[2]], 3)),
                           t_of(np.concatenate([kv[1], kv[3]], 3)), t_of(np.concatenate([ref_mask, ph_mask], 1)),
                           blocks, cos, sin, heads=CFG.heads, head_dim=CFG.head_dim)
    assert rel_err(got.numpy(), np.asarray(want)) < 2e-5
    # the int8 weights matter: the same scan on the float weights differs
    fp_out = K.fused_dit_scan(t_of(x), t_of(mods), t_of(mask), t_of(np.concatenate([kv[0], kv[2]], 3)),
                              t_of(np.concatenate([kv[1], kv[3]], 3)),
                              t_of(np.concatenate([ref_mask, ph_mask], 1)), fp["blocks"], cos, sin,
                              heads=CFG.heads, head_dim=CFG.head_dim)
    assert rel_err(fp_out.numpy(), np.asarray(want)) > 1e-4


# ------------------------------------------------------- (h) params_from_jax


def test_params_from_jax_keeps_quantized_leaves():
    jp = JD.quantize_stream_weights(JD.quantize_modulations({"dit": _fused_dit(4)}))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), None)
    for g, n in STREAMS + (("attn_norm", "linear"),):
        for leaf in ("w_q", "scale"):
            want = np.asarray(jp["dit"]["blocks"][g][n][leaf])
            got = tp["dit"]["blocks"][g][n][leaf]
            assert got.dtype == (torch.int8 if leaf == "w_q" else torch.float32), (g, n, leaf)
            np.testing.assert_array_equal(got.numpy(), want)
        assert "w" not in tp["dit"]["blocks"][g][n]

"""The port's cached DiT scan (smalltts_tpu_torch/ops/kernels/dit_block.py) on
the CPU, where every launch takes its plain version, against the JAX
package's Pallas whole-scan kernel (interpret mode) and its `_block_core`
loop; and the parameter conversion from the JAX package's trees.

fp32, the shapes of tests/test_pallas_block.py; the adaLN modulation is
re-drawn from a seed (zero-init would make every block the identity).
Tolerance: 2e-5 relative to the largest output, the bound the Pallas kernel
itself is held to against the XLA scan.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from smalltts_tpu.models import dit as JD  # noqa: E402
from smalltts_tpu.ops.pallas import block as JB  # noqa: E402
from smalltts_tpu_torch.models import dit as PD  # noqa: E402
from smalltts_tpu_torch.ops.kernels import dit_block as K  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402

CFG = JD.DiTConfig(latent_dim=16, phoneme_dim=16, hidden_dim=64, n_blocks=3, heads=4, rot_dim=8,
                   conv_groups=4)
PCFG = PD.DiTConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(PD.DiTConfig)})
B, T, R, P = 2, 16, 8, 12
RTOL = 2e-5


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def tt(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def setup(seed=0):
    rs = np.random.RandomState(seed)
    p = JD.init_dit(jax.random.PRNGKey(seed), CFG)
    p = JD.fuse_serving_projections({"dit": p})["dit"]
    h = CFG.hidden_dim
    blocks = dict(p["blocks"])
    blocks["attn_norm"] = {"linear": {
        "w": jnp.asarray(0.3 * rs.randn(CFG.n_blocks, h, 6 * h), jnp.float32),
        "b": jnp.asarray(0.1 * rs.randn(CFG.n_blocks, 6 * h), jnp.float32)}}
    p["blocks"] = blocks
    x = rs.randn(B, T, h).astype(np.float32)
    emb = rs.randn(B, h).astype(np.float32)
    mods = np.array(JD._all_block_modulations(p["blocks"], jnp.asarray(emb)))   # (L, B, 6H)
    kv = [(0.5 * rs.randn(CFG.n_blocks, B, CFG.heads, s, CFG.head_dim)).astype(np.float32)
          for s in (R, R, P, P)]
    mask = np.arange(T)[None, :] < np.array([T, T - 5])[:, None]
    ref_mask = np.arange(R)[None, :] < np.array([R, R - 3])[:, None]
    ph_mask = np.arange(P)[None, :] < np.array([P - 2, P])[:, None]
    return p, x, mods, kv, mask, ref_mask, ph_mask


def jax_block_core_loop(p, x, mods, kv, mask, ref_mask, ph_mask):
    joint = jnp.concatenate([mask, ref_mask, ph_mask], axis=1)
    rope = JD._rope_slice(CFG, T)
    out = jnp.asarray(x)
    for l in range(CFG.n_blocks):
        blk = jax.tree.map(lambda a: a[l], p["blocks"])
        out = JD._block_core(blk, CFG, out, jnp.asarray(mods[l]), jnp.asarray(mask), joint, rope,
                             tuple(jnp.asarray(c[l]) for c in kv))
    return np.asarray(out)


def jax_pallas_scan(p, x, mods, kv, mask, ref_mask, ph_mask):
    packed = JB.pack_block_weights(p["blocks"], CFG.heads, CFG.head_dim)
    k_cross = JB.pack_cross_kv(jnp.concatenate([kv[0], kv[2]], axis=3), CFG.head_dim)
    v_cross = JB.pack_cross_kv(jnp.concatenate([kv[1], kv[3]], axis=3), CFG.head_dim)
    cos, sin = JB.rope_tables(np.asarray(JD._rope_slice(CFG, T)), CFG.heads, CFG.head_dim, T)
    mods6 = jnp.stack(jnp.split(jnp.asarray(mods), 6, axis=-1), axis=1)
    cross_mask = np.concatenate([ref_mask, ph_mask], axis=1)
    self_bias = jnp.where(mask, 0.0, -1e9)[:, None, :].astype(jnp.float32)
    cross_bias = jnp.where(cross_mask, 0.0, -1e9)[:, None, :].astype(jnp.float32)
    row_mask = jnp.asarray(mask[..., None].astype(np.float32))
    return np.asarray(JB.fused_dit_scan(
        jnp.asarray(x), mods6, self_bias, cross_bias, row_mask, jnp.asarray(cos), jnp.asarray(sin),
        packed, k_cross, v_cross, heads=CFG.heads, head_dim=CFG.head_dim, hidden=CFG.hidden_dim,
        ff_dim=CFG.ff_dim, interpret=True))


def port_scan(p, x, mods, kv, mask, ref_mask, ph_mask):
    blocks = params_from_jax(to_np({"blocks": p["blocks"]}), None)["blocks"]
    cross_k = torch.from_numpy(np.concatenate([kv[0], kv[2]], axis=3))
    cross_v = torch.from_numpy(np.concatenate([kv[1], kv[3]], axis=3))
    cross_mask = torch.from_numpy(np.concatenate([ref_mask, ph_mask], axis=1))
    cos, sin = PD.rope_cos_sin(PCFG, T, "cpu")
    xt = torch.from_numpy(x)
    out = K.fused_dit_scan(xt, torch.from_numpy(mods), torch.from_numpy(mask), cross_k, cross_v,
                           cross_mask, blocks, cos, sin, heads=CFG.heads, head_dim=CFG.head_dim)
    assert torch.equal(xt, torch.from_numpy(x)), "the scan must not modify its input"
    return out.numpy()


def test_scan_matches_pallas_and_block_core():
    args = setup()
    got = port_scan(*args)
    assert rel_err(got, jax_block_core_loop(*args)) < RTOL
    assert rel_err(got, jax_pallas_scan(*args)) < RTOL


def test_scan_masks_matter():
    """A masked cross key's content must not change the output; a tighter
    self mask must."""
    p, x, mods, kv, mask, ref_mask, ph_mask = setup(1)
    base = port_scan(p, x, mods, kv, mask, ref_mask, ph_mask)
    kv2 = [c.copy() for c in kv]
    kv2[0][:, 1, :, -1, :] = 1e3  # ref_mask[1, R-3:] is False
    kv2[1][:, 1, :, -1, :] = 1e3
    np.testing.assert_allclose(port_scan(p, x, mods, kv2, mask, ref_mask, ph_mask), base,
                               rtol=1e-5, atol=1e-5)
    tighter = np.arange(T)[None, :] < np.array([T - 8, T - 8])[:, None]
    assert np.abs(port_scan(p, x, mods, kv, tighter, ref_mask, ph_mask) - base).max() > 1e-3


def test_layer_pieces_match_jax():
    """Each launch's plain version against the JAX expression it replaces."""
    p, x, mods, kv, mask, ref_mask, ph_mask = setup(2)
    h, heads, d = CFG.hidden_dim, CFG.heads, CFG.head_dim
    blk = jax.tree.map(lambda a: a[0], p["blocks"])
    mod = jnp.asarray(mods[0])
    want_norm = np.array(JD._apply_adaln_zero(mod, jnp.asarray(x))[0])
    got_norm = K.adaln_modulate_plain(torch.from_numpy(x), torch.from_numpy(mods[0][:, :h]),
                                      torch.from_numpy(mods[0][:, h:2 * h]))
    assert rel_err(got_norm.numpy(), want_norm) < 1e-5

    q, k, _, _ = JD._self_qkv_gate(blk["attn"], CFG, jnp.asarray(want_norm), JD._rope_slice(CFG, T))
    qkvg = K.gemm_bias_plain(torch.from_numpy(want_norm), tt(np.asarray(blk["attn"]["qkvg"]["w"])),
                             tt(np.asarray(blk["attn"]["qkvg"]["b"])))
    cos, sin = PD.rope_cos_sin(PCFG, T, "cpu")
    K.qk_norm_rope_plain(qkvg, tt(np.asarray(blk["attn"]["q_norm"]["scale"])),
                         tt(np.asarray(blk["attn"]["k_norm"]["scale"])), cos, sin)
    got_q = qkvg[..., :h].reshape(B, T, heads, d).transpose(1, 2)
    got_k = qkvg[..., h:2 * h].reshape(B, T, heads, d).transpose(1, 2)
    assert rel_err(got_q.numpy(), np.asarray(q)) < 1e-5
    assert rel_err(got_k.numpy(), np.asarray(k)) < 1e-5

    want_ff = np.asarray(JD._ff(blk["ff"], jnp.asarray(want_norm)))
    mid = K.gemm_swiglu_plain(torch.from_numpy(want_norm), tt(np.asarray(blk["ff"]["w13"]["w"])),
                              tt(np.asarray(blk["ff"]["w13"]["b"])))
    xr = torch.zeros(B, T, h)
    gate = torch.full((B, h), 10.0)  # tanh(10) = 1 in fp32: x += ff
    K.gemm_residual_plain(mid, tt(np.asarray(blk["ff"]["w2"]["w"])),
                          tt(np.asarray(blk["ff"]["w2"]["b"])), xr, gate)
    assert rel_err(xr.numpy(), want_ff) < 1e-5


@pytest.mark.parametrize("fused", [False, True])
def test_params_from_jax_round_trip(fused):
    """Both block layouts convert leaf for leaf; conv kernels go HIO ->
    (c_out, c_in/g, k) and back exactly; fusing in the port equals fusing in
    the JAX package."""
    sys.path.insert(0, "tests")
    from tiny import TINY_BACKBONE

    from smalltts_tpu.models.backbone import init_backbone
    from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict

    jp = init_backbone(jax.random.PRNGKey(3), TINY_BACKBONE)
    if fused:
        jp = JD.fuse_serving_projections(jp)
    cfg = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
    tp = params_from_jax(to_np(jp), cfg)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            yield from (flat(v, key) if isinstance(v, dict) else [(key, v)])

    flat_t = dict(flat(tp))
    assert flat_t.keys() == flat_j.keys()
    for key, t in flat_t.items():
        back = t.numpy()
        if key.startswith("dit/input_embed/conv") and key.endswith("/w"):
            assert t.shape == flat_j[key].shape[::-1]
            back = back.transpose(2, 1, 0)
        np.testing.assert_array_equal(back, flat_j[key], err_msg=key)
    if not fused:
        fj = to_np(JD.fuse_serving_projections(jp))
        ft = PD.fuse_serving_projections(tp)
        for g, name in (("attn", "qkvg"), ("ff", "w13")):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(ft["dit"]["blocks"][g][name][leaf].numpy(),
                                              fj["dit"]["blocks"][g][name][leaf])

"""The port's models (smalltts_tpu_torch.models) against the JAX package's, on
the same weights (converted with utils.convert.params_from_jax) and the same
numpy inputs, in fp32 on the CPU with the tiny configs of tests/tiny.py.

Tolerance: 1e-5 relative to the largest output (fp32 sums in another order);
the zero-init adaLN and velocity leaves are re-drawn so no block is the
identity.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu.models import backbone as JBK  # noqa: E402
from smalltts_tpu.models import codec as JC  # noqa: E402
from smalltts_tpu.models import dit as JD  # noqa: E402
from smalltts_tpu.models.style_encoder import style_encoder as j_style  # noqa: E402
from smalltts_tpu.models.text_encoder import text_encoder as j_text  # noqa: E402
from smalltts_tpu_torch.models import backbone as PBK  # noqa: E402
from smalltts_tpu_torch.models import codec as PC  # noqa: E402
from smalltts_tpu_torch.models import dit as PD  # noqa: E402
from smalltts_tpu_torch.models.style_encoder import style_encoder as p_style  # noqa: E402
from smalltts_tpu_torch.models.text_encoder import text_encoder as p_text  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL = 1e-5
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
B, R, P, TB = 2, 10, 12, 16
T = torch.from_numpy


def close(got, want, rtol=RTOL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)
    assert err <= rtol, f"rel err {err:.3e}"


def redraw(params, seed=0):
    """Give the zero-init leaves seeded values on the JAX side."""
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: x, params)
    dit = params["dit"]
    for lin in (dit["blocks"]["attn_norm"]["linear"], dit["norm_out"]["linear"], params["velocity"]):
        for k in lin:
            lin[k] = jnp.asarray((0.2 if k == "w" else 0.5) * rs.randn(*lin[k].shape), jnp.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    jp = redraw(JBK.init_backbone(jax.random.PRNGKey(0), TINY_BACKBONE))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), PCFG)


@pytest.fixture(scope="module")
def conds():
    rs = np.random.RandomState(1)
    ref = rs.randn(B, R, 64).astype(np.float32)
    ref_len = np.array([R, 6], np.int32)
    ph = rs.randint(1, 198, size=(B, P)).astype(np.int32)
    ph_len = np.array([9, P], np.int32)
    ph_mask = np.arange(P)[None] < ph_len[:, None]
    return ref, ref_len, ph, ph_mask


def test_text_encoder(weights, conds):
    jp, tp = weights
    _, _, ph, ph_mask = conds
    want = j_text(jp["phoneme_embedding"], jnp.asarray(ph), jnp.asarray(ph_mask), TINY_BACKBONE.text)
    got = p_text(tp["phoneme_embedding"], T(ph).long(), T(ph_mask), PCFG.text)
    close(got, want)


def test_style_encoder(weights, conds):
    jp, tp = weights
    ref, ref_len, _, _ = conds
    want_seq, want_mask = j_style(jp["style_encoder"], jnp.asarray(ref), jnp.asarray(ref_len), TINY_BACKBONE.style)
    got_seq, got_mask = p_style(tp["style_encoder"], T(ref), T(ref_len), PCFG.style)
    close(got_seq, want_seq)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert float(got_seq[1, 6:].abs().max()) == 0.0  # output zeroed past the length


def test_time_embedding(weights):
    jp, tp = weights
    t = np.linspace(1.0, 0.0, 4, dtype=np.float32)
    close(PBK.time_embedding(tp["time_embedding"], T(t)), JBK.time_embedding(jp["time_embedding"], jnp.asarray(t)))


def test_cross_kv_and_cached_forward(weights, conds):
    jp, tp = weights
    ref, ref_len, ph, ph_mask = conds
    jcond = JBK.encode_conditions(jp, TINY_BACKBONE, jnp.asarray(ref), jnp.asarray(ref_len), jnp.asarray(ph),
                                  jnp.asarray(ph_mask))
    pcond = PBK.encode_conditions(tp, PCFG, T(ref), T(ref_len), T(ph).long(), T(ph_mask))
    ref_seq, _ = j_style(jp["style_encoder"], jnp.asarray(ref), jnp.asarray(ref_len), TINY_BACKBONE.style)
    emb = j_text(jp["phoneme_embedding"], jnp.asarray(ph), jnp.asarray(ph_mask), TINY_BACKBONE.text)
    jkv = JD.dit_encode_cross_kv(jp["dit"], TINY_BACKBONE.dit, ref_seq, emb, jnp.asarray(ph_mask))
    pkv = PD.dit_encode_cross_kv(tp["dit"], PCFG.dit, T(np.array(ref_seq)), T(np.array(emb)), T(ph_mask))
    for g, w in zip(pkv, jkv):
        close(g, w)
    close(pcond.cross_k, jnp.concatenate([jcond.cross_kv.k_ref, jcond.cross_kv.k_text], axis=3))
    close(pcond.cross_v, jnp.concatenate([jcond.cross_kv.v_ref, jcond.cross_kv.v_text], axis=3))

    rs = np.random.RandomState(2)
    x = rs.randn(B, TB, 64).astype(np.float32)
    mask = np.arange(TB)[None] < np.array([TB, 11])[:, None]
    t = np.array([0.7, 0.7], np.float32)
    t_emb = JBK.time_embedding(jp["time_embedding"], jnp.asarray(t))
    want = JD.dit_forward_cached(jp["dit"], TINY_BACKBONE.dit, jnp.asarray(x), t_emb, jnp.asarray(mask),
                                 jcond.cross_kv, jcond.ref_mask, jcond.phonemes_mask)
    tpf = PD.fuse_serving_projections(tp)
    got = PD.dit_forward_cached(tpf["dit"], PCFG.dit, T(x), T(np.array(t_emb)), T(mask), pcond.cross_k,
                                pcond.cross_v, pcond.cross_mask)
    close(got, want)
    # and the denoise step with hoisted step modulations, as the sampler runs it
    mods, finals = JD.precompute_step_modulations(jp["dit"], t_emb[:1])
    jv = JBK.denoise_step(jp, TINY_BACKBONE, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(t), jcond,
                          t_emb=t_emb, step_mods=(mods[:, 0], finals[0]))
    pm, pf = PD.precompute_step_modulations(tpf["dit"], T(np.array(t_emb[:1])))
    pv = PBK.denoise_step(tpf, PCFG, T(x), T(mask), T(t), pcond, t_emb=T(np.array(t_emb)),
                          step_mods=(pm[:, 0], pf[0]))
    close(pv, jv)


def test_codec_encode_decode():
    jp = JC.init_codec(jax.random.PRNGKey(3), TINY_CODEC)
    rs = np.random.RandomState(4)
    # non-zero snake alphas so the activation is exercised away from a = 1
    jp = jax.tree.map(lambda x: x, jp)
    for stage in jp["dec_stages"] + jp["enc_stages"]:
        stage["log_alpha"] = jnp.asarray(0.3 * rs.randn(*stage["log_alpha"].shape), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), PCODEC)
    audio = (0.3 * rs.randn(2, 1, 2 * TINY_CODEC.hop)).astype(np.float32)
    close(PC.codec_encode(tp, T(audio), PCODEC), JC.codec_encode(jp, jnp.asarray(audio), TINY_CODEC))
    lat = rs.randn(2, 3, 64).astype(np.float32)
    close(PC.codec_decode(tp, T(lat), PCODEC), JC.codec_decode(jp, jnp.asarray(lat), TINY_CODEC))
    x = (5 * rs.randn(3, 7, 16)).astype(np.float32)
    la = (0.5 * rs.randn(16)).astype(np.float32)
    close(PC.snake(T(x), T(la)), JC.snake(jnp.asarray(x), jnp.asarray(la)))

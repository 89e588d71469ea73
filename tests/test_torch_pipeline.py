"""The port's serving slice as a whole, on the CPU in fp32, against the JAX
package on the same converted weights and the same numpy noise.

Tolerances: latents and float waveforms 1e-5 relative to the largest value
(fp32 sums in another order, over 4 steps and the codec); int16 waveforms
within 1 LSB (a float a hair from a rounding boundary may round the other
way).
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

from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS  # noqa: E402
from smalltts_tpu.infer.sampler import sample_latents as j_sample_latents  # noqa: E402
from smalltts_tpu.models.backbone import init_backbone as j_init_backbone  # noqa: E402
from smalltts_tpu.models.codec import codec_decode as j_codec_decode  # noqa: E402
from smalltts_tpu.models.codec import init_codec as j_init_codec  # noqa: E402
from smalltts_tpu_torch.data.bucketing import HOP_SIZE  # noqa: E402
from smalltts_tpu_torch.infer.pipeline import SmallTTS  # noqa: E402
from smalltts_tpu_torch.infer.sampler import sample_latents  # noqa: E402
from smalltts_tpu_torch.serving.batcher import Batcher  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402

RTOL = 1e-5
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
B, R, P, TB, STEPS = 2, 64, 128, 16, 4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def redraw(params, seed=0):
    rs = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: x, params)
    dit = params["dit"]
    for lin in (dit["blocks"]["attn_norm"]["linear"], dit["norm_out"]["linear"], params["velocity"]):
        for k in lin:
            lin[k] = jnp.asarray((0.2 if k == "w" else 0.5) * rs.randn(*lin[k].shape), jnp.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    jp = redraw(j_init_backbone(jax.random.PRNGKey(0), TINY_BACKBONE))
    jc = j_init_codec(jax.random.PRNGKey(1), TINY_CODEC)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return jp, jc, params_from_jax(to_np(jp), PCFG), params_from_jax(to_np(jc), PCODEC)


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(2)
    ref = rs.randn(B, R, 64).astype(np.float32)
    ref_len = np.array([40, 9], np.int32)
    ph = rs.randint(1, 198, size=(B, P)).astype(np.int32)
    ph_len = np.array([100, 31], np.int32)
    seq = np.array([TB, 11], np.int32)
    noises = rs.randn(STEPS, B, TB, 64).astype(np.float32)
    return ref, ref_len, ph, ph_len, seq, noises


def test_sample_latents_with_injected_noise(weights, batch):
    jp, _, tp, _ = weights
    from smalltts_tpu_torch.models.dit import fuse_serving_projections

    ref, ref_len, ph, ph_len, seq, noises = batch
    want = j_sample_latents(jp, TINY_BACKBONE, *(jnp.asarray(a) for a in (ref, ref_len, ph, ph_len, seq)),
                            jax.random.PRNGKey(9), num_steps=STEPS, noises=jnp.asarray(noises))
    T = torch.from_numpy
    got = sample_latents(fuse_serving_projections(tp), PCFG, T(ref), T(ref_len), T(ph).long(), T(ph_len),
                         T(seq), num_steps=STEPS, noises=T(noises))
    assert rel_err(got.numpy(), want) < RTOL
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # the test is not vacuous
    with pytest.raises(ValueError, match="steps"):
        sample_latents(fuse_serving_projections(tp), PCFG, T(ref), T(ref_len), T(ph).long(), T(ph_len),
                       T(seq), num_steps=3, noises=T(noises))


@pytest.mark.parametrize("pcm16", [False, True])
def test_synthesize_padded_matches_jax_pipeline(weights, batch, pcm16):
    jp, jc, tp, tc = weights
    ref, ref_len, ph, ph_len, seq, noises = batch
    jtts = JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", pcm16_out=pcm16)
    lat = j_sample_latents(jtts.params, TINY_BACKBONE, *(jnp.asarray(a) for a in (ref, ref_len, ph, ph_len, seq)),
                           jax.random.PRNGKey(9), num_steps=STEPS, noises=jnp.asarray(noises))
    want = np.asarray(j_codec_decode(jtts.codec_params, lat, TINY_CODEC))
    if pcm16:  # the JAX pipeline's in-graph quantisation (sampler.py:185-187)
        want = np.asarray(jnp.rint(jnp.clip(jnp.asarray(want), -1.0, 1.0) * jnp.float32(32767.0)).astype(jnp.int16))
    tts = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", pcm16_out=pcm16)
    got = tts.synthesize_padded(ref, ref_len, ph, ph_len, seq, TB, noises=noises)
    assert got.shape == (B, 1, TB * HOP_SIZE) and got.dtype == want.dtype
    if pcm16:
        assert int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) <= 1
        assert np.abs(want).max() > 0
    else:
        assert rel_err(got, want) < RTOL


@pytest.mark.parametrize("w8_modulation,w8_stream", [(True, False), (False, True), (True, True)])
def test_w8_serving_matches_jax_pipeline(weights, batch, w8_modulation, w8_stream):
    """int8 serving: the same options in both packages, the same weights and
    noise. Latents to 1e-5 relative, pcm16 within 1 LSB; and the int8 output
    is not the float output (the quantized path really ran)."""
    jp, jc, tp, tc = weights
    ref, ref_len, ph, ph_len, seq, noises = batch
    opts = dict(w8_modulation=w8_modulation, w8_stream=w8_stream, pcm16_out=True)
    jtts = JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", **opts)
    lat_j = j_sample_latents(jtts.params, TINY_BACKBONE, *(jnp.asarray(a) for a in (ref, ref_len, ph, ph_len, seq)),
                             jax.random.PRNGKey(9), num_steps=STEPS, noises=jnp.asarray(noises))
    wave_j = jnp.clip(j_codec_decode(jtts.codec_params, lat_j, TINY_CODEC), -1.0, 1.0)
    want = np.asarray(jnp.rint(wave_j * jnp.float32(32767.0)).astype(jnp.int16))
    tts = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", **opts)
    blocks = tts.params["dit"]["blocks"]
    assert ("w_q" in blocks["attn_norm"]["linear"]) == w8_modulation
    assert all(("w_q" in blocks[g][n]) == w8_stream for g, n in (("attn", "qkvg"), ("attn", "to_out"),
                                                                  ("ff", "w13"), ("ff", "w2")))
    T = torch.from_numpy
    args = (PCFG, T(ref), T(ref_len), T(ph).long(), T(ph_len), T(seq))
    lat_t = sample_latents(tts.params, *args, num_steps=STEPS, noises=T(noises))
    assert rel_err(lat_t.numpy(), lat_j) < RTOL
    got = tts.synthesize_padded(ref, ref_len, ph, ph_len, seq, TB, noises=noises)
    assert got.dtype == np.int16 and int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) <= 1
    fp = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu")
    lat_fp = sample_latents(fp.params, *args, num_steps=STEPS, noises=T(noises))
    assert rel_err(lat_t.numpy(), lat_fp.numpy()) > 1e-4


def test_batcher_answers_requests(weights):
    _, _, tp, tc = weights
    tts = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", pcm16_out=True)
    rs = np.random.RandomState(3)
    batcher = Batcher(tts, max_batch=4)
    try:
        reqs = [(rs.randn(int(rs.randint(5, 40)), 64).astype(np.float32),
                 rs.randint(1, 198, size=int(rs.randint(3, 60))).tolist(), d)
                for d in (0.5, 2.0, 2.0, 5.0, 1.0, 2.0)]
        futs = [batcher.submit(*r) for r in reqs]
        outs = [f.result(timeout=300) for f in futs]
    finally:
        batcher.close()
    for (_, _, d), out in zip(reqs, outs):
        n = int(np.ceil(d * 24000 / HOP_SIZE)) * HOP_SIZE
        assert out.shape == (1, n) and out.dtype == np.int16


def test_npz_checkpoint_loads_with_metadata(weights, tmp_path):
    """A JAX-package checkpoint (bf16 leaves, config metadata) loads with its
    own architecture and exact values."""
    from smalltts_tpu.utils import checkpoint as jckpt
    from smalltts_tpu.utils.config_io import backbone_meta, codec_meta

    jp, jc, _, _ = weights
    bb, cc = str(tmp_path / "bb.npz"), str(tmp_path / "codec.npz")
    jckpt.save_pytree(bb, jckpt.cast_floating(jp, jnp.bfloat16), meta=backbone_meta(TINY_BACKBONE))
    jckpt.save_pytree(cc, jc, meta=codec_meta(TINY_CODEC))
    tts = SmallTTS(checkpoint=bb, codec_checkpoint=cc, device="cpu")
    assert tts.cfg == PCFG and tts.codec_cfg == PCODEC
    want = np.asarray(jp["dit"]["blocks"]["ff"]["w2"]["w"].astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(tts.params["dit"]["blocks"]["ff"]["w2"]["w"].numpy(), want)
    w = tts.codec_params["dec_out"]["w"].numpy()
    np.testing.assert_array_equal(w, np.asarray(jc["dec_out"]["w"]).transpose(2, 1, 0))


def test_synthesize_timed_and_estimate_duration(weights):
    from smalltts_tpu_torch.infer.pipeline import estimate_duration

    _, _, tp, tc = weights
    tts = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu")
    wave = (0.1 * np.random.RandomState(5).randn(3 * 24000)).astype(np.float32)
    audio, timing = tts.synthesize_timed(wave, [5, 9, 11, 40], 2.0)
    assert audio.shape == (1, 15 * HOP_SIZE) and audio.dtype == np.float32
    stages = (timing.codec_enc_ms, timing.cond_enc_ms, timing.denoise_ms, timing.codec_dec_ms)
    assert all(t > 0 for t in stages) and timing.total_ms >= sum(stages) * 0.99
    assert estimate_duration("x" * 23) == 2.0
    assert estimate_duration("") == 0.5 and estimate_duration("x" * 10_000) == 30.0

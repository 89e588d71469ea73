"""The port's A/B scripts (smalltts_tpu_torch/scripts/ab_fused_block.py and
ab_fused_block_e2e.py) and SmallTTS(fused_block=False), on the CPU at the
tiny config, against the root scripts and the JAX package.

- Flags: each module has every add_argument flag of its root script, plus
  --device.
- utils.checkpoint.cast_floating against the JAX package's, bit for bit.
- Each arm's single denoise_step on the script's inputs (RandomState(0))
  against the JAX package's denoise_step on the same weights: the split
  arm against the JAX split layout, the fused arm against
  fuse_serving_projections' layout; fp32, 1e-5 of the largest value (sums
  in another order).
- Each script's JSON line holds the documented keys, finite.
- SmallTTS(fused_block=False) keeps the split layout, and on injected noise
  equals the JAX SmallTTS(fused_block=False) (the JAX default: its XLA
  scan) within 1e-5 of the largest sample.
"""

import ast
import dataclasses
import io
import json
import math
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu_torch.scripts import ab_fused_block as ab  # noqa: E402
from smalltts_tpu_torch.scripts import ab_fused_block_e2e as e2e  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(path):
    tree = ast.parse(open(path).read())
    return {n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "add_argument" and n.args and isinstance(n.args[0], ast.Constant)}


@pytest.mark.parametrize("name", ["ab_fused_block", "ab_fused_block_e2e"])
def test_flags_are_the_root_scripts_plus_device(name):
    root = _flags(os.path.join(ROOT, "scripts", f"{name}.py"))
    port = _flags(os.path.join(ROOT, "smalltts_tpu_torch", "scripts", f"{name}.py"))
    assert root and port == root | {"--device"}


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights (zero-init leaves re-drawn) and the same weights
    in the JAX package's layout."""
    from smalltts_tpu_torch.models.backbone import init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import init_codec
    from smalltts_tpu_torch.utils.convert import params_to_jax

    g = torch.Generator().manual_seed(0)
    tp, tc = redraw_zero_init(init_backbone(g, PCFG), g), init_codec(g, PCODEC)
    to_jax = lambda t: jax.tree.map(lambda x: jnp.asarray(x.numpy()), params_to_jax(t))  # noqa: E731
    return to_jax(tp), to_jax(tc), tp, tc


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def test_each_arm_denoise_step_equals_jax(weights):
    from smalltts_tpu.models.backbone import denoise_step as j_denoise_step
    from smalltts_tpu.models.backbone import encode_conditions as j_encode_conditions
    from smalltts_tpu.models.dit import fuse_serving_projections as j_fuse
    from smalltts_tpu.ops.masking import length_mask as j_length_mask
    from smalltts_tpu_torch.models.backbone import denoise_step

    jp, _, tp, _ = weights
    B, T = 2, 8
    arms = ab.make_arms(tp)
    assert "qkv_self" in arms["split"]["dit"]["blocks"]["attn"] and "qkvg" in arms["fused"]["dit"]["blocks"]["attn"]
    cond, x, mask, t = ab.make_inputs(PCFG, arms["split"], B, T, torch.device("cpu"), torch.float32)
    rng = np.random.RandomState(0)  # the script's draws, in its order
    ref = jnp.asarray(rng.randn(B, ab.R_FRAMES, 64).astype(np.float32))
    ph = jnp.asarray(rng.randint(1, 150, (B, ab.P_TOKENS)).astype(np.int32))
    ph_mask = j_length_mask(jnp.full((B,), ab.P_TOKENS - 9, jnp.int32), ab.P_TOKENS)
    # the JAX functions jitted: one compile a function instead of one an op
    jcond = jax.jit(lambda *a: j_encode_conditions(a[0], TINY_BACKBONE, *a[1:]))(
        jp, ref, jnp.full((B,), ab.R_FRAMES, jnp.int32), ph, ph_mask)
    j_step = jax.jit(lambda *a: j_denoise_step(a[0], TINY_BACKBONE, *a[1:]))
    jx = jnp.asarray(rng.randn(B, T, 64).astype(np.float32))
    jmask = j_length_mask(jnp.full((B,), T - 2, jnp.int32), T)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    for name, jparams in (("split", jp), ("fused", j_fuse(jp))):
        want = np.asarray(j_step(jparams, jx, jmask, jnp.full((B,), 0.7, jnp.float32), jcond))
        with torch.inference_mode():
            got = denoise_step(arms[name], PCFG, x, mask, t, cond).numpy()
        assert np.abs(want).max() > 1e-2 and _rel(got, want) < RTOL, (name, _rel(got, want))


def test_cast_floating_equals_jax():
    """utils.checkpoint.cast_floating (the A/B's bf16 cast) against the JAX
    package's: floating leaves cast, integer leaves kept, the same values."""
    from smalltts_tpu.utils.checkpoint import cast_floating as j_cast
    from smalltts_tpu_torch.utils.checkpoint import cast_floating

    rs = np.random.RandomState(4)
    tree = {"w": rs.randn(3, 5).astype(np.float32), "n": {"idx": np.arange(4, dtype=np.int32)},
            "blocks": [rs.randn(2).astype(np.float32)]}
    got = cast_floating({"w": torch.from_numpy(tree["w"]), "n": {"idx": torch.from_numpy(tree["n"]["idx"])},
                         "blocks": [torch.from_numpy(tree["blocks"][0])]}, torch.bfloat16)
    want = j_cast(tree, jnp.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and got["blocks"][0].dtype == torch.bfloat16
    assert got["n"]["idx"].dtype == torch.int32 and want["n"]["idx"].dtype == jnp.int32
    for g, w in ((got["w"], want["w"]), (got["blocks"][0], want["blocks"][0]), (got["n"]["idx"], want["n"]["idx"])):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def _json_lines(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def _finite(line):
    return all(math.isfinite(v) for v in line.values() if isinstance(v, float))


def test_ab_json_keys(monkeypatch):
    monkeypatch.setattr(ab, "default_config", lambda: PCFG)
    monkeypatch.setenv("SMALLTTS_PEAK_TFLOPS", "1")
    monkeypatch.setenv("SMALLTTS_PEAK_GBPS", "10")
    lines = _json_lines(ab.main, ["--cells", "2x8", "1x8", "--k", "2", "--device", "cpu"])
    assert [line["cell"] for line in lines] == ["2x8", "1x8"]
    for line in lines:
        assert set(line) == {"cell", "k", "split_ms", "split_mfu", "split_hbm_frac", "fused_ms", "fused_mfu",
                             "fused_hbm_frac", "sum_rel", "speedup"}, line
        assert _finite(line) and line["k"] == 2 and line["sum_rel"] < 1e-4


def test_ab_e2e_json_keys(monkeypatch):
    monkeypatch.setattr(e2e, "default_configs", lambda: (PCFG, PCODEC))
    (line,) = _json_lines(e2e.main, ["--cells", "1x2", "--k", "2", "--device", "cpu"])
    assert set(line) == {"cell", "k", "t_bucket", "split_ms", "fused_ms", "sum_rel", "speedup"}, line
    assert line["cell"] == "1x2" and line["t_bucket"] == 16 and _finite(line) and line["sum_rel"] < 1e-4


def test_smalltts_split_layout_equals_jax(weights):
    from smalltts_tpu.infer.pipeline import SmallTTS as JSmallTTS
    from smalltts_tpu.infer.sampler import sample_latents as j_sample_latents
    from smalltts_tpu.models.codec import codec_decode as j_codec_decode
    from smalltts_tpu_torch.infer.pipeline import SmallTTS

    jp, jc, tp, tc = weights
    rs = np.random.RandomState(2)
    B, R, P, TB = 2, 64, 128, 16
    ref = rs.randn(B, R, 64).astype(np.float32)
    ref_len, ph_len, seq = np.array([40, 9], np.int32), np.array([100, 31], np.int32), np.array([TB, 11], np.int32)
    ph = rs.randint(1, 198, size=(B, P)).astype(np.int32)
    noises = rs.randn(4, B, TB, 64).astype(np.float32)
    jtts = JSmallTTS(jp, jc, cfg=TINY_BACKBONE, codec_cfg=TINY_CODEC, codec="native", fused_block=False)
    sample = jax.jit(lambda p, *a, noises: j_sample_latents(p, TINY_BACKBONE, *a, num_steps=4, noises=noises))
    lat = sample(jtts.params, *(jnp.asarray(a) for a in (ref, ref_len, ph, ph_len, seq)), jax.random.PRNGKey(9),
                 noises=jnp.asarray(noises))
    want = np.asarray(jax.jit(lambda c, x: j_codec_decode(c, x, TINY_CODEC))(jtts.codec_params, lat))
    tts = SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", fused_block=False)
    assert not tts.fused_block and "qkv_self" in tts.params["dit"]["blocks"]["attn"]
    got = tts.synthesize_padded(ref, ref_len, ph, ph_len, seq, TB, noises=noises)
    assert got.shape == want.shape and np.abs(want).max() > 1e-3 and _rel(got, want) < RTOL
    with pytest.raises(ValueError, match="w8_stream needs fused_block"):
        SmallTTS(tp, tc, cfg=PCFG, codec_cfg=PCODEC, device="cpu", fused_block=False, w8_stream=True)

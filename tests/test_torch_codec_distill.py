"""The port's codec distiller (smalltts_tpu_torch/train/codec_distill.py)
against the JAX package's, on the CPU in fp32. The teacher is one mini codec
(strides (4, 5), hop 20, seed-5 weights) exported once by the port
(onnxtorch/export.py) and the same .onnx files are handed to both
packages' OnnxCodec; the student is the same mini layout from JAX's init,
carried across by params_from_jax. In decoder-only distillation JAX's
jax.random.normal draw is passed to the port.

Tolerances, relative to the JAX value: multi_stft_loss 1e-5 (the FFT sums
in another order); the schedule 1e-6 (float32 cosines); the params after
each of two steps 1e-4 rel-L2 over the whole tree and each leaf nonzero at
init, 2e-2 for the zero-init snake log_alpha leaves (AdamW's first updates
alone, whose signs follow gradients near zero: see
test_torch_codec_train.py); the metrics of each step 1e-5.
"""

import dataclasses
import importlib.util
import os
import struct
import sys
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from smalltts_tpu.models import codec as JC  # noqa: E402
from smalltts_tpu.onnxjax.codec import OnnxCodec as JOnnxCodec  # noqa: E402
from smalltts_tpu.train import codec_distill as JD  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils import config_io as jcio  # noqa: E402
from smalltts_tpu_torch.models import codec as PC  # noqa: E402
from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec  # noqa: E402
from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export  # noqa: E402
from smalltts_tpu_torch.train import codec_distill as PD  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_MINI = JC.CodecConfig(strides=(4, 5), channels=(32, 24, 8), res_dilations=(1,))
P_MINI = PC.CodecConfig(**dataclasses.asdict(J_MINI))
SAMPLES = 2400  # 0.1 s: 120 frames of hop 20, every STFT size fits
TOL = 1e-5
STEP_TOL = 1e-4
ZERO_INIT_STEP_TOL = 2e-2


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """encoder.onnx and decoder.onnx of a seeded mini codec, exported by the port."""
    d = tmp_path_factory.mktemp("mini_codec")
    cp = PC.init_codec(torch.Generator().manual_seed(5), P_MINI)
    (d / "encoder.onnx").write_bytes(export(CodecEncoder(cp, P_MINI), (0.1 * torch.randn(1, 1, 4 * P_MINI.hop),),
                                            dynamic_axes={"audio": {0: "b", 2: "t"}}, input_names=["audio"]))
    (d / "decoder.onnx").write_bytes(export(CodecDecoder(cp, P_MINI), (torch.randn(1, 4, 64),),
                                            dynamic_axes={"latents": {0: "b", 1: "t"}}, input_names=["latents"]))
    return d


def teachers(d, encoder=True):
    enc = str(d / "encoder.onnx") if encoder else None
    return OnnxCodec(enc, str(d / "decoder.onnx"), device="cpu"), JOnnxCodec(enc, str(d / "decoder.onnx"))


def test_configs_match_jax():
    assert dataclasses.asdict(PD.CodecDistillConfig()) == dataclasses.asdict(JD.CodecDistillConfig())
    assert PD.STFT_SIZES == JD.STFT_SIZES


@pytest.mark.parametrize("samples,used", [(4096, 3), (1500, 2), (400, 0)])
def test_multi_stft_loss_matches_jax(samples, used):
    rs = np.random.RandomState(samples)
    a, b = (0.3 * rs.randn(2, samples)).astype(np.float32), (0.3 * rs.randn(2, samples)).astype(np.float32)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = float(JD.multi_stft_loss(jnp.asarray(a), jnp.asarray(b)))
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = float(PD.multi_stft_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert sum(n <= samples for n in PD.STFT_SIZES) == used
    if used:
        assert not pw and abs(got - want) <= TOL * abs(want) and want > 0.1
        assert float(PD.multi_stft_loss(torch.from_numpy(a), torch.from_numpy(a))) < 1e-5
    else:
        assert got == want == 0.0
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw if "STFT" in str(w.message)]
        assert "shorter than every STFT resolution" in str(pw[0].message)


def test_synthetic_audio_iter_bit_for_bit():
    j_it, p_it = JD.synthetic_audio_iter(3, 800, seed=4), PD.synthetic_audio_iter(3, 800, seed=4)
    for _ in range(3):
        a, b = next(j_it), next(p_it)
        assert a.dtype == b.dtype == np.float32 and a.shape == (3, 1, 800)
        np.testing.assert_array_equal(a, b)


class DuckWithEncode:
    params = {"decoder": {}}

    def decode_fn(self, params, latents):
        return latents

    def encode_fn(self, params, audio):
        return audio


class DuckDecodeOnly:
    params = {"decoder": {}}

    def decode_fn(self, params, latents):
        return latents


@pytest.mark.parametrize("kind", ["encoder", "decoder_only", "duck_with_encode", "duck_decode_only"])
def test_teacher_fns_match_jax(kind, assets):
    if kind in ("encoder", "decoder_only"):
        port, jteacher = teachers(assets, encoder=kind == "encoder")
    else:
        port = jteacher = DuckWithEncode() if kind == "duck_with_encode" else DuckDecodeOnly()
    p_params, p_dec, p_enc = PD._teacher_fns(port)
    j_params, _, j_enc = JD._teacher_fns(jteacher)
    assert p_params is port.params and (p_enc is None) == (j_enc is None) == (kind in ("decoder_only",
                                                                                       "duck_decode_only"))
    lat = np.random.RandomState(0).randn(1, 3, 64).astype(np.float32)
    got = p_dec(p_params, torch.from_numpy(lat))
    if kind in ("encoder", "decoder_only"):
        want = jteacher.decode_fn(j_params, jnp.asarray(lat))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL * float(np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("warmup", [0, 4])
def test_schedule_matches_optax(warmup):
    cfg = PD.CodecDistillConfig(num_steps=20, warmup=warmup, lr=2e-4)
    _, sched = PD.distill_optimizer({"w": torch.zeros(2)}, cfg)
    want = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, warmup, cfg.num_steps, cfg.lr * 0.01)
    for step in sorted({0, 1, warmup, (warmup + cfg.num_steps) // 2, cfg.num_steps - 1, cfg.num_steps}):
        w, g = float(want(step)), float(sched(step))
        assert abs(g - w) <= 1e-6 * cfg.lr, (step, g, w)


@pytest.mark.parametrize("encoder", [True, False], ids=["encoder", "decoder_only"])
def test_two_distill_steps_match_jax(encoder, assets):
    port_teacher, j_teacher = teachers(assets, encoder)
    cfg = JD.CodecDistillConfig(num_steps=10, batch_size=2, seconds_per_sample=0.1, warmup=1)
    p_cfg = PD.CodecDistillConfig(**dataclasses.asdict(cfg))
    jp = jax.tree_util.tree_map(np.asarray, JC.init_codec(jax.random.PRNGKey(0), J_MINI))
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup, cfg.num_steps, cfg.lr * 0.01)))
    j_tp, j_dec, j_enc = JD._teacher_fns(j_teacher)
    j_step = JD.make_codec_distill_step(J_MINI, cfg, j_dec, j_enc, tx)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_opt = tx.init(j_params)
    p_params = params_from_jax(jp, P_MINI)
    p_tx, _ = PD.distill_optimizer(p_params, p_cfg)
    p_opt = p_tx.init(p_params)
    p_tp, p_dec, p_enc = PD._teacher_fns(port_teacher)
    p_step = PD.make_codec_distill_step(P_MINI, p_cfg, p_dec, p_enc, p_tx)
    it = JD.synthetic_audio_iter(2, SAMPLES, seed=0)
    init = pckpt.flatten_pytree(jp)
    zero_init = {k for k, v in init.items() if not np.any(v)}
    key = jax.random.PRNGKey(1)
    for step in range(2):
        audio = next(it)
        key, sub = jax.random.split(key)
        j_params, j_opt, j_metrics = j_step(j_params, j_opt, j_tp, jnp.asarray(audio), sub)
        lat = None if encoder else torch.from_numpy(np.asarray(
            jax.random.normal(sub, (2, SAMPLES // J_MINI.hop, J_MINI.latent_dim))))
        p_params, p_opt, p_metrics = p_step(p_params, p_opt, p_tp, torch.from_numpy(audio), latents=lat)
        assert set(p_metrics) == set(j_metrics)
        assert ("enc_mse" in p_metrics) == encoder
        for k in j_metrics:
            assert abs(float(p_metrics[k]) - float(j_metrics[k])) <= TOL * abs(float(j_metrics[k])), (step, k)
        want = pckpt.flatten_pytree(jax.tree_util.tree_map(np.asarray, j_params))
        got = {k: v.numpy() for k, v in pckpt.flatten_pytree(params_to_jax(p_params, P_MINI)).items()}
        whole = rel_l2(np.concatenate([got[k].ravel() for k in want]), np.concatenate([want[k].ravel() for k in want]))
        assert whole <= STEP_TOL, (step, whole)
        for k in want:
            tol = ZERO_INIT_STEP_TOL if k in zero_init else STEP_TOL
            assert rel_l2(got[k], want[k]) <= tol, (step, k, rel_l2(got[k], want[k]))
    assert max(rel_l2(want[k], init[k]) for k in want) > 1e-5  # the second step moved the params


def test_train_codec_distill_saves_a_checkpoint_jax_reads(tmp_path, assets, capsys):
    teacher, _ = teachers(assets)
    seen = []
    params, metrics = PD.train_codec_distill(
        PD.CodecDistillConfig(num_steps=3, batch_size=2, seconds_per_sample=0.1, save_every=2, warmup=1), P_MINI,
        teacher=teacher, checkpoint_dir=str(tmp_path), log_every=1, device="cpu",
        on_step=lambda step, m: seen.append(step))
    assert seen == [0, 1, 2] and set(metrics) == {"enc_mse", "dec_l1", "dec_stft", "loss"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert "step 2: enc_mse=" in capsys.readouterr().out
    path = str(tmp_path / "codec_distilled.npz")
    assert jcio.codec_config_from_meta(jckpt.load_meta(path)) == J_MINI
    flat = pckpt.flatten_pytree(jckpt.load_pytree(path))
    mine = pckpt.flatten_pytree(params_to_jax(params, P_MINI))
    assert flat.keys() == mine.keys() and all(np.array_equal(np.asarray(flat[k]), mine[k].numpy()) for k in flat)


def test_default_teacher_raises_on_absent_assets_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.setenv("SMALLTTS_ASSETS", str(tmp_path / "absent"))
    with pytest.raises(Exception) as j_err:
        JD.train_codec_distill(JD.CodecDistillConfig(num_steps=1), J_MINI, checkpoint_dir=str(tmp_path))
    with pytest.raises(Exception) as p_err:
        PD.train_codec_distill(PD.CodecDistillConfig(num_steps=1), P_MINI, checkpoint_dir=str(tmp_path), device="cpu")
    assert type(p_err.value) is type(j_err.value)
    assert "encoder.onnx" in str(p_err.value) and "encoder.onnx" in str(j_err.value)


def wav16(samples, sr=16_000):
    data = np.clip(np.rint(samples * 32767), -32768, 32767).astype("<i2").tobytes()
    return struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16,
                       b"data", len(data)) + data


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rs = np.random.RandomState(0)
    for i, n in enumerate((900, 3000, 5000)):  # one clip shorter than a crop
        (d / f"{i}.wav").write_bytes(wav16(0.3 * np.sin(np.arange(n) / (3.0 + i)) + 0.01 * rs.randn(n)))
    (d / "notes.txt").write_text("not audio")
    return d


def test_wav_dir_iter_matches_the_jax_script(wav_dir):
    spec = importlib.util.spec_from_file_location("distill_codec_script", os.path.join(ROOT, "scripts",
                                                                                       "distill_codec.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    j_it, p_it = script.wav_dir_iter(str(wav_dir), 2, 2400, seed=3), PD.wav_dir_iter(str(wav_dir), 2, 2400, seed=3)
    for _ in range(4):
        a, b = next(j_it), next(p_it)
        assert a.shape == b.shape == (2, 1, 2400) and b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    empty = wav_dir / "empty"
    empty.mkdir(exist_ok=True)
    with pytest.raises(SystemExit, match="no .wav files"):
        next(PD.wav_dir_iter(str(empty), 2, 2400))


@pytest.mark.parametrize("encoder", [True, False], ids=["encoder", "decoder_only"])
def test_cli_trains_on_the_exported_assets_and_a_wav_dir(encoder, assets, wav_dir, tmp_path, monkeypatch, capsys):
    d = tmp_path / "codec"
    d.mkdir()
    (d / "decoder.onnx").write_bytes((assets / "decoder.onnx").read_bytes())
    if encoder:
        (d / "encoder.onnx").write_bytes((assets / "encoder.onnx").read_bytes())
    monkeypatch.setattr(PD, "CodecConfig", lambda: P_MINI)  # the student at the teacher's mini width
    rc = PD.main(["--assets", str(d), "--steps", "3", "--batch-size", "2", "--seconds", "0.1", "--checkpoint-dir",
                  str(tmp_path / "ckpt"), "--wav-dir", str(wav_dir), "--save-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "step 0: " in out and "final:" in out
    assert ("enc_mse=" in out) == encoder
    meta = pckpt.load_meta(str(tmp_path / "ckpt" / "codec_distilled.npz"))
    assert jcio.codec_config_from_meta(meta) == J_MINI
    assert PD.main(["--assets", str(tmp_path / "nothing"), "--device", "cpu"]) == 1

"""The port's corpus harness (smalltts_tpu_torch/scripts/imf_corpus.py) and
IMF experiments (exp_imf_boundary, exp_imf_source) against the JAX harness
(tests/test_imf_quality.py) and the root scripts, on the CPU.

- The corpus and the padded batch: the JAX harness's `_build_corpus_and_models`
  with its codec and teacher steps stubbed out (no training), against the
  port's with no steps and the same codec weights: wavs,
  tokens, lengths and phonemes equal, latents and the codec round trip
  within 1e-5 of the largest value (fp32 convolutions in another order).
- `evaluate` on the same latents, codec and SV teacher weights (the JAX
  harness's `_sv_embed_fn` embedding written out on them): the mean
  mel distance within 1e-4 relative and the mean speaker cosine within
  1e-4 of the JAX harness's evaluation.
- exp_imf_source's CONFIGS equal to the root script's, field by field, and
  each ImfConfig they build equal to the JAX package's.
- Both experiment scripts answer --help (the source script with the live
  list of configs, as the root script prints it); an unknown config exits.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_CODEC  # noqa: E402

from smalltts_tpu_torch.scripts import exp_imf_boundary, exp_imf_source  # noqa: E402
from smalltts_tpu_torch.scripts import imf_corpus as H  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_script(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.fixture(scope="module")
def both_corpora():
    """The JAX harness's corpus with its training stubbed out (no codec or
    teacher steps; the teacher's init skipped, the codec's replaced by
    seeded weights of the port's init), and the port's from the same codec
    weights with no steps."""
    import test_imf_quality as jq

    from smalltts_tpu.models import backbone, codec
    from smalltts_tpu.train import codec_train, teacher
    from smalltts_tpu_torch.models.codec import init_codec
    from smalltts_tpu_torch.utils.convert import params_to_jax

    cp = init_codec(torch.Generator().manual_seed(0), H.TINY_CODEC)
    j_cp0 = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params_to_jax(cp))
    mp = pytest.MonkeyPatch()
    mp.setattr(codec, "init_codec", lambda key, cfg: j_cp0)
    # the harness's eager codec calls, jitted: the same functions, one compile a shape instead of one an op
    mp.setattr(codec, "codec_encode", jax.jit(codec.codec_encode, static_argnums=2))
    mp.setattr(codec, "codec_decode", jax.jit(codec.codec_decode, static_argnums=2))
    mp.setattr(backbone, "init_backbone", lambda key, cfg: {})
    mp.setattr(codec_train, "make_codec_step", lambda *a, **k: (lambda cp, oc, aud: (cp, oc, 0.0, None)))
    mp.setattr(teacher, "make_teacher_step", lambda *a, **k: (lambda p, o, e, b, key: (p, o, e, 0.0)))
    try:
        j_utts, j_cp, j_batch, _, _, _ = jq._build_corpus_and_models()
    finally:
        mp.undo()
    utts, p_cp, batch, _, _, codec_cfg = H.build_corpus_and_models(0, 0, device="cpu", codec_params=cp)
    assert dataclasses.asdict(codec_cfg) == dataclasses.asdict(TINY_CODEC)
    return j_utts, j_cp, j_batch, utts, p_cp, batch


def test_corpus_and_padded_batch_equal_jax(both_corpora):
    j_utts, _, j_batch, utts, _, batch = both_corpora
    assert len(utts) == len(j_utts) == 6
    for u, w in zip(utts, j_utts):
        assert (u["text"], u["speaker"]) == (w["text"], w["speaker"])
        np.testing.assert_array_equal(u["wav"], w["wav"])
        np.testing.assert_array_equal(u["tokens"], w["tokens"])
        assert u["latents"].shape == w["latents"].shape and _rel(u["latents"], w["latents"]) < 1e-5
        assert u["rec_floor"].shape == w["rec_floor"].shape and _rel(u["rec_floor"], w["rec_floor"]) < 1e-5
    assert sorted(batch) == sorted(j_batch)
    for k in ("latents_lengths", "ref_latents_lengths", "phonemes", "phonemes_lengths"):
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(j_batch[k]))
    for k in ("latents", "ref_latents"):
        assert batch[k].shape == j_batch[k].shape and _rel(batch[k].numpy(), j_batch[k]) < 1e-5


def test_evaluate_equals_jax_on_the_same_latents(both_corpora):
    """The port's evaluate against the JAX harness's evaluation (its body,
    written out here: the JAX test defines it inside the test function), on
    the JAX corpus's own latents nudged by a fixed noise."""
    from smalltts_tpu.models.codec import codec_decode
    from smalltts_tpu.models.sv import SVConfig
    from smalltts_tpu.models.sv_teacher import resample_24k_to_16k, sv_teacher_embed
    from smalltts_tpu.utils.metrics import mel_distance
    from smalltts_tpu_torch.models.sv_teacher import init_sv_teacher
    from smalltts_tpu_torch.utils.convert import params_to_jax

    j_utts, j_cp, _, utts, p_cp, _ = both_corpora
    rs = np.random.RandomState(5)
    lats = [u["latents"][None] + 0.1 * rs.randn(1, *u["latents"].shape).astype(np.float32) for u in j_utts]
    cfg = SVConfig(input_dim=80, channels=(16, 16, 16, 16, 48), emb_dim=8, attention_channels=8, se_channels=8,
                   res2net_scale=2)  # the JAX harness's _sv_embed_fn config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(H.TINY_SV_TEACHER)
    sv_params = init_sv_teacher(torch.Generator().manual_seed(7), H.TINY_SV_TEACHER)
    j_sv = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params_to_jax(sv_params, H.TINY_SV_TEACHER))

    embed = jax.jit(lambda p, a: sv_teacher_embed(p, a, cfg=cfg))
    decode = jax.jit(codec_decode, static_argnums=2)

    def j_embed(wav):  # the JAX harness's _sv_embed_fn embed (jitted), on the same weights
        a16 = resample_24k_to_16k(np.asarray(wav, np.float32)[None, None, :])
        e = np.asarray(embed(j_sv, a16))[0]
        return e / (np.linalg.norm(e) + 1e-9)

    mels, svs = [], []
    for i, u in enumerate(j_utts):  # the JAX harness's evaluate, sample_fn returning lats[i]
        audio = np.asarray(decode(j_cp, jnp.asarray(lats[i], jnp.float32), TINY_CODEC))[0, 0]
        gt = u["wav"][: len(audio)]
        audio = audio[: len(gt)]
        mels.append(mel_distance(gt, audio))
        svs.append(float(j_embed(gt) @ j_embed(audio)))
    want = (float(np.mean(mels)), float(np.mean(svs)))
    got = H.evaluate(utts, p_cp, H.TINY_CODEC, H.sv_embed_fn("cpu", sv_params), lambda i, T, gen: lats[i])
    assert abs(got[0] - want[0]) <= 1e-4 * want[0] and abs(got[1] - want[1]) <= 1e-4, (got, want)
    assert abs(H.codec_floor(utts) - float(np.mean([mel_distance(u["wav"][: len(u["rec_floor"])], u["rec_floor"])
                                                    for u in j_utts]))) <= 1e-4 * want[0]


def test_exp_imf_source_configs_equal_the_root_script():
    from smalltts_tpu.train.imf import ImfConfig as JImfConfig
    from smalltts_tpu_torch.train.imf import ImfConfig

    root = _root_script("exp_imf_source")
    assert list(exp_imf_source.CONFIGS) == list(root.CONFIGS)
    for name, entry in root.CONFIGS.items():
        assert exp_imf_source.CONFIGS[name] == entry, name
        assert dataclasses.asdict(ImfConfig(**entry[1])) == dataclasses.asdict(JImfConfig(**entry[1])), name


def _help(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_exp_scripts_answer_help(monkeypatch):
    rc, out = _help(exp_imf_boundary.main, ["--help"])
    assert rc == 0 and "usage: python -m smalltts_tpu_torch.scripts.exp_imf_boundary" in out
    rc, out = _help(exp_imf_source.main, ["-h"])
    assert rc == 0 and "usage: python -m smalltts_tpu_torch.scripts.exp_imf_source" in out
    root = _root_script("exp_imf_source")
    monkeypatch.setattr(sys, "argv", ["exp_imf_source.py", "--help"])
    _, want = _help(lambda argv: root.main(), None)
    assert out.strip().splitlines()[-1] == want.strip().splitlines()[-1]
    assert out.strip().splitlines()[-1] == "configs: " + " ".join(exp_imf_source.CONFIGS) + " all"
    with pytest.raises(SystemExit, match="unknown configs"):
        exp_imf_source.main(["nope", "--device", "cpu"])

"""The port's data loaders (smalltts_tpu_torch/data/{synthetic,local}.py)
against the JAX package's, on the CPU, and the trainer CLIs' data flags.

- write_corpus writes byte-identical files to JAX's for one seed;
- scan_corpus reads both layouts; LocalDataset and get_local_dataloader
  give JAX's batches exactly (one numpy encoder on both sides; each side's
  own text frontend, the chars backend here); a corrupt clip is skipped;
- default_encode_fn from a native-codec checkpoint (tests/tiny.py's codec)
  encodes as JAX's does, within 1e-5 of the largest JAX latent (fp32
  convolutions summed in another order);
- an error in the loader's producer thread is raised in the loop;
- every trainer CLI (ASR, SV, distill, teacher) passes --data-dir and its
  codec flag to cli_data_iter and the iterator to its trainer.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

sys.path.insert(0, "tests")
from tiny import TINY_CODEC  # noqa: E402

from smalltts_tpu.data import local as JL  # noqa: E402
from smalltts_tpu.data import synthetic as JS  # noqa: E402
from smalltts_tpu.models import codec as JCo  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu_torch.data import local as PL  # noqa: E402
from smalltts_tpu_torch.data import synthetic as PS  # noqa: E402
from smalltts_tpu_torch.models import codec as PCo  # noqa: E402

HOP = 20  # a stand-in codec's hop, as tests/test_local_data.py
CFG = dict(batch_size=2, latent_dim=8, max_phonemes=32, max_latents=24, max_ref=8, min_latents=4, hop=HOP)


def fake_encode(audio):
    """(B, 1, T) -> (B, T // HOP, 8): each frame's mean and its index."""
    b, _, t = audio.shape
    frames = audio[:, 0, : (t // HOP) * HOP].reshape(b, t // HOP, HOP)
    feat = np.zeros((b, t // HOP, 8), np.float32)
    feat[..., 0] = frames.mean(-1)
    feat[..., 1] = np.arange(t // HOP)[None, :]
    return feat


def test_write_corpus_is_jax_byte_for_byte(tmp_path):
    want = JS.write_corpus(str(tmp_path / "jax"), n_utts=6, n_speakers=3, seed=7)
    got = PS.write_corpus(str(tmp_path / "port"), n_utts=6, n_speakers=3, seed=7)
    assert [(os.path.basename(w), t, s) for w, t, s in got] == [(os.path.basename(w), t, s) for w, t, s in want]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 12
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    assert np.array_equal(PS.synth_speech("blue moon", 2, seed=3), JS.synth_speech("blue moon", 2, seed=3))
    rng_j, rng_p = np.random.RandomState(5), np.random.RandomState(5)
    assert [PS.make_text(rng_p) for _ in range(4)] == [JS.make_text(rng_j) for _ in range(4)]


def _corpus(root, metadata):
    entries = PS.write_corpus(str(root), n_utts=5, n_speakers=2, seed=1)
    if metadata:  # LJSpeech's id|raw|normalized, the .txt files gone
        lines = []
        for wav, text, _ in entries:
            os.remove(wav[:-4] + ".txt")
            lines.append(f"{os.path.basename(wav)[:-4]}|RAW {text}|{text}")
        (root / "metadata.csv").write_text("\n".join(lines) + "\n")
    return entries


@pytest.mark.parametrize("metadata", [False, True], ids=["sidecar", "metadata"])
def test_local_dataset_batches_match_jax(tmp_path, metadata):
    _corpus(tmp_path, metadata)
    assert PL.scan_corpus(str(tmp_path)) == JL.scan_corpus(str(tmp_path))
    jds = JL.LocalDataset(str(tmp_path), fake_encode, JL.LocalDataConfig(**CFG))
    pds = PL.LocalDataset(str(tmp_path), fake_encode, PL.LocalDataConfig(**CFG))
    assert pds.texts == jds.texts and len(pds) == len(jds) == 5
    assert all(np.array_equal(a, b) for a, b in zip(pds.tokens, jds.tokens))
    assert all(np.array_equal(a, b) for a, b in zip(pds.latents, jds.latents))
    jit_, pit = JL.get_local_dataloader(str(tmp_path), fake_encode, JL.LocalDataConfig(**CFG), seed=3), \
        PL.get_local_dataloader(str(tmp_path), fake_encode, PL.LocalDataConfig(**CFG), seed=3)
    for _ in range(3):
        want, got = next(jit_), next(pit)
        assert got.keys() == want.keys()
        for k in want:
            assert (got[k] == want[k]) if k == "texts" else np.array_equal(got[k], want[k]), k
    assert dataclasses.asdict(PL.dataset_dummy_compat(PL.LocalDataConfig(**CFG))) == \
        dataclasses.asdict(JL.dataset_dummy_compat(JL.LocalDataConfig(**CFG)))


def test_corrupt_clip_skipped_and_short_corpus_refused(tmp_path, capfd):
    _corpus(tmp_path, False)
    (tmp_path / "0000.wav").write_bytes(b"not a wav")
    ds = PL.LocalDataset(str(tmp_path), fake_encode, PL.LocalDataConfig(**CFG))
    assert len(ds) == 4 and "skipping" in capfd.readouterr().err
    short = tmp_path / "short"
    short.mkdir()
    PS.write_corpus(str(short), n_utts=2, seed=0)
    with pytest.raises(ValueError, match="shorter"):
        PL.LocalDataset(str(short), fake_encode, PL.LocalDataConfig(**{**CFG, "min_latents": 10 ** 6}))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no \\(wav, text\\) pairs"):
        PL.scan_corpus(str(tmp_path / "empty"))


def test_producer_error_surfaces_in_the_loop(tmp_path, monkeypatch):
    _corpus(tmp_path, False)

    def broken(self, rng):
        raise RuntimeError("producer failed")

    monkeypatch.setattr(PL.LocalDataset, "sample_batch", broken)
    it = PL.get_local_dataloader(str(tmp_path), fake_encode, PL.LocalDataConfig(**CFG))
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_default_encode_fn_from_a_checkpoint_matches_jax(tmp_path):
    jp = JCo.init_codec(jax.random.PRNGKey(0), TINY_CODEC)
    path = str(tmp_path / "codec.npz")
    jckpt.save_pytree(path, jp)
    pcfg = PCo.CodecConfig(**dataclasses.asdict(TINY_CODEC))
    audio = (0.3 * np.random.RandomState(0).randn(2, 1, 4 * TINY_CODEC.hop)).astype(np.float32)
    want = np.asarray(JL.default_encode_fn(path, TINY_CODEC)(audio))
    got = PL.default_encode_fn(path, pcfg, device="cpu")(audio)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape == (2, 4, 64)
    assert float(np.abs(got.numpy() - want).max() / np.abs(want).max()) <= 1e-5
    with pytest.warns(UserWarning, match="random-init codec"):
        enc = PL.default_encode_fn(None, pcfg, device="cpu")
    assert enc(audio).shape == (2, 4, 64)


def test_cli_data_iter_without_a_directory_is_none():
    assert PL.cli_data_iter(None, None, 2) is None and PL.cli_data_iter("", "c.npz", 2) is None


@pytest.mark.parametrize("cli", ["asr", "sv", "distill", "teacher"])
def test_each_cli_passes_data_dir_to_its_trainer(cli, tmp_path, monkeypatch):
    from smalltts_tpu_torch.train import asr_train, distill, sv_train, teacher

    sentinel, seen = object(), {}

    def fake_iter(data_dir, codec_checkpoint, batch_size, device=None):
        seen["args"] = (data_dir, codec_checkpoint, batch_size)
        return sentinel

    def fake_train(*args, **kw):
        seen["data_iter"] = kw.get("data_iter")

    monkeypatch.setattr(PL, "cli_data_iter", fake_iter)
    module, fn, flag = {"asr": (asr_train, "train_asr", "--data-codec-checkpoint"),
                        "sv": (sv_train, "train_sv", "--data-codec-checkpoint"),
                        "distill": (distill, "train_distill", "--data-codec-checkpoint"),
                        "teacher": (teacher, "train_teacher", "--codec-checkpoint")}[cli]
    monkeypatch.setattr(module, fn, fake_train)
    argv = ["--steps", "1", "--batch-size", "3", "--data-dir", str(tmp_path), flag, "c.npz"]
    if cli == "distill":
        for name in ("t.npz", "a.npz", "s.npz"):
            (tmp_path / name).write_bytes(b"")
        argv += ["--teacher", str(tmp_path / "t.npz"), "--asr", str(tmp_path / "a.npz"), "--sv",
                 str(tmp_path / "s.npz")]
    module.main(argv)
    assert seen == {"args": (str(tmp_path), "c.npz", 3), "data_iter": sentinel}

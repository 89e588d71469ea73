"""The port's waveform SV teacher (smalltts_tpu_torch/models/sv_teacher.py)
against the JAX package's, on the CPU in fp32, on the same numpy inputs and
weights.

- fbank, mean_norm (with and without lengths) and resample_24k_to_16k
  (length and values) at 1e-5 of the largest JAX value (the FFT and the
  convolution sum in another order);
- sv_teacher_embed on a small ECAPA of the voxceleb layout (res2net scale
  8, so the speechbrain converter's fixed scale applies), its weights a
  speechbrain-keyed state dict converted by JAX's converter, 1e-5;
- convert_speechbrain_teacher bit for bit against JAX's, with and without
  the `embedding_model.` prefix; load_teacher from a torch checkpoint
  (plain and under "state_dict") and from an npz, bit for bit against the
  JAX package's load_teacher carried across by params_from_jax.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from test_torch_convert_aux import _fake_speechbrain_ecapa_sd  # noqa: E402

from smalltts_tpu.models import sv_teacher as JT  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu_torch.models import sv as PSV  # noqa: E402
from smalltts_tpu_torch.models import sv_teacher as PT  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax  # noqa: E402

TOL = 1e-5
# the voxceleb ECAPA's kernels, dilations and res2net scale at narrow widths
J_SMALL = dataclasses.replace(JT.VOXCELEB_ECAPA, emb_dim=16, channels=(32, 32, 32, 32, 96), attention_channels=8,
                              se_channels=8)
P_SMALL = PSV.SVConfig(**dataclasses.asdict(J_SMALL))


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def speechbrain_sd(prefix="embedding_model."):
    sd = _fake_speechbrain_ecapa_sd(J_SMALL, np.random.RandomState(0))
    return {f"{prefix}{k[len('ecapa.'):]}": v for k, v in sd.items()}


def test_fbank_mean_norm_and_resampler_match_jax():
    rs = np.random.RandomState(0)
    wav = (0.1 * rs.randn(2, 4000)).astype(np.float32)
    want = np.array(JT.fbank(jnp.asarray(wav)))
    got = PT.fbank(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, 1 + 4000 // 160, 80)
    assert rel(got, want) <= TOL
    lengths = np.array([26, 9], np.int32)
    for ln in (None, lengths):
        jw = JT.mean_norm(jnp.asarray(want), None if ln is None else jnp.asarray(ln))
        pw = PT.mean_norm(torch.from_numpy(want), None if ln is None else torch.from_numpy(ln))
        assert rel(pw, jw) <= TOL
    for t in (3000, 3001, 4802):
        audio = (0.3 * rs.randn(2, 1, t)).astype(np.float32)
        want_r = np.asarray(JT.resample_24k_to_16k(jnp.asarray(audio)))
        got_r = PT.resample_24k_to_16k(torch.from_numpy(audio))
        assert got_r.shape == want_r.shape == (2, 1, (2 * t - 2) // 3 + 1), (got_r.shape, want_r.shape)
        assert rel(got_r, want_r) <= TOL


def test_speechbrain_conversion_is_jax_bit_for_bit():
    for prefix in ("embedding_model.", ""):
        sd = speechbrain_sd(prefix)
        want = jckpt.flatten_pytree(JT.convert_speechbrain_teacher(sd))
        got = pckpt.flatten_pytree(PT.convert_speechbrain_teacher(sd))
        assert got.keys() == want.keys()
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype and np.array_equal(got[k], want[k]), k
    assert len(PT.convert_speechbrain_teacher(speechbrain_sd())["blocks"][0]["res2net"]) == 7


def test_teacher_embed_matches_jax():
    jp = JT.convert_speechbrain_teacher(speechbrain_sd())
    pp = params_from_jax(jp, P_SMALL)
    rs = np.random.RandomState(1)
    audio = (0.2 * rs.randn(2, 1, 9600)).astype(np.float32)
    lengths = np.array([9600, 5000], np.int32)
    for ln in (None, lengths):
        want = JT.sv_teacher_embed(jp, jnp.asarray(audio), None if ln is None else jnp.asarray(ln), cfg=J_SMALL)
        got = PT.sv_teacher_embed(pp, torch.from_numpy(audio), None if ln is None else torch.from_numpy(ln),
                                  cfg=P_SMALL)
        assert got.shape == (2, 16) and rel(got, want) <= TOL
    # the 24 kHz teacher function: resampled, lengths scaled to 16 kHz
    jfn, _ = JT.make_teacher_fn(jp, J_SMALL)
    pfn, _ = PT.make_teacher_fn(pp, P_SMALL)
    audio24 = (0.2 * rs.randn(2, 1, 6400)).astype(np.float32)
    want = jfn(jp, jnp.asarray(audio24), jnp.asarray([6400, 3200]))
    assert rel(pfn(pp, torch.from_numpy(audio24), torch.tensor([6400, 3200])), want) <= TOL


def test_load_teacher_from_a_torch_checkpoint_and_an_npz(tmp_path):
    sd = speechbrain_sd()
    want = pckpt.flatten_pytree(params_from_jax(JT.convert_speechbrain_teacher(sd), P_SMALL))
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save(tsd, tmp_path / "embedding_model.ckpt")
    torch.save({"state_dict": tsd}, tmp_path / "wrapped.ckpt")
    jckpt.save_pytree(str(tmp_path / "teacher.npz"), JT.load_teacher(str(tmp_path / "embedding_model.ckpt")))
    for name in ("embedding_model.ckpt", "wrapped.ckpt", "teacher.npz"):
        got = pckpt.flatten_pytree(PT.load_teacher(str(tmp_path / name)))
        assert got.keys() == want.keys(), name
        assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want), name

"""The port's codec trainer (smalltts_tpu_torch/train/codec_train.py) against
the JAX package's, on the CPU in fp32, with a mini codec (strides (4, 5),
hop 20), the same weights (JAX's init carried across by params_from_jax) and
the same numpy batches.

Tolerances, relative to the JAX value: the STFT loss and codec_loss with its
aux 1e-5 (the FFT and the convolutions sum in another order); the params
after each of two AdamW steps 1e-4 rel-L2 over the whole tree and over each
leaf the init did not set to zero. The zero-init leaves (every snake
log_alpha) hold AdamW's first updates alone, g / (|g| + eps) of ~1e-4
each, and the gradients agree to 1e-5-1e-4 rel-L2 per leaf (the log of
small STFT magnitudes magnifies fp32 rounding), so an element whose
gradient is near zero can take the other sign: up to 7.6e-3 measured,
held at 2e-2. A checkpoint the port saves decodes in JAX within 1e-5 of
the port's decode; the gradient through an exact-zero STFT bin 1e-5 of the
largest.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

sys.path.insert(0, "tests")

from smalltts_tpu.models import codec as JC  # noqa: E402
from smalltts_tpu.train import codec_train as JT  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils import config_io as jcio  # noqa: E402
from smalltts_tpu_torch.models import codec as PC  # noqa: E402
from smalltts_tpu_torch.train import codec_train as PT  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils import config_io as pcio  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax  # noqa: E402

J_MINI = JC.CodecConfig(strides=(4, 5), channels=(32, 24, 8), res_dilations=(1,))
P_MINI = PC.CodecConfig(**dataclasses.asdict(J_MINI))
SEGMENT = 2400  # 120 frames of hop 20; fits the 2048-sample resolution
TRAIN = JT.CodecTrainConfig(batch_size=2, segment_samples=SEGMENT)
P_TRAIN = PT.CodecTrainConfig(batch_size=2, segment_samples=SEGMENT)
TOL = 1e-5
STEP_TOL = 1e-4
ZERO_INIT_STEP_TOL = 2e-2


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


def jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray, JC.init_codec(jax.random.PRNGKey(seed), J_MINI))


def test_config_and_codec_meta_match_jax():
    assert dataclasses.asdict(P_TRAIN) == dataclasses.asdict(TRAIN)
    assert dataclasses.asdict(PT.CodecTrainConfig()) == dataclasses.asdict(JT.CodecTrainConfig())
    assert pcio.codec_meta(P_MINI) == jcio.codec_meta(J_MINI)
    assert pcio.codec_config_from_meta(jcio.codec_meta(J_MINI)) == P_MINI


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_resolution_stft_loss_matches_jax(seed):
    rs = np.random.RandomState(seed)
    a, b = (0.3 * rs.randn(2, 4096)).astype(np.float32), (0.3 * rs.randn(2, 4096)).astype(np.float32)
    res = TRAIN.stft_resolutions
    want = float(JT.multi_resolution_stft_loss(jnp.asarray(a), jnp.asarray(b), res))
    got = float(PT.multi_resolution_stft_loss(torch.from_numpy(a), torch.from_numpy(b), res))
    assert abs(got - want) <= TOL * abs(want)
    assert float(PT.multi_resolution_stft_loss(torch.from_numpy(a), torch.from_numpy(a), res)) == 0.0


def test_codec_loss_and_aux_match_jax():
    jp = jax_params()
    audio = next(JT.dummy_audio_iter(2, SEGMENT, seed=3))
    want, want_aux = JT.codec_loss(jax.tree_util.tree_map(jnp.asarray, jp), J_MINI, jnp.asarray(audio), TRAIN)
    got, got_aux = PT.codec_loss(params_from_jax(jp, P_MINI), P_MINI, torch.from_numpy(audio), P_TRAIN)
    assert list(got_aux) == list(want_aux) == ["stft", "wav_l1", "latent_rms"]
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    for k in want_aux:
        assert abs(float(got_aux[k]) - float(want_aux[k])) <= TOL * abs(float(want_aux[k])), k


def test_two_codec_steps_match_jax():
    jp = jax_params()
    batches = [next(it) for it in [JT.dummy_audio_iter(2, SEGMENT, seed=5)] for _ in range(2)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(TRAIN.lr, weight_decay=1e-2))
    j_step = JT.make_codec_step(J_MINI, TRAIN, tx)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_opt = tx.init(j_params)
    p_params = params_from_jax(jp, P_MINI)
    p_tx = PT.codec_optimizer(p_params, P_TRAIN)
    p_opt = p_tx.init(p_params)
    p_step = PT.make_codec_step(P_MINI, P_TRAIN, p_tx)
    moved = 0.0
    init = pckpt.flatten_pytree(jp)
    zero_init = {k for k, v in init.items() if not np.any(v)}
    assert zero_init and all("log_alpha" in k.split("/")[-1] for k in zero_init)
    for audio in batches:
        j_params, j_opt, j_loss, j_aux = j_step(j_params, j_opt, jnp.asarray(audio))
        p_params, p_opt, p_loss, p_aux = p_step(p_params, p_opt, torch.from_numpy(audio))
        assert abs(float(p_loss) - float(j_loss)) <= TOL * abs(float(j_loss))
        want = pckpt.flatten_pytree(jax.tree_util.tree_map(np.asarray, j_params))
        got = pckpt.flatten_pytree(params_to_jax(p_params, P_MINI))
        assert got.keys() == want.keys()
        whole = rel_l2(np.concatenate([got[k].numpy().ravel() for k in want]),
                       np.concatenate([want[k].ravel() for k in want]))
        assert whole <= STEP_TOL, whole
        for k in want:
            tol = ZERO_INIT_STEP_TOL if k in zero_init else STEP_TOL
            assert rel_l2(got[k].numpy(), want[k]) <= tol, (k, rel_l2(got[k].numpy(), want[k]))
        moved = max(moved, max(rel_l2(want[k], init[k]) for k in want))
    assert int(p_opt["count"]) == 2 and moved > 1e-5  # the steps moved the params


def test_dummy_audio_iter_bit_for_bit():
    j_it, p_it = JT.dummy_audio_iter(3, 640, seed=7), PT.dummy_audio_iter(3, 640, seed=7)
    for _ in range(3):
        a, b = next(j_it), next(p_it)
        assert a.dtype == b.dtype == np.float32 and a.shape == (3, 1, 640)
        np.testing.assert_array_equal(a, b)


def test_train_codec_saves_a_checkpoint_jax_decodes(tmp_path, capsys):
    params = PT.train_codec(PT.CodecTrainConfig(num_steps=3, batch_size=2, segment_samples=SEGMENT, save_every=2),
                            P_MINI, seed=0, checkpoint_dir=str(tmp_path), log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert "step 2: codec_loss=" in out and "latent_rms=" in out
    path = str(tmp_path / "checkpoint_latest.npz")
    assert jcio.codec_config_from_meta(jckpt.load_meta(path)) == J_MINI
    tree = jckpt.load_pytree(path)
    flat, mine = pckpt.flatten_pytree(tree), pckpt.flatten_pytree(params_to_jax(params, P_MINI))
    assert flat.keys() == mine.keys() and all(np.array_equal(np.asarray(flat[k]), mine[k].numpy()) for k in flat)
    lat = np.random.RandomState(0).randn(2, 6, 64).astype(np.float32)
    want = JC.codec_decode(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(lat), J_MINI)
    got = PC.codec_decode(params, torch.from_numpy(lat), P_MINI)
    assert rel(got, np.asarray(want)) <= TOL


def test_train_codec_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.train_codec(PT.CodecTrainConfig(num_steps=1), P_MINI)


def test_gradient_through_an_exact_zero_bin_matches_jax():
    """The first 1024 samples of the prediction are zero, so its first frames
    at every resolution have exact-zero bins: |rfft|'s gradient there is 0 in
    both packages (torch.abs's at complex 0 as well), and the gradient is
    finite and equal."""
    z = torch.zeros(3, dtype=torch.complex64, requires_grad=True)
    torch.abs(z).sum().backward()
    assert torch.equal(z.grad, torch.zeros_like(z.grad))
    rs = np.random.RandomState(2)
    pred = (0.3 * rs.randn(1, 4096)).astype(np.float32)
    pred[:, :1024] = 0.0
    target = (0.3 * rs.randn(1, 4096)).astype(np.float32)
    res = TRAIN.stft_resolutions
    want = np.asarray(jax.grad(lambda p: JT.multi_resolution_stft_loss(p, jnp.asarray(target), res))(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    PT.multi_resolution_stft_loss(p, torch.from_numpy(target), res).backward()
    assert bool(torch.isfinite(p.grad).all()) and np.isfinite(want).all()
    assert float(PT._stft_mag(torch.from_numpy(pred), 512, 128)[0, 0].abs().max()) == 0.0
    assert rel(p.grad, want) <= TOL

"""The codec trainer: the waveform autoencoder (models/codec.py) trained from
scratch on an L1 waveform loss plus a multi-resolution STFT loss (port of
smalltts_tpu/train/codec_train.py). Batch 8 of 25,600-sample segments,
AdamW 1e-4 (weight decay 1e-2) after clipping the global norm to 1, a
save every 2000 steps in the JAX package's layout with the codec's config.

The codec runs in fp32; on the card its convolutions are cuDNN's with TF32
off in the forward and the backward (ops/nn.conv1d), and the STFTs are
torch.fft's. The step is functional (new trees back).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, codec_encode, init_codec
from smalltts_tpu_torch.train.optim import adamw, apply_updates, value_and_grad


@dataclass(frozen=True)
class CodecTrainConfig:
    num_steps: int = 500_000
    batch_size: int = 8
    segment_samples: int = 3200 * 8  # ~1.07 s segments
    lr: float = 1e-4
    save_every: int = 2_000
    stft_resolutions: Tuple[Tuple[int, int], ...] = ((512, 128), (1024, 256), (2048, 512))
    wav_l1_weight: float = 10.0


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, 1 + (T - n_fft) // hop, n_fft // 2 + 1): |rfft| of
    Hann-windowed frames (the window is numpy's hanning, as jnp.hanning)."""
    frames = x.unfold(-1, n_fft, hop)
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(device=x.device, dtype=x.dtype)
    return torch.abs(torch.fft.rfft(frames * window, dim=-1))


def multi_resolution_stft_loss(pred: torch.Tensor, target: torch.Tensor, resolutions) -> torch.Tensor:
    """Spectral convergence (the 2-norm of the difference over all elements,
    over the target's) plus log-magnitude L1 (epsilon 1e-6 in the log),
    averaged over the resolutions, each (n_fft, hop); the clips must fit
    every resolution. Distinct from codec_distill.multi_stft_loss (hop
    n_fft / 4 there, the epsilon inside the magnitude, short clips
    tolerated)."""
    loss = 0.0
    for n_fft, hop in resolutions:
        p = _stft_mag(pred, n_fft, hop)
        t = _stft_mag(target, n_fft, hop)
        sc = torch.linalg.vector_norm(t - p) / torch.clamp_min(torch.linalg.vector_norm(t), 1e-6)
        log_l1 = torch.abs(torch.log(p + 1e-6) - torch.log(t + 1e-6)).mean()
        loss = loss + sc + log_l1
    return loss / len(resolutions)


def codec_loss(params, cfg: CodecConfig, audio: torch.Tensor, train_cfg: CodecTrainConfig):
    """audio (B, 1, T), T a multiple of the hop -> (loss, {"stft", "wav_l1",
    "latent_rms"})."""
    latents = codec_encode(params, audio, cfg)
    recon = codec_decode(params, latents, cfg)
    wav_l1 = torch.abs(recon - audio).mean()
    stft = multi_resolution_stft_loss(recon[:, 0, :], audio[:, 0, :], train_cfg.stft_resolutions)
    return stft + train_cfg.wav_l1_weight * wav_l1, {
        "stft": stft, "wav_l1": wav_l1, "latent_rms": torch.sqrt((latents ** 2).mean())}


def codec_optimizer(params, train_cfg: CodecTrainConfig = CodecTrainConfig()):
    """optax.chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=1e-2))."""
    return adamw(params, train_cfg.lr, weight_decay=1e-2, clip_norm=1.0)


def make_codec_step(cfg: CodecConfig, train_cfg: CodecTrainConfig, tx):
    """step(params, opt_state, audio) -> (params, opt_state, loss, aux), the
    loss and aux detached on the device."""

    def step(params, opt_state, audio):
        loss, aux, grads = value_and_grad(params, lambda p: codec_loss(p, cfg, audio, train_cfg))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss, {k: v.detach() for k, v in aux.items()}

    return step


def dummy_audio_iter(batch_size: int, segment: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Random audio: (batch, 1, segment) float32 of 0.3 x N(0, 1), numpy's draws."""
    rng = np.random.default_rng(seed)
    while True:
        yield (0.3 * rng.standard_normal((batch_size, 1, segment))).astype(np.float32)


def train_codec(
    train_cfg: CodecTrainConfig = CodecTrainConfig(),
    cfg: CodecConfig = CodecConfig(),
    data_iter: Optional[Iterator] = None,
    seed: int = 0,
    checkpoint_dir: str = "assets/codec_checkpoints",
    log_every: int = 100,
    device=None,
    on_step=None,
):
    """The training loop on `data_iter`'s (B, 1, T) numpy batches (random
    audio by default), on the card unless `device` says otherwise. The init
    draws from a torch.Generator seeded with `seed`. At step % save_every ==
    0 past step 1 it writes checkpoint_latest.npz in the JAX package's
    layout with codec_meta(cfg). `on_step(step, loss)`, when given, is
    called after each step with the loss on the device. Returns the params."""
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import codec_meta
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    dev = resolve_device(device)
    params = init_codec(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    tx = codec_optimizer(params, train_cfg)
    opt_state = tx.init(params)
    step_fn = make_codec_step(cfg, train_cfg, tx)
    data_iter = data_iter or dummy_audio_iter(train_cfg.batch_size, train_cfg.segment_samples, seed)
    for step in range(train_cfg.num_steps):
        audio = to_device(next(data_iter), dev)
        params, opt_state, loss, aux = step_fn(params, opt_state, audio)
        if on_step is not None:
            on_step(step, loss)
        if step % log_every == 0:
            print(f"step {step}: codec_loss={float(loss):.4f} "
                  + " ".join(f"{k}={float(v):.4f}" for k, v in aux.items()))
        if step % train_cfg.save_every == 0 and step > 1:
            ckpt.save_pytree(f"{checkpoint_dir}/checkpoint_latest.npz", params_to_jax(params, cfg),
                             meta=codec_meta(cfg))
    return params

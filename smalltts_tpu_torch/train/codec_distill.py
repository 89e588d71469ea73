"""Codec distillation: an imported ONNX codec (the VibeVoice codec of
assets/codec) as the frozen teacher of the fast sub-pixel codec
(models/codec.py) (port of smalltts_tpu/train/codec_distill.py).

- decoder: student_decode(latents) ~ teacher_decode(latents) under L1 on
  the waveform plus a multi-resolution STFT loss (spectral convergence and
  log-magnitude L1 at 3 FFT sizes);
- encoder, when the teacher has one: student_encode(audio) ~
  teacher_encode(audio), MSE in latent space.

The teacher (onnxtorch.codec.OnnxCodec, fp32 with TF32 off) runs without
grad in the same step. With no teacher encoder the decoder learns on
latents drawn from N(0, 1) by a torch.Generator (the JAX package draws them
from its key); a step takes them as an argument too. Schedule: linear
warmup from 0, then cosine to 1% of the peak (optax's
warmup_cosine_decay_schedule); AdamW at optax's default weight decay 1e-4
after clipping the global norm.

    python -m smalltts_tpu_torch.train.codec_distill [--steps 100000] [--batch-size 4]
        [--seconds 1.0] [--assets assets/codec] [--checkpoint-dir assets/codec_checkpoints]
        [--wav-dir DIR] [--save-every 2000] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, codec_encode, init_codec
from smalltts_tpu_torch.train.optim import adamw, apply_updates, value_and_grad, warmup_cosine

STFT_SIZES: Tuple[int, ...] = (512, 1024, 2048)
SAMPLE_RATE = 24_000


@dataclass(frozen=True)
class CodecDistillConfig:
    num_steps: int = 100_000
    batch_size: int = 4
    seconds_per_sample: float = 1.0
    lr: float = 2e-4
    warmup: int = 1_000
    grad_clip: float = 1.0
    l1_weight: float = 1.0
    stft_weight: float = 1.0
    latent_weight: float = 1.0
    save_every: int = 2_000


def _stft_mag(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(B, T) with T >= n_fft -> (B, frames, n_fft // 2 + 1): the magnitude of
    Hann-windowed frames at hop n_fft / 4, sqrt(re^2 + im^2 + 1e-9)."""
    frames = x.unfold(-1, n_fft, n_fft // 4)
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(x.device)
    spec = torch.fft.rfft((frames * window).float(), n=n_fft, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)


def multi_stft_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-resolution STFT loss between (B, T) waveforms: spectral
    convergence plus log-magnitude L1, averaged over the STFT_SIZES that fit
    the audio. Audio shorter than every size warns and gives 0."""
    total, used = 0.0, 0
    for n_fft in STFT_SIZES:
        if a.shape[-1] < n_fft:
            continue
        ma, mb = _stft_mag(a, n_fft), _stft_mag(b, n_fft)
        sc = torch.linalg.vector_norm(ma - mb) / torch.clamp_min(torch.linalg.vector_norm(mb), 1e-6)
        log_l1 = torch.abs(torch.log(ma) - torch.log(mb)).mean()
        total = total + sc + log_l1
        used += 1
    if used == 0:
        warnings.warn(f"audio ({a.shape[-1]} samples) is shorter than every STFT resolution {STFT_SIZES}; "
                      "spectral loss contributes nothing", stacklevel=2)
        return torch.zeros((), device=a.device)
    return total / used


def make_codec_distill_step(
    cfg: CodecConfig,
    train_cfg: CodecDistillConfig,
    teacher_decode: Callable,  # (teacher_params, latents (B, T', 64)) -> (B, 1, T)
    teacher_encode: Optional[Callable],  # (teacher_params, audio) -> latents, or None
    tx,
):
    """step(params, opt_state, teacher_params, audio, gen=None, latents=None)
    -> (params, opt_state, metrics): metrics {"enc_mse" (with an encoder),
    "dec_l1", "dec_stft", "loss"} detached on the device. Without a teacher
    encoder the decoder's latents are `latents` when given, else drawn from
    N(0, 1) by `gen`, (B, T / hop, latent_dim)."""

    def step(params, opt_state, teacher_params, audio, gen=None, latents=None):
        with torch.no_grad():
            if teacher_encode is not None:
                t_latents = teacher_encode(teacher_params, audio)
                latents_for_dec = t_latents
            else:
                t_latents = None
                latents_for_dec = latents if latents is not None else torch.randn(
                    (audio.shape[0], audio.shape[-1] // cfg.hop, cfg.latent_dim), generator=gen,
                    device=audio.device)
            t_audio = teacher_decode(teacher_params, latents_for_dec)

        def loss_fn(p):
            out = {}
            loss = 0.0
            if t_latents is not None:
                s_latents = codec_encode(p, audio, cfg)
                out["enc_mse"] = ((s_latents - t_latents) ** 2).mean()
                loss = loss + train_cfg.latent_weight * out["enc_mse"]
            s_audio = codec_decode(p, latents_for_dec, cfg)
            n = min(s_audio.shape[-1], t_audio.shape[-1])
            sa, ta = s_audio[..., :n][:, 0, :], t_audio[..., :n][:, 0, :]
            out["dec_l1"] = torch.abs(sa - ta).mean()
            out["dec_stft"] = multi_stft_loss(sa, ta)
            loss = loss + train_cfg.l1_weight * out["dec_l1"] + train_cfg.stft_weight * out["dec_stft"]
            out["loss"] = loss
            return loss, out

        _, metrics, grads = value_and_grad(params, loss_fn)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


def _teacher_fns(teacher):
    """(teacher_params, decode_fn, encode_fn or None) from an OnnxCodec or a
    duck-typed teacher: the public `encoder` property decides (None on a
    decode-only OnnxCodec); without that property, a callable `encode_fn`."""
    decode = lambda tp, lat: teacher.decode_fn(tp, lat)  # noqa: E731
    if hasattr(teacher, "encoder"):
        has_encoder = teacher.encoder is not None
    else:
        has_encoder = callable(getattr(teacher, "encode_fn", None))
    encode = None
    if has_encoder:
        encode = lambda tp, a: teacher.encode_fn(tp, a)  # noqa: E731
    return teacher.params, decode, encode


def synthetic_audio_iter(batch_size: int, samples: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Mixed tones plus noise, (batch, 1, samples) float32, numpy's draws."""
    rng = np.random.RandomState(seed)
    t = np.arange(samples) / float(SAMPLE_RATE)
    while True:
        batch = []
        for _ in range(batch_size):
            f = rng.uniform(80, 1000, size=3)
            a = rng.uniform(0.05, 0.3, size=3)
            wav = sum(ai * np.sin(2 * np.pi * fi * t) for fi, ai in zip(f, a))
            noise = rng.randn(samples) * rng.uniform(0.0, 0.05)
            batch.append((wav + noise).astype(np.float32))
        yield np.stack(batch)[:, None, :]


def distill_optimizer(params, train_cfg: CodecDistillConfig):
    """optax.chain(clip_by_global_norm(grad_clip), adamw(warmup_cosine_decay_schedule(
    0, lr, warmup, num_steps, 0.01 lr))) -> (the optimizer, its schedule)."""
    sched = warmup_cosine(train_cfg.lr, train_cfg.num_steps, train_cfg.warmup, train_cfg.lr * 0.01,
                          warmup_start_factor=0.0)
    return adamw(params, sched, weight_decay=1e-4, clip_norm=train_cfg.grad_clip), sched


def train_codec_distill(
    train_cfg: CodecDistillConfig = CodecDistillConfig(),
    codec_cfg: CodecConfig = CodecConfig(),
    teacher=None,
    data_iter: Optional[Iterator] = None,
    seed: int = 0,
    checkpoint_dir: str = "assets/codec_checkpoints",
    log_every: int = 100,
    device=None,
    on_step=None,
):
    """The distillation loop, on the card unless `device` says otherwise.
    `teacher` is an OnnxCodec (or compatible) whose params are on that
    device; None loads OnnxCodec() from $SMALLTTS_ASSETS/codec. The student's
    init and the decoder-only latents draw from torch.Generators seeded with
    `seed` and `seed + 1`; the data is synthetic_audio_iter's unless
    `data_iter` yields (B, 1, T) batches. At step % save_every == 0 past step
    1 it writes codec_distilled.npz in the JAX package's layout with
    codec_meta. `on_step(step, metrics)` is called after each step with the
    metrics on the device. Returns (params, the last metrics as floats)."""
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import codec_meta
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    dev = resolve_device(device)
    if teacher is None:
        from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec

        teacher = OnnxCodec(device=dev)
    teacher_params, teacher_decode, teacher_encode = _teacher_fns(teacher)
    params = init_codec(torch.Generator(device=dev).manual_seed(seed), codec_cfg, device=dev)
    tx, _ = distill_optimizer(params, train_cfg)
    opt_state = tx.init(params)
    step_fn = make_codec_distill_step(codec_cfg, train_cfg, teacher_decode, teacher_encode, tx)
    samples = int(train_cfg.seconds_per_sample * SAMPLE_RATE)
    samples -= samples % codec_cfg.hop
    data_iter = data_iter or synthetic_audio_iter(train_cfg.batch_size, samples, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    metrics = {}
    for step in range(train_cfg.num_steps):
        audio = to_device(next(data_iter), dev)
        params, opt_state, metrics = step_fn(params, opt_state, teacher_params, audio, gen)
        if on_step is not None:
            on_step(step, metrics)
        if step % log_every == 0:
            print(f"step {step}: " + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()))
        if step % train_cfg.save_every == 0 and step > 1:
            ckpt.save_pytree(f"{checkpoint_dir}/codec_distilled.npz", params_to_jax(params, codec_cfg),
                             meta=codec_meta(codec_cfg))
    return params, {k: float(v) for k, v in metrics.items()}


def wav_dir_iter(path: str, batch_size: int, samples: int, seed: int = 0) -> Iterator[np.ndarray]:
    """(batch, 1, samples) float32 crops of the .wav files under `path`,
    decoded and resampled to 24 kHz by serving.audio_io on first use, 256
    clips kept (least recently used dropped); shorter clips are
    zero-padded."""
    from smalltts_tpu_torch.serving import audio_io

    files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".wav"))
    if not files:
        raise SystemExit(f"no .wav files under {path}")
    rng = np.random.RandomState(seed)
    cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
    cache_cap = 256

    def get_clip(idx: int) -> np.ndarray:
        clip = cache.get(idx)
        if clip is None:
            with open(files[idx], "rb") as f:
                clip = audio_io.decode_and_resample(f.read(), SAMPLE_RATE)
            cache[idx] = clip
            while len(cache) > cache_cap:
                cache.popitem(last=False)
        else:
            cache.move_to_end(idx)
        return clip

    while True:
        batch = []
        for _ in range(batch_size):
            clip = get_clip(rng.randint(len(files)))
            if len(clip) < samples:
                clip = np.pad(clip, (0, samples - len(clip)))
            start = rng.randint(max(len(clip) - samples, 0) + 1)
            batch.append(clip[start:start + samples])
        yield np.stack(batch).astype(np.float32)[:, None, :]


def main(argv=None) -> int:
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.utils.transfer import resolve_device

    ap = argparse.ArgumentParser(description="Distill the imported ONNX codec into the fast sub-pixel codec.")
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--assets", default="assets/codec", help="directory of the teacher's {encoder,decoder}.onnx")
    ap.add_argument("--checkpoint-dir", default="assets/codec_checkpoints")
    ap.add_argument("--wav-dir", default=None, help="real audio corpus; default: synthetic tones and noise")
    ap.add_argument("--save-every", type=int, default=CodecDistillConfig.save_every)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    enc = os.path.join(args.assets, "encoder.onnx")
    dec = os.path.join(args.assets, "decoder.onnx")
    if not os.path.isfile(dec):
        print(f"missing {dec}; fetch codec assets first", file=sys.stderr)
        return 1
    teacher = OnnxCodec(enc if os.path.isfile(enc) else None, dec, device=dev)
    cfg = CodecDistillConfig(num_steps=args.steps, batch_size=args.batch_size, seconds_per_sample=args.seconds,
                             save_every=args.save_every)
    codec_cfg = CodecConfig()
    data_iter = None
    if args.wav_dir:
        samples = int(args.seconds * SAMPLE_RATE)
        samples -= samples % codec_cfg.hop
        data_iter = wav_dir_iter(args.wav_dir, args.batch_size, samples)
    else:
        print("warn: no --wav-dir, training on synthetic audio (smoke only)", file=sys.stderr)
    _, metrics = train_codec_distill(cfg, codec_cfg, teacher=teacher, data_iter=data_iter,
                                     checkpoint_dir=args.checkpoint_dir, device=dev)
    print("final:", metrics)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

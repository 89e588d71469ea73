"""Few-step samplers (port of smalltts_tpu/infer/sampler.py).

"dmd", the 4-step DMD loop: for t in linspace(1, 0, steps), re-noise the
running estimate with fresh noise at level t, evaluate the denoiser, update
x_pred = alpha*x_t - sigma*velocity; x_pred starts at zeros; no CFG. "imf",
the integral-velocity student (train/imf.imf_sample): one start noise, then
x -= (t - r) * u per interval. Then the codec decodes in fp32 and the
waveform is optionally quantised to int16 in place of the float. The time
embeddings and every step's adaLN modulations are computed once before the
loop.

Noise is an argument throughout, (draws, B, T, latent_dim): one draw per
step for "dmd", the single start noise for "imf" (`noise_draws`).
"""

from __future__ import annotations

from typing import Optional

import torch

from smalltts_tpu_torch.models.backbone import (
    BackboneConfig,
    denoise_step,
    encode_conditions,
    time_embedding,
)
from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode
from smalltts_tpu_torch.models.dit import precompute_step_modulations
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.ops.schedule import get_alpha_sigma

NUM_STEPS = 4
SAMPLERS = ("dmd", "imf")


def _check_sampler(sampler: str) -> None:
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be 'dmd' or 'imf', got {sampler!r}")


def noise_draws(sampler: str, num_steps: int) -> int:
    """Noise slices a sampler reads: one a step for "dmd", the start noise
    alone for "imf"."""
    _check_sampler(sampler)
    return 1 if sampler == "imf" else num_steps


def draw_noises(num_steps: int, batch: int, t_bucket: int, latent_dim: int, dtype, device,
                generator: torch.Generator, sampler: str = "dmd") -> torch.Tensor:
    """Standard-normal noise, (noise_draws(sampler, num_steps), B, T,
    latent_dim): fresh noise for every DMD step, or IMF's one start noise."""
    return torch.randn((noise_draws(sampler, num_steps), batch, t_bucket, latent_dim), generator=generator,
                       device=device, dtype=torch.float32).to(dtype)


def sample_latents(
    params,
    cfg: BackboneConfig,
    ref_latents: torch.Tensor,      # (B, R, 64)
    ref_lengths: torch.Tensor,      # (B,)
    phonemes: torch.Tensor,         # (B, P)
    phoneme_lengths: torch.Tensor,  # (B,)
    seq_lengths: torch.Tensor,      # (B,) true latent frame counts
    num_steps: int = NUM_STEPS,
    noises: Optional[torch.Tensor] = None,  # (noise_draws(sampler, num_steps), B, T, 64)
    t_bucket: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    sampler: str = "dmd",
) -> torch.Tensor:
    """Condition encoding + the step loop -> masked latents (B, T, 64). The
    bucket length comes from `t_bucket` or the injected `noises`' shape;
    without `noises` the noise is drawn from `generator`. `sampler="imf"`
    (a departure: the JAX function is DMD only) runs imf_sample from the
    one start noise."""
    draws = noise_draws(sampler, num_steps)
    if t_bucket is None:
        if noises is None:
            raise ValueError("pass t_bucket or noises (its shape fixes the bucket)")
        t_bucket = noises.shape[2]
    if noises is not None and noises.shape[0] != draws:
        raise ValueError(f"noises has {noises.shape[0]} steps, num_steps={num_steps} needs {draws}")
    ph_mask = length_mask(phoneme_lengths, phonemes.shape[1])
    cond = encode_conditions(params, cfg, ref_latents, ref_lengths, phonemes, ph_mask)
    if noises is None:
        noises = draw_noises(num_steps, seq_lengths.shape[0], t_bucket, cfg.latent_dim,
                             params["velocity"]["w"].dtype, seq_lengths.device, generator, sampler)
    return _latents(params, cfg, cond, seq_lengths, t_bucket, num_steps, noises, sampler)


def _latents(params, cfg, cond, seq_lengths, t_bucket, num_steps, noises, sampler):
    if sampler == "imf":
        from smalltts_tpu_torch.train.imf import imf_sample

        return imf_sample(params, cfg, cond, seq_lengths, t_bucket, noises[0], num_steps)
    return _sample_loop(params, cfg, cond, seq_lengths, t_bucket, num_steps, noises)


def _sample_loop(params, cfg, cond, seq_lengths, t_bucket, num_steps, noises):
    b = seq_lengths.shape[0]
    dev = seq_lengths.device
    mask = length_mask(seq_lengths, t_bucket)
    ts = torch.linspace(1.0, 0.0, num_steps, dtype=torch.float32, device=dev)
    dtype = params["velocity"]["w"].dtype
    x_pred = torch.zeros((b, t_bucket, cfg.latent_dim), dtype=dtype, device=dev)
    t_embs = time_embedding(params["time_embedding"], ts, cfg.time_embed_dim)
    if "r_gate" in params:
        # an IMF checkpoint's instantaneous velocity u(x, t, t) is evaluated
        # at te(t) + r_gate * te(t), the embedding it was trained with
        t_embs = t_embs * (1.0 + params["r_gate"]).to(t_embs.dtype)
    step_mods, step_finals = precompute_step_modulations(params["dit"], t_embs)
    alphas, sigmas = get_alpha_sigma(ts)
    for i in range(num_steps):
        alpha, sigma = alphas[i].to(dtype), sigmas[i].to(dtype)
        x_t = alpha * x_pred + sigma * noises[i].to(dtype)
        velocity = denoise_step(
            params, cfg, x_t, mask, ts[i].expand(b), cond,
            t_emb=t_embs[i].expand(b, -1), step_mods=(step_mods[:, i], step_finals[i]))
        x_pred = alpha * x_t - sigma * velocity
    return torch.where(mask[..., None], x_pred, torch.zeros((), dtype=dtype, device=dev))


def make_synthesize_fn(cfg: BackboneConfig, codec_cfg: CodecConfig, num_steps: int = NUM_STEPS,
                       decode_fn=None, sampler: str = "dmd", pcm16: bool = False):
    """(params, codec_params, inputs, noises, t_bucket) -> waveform (B, 1, t_bucket * hop),
    float32, or int16 when `pcm16` (clip to [-1, 1], scale by 32767, round
    half to even).

    `decode_fn(codec_params, latents) -> audio` selects the codec: the native
    codec by default, or an imported ONNX decoder (onnxtorch.codec.
    OnnxCodec.decode_fn). `sampler` is "dmd" or "imf" (params must carry
    the r_gate leaf); `noises` holds noise_draws(sampler, num_steps) slices."""
    if decode_fn is None:
        decode_fn = lambda cp, lat: codec_decode(cp, lat, codec_cfg)  # noqa: E731
    _check_sampler(sampler)

    def synthesize(params, codec_params, ref_latents, ref_lengths, phonemes, phoneme_lengths,
                   seq_lengths, noises, t_bucket: int):
        ph_mask = length_mask(phoneme_lengths, phonemes.shape[1])
        cond = encode_conditions(params, cfg, ref_latents, ref_lengths, phonemes, ph_mask)
        latents = _latents(params, cfg, cond, seq_lengths, t_bucket, num_steps, noises, sampler)
        audio = decode_fn(codec_params, latents.float())
        if pcm16:
            x = torch.clamp(audio.float(), -1.0, 1.0)
            audio = torch.round(x * 32767.0).to(torch.int16)
        return audio

    return synthesize

"""Shifted-cosine diffusion schedule (port of smalltts_tpu/ops/schedule.py).

    alpha_t^2 = cos^2(pi/2 * t)
    logSNR    = log(alpha_t^2 / (1 - alpha_t^2)) + 2*log(0.5)
    alpha     = sqrt(sigmoid(logSNR)),  sigma = sqrt(1 - sigmoid(logSNR))
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_SHIFT = 2.0 * math.log(0.5)


def get_alpha_sigma(t: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """`t` of any shape in [0, 1] (float32); returns (alpha, sigma)."""
    t = torch.clamp(t, eps, 1.0 - 1e-5)
    alpha_t_sq = torch.cos(math.pi / 2.0 * t) ** 2
    log_snr = torch.log(alpha_t_sq / (1.0 - alpha_t_sq))
    alpha_sq = torch.sigmoid(log_snr + _SHIFT)
    return torch.sqrt(alpha_sq), torch.sqrt(1.0 - alpha_sq)


def apply_noise(latents: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
    """Noise `latents` (B, T, D) at per-sample timestep `t` (B,): returns
    (noised, velocity) = (alpha x + sigma eps, alpha eps - sigma x)."""
    alpha, sigma = get_alpha_sigma(t)
    alpha, sigma = alpha[:, None, None], sigma[:, None, None]
    return alpha * latents + sigma * noise, alpha * noise - sigma * latents


def random_cond_mask(gen: torch.Generator, lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Random contiguous conditioning span per sample: (B, max_len) bool with
    a True run of random length below length / 2 at a random start. The two
    uniform draws come from `gen`, span first."""
    b = lengths.shape[0]
    u_span = torch.rand((b,), generator=gen, device=lengths.device)
    u_start = torch.rand((b,), generator=gen, device=lengths.device)
    half = torch.clamp_min(lengths // 2, 1)
    span = (u_span * half).to(lengths.dtype)
    start = (u_start * torch.clamp_min(lengths - span, 1)).to(lengths.dtype)
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)[None, :]
    return (pos >= start[:, None]) & (pos < (start + span)[:, None])


def x_pred_from_velocity(x_t: torch.Tensor, velocity: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Posterior-mean estimate x0 = alpha x_t - sigma v, t broadcast over x_t's trailing dims."""
    alpha, sigma = get_alpha_sigma(t)
    shape = (-1,) + (1,) * (x_t.ndim - 1)
    return alpha.reshape(shape) * x_t - sigma.reshape(shape) * velocity

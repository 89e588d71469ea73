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

"""Length masks and the masked loss (port of smalltts_tpu/ops/masking.py)."""

from __future__ import annotations

import torch

from smalltts_tpu_torch.parallel.comm import dp_sum


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask, True for valid positions."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE over (B, T, D) with a (B, T) mask: the squared error summed
    over valid elements (the mask broadcast over D) divided by their count,
    clamped at 1. Accumulates in float32 whatever the inputs' dtype. Under a
    data-parallel mesh in use both sums are the global batch's."""
    pred, target = pred.float(), target.float()
    valid = mask[..., None].expand(pred.shape).float()
    diff = (pred - target) ** 2 * valid
    return dp_sum(diff.sum()) / torch.clamp_min(dp_sum(valid.sum()), 1.0)

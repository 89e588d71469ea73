"""Length masks (port of smalltts_tpu/ops/masking.py::length_mask)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask, True for valid positions."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]

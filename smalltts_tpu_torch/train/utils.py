"""Training-math utilities under the reference's names (port of
smalltts_tpu/train/utils.py; the functions live in ops/schedule and
ops/masking)."""

from smalltts_tpu_torch.ops.masking import length_mask, masked_mse
from smalltts_tpu_torch.ops.schedule import apply_noise, get_alpha_sigma, random_cond_mask, x_pred_from_velocity


def get_mask(lengths, max_len: int):
    """(B,) lengths -> (B, max_len) bool, True for valid positions."""
    return length_mask(lengths, max_len)


get_random_cond = random_cond_mask

__all__ = [
    "apply_noise",
    "get_alpha_sigma",
    "get_mask",
    "get_random_cond",
    "length_mask",
    "masked_mse",
    "x_pred_from_velocity",
]

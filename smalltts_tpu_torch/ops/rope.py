"""Rotary position embeddings (port of smalltts_tpu/ops/rope.py).

Two conventions, kept numerically distinct as in the JAX package:

1. interleaved-pair RoPE (DiT): duplicated-frequency table [f0, f0, f1, f1, ...],
   rotation of adjacent lanes on the first `rot_dim` head dims, in float32;
2. complex-pair RoPE (text/style encoders): cos/sin tables over the full head
   dim, computed in the input dtype (cos/sin cast to x.dtype first).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from smalltts_tpu_torch.utils.transfer import to_device


def rope_table_interleaved(max_seq: int, dim: int, theta: float = 1e4) -> np.ndarray:
    """DiT-style table: (max_seq, dim) float32 with duplicated freqs."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(max_seq, dtype=np.float32)
    freqs = np.einsum("i,j->ij", t, inv_freq)
    return np.stack([freqs, freqs], axis=-1).reshape(max_seq, dim)


def rope_table_cos_sin(max_seq: int, head_dim: int, theta: float = 1e4):
    """Encoder-style table: cos/sin of angle t*theta_j, each (max_seq, head_dim/2)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(max_seq, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs), np.sin(freqs)


# The tables below are made once per (length, dim, device) and kept: the
# serving path reads them every batch and step without a host round trip.
# They are made outside inference mode whatever the caller's mode: a table
# first made while serving (under torch.inference_mode) would otherwise be
# an inference tensor, which a later training step cannot save for its
# backward.


@functools.lru_cache(maxsize=None)
def interleaved_cos_sin(max_seq: int, dim: int, device) -> tuple:
    """cos/sin of rope_table_interleaved on `device`, each (max_seq, dim) fp32."""
    with torch.inference_mode(False):
        freqs = to_device(rope_table_interleaved(max_seq, dim), device)
        return torch.cos(freqs), torch.sin(freqs)


@functools.lru_cache(maxsize=None)
def pair_cos_sin(max_seq: int, head_dim: int, device) -> tuple:
    """rope_table_cos_sin on `device`, each (max_seq, head_dim / 2) fp32."""
    with torch.inference_mode(False):
        return tuple(to_device(t, device) for t in rope_table_cos_sin(max_seq, head_dim))


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """[x0, x1, x2, x3, ...] -> [-x1, x0, -x3, x2, ...]."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_rope_interleaved(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Interleaved RoPE on the leading `freqs.shape[-1]` lanes of x (..., T, D);
    freqs (T, rot_dim) float32. The rotation runs in float32 and casts back."""
    return rotate_interleaved(x, torch.cos(freqs), torch.sin(freqs))


def rotate_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """apply_rope_interleaved from the tables' cos and sin, (T, rot_dim)
    float32 (interleaved_cos_sin's)."""
    rot = cos.shape[-1]
    xr, x_pass = x[..., :rot], x[..., rot:]
    xf = xr.float()
    xr = (xf * cos + _rotate_half_interleaved(xf) * sin).to(x.dtype)
    return torch.cat([xr, x_pass], dim=-1) if x_pass.shape[-1] else xr


def apply_rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Complex-pair RoPE over the full head dim, in x's dtype.
    x (B, T, H, D); cos/sin (T, D/2)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    re, im = x2[..., 0], x2[..., 1]
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    return torch.stack([re * cos - im * sin, re * sin + im * cos], dim=-1).reshape(x.shape)

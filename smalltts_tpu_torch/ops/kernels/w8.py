"""int8-weight products: wrappers of csrc/w8.cu, their plain versions, and
the per-channel quantizer (port of smalltts_tpu/ops/pallas/w8.py).

Weights are stored int8 with a symmetric per-output-channel fp32 scale
(`quantize_w8`), and the product is the fp32 sum of x times the int8 values,
times the scale, rounded once to x's dtype. int8 values convert to bf16
exactly, so the only error against the float product is the weight rounding.

Three entry points, one C entry (csrc/w8.cu has the source note: what bounds
the product on the card, and what the two kernels behind the entry do about
that; the kernel is chosen there, from the shape and the alignment alone):

- `w8_matmul(x, w_q, scale)`: (M, K) x (K, N) -> (M, N);
- `w8_matmul_stacked(x, w_q, scale, idx)`: layer `idx` of (L, K, N), the
  index a device int32 that the kernel reads itself (no host sync);
- `w8_matmul_all_layers(x, w_q, scale)`: every layer, -> (L, M, N). The
  serving path's hoisted adaLN modulation product runs through it
  (models/dit.py::_all_block_modulations).

Each wrapper takes its plain version for CPU tensors (and under the
test-only `kernels.force_plain()`), and otherwise launches its kernel or
raises. On the card the kernel takes bf16 x only.
"""

from __future__ import annotations

import torch

from smalltts_tpu_torch.ops import kernels


def quantize_w8(w: torch.Tensor):
    """(K, N) or (L, K, N) float weight -> (w_q int8, scale fp32 (..., N)).

    Symmetric per output channel, computed in fp32: scale = amax(|w|) over K
    / 127, or 1 for an all-zero channel; q = round-half-even(w / scale)."""
    wf = w.float()
    amax = torch.amax(wf.abs(), dim=-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127).to(torch.int8)
    return q, scale


def w8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain version: x (M, K) x w_q (..., K, N) -> (..., M, N), fp32 sum
    of x times the int8 values, times scale (..., N) in fp32, one rounding."""
    acc = torch.matmul(x.float(), w_q.float())
    return (acc * scale.float().unsqueeze(-2)).to(x.dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(x, w_q, scale, idx, out, L, grid_layers, what):
    M, K = x.shape
    N = w_q.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: bf16 x only on the card, got {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"{what}: w_q must be int8 and scale fp32, got {w_q.dtype}, {scale.dtype}")
    if w_q.shape[-2] != K or scale.shape != (*w_q.shape[:-2], N):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if N % 8 or w_q.data_ptr() % 8:
        raise ValueError(f"{what}: N={N} must be a multiple of 8 and w_q 8-byte aligned")
    if any(t.device != x.device for t in (w_q, scale) + ((idx,) if idx is not None else ())):
        raise ValueError(f"{what}: all inputs must be on one device")
    x, w_q, scale = x.contiguous(), w_q.contiguous(), scale.contiguous()
    lib = kernels.load("w8")
    status = lib.st_w8_matmul(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                              idx.data_ptr() if idx is not None else None, out.data_ptr(),
                              M, K, N, L, grid_layers, _stream(x))
    kernels.check(lib, "w8", status, what)
    kernels.count_launch(what)
    return out


def w8_matmul(x, w_q, scale):
    """x (M, K) x int8 w_q (K, N) with scale (N,) -> (M, N) in x's dtype."""
    if kernels.use_plain(x):
        return w8_matmul_ref(x, w_q, scale)
    if w_q.dim() != 2:
        raise ValueError("w8_matmul: w_q must be (K, N)")
    out = torch.empty((x.shape[0], w_q.shape[1]), device=x.device, dtype=x.dtype)
    return _launch(x, w_q, scale, None, out, 1, 1, "w8_matmul")


def _layer_index(idx, L, device):
    """The layer index as a 1-element int32 tensor on `device`, clamped to
    [0, L) as the kernel clamps it. A Python int becomes a fill on the device,
    never a host copy."""
    if not torch.is_tensor(idx):
        return torch.full((1,), min(max(int(idx), 0), L - 1), dtype=torch.int32, device=device)
    if idx.numel() != 1:
        raise ValueError("w8_matmul_stacked: idx must hold one layer index")
    return idx.reshape(1)


def w8_matmul_stacked(x, w_q, scale, idx):
    """x (M, K) x layer `idx` of int8 w_q (L, K, N), scale (L, N) -> (M, N).
    `idx` is an int or a 1-element integer tensor; on the card the kernel
    reads it from device memory, so the call makes no synchronizing copy."""
    L = w_q.shape[0]
    idx = _layer_index(idx, L, x.device)
    if kernels.use_plain(x):
        pick = idx.long().clamp(0, L - 1)
        return w8_matmul_ref(x, w_q.index_select(0, pick)[0], scale.index_select(0, pick)[0])
    if w_q.dim() != 3 or idx.dtype != torch.int32:
        raise ValueError("w8_matmul_stacked: w_q (L, K, N) and an int32 idx on the card")
    out = torch.empty((x.shape[0], w_q.shape[2]), device=x.device, dtype=x.dtype)
    return _launch(x, w_q, scale, idx.contiguous(), out, L, 1, "w8_matmul_stacked")


def w8_matmul_all_layers(x, w_q, scale):
    """x (M, K) x every layer of int8 w_q (L, K, N), scale (L, N) -> (L, M, N)."""
    if kernels.use_plain(x):
        return w8_matmul_ref(x, w_q, scale)
    if w_q.dim() != 3:
        raise ValueError("w8_matmul_all_layers: w_q must be (L, K, N)")
    L = w_q.shape[0]
    out = torch.empty((L, x.shape[0], w_q.shape[2]), device=x.device, dtype=x.dtype)
    return _launch(x, w_q, scale, None, out, L, L, "w8_matmul_all_layers")

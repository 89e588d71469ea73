"""The codec decoder's pointwise pass between two convolutions: wrapper of
csrc/codec.cu and its plain version (no Pallas counterpart: the JAX package
leaves the codec to XLA).

`codec_pointwise(y, bias, x, r=, tanh=, keep=, alpha=, pad=)` takes a
convolution's raw NCW output y (B, C*r, T) and gives

    v = y + bias[:, None], then tanh(v) (`tanh`), then depth to time
    (v[b, j*C + c, t] -> (b, c, t*r + j)), then x + v (`x`, in v's layout);
    returns (v where `keep`, else None;
             snake(v, alpha) padded by `pad` = (lo, hi) zeros, where `alpha`
             is given: the next convolution's input, else None)

in float32, bit for bit the op chain of models/codec.py's channel-last
decode (`bhaskara_snake` with `alpha` = exp(log_alpha)). The
card's decode (models/codec.py::_decode_ncw) runs one launch after each of
its 27 convolutions. The wrapper takes the plain version for CPU tensors
(and under the test-only `kernels.force_plain()`), and otherwise launches
the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from smalltts_tpu_torch.ops import kernels


def bhaskara_snake(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x + sin^2(a x)/a with Bhaskara I's approximation of |sin| over the
    period pi: sin(pi f) ~= 16 f (1-f) / (5 - 4 f (1-f)), f in [0, 1)
    (smalltts_tpu/models/codec.py:64-80). Channel-last: a = exp(log_alpha)
    (C,). The kernel rounds in this order."""
    y = a * x * (1.0 / math.pi)
    f = y - torch.floor(y)
    g = f * (1.0 - f)
    s = 16.0 * g / (5.0 - 4.0 * g)
    return x + (s * s) / a


def codec_pointwise_ref(y, bias, x=None, *, r: int = 1, tanh: bool = False, keep: bool = True,
                        alpha: Optional[torch.Tensor] = None, pad: Tuple[int, int] = (0, 0)):
    """The plain version: PyTorch ops in the order the kernel rounds them."""
    b, cr, t = y.shape
    v = y + bias[:, None]
    if tanh:  # over y's own layout, as the channel-last decode applies it
        v = torch.tanh(v)
    if r > 1:
        v = v.reshape(b, r, cr // r, t).permute(0, 2, 3, 1).reshape(b, cr // r, t * r)
    if x is not None:
        v = x + v
    snake = F.pad(bhaskara_snake(v.transpose(1, 2), alpha).transpose(1, 2), pad) if alpha is not None else None
    return (v if keep else None), snake


def codec_pointwise(y, bias, x=None, *, r: int = 1, tanh: bool = False, keep: bool = True,
                    alpha: Optional[torch.Tensor] = None, pad: Tuple[int, int] = (0, 0)):
    """See the module's note; returns (plain or None, snake buffer or None)."""
    if x is not None and tanh:
        raise ValueError("codec_pointwise: the residual and tanh are exclusive")
    if not keep and alpha is None:
        raise ValueError("codec_pointwise: nothing to write")
    if kernels.use_plain(y):
        return codec_pointwise_ref(y, bias, x, r=r, tanh=tanh, keep=keep, alpha=alpha, pad=pad)
    B, cr, T = y.shape
    lo, hi = (int(q) for q in pad)
    if cr % r or lo < 0 or hi < 0:
        raise ValueError(f"codec_pointwise: y {tuple(y.shape)}, r {r}, pad {pad}")
    C = cr // r
    ins = [y, bias] + ([x] if x is not None else []) + ([alpha] if alpha is not None else [])
    if any(t.dtype != torch.float32 or t.device != y.device for t in ins):
        raise ValueError("codec_pointwise: float32 tensors on one device only on the card")
    if bias.shape != (cr,) or (x is not None and x.shape != (B, C, T * r)) or (
            alpha is not None and alpha.shape != (C,)):
        raise ValueError(f"codec_pointwise: y {tuple(y.shape)}, bias {tuple(bias.shape)}, "
                         f"x {None if x is None else tuple(x.shape)}, alpha {None if alpha is None else tuple(alpha.shape)}")
    y, bias = y.contiguous(), bias.contiguous()
    x = x.contiguous() if x is not None else None
    alpha = alpha.contiguous() if alpha is not None else None
    plain = torch.empty((B, C, T * r), device=y.device, dtype=torch.float32) if keep else None
    snake = torch.empty((B, C, lo + T * r + hi), device=y.device, dtype=torch.float32) if alpha is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = kernels.load("codec")
    status = lib.st_codec_pointwise(ptr(y), ptr(bias), ptr(x), ptr(alpha), ptr(plain), ptr(snake), B, C, T, r, lo, hi,
                                    1 if x is not None else 2 if tanh else 0,
                                    torch.cuda.current_stream(y.device).cuda_stream)
    kernels.check(lib, "codec", status, "codec_pointwise")
    kernels.count_launch("codec_pointwise")
    return plain, snake

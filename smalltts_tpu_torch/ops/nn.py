"""Functional NN primitives on tensors (port of smalltts_tpu/ops/nn.py).

Parameters are plain nested dicts of tensors in the JAX package's layouts
(linear weight (in, out); conv weight in torch's (c_out, c_in/groups, k)).
Products accumulate in float32 and norms compute in float32, then cast back,
as the JAX package does. Block stacks carry a leading layer dim L.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------- init


def _uniform(gen, shape, bound, dtype, device):
    w = torch.empty(shape, device=device, dtype=torch.float32)
    return w.uniform_(-bound, bound, generator=gen).to(dtype)


def init_linear(gen, in_dim, out_dim, bias=True, dtype=torch.float32, device="cpu", lead=()):
    """Torch-default fan-in uniform init; weight (*lead, in_dim, out_dim)."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (*lead, in_dim, out_dim), bound, dtype, device)}
    if bias:
        p["b"] = _uniform(gen, (*lead, out_dim), bound, dtype, device)
    return p


def init_zeros_linear(in_dim, out_dim, bias=True, dtype=torch.float32, device="cpu", lead=()):
    """Zero-initialized linear (adaLN-zero modulation / velocity head)."""
    p = {"w": torch.zeros((*lead, in_dim, out_dim), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((*lead, out_dim), dtype=dtype, device=device)
    return p


def init_rmsnorm(shape, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def init_conv1d(gen, c_in, c_out, k, groups=1, dtype=torch.float32, device="cpu"):
    """Torch Conv1d init; weight (c_out, c_in // groups, k)."""
    bound = 1.0 / math.sqrt((c_in // groups) * k)
    return {
        "w": _uniform(gen, (c_out, c_in // groups, k), bound, dtype, device),
        "b": _uniform(gen, (c_out,), bound, dtype, device),
    }


# -------------------------------------------------------------------------- apply


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated in float32 and returned in float32: x (..., K) with
    w (K, N), or x (L, M, K) with w (L, K, N). bf16 operands on the card go
    to cuBLAS with a float32 result (the out_dtype of torch.mm / torch.bmm);
    elsewhere they are upcast, which is exact for bf16."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return torch.matmul(x.float(), w.float())
    if w.dim() == 3:
        return torch.bmm(x.contiguous(), w, out_dtype=torch.float32)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def dequantize(w_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 weight times its per-channel scale, both cast to `dtype` first and
    the product rounded in `dtype` (the JAX package's nn.linear, nn.py:79)."""
    return w_q.to(dtype) * scale.to(dtype)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) as the JAX package computes it: the product accumulates
    in float32, the bias adds in float32, and the sum rounds once to x's
    dtype. An int8 leaf (`w_q`, `scale`) is dequantized first."""
    w = dequantize(p["w_q"], p["scale"], x.dtype) if "w_q" in p else p["w"].to(x.dtype)
    y = matmul_f32(x, w)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last dim; scale may be (D,) or (H, D)."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * p["scale"].float()).to(x.dtype)


def layernorm_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def conv1d(p, x: torch.Tensor, groups: int = 1, padding="SAME", dilation: int = 1) -> torch.Tensor:
    """Channel-last grouped 1-D conv: x (B, T, C_in) -> (B, T', C_out).
    "SAME" pads (k-1)*dilation split low-first as XLA does; an int pads both sides."""
    k = p["w"].shape[-1]
    if padding == "SAME":
        total = (k - 1) * dilation
        lo, hi = total // 2, total - total // 2
    else:
        lo = hi = int(padding)
    h = F.pad(x.transpose(1, 2), (lo, hi))
    y = F.conv1d(h, p["w"].to(x.dtype), None, dilation=dilation, groups=groups)
    return (y.float() + p["b"].float()[:, None]).to(x.dtype).transpose(1, 2)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each op rounded to x's dtype: the op chain of JAX's
    sigmoid, which in bf16 gives other values than torch.sigmoid's one
    rounding."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), each op rounded to x's dtype (JAX's silu chain)."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, logaddexp(x, 0): max(x, 0) + log1p(exp(-|x - 0|)),
    each op rounded to x's dtype (F.softplus rounds once)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(x - zero)))


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(softplus(x))


def layer(tree, l: int):
    """Layer `l` of a tree of stacked block params (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, l) for k, v in tree.items()}
    return tree[l]


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention, (B, H, Tq, D) x (B, H, Tk, D).

    key_mask (B, Tk) bool, True = attend. On a CUDA tensor with a key mask
    this is the hand-written attention kernel (ops/kernels/attention.py);
    otherwise the JAX package's XLA path: fp32 scores, masked keys -1e9,
    fp32 softmax, probs cast to the input dtype before PV."""
    if key_mask is not None and q.device.type != "cpu":
        from smalltts_tpu_torch.ops.kernels.attention import fused_attention

        return fused_attention(q, k, v, key_mask)
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :], scores, -1e9)  # finite: masked rows stay finite
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype)

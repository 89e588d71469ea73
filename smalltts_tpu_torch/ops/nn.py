"""Functional NN primitives on tensors (port of smalltts_tpu/ops/nn.py).

Parameters are plain nested dicts of tensors in the JAX package's layouts
(linear weight (in, out); conv weight in torch's (c_out, c_in/groups, k)).
Products accumulate in float32 and norms compute in float32, then cast back,
as the JAX package does. Block stacks carry a leading layer dim L.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from smalltts_tpu_torch.parallel.comm import dp_stat, dp_ways

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


def init_embedding(gen, vocab, dim, dtype=torch.float32, device="cpu"):
    w = torch.empty((vocab, dim), device=device, dtype=torch.float32)
    return {"w": w.normal_(generator=gen).to(dtype)}


def init_rmsnorm(shape, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def init_conv1d(gen, c_in, c_out, k, groups=1, dtype=torch.float32, device="cpu"):
    """Torch Conv1d init; weight (c_out, c_in // groups, k)."""
    bound = 1.0 / math.sqrt((c_in // groups) * k)
    return {
        "w": _uniform(gen, (c_out, c_in // groups, k), bound, dtype, device),
        "b": _uniform(gen, (c_out,), bound, dtype, device),
    }


def init_batchnorm(ch, dtype=torch.float32, device="cpu"):
    """BatchNorm params and running state; `mean`/`var` (float32) are the
    state, which the optimizer leaves as they are (train.optim.trainable_mask)."""
    return {"scale": torch.ones(ch, dtype=dtype, device=device), "bias": torch.zeros(ch, dtype=dtype, device=device),
            "mean": torch.zeros(ch, device=device), "var": torch.ones(ch, device=device)}


# -------------------------------------------------------------------------- apply


class _MatmulF32(torch.autograd.Function):
    """The bf16 product with a float32 result on the card, differentiable:
    cuBLAS's out_dtype product has no autograd node. The backward is the
    transpose JAX takes of dot_general(preferred_element_type=float32): dx =
    dy w^T and dw = x^T dy, accumulated in float32 and rounded to the
    operands' dtypes. dy is rounded to the operands' dtype first, which is
    exact on the port's paths: every caller rounds the float32 product (plus
    a float32 bias) to that dtype, so its cotangent is a bf16 value."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(dy, w.transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if w.dim() == 3:
                dw = torch.bmm(x.transpose(1, 2), dy, out_dtype=torch.float32)
            else:
                dw = torch.mm(x.reshape(-1, x.shape[-1]).t(), dy.reshape(-1, dy.shape[-1]),
                              out_dtype=torch.float32)
            dw = dw.to(w.dtype)
        return dx, dw


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cuBLAS's bf16 product with a float32 result (no autograd node)."""
    if w.dim() == 3:
        return torch.bmm(x.contiguous(), w, out_dtype=torch.float32)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w accumulated in float32 and returned in float32: x (..., K) with
    w (K, N), or x (L, M, K) with w (L, K, N). bf16 operands on the card go
    to cuBLAS with a float32 result (the out_dtype of torch.mm / torch.bmm),
    through _MatmulF32 where a gradient is wanted; elsewhere they are
    upcast, which is exact for bf16."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return torch.matmul(x.float(), w.float())
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MatmulF32.apply(x, w)
    return _mm_f32(x, w)


def dequantize(w_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 weight times its per-channel scale, both cast to `dtype` first and
    the product rounded in `dtype` (the JAX package's nn.linear, nn.py:79)."""
    return w_q.to(dtype) * scale.to(dtype)


def linear(p, x: torch.Tensor, reduce=None) -> torch.Tensor:
    """x @ w (+ b) as the JAX package computes it: the product accumulates
    in float32, the bias adds in float32, and the sum rounds once to x's
    dtype. An int8 leaf (`w_q`, `scale`) is dequantized first. `reduce`,
    given, takes the float32 product before the bias: a row-parallel
    product's sum over tensor-parallel ranks (parallel.comm.tp_sum)."""
    w = dequantize(p["w_q"], p["scale"], x.dtype) if "w_q" in p else p["w"].to(x.dtype)
    y = matmul_f32(x, w)
    if reduce is not None:
        y = reduce(y)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def out_features(p) -> int:
    """A linear leaf's output width (its shard's, under tensor parallelism)."""
    return (p["w_q"] if "w_q" in p else p["w"]).shape[-1]


def embedding(p, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids.long()]


def batchnorm(p, x: torch.Tensor, train: bool, mask: Optional[torch.Tensor] = None, momentum: float = 0.1,
              eps: float = 1e-5):
    """Channel-last BatchNorm over (B, T, C), the statistics over the valid
    positions where a (B, T) mask is given. Returns (y, new_params): in
    training the batch statistics normalize and the running ones move by
    `momentum`, the variance the BIASED one, as the JAX package tracks it
    (F.batch_norm tracks the unbiased one); the new running stats carry no
    gradient. Under a data-parallel mesh in use the statistics are the
    global batch's (summed over dp), as the JAX package's sharded batch gives."""
    xf = x.float()
    if train:
        dp = dp_ways()
        if mask is not None:
            m = mask[..., None].float()
            count = torch.clamp_min(dp_stat(m.sum()), 1.0)
            mean = dp_stat((xf * m).sum(dim=(0, 1))) / count
            var = dp_stat((((xf - mean) ** 2) * m).sum(dim=(0, 1))) / count
        elif dp == 1:
            mean = xf.mean(dim=(0, 1))
            var = ((xf - mean) ** 2).mean(dim=(0, 1))
        else:
            n = xf.shape[0] * xf.shape[1] * dp
            mean = dp_stat(xf.sum(dim=(0, 1))) / n
            var = dp_stat(((xf - mean) ** 2).sum(dim=(0, 1))) / n
        new_p = dict(p)
        new_p["mean"] = ((1 - momentum) * p["mean"] + momentum * mean).detach()
        new_p["var"] = ((1 - momentum) * p["var"] + momentum * var).detach()
    else:
        mean, var = p["mean"], p["var"]
        new_p = p
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), new_p


def groupnorm(scale, bias, x: torch.Tensor, num_groups: int = 1, eps: float = 1e-5,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel-last GroupNorm over (B, T, C): per sample, over time and the
    group's channels; with a (B, T) mask over the valid frames only."""
    b, t, c = x.shape
    xf = x.float().reshape(b, t, num_groups, c // num_groups)
    if mask is not None:
        m = mask.float()[:, :, None, None]
        count = torch.clamp_min(m.sum(dim=1, keepdim=True) * xf.shape[-1], 1.0)
        mean = (xf * m).sum(dim=(1, 3), keepdim=True) / count
        var = (((xf - mean) ** 2) * m).sum(dim=(1, 3), keepdim=True) / count
    else:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def mask_value(dtype) -> float:
    """The finite large-negative additive mask of a dtype's softmax."""
    return -1e9 if dtype == torch.float32 else -3e4


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
    w = p["w"].to(x.dtype)
    if not (x.is_cuda and x.dtype == torch.float32):
        y = F.conv1d(h, w, None, dilation=dilation, groups=groups)
    elif torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
        y = _Conv1dF32.apply(h, w, dilation, groups)
    else:
        with no_tf32():
            y = F.conv1d(h, w, None, dilation=dilation, groups=groups)
    return (y.float() + p["b"].float()[:, None]).to(x.dtype).transpose(1, 2)


_TF32_LOCK = threading.Lock()
_tf32_blocks = 0  # no_tf32 blocks open in any thread
_tf32_saved = True  # the flag as the first of them found it


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full float32 while the block runs: PyTorch lets
    cuDNN use TF32 by default (torch.backends.cudnn.allow_tf32), where the
    JAX package computes float32. The flag is global to the process and the
    blocks run in several threads (request threads, the batcher, autograd's
    backward, a data loader), so they share one count: the first block to
    open turns TF32 off and the last to close restores the flag it found. A
    save and restore in each block (torch.backends.cudnn.flags) would let
    one thread turn TF32 back on inside another's block, or leave it off."""
    global _tf32_blocks, _tf32_saved
    c = torch.backends.cudnn
    with _TF32_LOCK:
        if _tf32_blocks == 0:
            _tf32_saved = c.allow_tf32
            c.allow_tf32 = False
        _tf32_blocks += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_blocks -= 1
            if _tf32_blocks == 0:
                c.allow_tf32 = _tf32_saved


class _Conv1dF32(torch.autograd.Function):
    """The float32 conv on the card with TF32 off in the forward and in the
    backward: cuDNN reads the flag when a convolution runs, and autograd
    runs the backward after the forward's context has closed."""

    @staticmethod
    def forward(ctx, h, w, dilation, groups):
        ctx.save_for_backward(h, w)
        ctx.dilation, ctx.groups = dilation, groups
        with no_tf32():
            return F.conv1d(h, w, None, dilation=dilation, groups=groups)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        with no_tf32():
            dh, dw, _ = torch.ops.aten.convolution_backward(
                dy, h, w, None, [1], [0], [ctx.dilation], False, [0], ctx.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dh, dw, None, None


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


def layers(tree, n: int):
    """The n layers of a tree of stacked block params, as views: one
    torch.unbind per leaf, so the backward writes each stacked gradient once."""
    if isinstance(tree, dict):
        parts = {k: layers(v, n) for k, v in tree.items()}
        return [{k: v[l] for k, v in parts.items()} for l in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"a stacked leaf of {tree.shape[0]} layers, want {n}")
    return list(torch.unbind(tree, 0))


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention, (B, H, Tq, D) x (B, H, Tk, D).

    key_mask (B, Tk) bool, True = attend. On a CUDA tensor with a key mask
    this is the hand-written attention kernel (ops/kernels/attention.py),
    behind its autograd Function where a gradient is wanted;
    otherwise the JAX package's XLA path: fp32 scores, masked keys -1e9,
    fp32 softmax, probs cast to the input dtype before PV."""
    if key_mask is not None and q.device.type != "cpu":
        from smalltts_tpu_torch.ops.kernels.attention import attention, fused_attention

        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return attention(q, k, v, key_mask)  # the kernel forward, a PyTorch backward
        return fused_attention(q, k, v, key_mask)
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :], scores, -1e9)  # finite: masked rows stay finite
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype)

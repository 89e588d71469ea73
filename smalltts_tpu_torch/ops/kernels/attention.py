"""Masked attention: wrapper of csrc/attention.cu and its plain versions.

Port of the Pallas TPU kernel smalltts_tpu/ops/pallas/attention.py::fused_attention
(see the source note in csrc/attention.cu for what bounds it on the H100 and
how the design answers that). The optional second key/value source with its
own key mask, and the sigmoid gate, carry the DiT's joint attention
(smalltts_tpu/ops/pallas/block.py:344-377) without a per-step concatenation.

On the card, bf16 runs a FlashAttention-2 kernel in registers (mma.sync)
that splits the keys across a thread-block cluster where the (b, h, q tile)
blocks alone cannot fill the SMs, and merges the splits by a log-sum-exp
combine; `attention_split_plain` is that split and merge in plain PyTorch,
for the tests. fp32 runs the same design on the tensor cores with fp32
accuracy (3xTF32: each operand split into tf32 hi + lo, three products).
A head dim of 4 (the ASR conformer's), fp32 or bf16, runs a CUDA-core
kernel of its own, one query row a thread.

`attention` is the kernel behind a torch.autograd.Function, for training:
its forward is `fused_attention` over one key source, ungated; its backward
is `attention_backward`, in PyTorch ops (the Pallas kernel has no VJP; the
JAX package trains through its XLA attention).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from smalltts_tpu_torch.ops import kernels, nn

NAME = "attention"
HEAD_DIMS = (4, 64, 120, 128)
KEY_TILE = 64  # keys per tile of the bf16 kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v, key_mask, k2=None, v2=None, key_mask2=None, gate=None):
    """The same function in plain PyTorch. q (B,H,Tq,D); k/v (B,H,S,D);
    key_mask (B,S) bool. fp32 scores x 1/sqrt(D), masked keys replaced by
    -1e9, fp32 softmax shared over both sources, PV with fp32 probabilities,
    output in q's dtype; with a gate (B,H,Tq,D), that output times
    sigmoid(gate) in q's dtype, each op rounded (`_gated`)."""
    kf, vf, mask = k.float(), v.float(), key_mask
    if k2 is not None:
        kf = torch.cat([kf, k2.float()], dim=2)
        vf = torch.cat([vf, v2.float()], dim=2)
        mask = torch.cat([key_mask, key_mask2], dim=1)
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(mask[:, None, None, :], scores, -1e9)
    return _gated(torch.matmul(torch.softmax(scores, dim=-1), vf), q.dtype, gate)


def _gated(out, dtype, gate):
    """out rounded to `dtype`, then times sigmoid(gate) in `dtype`, each op
    rounded: the order of the DiT's XLA path (models/dit.py::_attend)."""
    out = out.to(dtype)
    return out if gate is None else out * nn.sigmoid(gate.to(dtype))


def attention_split_plain(q, k, v, key_mask, k2=None, v2=None, key_mask2=None, gate=None, *, splits):
    """The bf16 kernel's key split and merge in plain PyTorch (tests only).

    The keys are cut into tiles of KEY_TILE, the first source's and then the
    second's, and split r takes tiles [r * per, (r + 1) * per) with per =
    ceil(tiles / splits). Each split runs the online softmax over its tiles
    in order and keeps its own fp32 (m, l, O). The kernel picks the split
    count from the shape and gives every split a tile; here any count may be
    given, so a split may hold none (m = -inf, l = 0). The splits merge in
    rank order: M = max_j m_j, w_j = exp(m_j - M) (0 where m_j = -inf), O =
    sum_j (w_j / sum_i w_i l_i) O_j, in q's dtype, then times sigmoid(gate)
    as `_gated` rounds it."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    tiles = [(kk[:, :, j:j + KEY_TILE].float(), vv[:, :, j:j + KEY_TILE].float(), mm[:, j:j + KEY_TILE])
             for kk, vv, mm in ((k, v, key_mask), (k2, v2, key_mask2)) if kk is not None
             for j in range(0, kk.shape[2], KEY_TILE)]
    per = max(1, -(-len(tiles) // splits))
    B, H, Tq, D = q.shape
    parts = []
    for r in range(splits):
        m = torch.full((B, H, Tq, 1), -math.inf, device=q.device)
        l = torch.zeros((B, H, Tq, 1), device=q.device)
        o = torch.zeros((B, H, Tq, D), device=q.device)
        for kt, vt, mt in tiles[r * per:(r + 1) * per]:
            s = torch.where(mt[:, None, None, :], torch.matmul(qf, kt.transpose(-1, -2)) * scale, -1e9)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.matmul(p, vt)
            m = m_new
        parts.append((m, l, o))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - mx)) for m, _, _ in parts]
    total = sum(wj * l for wj, (_, l, _) in zip(w, parts))
    out = sum((wj / total) * o for wj, (_, _, o) in zip(w, parts))
    return _gated(out, q.dtype, gate)


def _strides(t: torch.Tensor, name: str):
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    return [t.stride(0), t.stride(1), t.stride(2)]


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    k2: Optional[torch.Tensor] = None,
    v2: Optional[torch.Tensor] = None,
    key_mask2: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked attention (B,H,Tq,D) over one or two key sources, optionally
    gated. Tensors may be strided views with a contiguous head dim. `out`, a
    (B,H,Tq,D) view, receives the result; without it the result is a
    (B,H,Tq,D) view of a (B,Tq,H,D) buffer. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise, and count the launch
    by (B, H, Tq, S1 + S2, D, dtype) as well. In bf16 the kernel chooses its
    key split from the shape."""
    if kernels.use_plain(q):
        res = attention_plain(q, k, v, key_mask, k2, v2, key_mask2, gate)
        if out is None:
            return res
        out.copy_(res)
        return out
    B, H, Tq, D = q.shape
    two = k2 is not None
    srcs = [q, k, v, key_mask] + ([k2, v2, key_mask2] if two else []) + ([gate] if gate is not None else [])
    if any(t is None or t.device != q.device for t in srcs) or (two and (v2 is None or key_mask2 is None)):
        raise ValueError("attention: all inputs must be given on one device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in srcs if t.dtype != torch.bool):
        raise ValueError(f"attention: q/k/v/gate must share fp32 or bf16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {D} not in {HEAD_DIMS}")
    S1 = k.shape[2]
    S2 = k2.shape[2] if two else 0
    if k.shape != (B, H, S1, D) or v.shape != k.shape or key_mask.shape != (B, S1):
        raise ValueError("attention: k/v/key_mask shapes do not match q")
    if two and (k2.shape != (B, H, S2, D) or v2.shape != k2.shape or key_mask2.shape != (B, S2)):
        raise ValueError("attention: k2/v2/key_mask2 shapes do not match q")
    if gate is not None and gate.shape != q.shape:
        raise ValueError("attention: gate must have q's shape")
    if out is None:
        out = torch.empty((B, Tq, H, D), device=q.device, dtype=q.dtype).transpose(1, 2)
    elif out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("attention: out must have q's shape and dtype")
    if q.dtype == torch.bfloat16 and D != 4:  # the tensor-core kernel copies q/k/v rows in 16-byte chunks
        for t in [q, k, v] + ([k2, v2] if two else []):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError("attention: bf16 q/k/v need 16-byte aligned rows (strides of 8)")
        if out.data_ptr() % 4 or any(st % 2 for st in out.stride()[:3]):  # it stores bf16 pairs
            raise ValueError("attention: bf16 out needs 4-byte aligned pairs (even strides)")
    if q.dtype == torch.float32 and D != 4:  # the 3xTF32 kernel copies and stores rows in 16-byte chunks
        for t in [q, k, v, out] + ([k2, v2] if two else []) + ([gate] if gate is not None else []):
            if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3]):
                raise ValueError("attention: fp32 q/k/v/gate/out need 16-byte aligned rows (strides of 4)")
    m1 = key_mask.to(torch.bool).contiguous()
    m2 = key_mask2.to(torch.bool).contiguous() if two else None
    none = [0, 0, 0]
    strides = (_strides(q, "q") + _strides(k, "k") + _strides(v, "v")
               + (_strides(k2, "k2") + _strides(v2, "v2") if two else none + none)
               + (_strides(gate, "gate") if gate is not None else none)
               + _strides(out, "out") + [m1.stride(0), m2.stride(0) if two else 0])
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), m1.data_ptr(),
            k2.data_ptr() if two else None, v2.data_ptr() if two else None,
            m2.data_ptr() if two else None,
            gate.data_ptr() if gate is not None else None, out.data_ptr()]
    lib = kernels.load("attention")
    status = lib.st_attention(
        _DTYPES[q.dtype], D, (ctypes.c_void_p * 9)(*ptrs), (ctypes.c_longlong * 23)(*strides),
        (ctypes.c_int * 5)(B, H, Tq, S1, S2), 1.0 / math.sqrt(D),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    kernels.check(lib, "attention", status, "attention kernel")
    kernels.count_launch(NAME, (B, H, Tq, S1 + S2, D, q.dtype))
    return out



def attention_backward(q, k, v, key_mask, out, dout):
    """Gradients (dq, dk, dv) of attention_plain(q, k, v, key_mask) (one
    source, no gate) at the output `out` it gave, for the cotangent `dout`.

    The fp32 scores and probabilities are recomputed from q and k with the
    -1e9 key mask, as the forward computes them; then dP = dO V^T, dS = P *
    (dP - rowsum(dO * O)), zero at the masked keys (the mask replaces those
    scores by a constant), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D) and dV =
    P^T dO, all in fp32, each rounded to its input's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    keep = key_mask[:, None, None, :]
    scores = torch.where(keep, torch.matmul(qf, kf.transpose(-1, -2)) * scale, -1e9)
    probs = torch.softmax(scores, dim=-1)
    dv = torch.matmul(probs.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = torch.where(keep, probs * (dp - delta), 0.0)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        out = fused_attention(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out = ctx.saved_tensors
        return (*attention_backward(q, k, v, key_mask, out, dout), None)


def attention(q, k, v, key_mask):
    """Masked attention (B,H,Tq,D) over one key source, differentiable:
    the forward is fused_attention (the kernel on a CUDA tensor), the
    backward attention_backward."""
    return _Attention.apply(q, k, v, key_mask)

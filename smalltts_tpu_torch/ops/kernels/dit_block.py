"""The cached DiT block scan: wrappers of csrc/dit_block.cu and plain versions.

Port of the Pallas TPU kernel smalltts_tpu/ops/pallas/block.py::fused_dit_scan.
On the H100 the 12-layer scan is a host loop; each layer is 8 launches of
hand-written kernels (csrc/dit_block.cu has the source note: what bounds it,
and what the design does about that):

    adaln_modulate -> gemm_bias (qkvg) -> qk_norm_rope -> attention
    -> gemm_residual (to_out, row-masked) -> adaln_modulate
    -> gemm_swiglu (w13) -> gemm_residual (w2)

Every rounding point is the JAX bf16 path's: the adaLN rounds LN(x),
1 + scale, n * (1 + scale) and + shift; the gated residual tanh(gate),
tanh(gate) * y and x + that.

Each wrapper takes its plain version for CPU tensors (and under the
test-only `kernels.force_plain()`), and otherwise launches its kernel or
raises. The products go to the port's own GEMM kernel, never to cuBLAS: a
Hopper wgmma kernel fed by TMA, with the tile width and a split of K over a
thread-block cluster chosen per product in C, and the bias / SwiGLU / gated
residual epilogues applied to the accumulators in registers.

With int8 stream weights (models/dit.py::quantize_stream_weights) a
product's leaf holds `w_q` (K, N) int8 and `scale` (1, N) fp32 in place of
`w`; the GEMM wrappers then take `w_scale` and launch the int8-weight
variant of the kernel, counted under their own names (`gemm_bias_w8`,
`gemm_swiglu_w8`, `gemm_residual_w8`).
"""

from __future__ import annotations

import torch

from smalltts_tpu_torch.ops import kernels, nn
from smalltts_tpu_torch.ops.kernels.attention import fused_attention
from smalltts_tpu_torch.parallel import comm

EPI_BIAS, EPI_SWIGLU, EPI_RESID = 0, 1, 2


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _bf16_only(what: str, *ts) -> None:
    """The scan runs in bf16 on the card: its kernels are built for bf16 alone."""
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError(f"{what}: bf16 only on the card, got {[t.dtype for t in ts]}")


# ------------------------------------------------------------ adaln_modulate


def adaln_modulate_plain(x, shift, scale, eps=1e-6):
    """The JAX adaLN, nn.layernorm_noaffine(x) * (1 + scale) + shift: mean
    and variance in fp32 (two passes), the normalized value rounded to x's
    dtype, then each op in that dtype (bf16: three more roundings).
    x (B, T, H); shift/scale (B, H)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    n = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return n * (1 + scale[:, None]) + shift[:, None]


def adaln_modulate(x, shift, scale):
    if kernels.use_plain(x):
        return adaln_modulate_plain(x, shift, scale)
    B, T, H = x.shape
    if not x.is_contiguous() or shift.shape != (B, H) or scale.shape != (B, H):
        raise ValueError("adaln_modulate: x (B,T,H) contiguous, shift/scale (B,H)")
    if shift.stride() != scale.stride() or shift.stride(1) != 1:
        raise ValueError("adaln_modulate: shift/scale must share strides, contiguous in H")
    _bf16_only("adaln_modulate", x, shift, scale)
    # 16-byte loads: every row start 16-byte aligned
    if H % 8 or H > 2048 or shift.stride(0) % 8 or any(t.data_ptr() % 16 for t in (x, shift, scale)):
        raise ValueError("adaln_modulate: H a multiple of 8 up to 2048, rows 16-byte aligned")
    out = torch.empty_like(x)
    lib = kernels.load("dit_block")
    status = lib.st_adaln_modulate(x.data_ptr(), out.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                                   shift.stride(0), B * T, T, H, _stream(x))
    kernels.check(lib, "dit_block", status, "adaln_modulate")
    kernels.count_launch("adaln_modulate")
    return out


# -------------------------------------------------------------- qk_norm_rope


def qk_norm_rope_plain(qkvg, q_scale, k_scale, cos, sin, eps=1e-6):
    """In place on qkvg (B, T, >= 2*heads*D): per-head RMSNorm (fp32) * scale,
    rounded to the dtype, then interleaved RoPE on the first `rot` lanes in
    fp32 (cos/sin (T, rot)), rounded again; q at column 0, k after it."""
    B, T, _ = qkvg.shape
    heads, D = q_scale.shape
    rot = cos.shape[-1]
    segs = []
    for i, scl in enumerate((q_scale, k_scale)):
        xf = qkvg[..., i * heads * D:(i + 1) * heads * D].reshape(B, T, heads, D).float()
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = (xf * inv * scl.float()).to(qkvg.dtype)
        yr = y[..., :rot].float()
        pairs = yr.reshape(B, T, heads, rot // 2, 2)
        swapped = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(yr.shape)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        y = torch.cat([(yr * c + swapped * s).to(qkvg.dtype), y[..., rot:]], dim=-1)
        segs.append(y.reshape(B, T, heads * D))
    # one write of the whole tensor, not of views of it: torch.onnx.export's
    # tracer follows an in-place copy into a tensor, not into its views
    qkvg.copy_(torch.cat(segs + [qkvg[..., 2 * heads * D:]], dim=-1))
    return qkvg


def qk_norm_rope(qkvg, q_scale, k_scale, cos, sin):
    if kernels.use_plain(qkvg):
        return qk_norm_rope_plain(qkvg, q_scale, k_scale, cos, sin)
    B, T, W = qkvg.shape
    heads, D = q_scale.shape
    rot = cos.shape[-1]
    if not qkvg.is_contiguous() or W < 2 * heads * D or k_scale.shape != q_scale.shape:
        raise ValueError("qk_norm_rope: qkvg (B,T,>=2*heads*D) contiguous")
    if cos.shape != (T, rot) or sin.shape != cos.shape or {cos.dtype, sin.dtype} != {torch.float32}:
        raise ValueError("qk_norm_rope: cos/sin must be fp32 (T, rot)")
    q_scale, k_scale = q_scale.contiguous(), k_scale.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    _bf16_only("qk_norm_rope", qkvg, q_scale, k_scale)
    # 16-byte loads and stores: every head's and every table row's start 16-byte aligned
    if D % 8 or D > 256 or rot % 8 or rot > D or W % 8 or any(
            t.data_ptr() % 16 for t in (qkvg, q_scale, k_scale, cos, sin)):
        raise ValueError("qk_norm_rope: D a multiple of 8 up to 256, rot of 8 up to D, "
                         "qkvg, scales and tables 16-byte aligned")
    lib = kernels.load("dit_block")
    status = lib.st_qk_norm_rope(qkvg.data_ptr(), W, B * T, T, heads, D, rot, q_scale.data_ptr(),
                                 k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(), _stream(qkvg))
    kernels.check(lib, "dit_block", status, "qk_norm_rope")
    kernels.count_launch("qk_norm_rope")
    return qkvg


# ---------------------------------------------------------------------- gemm


def _product(a, w, b=None, w_scale=None):
    """The JAX package's linear: fp32 accumulation, fp32 bias, one rounding.
    int8 `w` with `w_scale` is first dequantized as nn.linear does it."""
    if w_scale is not None:
        w = nn.dequantize(w, w_scale, a.dtype)
    y = torch.matmul(a.float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(a.dtype)


def gemm_bias_plain(a, w, b, w_scale=None):
    return _product(a, w, b, w_scale)


def gemm_swiglu_plain(a, w13, b13, w_scale=None):
    ab = _product(a, w13, b13, w_scale)
    f = ab.shape[-1] // 2
    return nn.silu(ab[..., :f]) * ab[..., f:]


def gemm_residual_plain(a, w, b, x, gate, row_mask=None, w_scale=None):
    """x (B, T, N) += tanh(gate[b]) * (a @ w (+ b)) [* row_mask], in place,
    each op in x's dtype."""
    y = _product(a, w, b, w_scale)
    if row_mask is not None:
        y = torch.where(row_mask[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    x.copy_(x + torch.tanh(gate)[:, None, :] * y)
    return x


def _gemm(name, epi, a, w, bias, out, gate=None, row_mask=None, n_out=None, T=1, half=0, w_scale=None):
    """Launch the GEMM and count it under `name`: bf16 `w`, or int8 `w` with
    its fp32 per-column `w_scale` ((N,) or (1, N)), counted as `name`_w8."""
    M, K = a.numel() // a.shape[-1], a.shape[-1]
    _bf16_only("gemm", a, out)
    if w_scale is not None:
        if w.dtype != torch.int8 or w_scale.dtype != torch.float32 or w_scale.numel() != w.shape[1]:
            raise ValueError("gemm: int8 w needs an fp32 scale per column")
        if w_scale.device != a.device:
            raise ValueError("gemm: w_scale must be on a's device")
        if n_out % 16 or w.shape[1] % 16 or half % 16:
            raise ValueError(f"gemm: int8 w needs N={n_out} and W's width in multiples of 16")
        w_scale = w_scale.reshape(-1).contiguous()
    else:
        _bf16_only("gemm", w)
    if not a.is_contiguous() or not w.is_contiguous() or not out.is_contiguous():
        raise ValueError("gemm: operands must be contiguous")
    if w.shape[0] != K or K % 8 or n_out % 8 or w.shape[1] % 8:
        raise ValueError(f"gemm: K={K}, N={n_out} and W's width must be multiples of 8")
    # TMA reads a and w (16-byte aligned bases and row strides), int8 W included
    if any(t.data_ptr() % 16 for t in (a, w, out)):
        raise ValueError("gemm: a, w and out must be 16-byte aligned")
    for t in (bias, gate):
        if t is not None and (t.dtype != torch.bfloat16 or t.stride(-1) != 1):
            raise ValueError("gemm: bias/gate must be bf16 and contiguous in N")
    mask = None
    if row_mask is not None:
        mask = row_mask.to(torch.bool).contiguous()
        if mask.numel() != M:
            raise ValueError("gemm: row_mask must hold one flag per row")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = kernels.load("dit_block")
    status = lib.st_gemm(epi, a.data_ptr(), K, w.data_ptr(), w.shape[1], ptr(w_scale), ptr(bias),
                         out.data_ptr(), n_out, ptr(gate), gate.stride(0) if gate is not None else 0,
                         ptr(mask), M, n_out, K, T, half, _stream(a))
    kernels.check(lib, "dit_block", status, "gemm")
    kernels.count_launch(name if w_scale is None else name + "_w8")


def gemm_bias(a, w, b, w_scale=None):
    """a (..., K) @ w (K, N) + b, bf16 in, fp32 accumulation, bf16 out; an
    int8 w with its per-column fp32 `w_scale` takes the int8-weight kernel."""
    if kernels.use_plain(a):
        return gemm_bias_plain(a, w, b, w_scale)
    out = torch.empty((*a.shape[:-1], w.shape[1]), device=a.device, dtype=a.dtype)
    _gemm("gemm_bias", EPI_BIAS, a, w, b, out, n_out=w.shape[1], w_scale=w_scale)
    return out


def gemm_swiglu(a, w13, b13, w_scale=None):
    """silu(a @ w1 + b1) * (a @ w3 + b3) with w13 = [w1 | w3] (K, 2F)."""
    if kernels.use_plain(a):
        return gemm_swiglu_plain(a, w13, b13, w_scale)
    f = w13.shape[1] // 2
    out = torch.empty((*a.shape[:-1], f), device=a.device, dtype=a.dtype)
    _gemm("gemm_swiglu", EPI_SWIGLU, a, w13, b13, out, n_out=f, half=f, w_scale=w_scale)
    return out


def gemm_residual(a, w, b, x, gate, row_mask=None, w_scale=None):
    """x (B, T, N) += tanh(gate (B, N)) * (a @ w (+ b)) [* row_mask (B, T)],
    updated in place; rows are NOT masked when row_mask is None."""
    if kernels.use_plain(a):
        return gemm_residual_plain(a, w, b, x, gate, row_mask, w_scale)
    B, T, N = x.shape
    if gate.shape != (B, N) or (row_mask is not None and row_mask.shape != (B, T)):
        raise ValueError("gemm_residual: gate (B,N), row_mask (B,T)")
    _gemm("gemm_residual", EPI_RESID, a, w, b, x, gate=gate, row_mask=row_mask, n_out=N, T=T, w_scale=w_scale)
    return x


# ---------------------------------------------------------------------- scan


def _weight(lin):
    """(w, w_scale) of a product's leaf: bf16 `w`, or int8 `w_q` and its scale."""
    return (lin["w_q"], lin["scale"]) if "w_q" in lin else (lin["w"], None)


def _row_residual(a, w, b, x, gate, row_mask, w_scale, tp: bool):
    """gemm_residual; row-parallel under tensor parallelism. The gated
    residual is linear in the product, so each rank adds tanh(gate) times
    its partial product (with the bias on the first rank alone) to x on the
    first rank and to zeros on the others, through the same kernel, and the
    sum over tp is the new residual."""
    if not tp:
        return gemm_residual(a, w, b, x, gate, row_mask=row_mask, w_scale=w_scale)
    first = comm.tp_rank() == 0
    part = x if first else torch.zeros_like(x)
    part = gemm_residual(a, w, b if first else None, part, gate, row_mask=row_mask, w_scale=w_scale)
    return comm.tp_sum_(part)


def block_layer(x, mod, mask, cross_k, cross_v, cross_mask, layer, cos, sin, heads, head_dim,
                tp=(False, False)):
    """One cached DiT block (port of smalltts_tpu/models/dit.py::_block_core)
    on the fused serving layout, updating x (B, T, H) in place.
    mod (B, 6H) [shift|scale|gate]_msa, [shift|scale|gate]_mlp; cross_k/v
    (B, heads, Sc, D); masks (B, T) / (B, Sc). Each product's leaf holds
    `w`, or int8 `w_q` with `scale` (quantize_stream_weights). `tp` says
    whether the attention and the FF leaves are this rank's tensor-parallel
    shards (`heads` then this rank's heads): qkvg and w13 are then
    column-parallel, to_out and w2 row-parallel (_row_residual)."""
    B, T, H = x.shape
    inner = heads * head_dim
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        mod[:, i * H:(i + 1) * H] for i in range(6))
    attn, ff = layer["attn"], layer["ff"]

    h = adaln_modulate(x, shift_msa, scale_msa)
    w, s = _weight(attn["qkvg"])
    qkvg = gemm_bias(h, w, attn["qkvg"]["b"], w_scale=s)
    # each in-place op's result is read from its return value, the same
    # tensor: the ONNX exporter's tracer follows writes only that way
    qkvg = qk_norm_rope(qkvg, attn["q_norm"]["scale"], attn["k_norm"]["scale"], cos, sin)

    def heads_view(i):  # (B, heads, T, D) view of column block i of qkvg
        return qkvg[..., i * inner:(i + 1) * inner].unflatten(-1, (heads, head_dim)).transpose(1, 2)

    att = torch.empty((B, T, inner), device=x.device, dtype=x.dtype)
    att = fused_attention(heads_view(0), heads_view(1), heads_view(2), mask,
                          cross_k, cross_v, cross_mask, gate=heads_view(3),
                          out=att.unflatten(-1, (heads, head_dim)).transpose(1, 2))
    att = att.transpose(1, 2).reshape(B, T, inner)  # a view of the (B, T, inner) buffer
    w, s = _weight(attn["to_out"])
    x = _row_residual(att, w, None, x, gate_msa, mask, s, tp[0])
    h = adaln_modulate(x, shift_mlp, scale_mlp)
    w, s = _weight(ff["w13"])
    mid = gemm_swiglu(h, w, ff["w13"]["b"], w_scale=s)
    w, s = _weight(ff["w2"])
    return _row_residual(mid, w, ff["w2"]["b"], x, gate_mlp, None, s, tp[1])


def fused_dit_scan(x, mods, mask, cross_k, cross_v, cross_mask, blocks, cos, sin, *,
                   heads, head_dim, tp=(False, False)):
    """The L-layer cached DiT scan. x (B, T, H); mods (L, B, 6H) (the batch
    stride may be 0); mask (B, T) bool; cross_k/v (L, B, heads, Sc, D) with
    cross_mask (B, Sc); blocks: stacked fused-serving block params (qkvg,
    to_out, q_norm, k_norm, w13, w2, each with a leading L; a product's leaf
    holds bf16 `w`, or int8 `w_q` with fp32 `scale` (L, 1, N)); cos/sin (T, rot)
    fp32. `tp`, as block_layer takes it, with a mesh in use. Returns the new
    residual (x is not modified)."""
    if "qkvg" not in blocks["attn"] or "w13" not in blocks["ff"]:
        raise ValueError("fused_dit_scan needs the fused serving layout (fuse_serving_projections)")
    x = x.contiguous().clone()
    L = mods.shape[0]
    used = {"attn": {k: blocks["attn"][k] for k in ("qkvg", "to_out", "q_norm", "k_norm")},
            "ff": {k: blocks["ff"][k] for k in ("w13", "w2")}}
    for l, blk in enumerate(nn.layers(used, L)):
        x = block_layer(x, mods[l], mask, cross_k[l], cross_v[l], cross_mask, blk, cos, sin, heads, head_dim, tp)
    return x

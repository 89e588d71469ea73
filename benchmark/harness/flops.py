"""Operations and bytes of smalltts's work, from its shapes, and the
yardstick they are held to: one H100 SXM's dense bf16 peak, 989 TFLOP/s,
and its HBM3 bandwidth, 3.35 TB/s (NVIDIA's data sheet). The fp32 codec is
held to the same peak, so that no later kernel for it can read above 100%
of the same work.

A multiply-add counts 2 operations. A kernel's bound is the larger of its
operations over the peak and its bytes over the bandwidth, each input byte
read once and each output byte written once. Attention counts the keys the
masks leave live in each row: that work the inputs need; other kernels
count their launched shapes."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16, FP32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


# ------------------------------------------------------ work of a request


def _encoder_flops(e, t: int) -> float:
    m = e.model_size
    per_layer = 2 * t * m * m * 5 + 4 * t * t * m + 2 * t * m * e.intermediate_size * 3
    return e.num_layers * per_layer


def style_flops(cfg, r: int) -> float:
    """The style encoder over r reference frames."""
    m = cfg.style.model_size
    return 2 * r * cfg.latent_dim * m + _encoder_flops(cfg.style, r) + 2 * r * m * cfg.hidden_dim


def text_flops(cfg, p: int) -> float:
    """The text encoder over p phonemes."""
    return _encoder_flops(cfg.text, p)


def cross_kv_flops(cfg, r: int, p: int) -> float:
    """The phoneme projection and every layer's cross K/V projections."""
    h = cfg.hidden_dim
    return 2 * p * cfg.phoneme_dim * h + cfg.dit.n_blocks * 2 * (r + p) * h * 2 * h


def dit_eval_flops(cfg, t: int, s_cross: int) -> float:
    """One denoiser evaluation over t frames with s_cross cross keys: the
    input embedding (projection, two grouped convolutions), every block's
    projections and attention, and the velocity head."""
    h, f, d = cfg.hidden_dim, cfg.ff_dim, cfg.dit
    embed = 2 * t * cfg.latent_dim * h + 2 * (2 * t * h * (h // d.conv_groups) * d.conv_kernel)
    block = 2 * t * h * 4 * h + 2 * t * h * h + 2 * t * h * 2 * f + 2 * t * f * h + 4 * t * (t + s_cross) * h
    return embed + d.n_blocks * block + 2 * t * h * cfg.latent_dim


def conditioning_flops(cfg) -> float:
    """Per-row work of the time embedding's MLP, the DiT's embedding MLP,
    every block's modulation and the final modulation."""
    h = cfg.hidden_dim
    return (2 * cfg.time_embed_dim * h + 2 * h * h + 2 * h * 2 * h + 2 * 2 * h * h
            + cfg.dit.n_blocks * 2 * h * 6 * h + 2 * h * 2 * h)


def codec_convs(cfg, t: int, batch: int = 1) -> List[Tuple[float, float]]:
    """(operations, bytes) of each convolution of the codec decoder over t
    latent frames, fp32."""
    c = cfg.codec
    ch, n = c.channels, len(c.strides)
    out = []

    def conv(cin, cout, k, length):
        out.append((2.0 * batch * length * cout * cin * k,
                    float(FP32 * (batch * cin * length + cout * cin * k + cout + batch * cout * length))))

    conv(c.latent_dim, ch[0], 3, t)
    length = t
    for i in range(n):
        for _ in c.res_dilations:
            conv(ch[i], ch[i], c.kernel, length)
            conv(ch[i], ch[i], 1, length)
        conv(ch[i], ch[i + 1] * c.strides[i], c.kernel, length)
        if i < n - 1:
            length *= c.strides[i]
    conv(ch[-1] * c.strides[-1], c.strides[-1], c.head_kernel, length)
    return out


def codec_decode_flops(cfg, t: int) -> float:
    return sum(f for f, _ in codec_convs(cfg, t))


def request_flops(cfg, r: int, p: int, t: int, steps: int = 4) -> float:
    """A served request's work at its own lengths: conditioning, `steps`
    denoiser evaluations, the codec decode. The time embedding and the
    modulations, shared by a batch, are left out."""
    return (style_flops(cfg, r) + text_flops(cfg, p) + cross_kv_flops(cfg, r, p)
            + steps * dit_eval_flops(cfg, t, r + p) + codec_decode_flops(cfg, t))


def teacher_row_forward_flops(cfg, r: int, p: int, t: int) -> float:
    """The teacher's forward over one row at its true lengths (r = 0 where
    the reference is dropped, p = 0 where the text is)."""
    return (style_flops(cfg, r) + text_flops(cfg, p) + cross_kv_flops(cfg, r, p)
            + dit_eval_flops(cfg, t, r + p) + conditioning_flops(cfg))


def teacher_row_flops(cfg, r: int, p: int, t: int) -> float:
    """Forward and backward: three times the forward's products."""
    return 3 * teacher_row_forward_flops(cfg, r, p, t)


# ----------------------------------------- kernel launches of a served batch


def _attention(b, heads, tq, d, live_keys: Sequence[int], gated: bool) -> Tuple[float, float]:
    keys = sum(live_keys)
    flops = 4.0 * heads * tq * d * keys
    nbytes = BF16 * (b * heads * tq * d * (3 if gated else 2) + 2 * heads * d * keys) + b * (tq + max(live_keys))
    return flops, float(nbytes)


def batch_launches(cfg, b: int, rb: int, pb: int, tb: int, ref_lens: Sequence[int], ph_lens: Sequence[int],
                   seq_lens: Sequence[int], steps: int = 4) -> Dict[str, List[Tuple[float, float]]]:
    """(operations, bytes) of every hand-written and codec convolution
    launch of one served batch of shape (b, rb, pb, tb), by class:
    "attention" (style, text and DiT), "scan" (adaln_modulate,
    qk_norm_rope and the GEMMs of the DiT scan), "codec_conv"."""
    h, f, d = cfg.hidden_dim, cfg.ff_dim, cfg.head_dim
    st, te = cfg.style, cfg.text
    att = []
    att += [_attention(b, st.num_heads, rb, st.head_dim, ref_lens, False)] * st.num_layers
    att += [_attention(b, te.num_heads, pb, te.head_dim, ph_lens, False)] * te.num_layers
    dit_keys = [s + r + p for s, r, p in zip(seq_lens, ref_lens, ph_lens)]
    att += [_attention(b, cfg.dit.heads, tb, d, dit_keys, True)] * (cfg.dit.n_blocks * steps)
    m = b * tb
    adaln = (8.0 * m * h, float(BF16 * (2 * m * h + 2 * b * h)))
    qk = (20.0 * m * h, float(BF16 * (4 * m * h + 2 * cfg.dit.heads * d) + FP32 * 2 * tb * cfg.dit.rot_dim))

    def gemm(k, n, n_out, resid):
        return (2.0 * m * k * n, float(BF16 * (m * k + k * n + n + m * n_out * (2 if resid else 1) + (b * n if resid else 0))))

    layer = [adaln, gemm(h, 4 * h, 4 * h, False), qk, gemm(h, h, h, True), adaln, gemm(h, 2 * f, f, False),
             gemm(f, h, h, True)]
    return {"attention": att, "scan": layer * (cfg.dit.n_blocks * steps), "codec_conv": codec_convs(cfg, tb, b)}

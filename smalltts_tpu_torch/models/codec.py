"""Sub-pixel neural audio codec: 24 kHz waveform <-> 64-dim latents at hop
3200 (port of smalltts_tpu/models/codec.py).

Every heavy convolution runs at a low rate with wide channels; depth<->time
reshapes resample, and the input/output heads are folded into the finest low
rate. Activations are the Bhaskara fast snake the codec is trained with.
Runs in fp32; its convolutions (nn.conv1d) run with cuDNN's TF32 off, since
cuDNN would otherwise compute fp32 convolutions in TF32.

The decoder has two paths that share only the arithmetic's definition.
Training, export and the CPU keep the channel-last op chain below (the JAX
package's layout, under autograd and the exporter's tracer). The card's
serving decode (float32 latents on CUDA, no gradient wanted, not traced)
keeps its activations in cuDNN's NCW layout from dec_in to dec_out, and
after each convolution one pass (ops/kernels/codec.py) adds the bias and
the residual, applies tanh and depth to time, and writes the snake of the
next convolution's input straight into its padded buffer: the same bits,
with about a tenth of the bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.ops.kernels.codec import bhaskara_snake, codec_pointwise
from smalltts_tpu_torch.utils.convert import tree_leaves


@dataclass(frozen=True)
class CodecConfig:
    latent_dim: int = 64
    strides: Tuple[int, ...] = (4, 4, 5, 5, 8)
    channels: Tuple[int, ...] = (768, 512, 384, 256, 128, 32)
    res_dilations: Tuple[int, ...] = (1, 3)
    kernel: int = 7
    head_kernel: int = 7

    @property
    def hop(self) -> int:
        return math.prod(self.strides)


def snake(x: torch.Tensor, log_alpha: torch.Tensor) -> torch.Tensor:
    """The Bhaskara fast snake (ops/kernels/codec.bhaskara_snake), channel-last:
    log_alpha (C,)."""
    return bhaskara_snake(x, torch.exp(log_alpha).to(x.dtype))


def _init_res_unit(gen, ch, kernel, dtype, device):
    return {
        "log_alpha1": torch.zeros((ch,), dtype=dtype, device=device),
        "conv1": nn.init_conv1d(gen, ch, ch, kernel, dtype=dtype, device=device),
        "log_alpha2": torch.zeros((ch,), dtype=dtype, device=device),
        "conv2": nn.init_conv1d(gen, ch, ch, 1, dtype=dtype, device=device),
    }


def _res_unit(p, x, d: int):
    """Dilated residual unit (codec.py:93-106)."""
    h = nn.conv1d(p["conv1"], snake(x, p["log_alpha1"]), dilation=d)
    h = nn.conv1d(p["conv2"], snake(h, p["log_alpha2"]), padding=0)
    return x + h


def init_codec(gen, cfg: CodecConfig = CodecConfig(), dtype=torch.float32, device="cpu"):
    n = len(cfg.strides)
    ch = cfg.channels
    kw = dict(dtype=dtype, device=device)
    enc_stages = []
    for i in reversed(range(n)):  # 24 kHz side -> latent rate
        r = cfg.strides[i]
        enc_stages.append({
            "conv": nn.init_conv1d(gen, ch[i + 1] * r, ch[i], cfg.kernel, **kw),
            "log_alpha": torch.zeros((ch[i],), **kw),
            "res": [_init_res_unit(gen, ch[i], cfg.kernel, dtype, device) for _ in cfg.res_dilations],
        })
    dec_stages = []
    for i in range(n):  # latent rate -> 24 kHz side
        r = cfg.strides[i]
        dec_stages.append({
            "res": [_init_res_unit(gen, ch[i], cfg.kernel, dtype, device) for _ in cfg.res_dilations],
            "log_alpha": torch.zeros((ch[i],), **kw),
            "conv": nn.init_conv1d(gen, ch[i], ch[i + 1] * r, cfg.kernel, **kw),
        })
    r_last = cfg.strides[-1]
    wide = ch[-1] * r_last
    return {
        "enc_in": nn.init_conv1d(gen, r_last, wide, cfg.head_kernel, **kw),
        "enc_stages": enc_stages,
        "enc_out": nn.init_conv1d(gen, ch[0], cfg.latent_dim, 3, **kw),
        "dec_in": nn.init_conv1d(gen, cfg.latent_dim, ch[0], 3, **kw),
        "dec_stages": dec_stages,
        "dec_log_alpha": torch.zeros((wide,), **kw),
        "dec_out": nn.init_conv1d(gen, wide, r_last, cfg.head_kernel, **kw),
    }


def _depth_to_time(x, r: int):
    b, t, c = x.shape
    return x.reshape(b, t * r, c // r)


def _time_to_depth(x, r: int):
    b, t, c = x.shape
    return x.reshape(b, t // r, r * c)


def codec_encode(p, audio: torch.Tensor, cfg: CodecConfig = CodecConfig()) -> torch.Tensor:
    """(B, 1, T) 24 kHz waveform -> (B, T // hop, latent_dim); T a multiple of hop."""
    if audio.shape[-1] % cfg.hop != 0:
        raise ValueError(f"audio length {audio.shape[-1]} must be a multiple of hop {cfg.hop}")
    b, _, t = audio.shape
    r_last = cfg.strides[-1]
    x = nn.conv1d(p["enc_in"], audio.reshape(b, t // r_last, r_last))
    for k, (stage, i) in enumerate(zip(p["enc_stages"], reversed(range(len(cfg.strides))))):
        if k:  # enc_in already produced the widened first stage
            x = _time_to_depth(x, cfg.strides[i])
        x = snake(nn.conv1d(stage["conv"], x), stage["log_alpha"])
        for ru, d in zip(stage["res"], cfg.res_dilations):
            x = _res_unit(ru, x, d)
    return nn.conv1d(p["enc_out"], x)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _inference_only(p, latents: torch.Tensor) -> bool:
    """float32 latents, no gradient wanted, and neither a jit trace nor an
    ONNX export running: what the NCW decode may serve."""
    if latents.dtype != torch.float32 or torch.jit.is_tracing() or torch.onnx.is_in_onnx_export():
        return False
    return not torch.is_grad_enabled() or not (
        latents.requires_grad or any(torch.is_tensor(t) and t.requires_grad for t in tree_leaves(p)))


def _same_pad(k: int, dilation: int) -> Tuple[int, int]:
    total = (k - 1) * dilation
    return total // 2, total - total // 2


def _decoder_convs(p, cfg: CodecConfig):
    """The decoder's convolutions in order: (params, dilation, log_alpha of
    the snake before it or None, what its output is, depth-to-time factor).
    Outputs: "x" the residual stream, "h" a unit's hidden, "res" x plus the
    unit, "head" the waveform."""
    n = len(cfg.strides)
    out = [(p["dec_in"], 1, None, "x", 1)]
    for i, (stage, r) in enumerate(zip(p["dec_stages"], cfg.strides)):
        for ru, d in zip(stage["res"], cfg.res_dilations):
            out += [(ru["conv1"], d, ru["log_alpha1"], "h", 1), (ru["conv2"], 1, ru["log_alpha2"], "res", 1)]
        out.append((stage["conv"], 1, stage["log_alpha"], "x", r if i < n - 1 else 1))
    out.append((p["dec_out"], 1, p["dec_log_alpha"], "head", cfg.strides[-1]))
    return out


def _decode_ncw(p, latents: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """The serving decode: cuDNN's float32 convolutions (TF32 off) on NCW
    buffers, each followed by one codec_pointwise pass that writes the next
    convolution's padded input; the residual stream is kept only where a
    unit adds it."""
    convs = _decoder_convs(p, cfg)
    f32 = torch.float32
    with nn.no_tf32():
        h = F.pad(latents.transpose(1, 2), _same_pad(p["dec_in"]["w"].shape[-1], 1))
        x = out = None
        for k, (cp, d, _, kind, r) in enumerate(convs):
            y = F.conv1d(h, cp["w"].to(f32), None, dilation=d)
            nxt = convs[k + 1] if k + 1 < len(convs) else None
            keep = kind == "head" or (kind in ("x", "res") and nxt[3] == "h")
            out, h = codec_pointwise(
                y, cp["b"].to(f32), x if kind == "res" else None, r=r, tanh=kind == "head", keep=keep,
                alpha=torch.exp(nxt[2]).to(f32) if nxt else None,
                pad=_same_pad(nxt[0]["w"].shape[-1], nxt[1]) if nxt else (0, 0))
            if kind in ("x", "res"):
                x = out
    return out


def codec_decode(p, latents: torch.Tensor, cfg: CodecConfig = CodecConfig()) -> torch.Tensor:
    """(B, T', latent_dim) -> (B, 1, T' * hop) waveform in [-1, 1]. On the
    card without autograd: the NCW decode (_decode_ncw); otherwise the
    channel-last op chain."""
    if _on_card(latents) and _inference_only(p, latents):
        return _decode_ncw(p, latents, cfg)
    n = len(cfg.strides)
    x = nn.conv1d(p["dec_in"], latents)
    for i, (stage, r) in enumerate(zip(p["dec_stages"], cfg.strides)):
        for ru, d in zip(stage["res"], cfg.res_dilations):
            x = _res_unit(ru, x, d)
        x = nn.conv1d(stage["conv"], snake(x, stage["log_alpha"]))
        if i < n - 1:
            x = _depth_to_time(x, r)
    x = torch.tanh(nn.conv1d(p["dec_out"], snake(x, p["dec_log_alpha"])))
    b, t_low, r_last = x.shape
    return x.reshape(b, 1, t_low * r_last)

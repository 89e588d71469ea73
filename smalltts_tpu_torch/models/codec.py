"""Sub-pixel neural audio codec: 24 kHz waveform <-> 64-dim latents at hop
3200 (port of smalltts_tpu/models/codec.py).

Every heavy convolution runs at a low rate with wide channels; depth<->time
reshapes resample, and the input/output heads are folded into the finest low
rate. Activations are the Bhaskara fast snake the codec is trained with.
Runs in fp32; its convolutions (nn.conv1d) run with cuDNN's TF32 off, since
cuDNN would otherwise compute fp32 convolutions in TF32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from smalltts_tpu_torch.ops import nn


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
    """x + sin^2(a x)/a with Bhaskara I's approximation of |sin| over the
    period pi: sin(pi f) ~= 16 f (1-f) / (5 - 4 f (1-f)), f in [0, 1)
    (codec.py:64-80). Channel-last: log_alpha (C,)."""
    a = torch.exp(log_alpha).to(x.dtype)
    y = a * x * (1.0 / math.pi)
    f = y - torch.floor(y)
    g = f * (1.0 - f)
    s = 16.0 * g / (5.0 - 4.0 * g)
    return x + (s * s) / a


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


def codec_decode(p, latents: torch.Tensor, cfg: CodecConfig = CodecConfig()) -> torch.Tensor:
    """(B, T', latent_dim) -> (B, 1, T' * hop) waveform in [-1, 1]."""
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

"""Speaker verification, forward only: ECAPA-TDNN over codec latents, the
frozen SV loss model of DMD2 distillation (port of
smalltts_tpu/models/sv.py): channels (768, 768, 768, 768, 2304), kernels
(3, 3, 3, 3, 1), dilations (1, 2, 3, 5, 1), attention 192, res2net scale 12,
SE 192, attentive statistics pooling with global context, embedding 192.
Padded positions are zeroed after every TDNN block."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.ops.masking import length_mask


@dataclass(frozen=True)
class SVConfig:
    input_dim: int = 64
    emb_dim: int = 192
    channels: Tuple[int, ...] = (768, 768, 768, 768, 2304)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3, 3, 1)
    dilations: Tuple[int, ...] = (1, 2, 3, 5, 1)
    attention_channels: int = 192
    res2net_scale: int = 12
    se_channels: int = 192


def _init_tdnn(gen, c_in, c_out, k, dtype, device):
    return {"conv": nn.init_conv1d(gen, c_in, c_out, k, dtype=dtype, device=device),
            "bn": nn.init_batchnorm(c_out, dtype, device)}


def _tdnn(p, x, dilation, train, mask=None):
    """conv (dilated, padded (k - 1) * dilation / 2 each side) -> ReLU ->
    BatchNorm, padded positions then zeroed."""
    k = p["conv"]["w"].shape[-1]
    y = torch.relu(nn.conv1d(p["conv"], x, padding=(k - 1) * dilation // 2, dilation=dilation))
    y, new_bn = nn.batchnorm(p["bn"], y, train, mask)
    if mask is not None:
        y = torch.where(mask[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y, {"conv": p["conv"], "bn": new_bn}


def _init_se_res2net(gen, ch, k, scale, se_ch, dtype, device):
    width = ch // scale
    kw = dict(dtype=dtype, device=device)
    return {
        "in_tdnn": _init_tdnn(gen, ch, ch, 1, dtype, device),
        "res2net": [_init_tdnn(gen, width, width, k, dtype, device) for _ in range(scale - 1)],
        "out_tdnn": _init_tdnn(gen, ch, ch, 1, dtype, device),
        "se1": nn.init_conv1d(gen, ch, se_ch, 1, **kw),
        "se2": nn.init_conv1d(gen, se_ch, ch, 1, **kw),
    }


def _se_res2net(p, cfg: SVConfig, x, dilation, train, mask):
    residual = x
    y, new_in = _tdnn(p["in_tdnn"], x, 1, train, mask)
    chunks = torch.chunk(y, cfg.res2net_scale, dim=-1)
    outs, prev, new_res = [chunks[0]], None, []
    for i, blk in enumerate(p["res2net"]):
        inp = chunks[i + 1] if prev is None else chunks[i + 1] + prev
        prev, nb = _tdnn(blk, inp, dilation, train, mask)
        new_res.append(nb)
        outs.append(prev)
    y, new_out = _tdnn(p["out_tdnn"], torch.cat(outs, dim=-1), 1, train, mask)
    # squeeze-excitation over the masked temporal mean
    if mask is not None:
        m = mask[..., None].to(y.dtype)
        s = (y * m).sum(dim=1, keepdim=True) / torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
    else:
        s = y.mean(dim=1, keepdim=True)
    s = torch.relu(nn.conv1d(p["se1"], s, padding=0))
    s = nn.sigmoid(nn.conv1d(p["se2"], s, padding=0))
    return y * s + residual, {**p, "in_tdnn": new_in, "res2net": new_res, "out_tdnn": new_out}


# the conv kernels of init_sv's tree (utils/convert): every TDNN block's,
# the SE and attention convs and the 1x1 embedding conv
CONV_PATHS = (r"(block0|mfa|blocks#\d+/(in_tdnn|out_tdnn|res2net#\d+))/conv/w"
              r"|blocks#\d+/se[12]/w|asp/attn[12]/w|fc/w")


def init_sv(gen, cfg: SVConfig = SVConfig(), dtype=torch.float32, device="cpu"):
    ch, kw = cfg.channels, dict(dtype=dtype, device=device)
    return {
        "block0": _init_tdnn(gen, cfg.input_dim, ch[0], cfg.kernel_sizes[0], dtype, device),
        "blocks": [_init_se_res2net(gen, ch[i + 1], cfg.kernel_sizes[i + 1], cfg.res2net_scale, cfg.se_channels,
                                    dtype, device) for i in range(3)],
        "mfa": _init_tdnn(gen, ch[0] * 3, ch[-1], cfg.kernel_sizes[-1], dtype, device),
        "asp": {"attn1": nn.init_conv1d(gen, ch[-1] * 3, cfg.attention_channels, 1, **kw),
                "attn2": nn.init_conv1d(gen, cfg.attention_channels, ch[-1], 1, **kw)},
        "asp_bn": nn.init_batchnorm(ch[-1] * 2, **kw),
        "fc": nn.init_conv1d(gen, ch[-1] * 2, cfg.emb_dim, 1, **kw),
    }


def _masked_stats(x, mask, eps=1e-12):
    m = mask[..., None].to(x.dtype)
    count = torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
    mean = (x * m).sum(dim=1, keepdim=True) / count
    var = ((x - mean) ** 2 * m).sum(dim=1, keepdim=True) / count
    return mean, torch.sqrt(torch.clamp_min(var, eps))


def sv_forward(p, cfg: SVConfig, latents, lengths, train: bool = False):
    """latents (B, T, 64), lengths (B,) -> (speaker embedding (B, emb_dim),
    new_params). A converted checkpoint's `asp/attn_tdnn_bn` (the attention
    conv's TDNN block: conv -> ReLU -> BN -> tanh) is applied where present."""
    mask = length_mask(lengths, latents.shape[1])
    x, new_b0 = _tdnn(p["block0"], latents, cfg.dilations[0], train, mask)
    feats, new_blocks = [], []
    for i, blk in enumerate(p["blocks"]):
        x, nb = _se_res2net(blk, cfg, x, cfg.dilations[i + 1], train, mask)
        feats.append(x)
        new_blocks.append(nb)
    x, new_mfa = _tdnn(p["mfa"], torch.cat(feats, dim=-1), cfg.dilations[-1], train, mask)

    # attentive statistics pooling with global context
    mean, std = _masked_stats(x, mask)
    ctx = torch.cat([x, mean.expand(x.shape), std.expand(x.shape)], dim=-1)
    a = nn.conv1d(p["asp"]["attn1"], ctx, padding=0)
    new_asp = p["asp"]
    if "attn_tdnn_bn" in p["asp"]:
        a, new_attn_bn = nn.batchnorm(p["asp"]["attn_tdnn_bn"], torch.relu(a), train, mask)
        new_asp = {**p["asp"], "attn_tdnn_bn": new_attn_bn}
    attn = nn.conv1d(p["asp"]["attn2"], torch.tanh(a), padding=0).float()
    attn = torch.where(mask[..., None], attn, nn.mask_value(torch.float32))
    w = torch.softmax(attn, dim=1).to(x.dtype)
    mu = (x * w).sum(dim=1, keepdim=True)
    sg = torch.sqrt(torch.clamp_min((x ** 2 * w).sum(dim=1, keepdim=True) - mu ** 2, 1e-12))
    pooled, new_bn = nn.batchnorm(p["asp_bn"], torch.cat([mu, sg], dim=-1), train)
    emb = nn.conv1d(p["fc"], pooled, padding=0)[:, 0, :]
    return emb, {**p, "block0": new_b0, "blocks": new_blocks, "mfa": new_mfa, "asp": new_asp, "asp_bn": new_bn}

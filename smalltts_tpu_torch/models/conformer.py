"""Conformer encoder (port of smalltts_tpu/models/conformer.py): half-step
FFN -> MHSA -> conv module (pointwise, GLU, depthwise, GroupNorm or
BatchNorm, SiLU, pointwise) -> half-step FFN -> final LayerNorm, pre-norm
with residuals. The ASR (7 x 64, 16 heads, BatchNorm) and the
discriminator (6 x 512, 8 heads, GroupNorm) run it.

BatchNorm running stats live in the params (`mean`/`var` leaves); every
apply returns (y, new_params)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smalltts_tpu_torch.ops import nn


@dataclass(frozen=True)
class ConformerConfig:
    input_dim: int
    num_heads: int
    ffn_dim: int
    num_layers: int
    depthwise_conv_kernel_size: int
    use_group_norm: bool = False
    # zero padded positions before the depthwise conv (and GroupNorm's stats
    # over valid frames only); False for weight-exact parity with converted
    # reference checkpoints, which trained with the leakage
    pad_invariant: bool = True

    @property
    def head_dim(self) -> int:
        return self.input_dim // self.num_heads


def _init_ln(dim, dtype, device):
    return {"scale": torch.ones(dim, dtype=dtype, device=device), "bias": torch.zeros(dim, dtype=dtype, device=device)}


def _ln(p, x, eps=1e-5):
    y = nn.layernorm_noaffine(x, eps)
    return y * p["scale"].to(y.dtype) + p["bias"].to(y.dtype)


def _init_ffn(gen, dim, ffn_dim, dtype, device):
    return {"ln": _init_ln(dim, dtype, device),
            "w1": nn.init_linear(gen, dim, ffn_dim, dtype=dtype, device=device),
            "w2": nn.init_linear(gen, ffn_dim, dim, dtype=dtype, device=device)}


def _ffn(p, x):
    return nn.linear(p["w2"], nn.silu(nn.linear(p["w1"], _ln(p["ln"], x))))


def init_conformer_layer(gen, cfg: ConformerConfig, dtype=torch.float32, device="cpu"):
    d, kw = cfg.input_dim, dict(dtype=dtype, device=device)
    p = {
        "ffn1": _init_ffn(gen, d, cfg.ffn_dim, dtype, device),
        "attn_ln": _init_ln(d, dtype, device),
        "attn": {"in_proj": nn.init_linear(gen, d, 3 * d, **kw), "out_proj": nn.init_linear(gen, d, d, **kw)},
        "conv_ln": _init_ln(d, dtype, device),
        "conv": {
            "pw1": nn.init_conv1d(gen, d, 2 * d, 1, **kw),
            "dw": nn.init_conv1d(gen, d, d, cfg.depthwise_conv_kernel_size, groups=d, **kw),
            "pw2": nn.init_conv1d(gen, d, d, 1, **kw),
        },
        "ffn2": _init_ffn(gen, d, cfg.ffn_dim, dtype, device),
        "final_ln": _init_ln(d, dtype, device),
    }
    if cfg.use_group_norm:
        p["conv"]["gn_scale"] = torch.ones(d, **kw)
        p["conv"]["gn_bias"] = torch.zeros(d, **kw)
    else:
        p["conv"]["bn"] = nn.init_batchnorm(d, **kw)
    return p


def _mhsa(p, cfg: ConformerConfig, x, key_mask):
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = torch.chunk(nn.linear(p["in_proj"], x), 3, dim=-1)
    q, k, v = (a.reshape(b, t, h, hd).transpose(1, 2) for a in (q, k, v))
    out = nn.sdpa(q, k, v, key_mask=key_mask)
    return nn.linear(p["out_proj"], out.transpose(1, 2).reshape(b, t, d))


def _glu(h):
    a, g = torch.chunk(h, 2, dim=-1)
    return a * nn.sigmoid(g)


def _conv_module(p, cfg: ConformerConfig, x, mask, train: bool):
    h = _glu(nn.conv1d(p["pw1"], x, padding=0))
    if mask is not None and cfg.pad_invariant:
        h = torch.where(mask[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
    k = cfg.depthwise_conv_kernel_size
    h = nn.conv1d(p["dw"], h, groups=cfg.input_dim, padding=(k - 1) // 2)
    new_p = p
    if cfg.use_group_norm:
        h = nn.groupnorm(p["gn_scale"], p["gn_bias"], h, num_groups=1, mask=mask if cfg.pad_invariant else None)
    else:
        h, new_bn = nn.batchnorm(p["bn"], h, train, mask)
        new_p = {**p, "bn": new_bn}
    return nn.conv1d(p["pw2"], nn.silu(h), padding=0), new_p


def conformer_layer(p, cfg: ConformerConfig, x, key_mask, train: bool = False):
    """One layer; returns (y, new_params) (BatchNorm stats move when train)."""
    x = x + 0.5 * _ffn(p["ffn1"], x)
    x = x + _mhsa(p["attn"], cfg, _ln(p["attn_ln"], x), key_mask)
    conv_out, new_conv = _conv_module(p["conv"], cfg, _ln(p["conv_ln"], x), key_mask, train)
    x = x + conv_out
    x = x + 0.5 * _ffn(p["ffn2"], x)
    return _ln(p["final_ln"], x), {**p, "conv": new_conv}


# the conv kernels of init_conformer's tree (HIO in the JAX package), as a
# regex over the paths of utils/convert
CONV_PATHS = r"layers#\d+/conv/(pw1|dw|pw2)/w"


def init_conformer(gen, cfg: ConformerConfig, dtype=torch.float32, device="cpu"):
    return {"layers": [init_conformer_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)]}


def conformer(p, cfg: ConformerConfig, x, key_mask, train: bool = False):
    """(B, T, D) + (B, T) valid-mask -> ((B, T, D), new_params)."""
    new_layers = []
    for layer in p["layers"]:
        x, new_layer = conformer_layer(layer, cfg, x, key_mask, train)
        new_layers.append(new_layer)
    return x, {"layers": new_layers}

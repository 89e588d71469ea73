"""Style (reference-audio) encoder over codec latents (port of
smalltts_tpu/models/style_encoder.py): in_proj 64->512, exp(log_scale) input
scale, 12 blocks (8 heads, eps 1e-5), final RMSNorm, out_proj 512->960,
output zeroed outside the length mask."""

from __future__ import annotations

import torch

from smalltts_tpu_torch.models.encoder import EncoderConfig, encoder_stack, init_encoder_blocks
from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.ops.rope import pair_cos_sin

LATENT_SIZE = 64
STYLE_ENCODER_CONFIG = EncoderConfig(
    model_size=512, num_layers=12, num_heads=8, intermediate_size=1536, norm_eps=1e-5
)


def init_style_encoder(gen, out_dim: int, cfg: EncoderConfig = STYLE_ENCODER_CONFIG,
                       dtype=torch.float32, device="cpu", latent_dim: int = LATENT_SIZE):
    return {
        "in_proj": nn.init_linear(gen, latent_dim, cfg.model_size, dtype=dtype, device=device),
        "log_scale": torch.tensor(-1.8, dtype=dtype, device=device),
        "blocks": init_encoder_blocks(gen, cfg, dtype, device),
        "norm": nn.init_rmsnorm(cfg.model_size, dtype, device),
        "out_proj": nn.init_linear(gen, cfg.model_size, out_dim, dtype=dtype, device=device),
    }


def style_encoder(p, latents, lengths, cfg: EncoderConfig = STYLE_ENCODER_CONFIG):
    """(B, R, 64) latents + (B,) lengths -> ((B, R, out_dim) ref_seq, (B, R) mask)."""
    t = latents.shape[1]
    mask = length_mask(lengths, t)
    x = nn.linear(p["in_proj"], latents)
    x = x * torch.exp(p["log_scale"]).to(x.dtype)
    x = encoder_stack(p["blocks"], cfg, x, mask, *pair_cos_sin(t, cfg.head_dim, x.device))
    x = nn.linear(p["out_proj"], nn.rmsnorm(p["norm"], x, cfg.norm_eps))
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device)), mask

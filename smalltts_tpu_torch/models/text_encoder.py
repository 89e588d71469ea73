"""Phoneme/text encoder: embedding -> 8 blocks (512 wide, 4 heads, eps 1e-6)
-> final RMSNorm (port of smalltts_tpu/models/text_encoder.py)."""

from __future__ import annotations

import torch

from smalltts_tpu_torch.models.encoder import EncoderConfig, encoder_stack, init_encoder_blocks
from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.ops.rope import pair_cos_sin

TEXT_ENCODER_CONFIG = EncoderConfig(
    model_size=512, num_layers=8, num_heads=4, intermediate_size=1024, norm_eps=1e-6
)


def init_text_encoder(gen, vocab_size: int, cfg: EncoderConfig = TEXT_ENCODER_CONFIG,
                      dtype=torch.float32, device="cpu"):
    emb = torch.empty((vocab_size, cfg.model_size), device=device, dtype=torch.float32)
    return {
        "text_embedding": {"w": emb.normal_(generator=gen).to(dtype)},
        "blocks": init_encoder_blocks(gen, cfg, dtype, device),
        "norm": nn.init_rmsnorm(cfg.model_size, dtype, device),
    }


def text_encoder(p, input_ids, mask=None, cfg: EncoderConfig = TEXT_ENCODER_CONFIG):
    """(B, P) int ids, (B, P) bool mask -> (B, P, model_size)."""
    x = p["text_embedding"]["w"][input_ids]
    x = encoder_stack(p["blocks"], cfg, x, mask, *pair_cos_sin(input_ids.shape[1], cfg.head_dim, x.device))
    return nn.rmsnorm(p["norm"], x, cfg.norm_eps)

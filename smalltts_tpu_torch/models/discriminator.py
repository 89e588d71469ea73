"""LSGAN discriminator over stacked DiT features and the conditioning
sequences (port of smalltts_tpu/models/discriminator.py): the last 3 DiT
layers' features flattened and projected, the noised latents, a (mask, t)
pair, the style sequence and the phoneme embeddings, concatenated on time,
through a 6-layer GroupNorm conformer, then a 1x1 conv to per-position
logits, masked-meaned to one logit a sample."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smalltts_tpu_torch.models import conformer as _conformer
from smalltts_tpu_torch.models.conformer import ConformerConfig, conformer, init_conformer
from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.text.vocab import phoneme_len


@dataclass(frozen=True)
class DiscriminatorConfig:
    latent_dim: int = 64
    transformer_dim: int = 960
    ref_dim: int = 960
    model_dim: int = 512
    num_tail_layers: int = 3
    vocab: int = phoneme_len
    conformer: ConformerConfig = ConformerConfig(
        input_dim=512, num_heads=8, ffn_dim=1024, num_layers=6,
        depthwise_conv_kernel_size=7, use_group_norm=True,
    )


# the conv kernels of init_discriminator's tree (utils/convert): the 1x1
# logit conv and the conformer's
CONV_PATHS = rf"out/w|enc/{_conformer.CONV_PATHS}"


def init_discriminator(gen, cfg: DiscriminatorConfig = DiscriminatorConfig(), dtype=torch.float32, device="cpu"):
    d, kw = cfg.model_dim, dict(dtype=dtype, device=device)
    return {
        "layers_proj": nn.init_linear(gen, cfg.num_tail_layers * cfg.transformer_dim, d, **kw),
        "audio_proj": nn.init_linear(gen, cfg.latent_dim, d, **kw),
        "phoneme_embed": nn.init_embedding(gen, cfg.vocab, d, **kw),
        "ref_proj": nn.init_linear(gen, cfg.ref_dim, d, **kw),
        "cond_proj": nn.init_linear(gen, 2, d, **kw),
        "enc": init_conformer(gen, cfg.conformer, **kw),
        "out": nn.init_conv1d(gen, d, 1, 1, **kw),
    }


def discriminator_forward(p, cfg: DiscriminatorConfig, stacked_features, noised, ref_seq, ref_mask, mask, phonemes,
                          t, train: bool = False):
    """stacked_features (B, L, T, transformer_dim), noised (B, T, latent),
    ref_seq (B, R, ref_dim), ref_mask (B, R), mask (B, T), phonemes (B, P),
    t (B,) -> (logits (B,), new_params)."""
    tail = stacked_features[:, -cfg.num_tail_layers:]
    b, n_layers, seq_len, _ = tail.shape
    flat = tail.transpose(1, 2).reshape(b, seq_len, n_layers * cfg.transformer_dim)
    layers_proj = nn.linear(p["layers_proj"], flat)
    dt = layers_proj.dtype
    noised_proj = nn.linear(p["audio_proj"], noised.to(dt))
    t_f = t.to(dt)[:, None, None].expand(b, seq_len, 1)
    cond = nn.linear(p["cond_proj"], torch.cat([mask.to(dt)[..., None], t_f], dim=-1))
    ref_proj = nn.linear(p["ref_proj"], ref_seq.to(dt))
    ph_emb = nn.embedding(p["phoneme_embed"], phonemes)

    feats = torch.cat([layers_proj, noised_proj, cond, ref_proj, ph_emb], dim=1)
    key_mask = torch.cat([mask, mask, mask, ref_mask, phonemes != 0], dim=1)
    enc, new_enc = conformer(p["enc"], cfg.conformer, feats, key_mask, train)
    y = nn.conv1d(p["out"], enc, padding=0)[..., 0]  # (B, S)
    valid = key_mask.float()
    logits = (y.float() * valid).sum(dim=1) / torch.clamp_min(valid.sum(dim=1), 1.0)
    return logits, {**p, "enc": new_enc}

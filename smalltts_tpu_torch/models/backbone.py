"""Flow-matching backbone: time embedding + text encoder + style encoder + DiT
+ zero-init velocity head (port of smalltts_tpu/models/backbone.py): the
full training forward (`backbone_forward`, `cfg_velocity`) and the
`encode_conditions` / `denoise_step` split of the cached inference path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from smalltts_tpu_torch.models.dit import DiTConfig, dit_encode_cross_kv, dit_forward, dit_forward_cached, init_dit
from smalltts_tpu_torch.models.encoder import EncoderConfig
from smalltts_tpu_torch.models.style_encoder import STYLE_ENCODER_CONFIG, init_style_encoder, style_encoder
from smalltts_tpu_torch.models.text_encoder import TEXT_ENCODER_CONFIG, init_text_encoder, text_encoder
from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.text.vocab import phoneme_len


@dataclass(frozen=True)
class BackboneConfig:
    latent_dim: int = 64
    hidden_dim: int = 960
    phoneme_dim: int = 512
    vocab_size: int = phoneme_len
    time_embed_dim: int = 256
    dit: DiTConfig = field(default_factory=DiTConfig)
    text: EncoderConfig = TEXT_ENCODER_CONFIG
    style: EncoderConfig = STYLE_ENCODER_CONFIG


class Conditions(NamedTuple):
    """Everything the denoise step needs that is constant across steps. The
    cross K/V hold the [ref | text] keys concatenated once per utterance,
    (L, B, heads, R + P, D), with cross_mask (B, R + P)."""

    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_mask: torch.Tensor
    ref_mask: torch.Tensor
    phonemes_mask: torch.Tensor
    ref_seq: torch.Tensor


def init_backbone(gen, cfg: BackboneConfig = BackboneConfig(), dtype=torch.float32, device="cpu"):
    """Seeded random init from `gen` (a torch.Generator on `device`)."""
    h = cfg.hidden_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "time_embedding": {
            "l1": nn.init_linear(gen, cfg.time_embed_dim, h, **kw),
            "l2": nn.init_linear(gen, h, h, **kw),
        },
        "phoneme_embedding": init_text_encoder(gen, cfg.vocab_size, cfg.text, **kw),
        "style_encoder": init_style_encoder(gen, h, cfg.style, latent_dim=cfg.latent_dim, **kw),
        "dit": init_dit(gen, cfg.dit, **kw),
        "velocity": nn.init_zeros_linear(h, cfg.latent_dim, **kw),
    }


def redraw_zero_init(params, gen, std: float = 0.02):
    """Re-draw the zero-init leaves (adaLN modulation, norm_out, velocity head)
    from `gen`, in place. With them at zero every block is the identity and
    the velocity is 0, so a smoke or parity run of untrained weights would
    pass whatever the blocks compute."""
    dit = params["dit"]
    for lin in (dit["blocks"]["attn_norm"]["linear"], dit["norm_out"]["linear"], params["velocity"]):
        for name, t in lin.items():
            r = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
            t.copy_((std if name == "w" else 5 * std) * r)
    return params


def time_embedding(p, t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal (t x 1e3) embedding + 2-layer MLP (backbone.py:79-89)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(1e4) / (half - 1)))
    ang = 1e3 * t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(p["l1"]["w"].dtype)
    return nn.linear(p["l2"], nn.silu(nn.linear(p["l1"], emb)))


def _check_shapes(cfg: BackboneConfig, noised, ref_latents, mask, phonemes, phonemes_mask, t):
    """The JAX package's shape checks (backbone.py:92-104)."""
    assert noised.dim() == 3 and ref_latents.dim() == 3, "noised and ref_latents must be (B, T, D)"
    assert mask.dim() == 2 and phonemes.dim() == 2 and phonemes_mask.dim() == 2, "masks and phonemes must be (B, T)"
    assert t.dim() == 1, "t must be (B,)"
    assert noised.shape[2] == cfg.latent_dim and ref_latents.shape[2] == cfg.latent_dim, "latent dim"
    assert phonemes.shape == phonemes_mask.shape, "phonemes and phonemes_mask differ in shape"
    assert noised.shape[:2] == mask.shape, "noised and mask differ in (B, T)"
    assert noised.shape[0] == ref_latents.shape[0] == phonemes.shape[0] == t.shape[0], "batch sizes differ"


def backbone_forward(p, cfg: BackboneConfig, noised, ref_latents, ref_latents_lengths, mask, phonemes,
                     phonemes_mask, t, return_features: bool = False):
    """Full training forward -> velocity (B, T, latent_dim), and with
    return_features the DiT's per-layer features (B, L, T, H)
    (backbone.py:107-130)."""
    _check_shapes(cfg, noised, ref_latents, mask, phonemes, phonemes_mask, t)
    ref_seq, ref_mask = style_encoder(p["style_encoder"], ref_latents, ref_latents_lengths, cfg.style)
    phoneme_embedding = text_encoder(p["phoneme_embedding"], phonemes, phonemes_mask, cfg.text)
    t_emb = time_embedding(p["time_embedding"], t, cfg.time_embed_dim)
    decoded, feats = dit_forward(p["dit"], cfg.dit, noised, ref_seq, ref_mask, phoneme_embedding,
                                 phonemes_mask, t_emb, mask)
    velocity = nn.linear(p["velocity"], decoded)
    return (velocity, feats) if return_features else velocity


def cfg_velocity(params, cfg: BackboneConfig, x_t, ref, ref_len, mask, ph, ph_mask, t,
                 cfg_scale_text: float = 2.0, cfg_scale_speaker: float = 1.5):
    """Double classifier-free guidance by 3x batch replication, in the order
    (cond, text dropped, speaker dropped) (backbone.py:133-168):
    v = v_c + s_text (v_c - v_no_text) + s_spk (v_c - v_no_spk)."""
    z = torch.zeros_like
    v3 = backbone_forward(
        params, cfg, torch.cat([x_t] * 3), torch.cat([ref, ref, z(ref)]), torch.cat([ref_len, ref_len, z(ref_len)]),
        torch.cat([mask] * 3), torch.cat([ph, z(ph), ph]), torch.cat([ph_mask, z(ph_mask), ph_mask]),
        torch.cat([t] * 3))
    v_c, v_no_text, v_no_spk = torch.chunk(v3, 3)
    return v_c + cfg_scale_text * (v_c - v_no_text) + cfg_scale_speaker * (v_c - v_no_spk)


def encode_conditions(p, cfg: BackboneConfig, ref_latents, ref_latents_lengths, phonemes,
                      phonemes_mask) -> Conditions:
    """Per-utterance conditioning (style + text + cross K/V), once."""
    ref_seq, ref_mask = style_encoder(p["style_encoder"], ref_latents, ref_latents_lengths, cfg.style)
    phoneme_embedding = text_encoder(p["phoneme_embedding"], phonemes, phonemes_mask, cfg.text)
    kv = dit_encode_cross_kv(p["dit"], cfg.dit, ref_seq, phoneme_embedding, phonemes_mask)
    return Conditions(
        torch.cat([kv.k_ref, kv.k_text], dim=3).contiguous(),
        torch.cat([kv.v_ref, kv.v_text], dim=3).contiguous(),
        torch.cat([ref_mask, phonemes_mask], dim=1).contiguous(),
        ref_mask, phonemes_mask, ref_seq,
    )


def denoise_step(p, cfg: BackboneConfig, noised, mask, t, cond: Conditions, t_emb=None,
                 step_mods=None) -> torch.Tensor:
    """One denoiser evaluation over the cached conditions -> velocity (B, T, latent)."""
    if t_emb is None:
        t_emb = time_embedding(p["time_embedding"], t, cfg.time_embed_dim)
    decoded = dit_forward_cached(p["dit"], cfg.dit, noised, t_emb, mask, cond.cross_k,
                                 cond.cross_v, cond.cross_mask, step_mods=step_mods)
    return nn.linear(p["velocity"], decoded)

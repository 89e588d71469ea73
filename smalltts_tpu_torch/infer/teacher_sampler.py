"""Teacher (many-step, double-CFG) sampler (port of
smalltts_tpu/infer/teacher_sampler.py): how a flow-matching teacher
checkpoint is evaluated before distillation.

The three condition sets (cond, text dropped, speaker dropped) are encoded
once, as one 3x batch in cfg_velocity's replication order; the time
embeddings and every step's adaLN modulations are computed once before the
loop. Each step re-noises the running estimate at level t, evaluates the
cached denoiser on the 3x batch (on the card: the DiT scan's kernels and the
attention kernel, as SmallTTS runs them) and combines
v = v_c + s_text (v_c - v_no_text) + s_spk (v_c - v_no_spk).

Noise is an argument, (num_steps, B, T, latent_dim). The running estimate,
the noise, x_t and the CFG combination are float32, as in the JAX sampler;
x_t is rounded to the params' dtype where it enters the denoiser, whose
activations are in that dtype (the JAX sampler's take float32 from x_t).

The scan's kernels are bf16 only, so a bf16 tree is fused into the serving
layout and runs them, while a float32 tree in the split layout (a teacher
as it trains) runs the blocks layer by layer in PyTorch ops, as the JAX
sampler does, with the attention kernel in fp32 on the card.
"""

from __future__ import annotations

import torch

from smalltts_tpu_torch.models.backbone import BackboneConfig, denoise_step, encode_conditions, time_embedding
from smalltts_tpu_torch.models.dit import fuse_serving_projections, precompute_step_modulations
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.ops.schedule import get_alpha_sigma


def _cfg_conditions(params, cfg: BackboneConfig, ref, ref_len, ph, ph_mask):
    """The (cond, no-text, no-speaker) conditions, one batched encode."""
    z = torch.zeros_like
    return encode_conditions(params, cfg, torch.cat([ref, ref, z(ref)]), torch.cat([ref_len, ref_len, z(ref_len)]),
                             torch.cat([ph, z(ph), ph]), torch.cat([ph_mask, z(ph_mask), ph_mask]))


def make_teacher_sampler(cfg: BackboneConfig, num_steps: int = 128, cfg_scale_text: float = 2.0,
                         cfg_scale_speaker: float = 1.5):
    """-> sample(params, ref, ref_len, ph, ph_len, seq_lens, noises, t_bucket)
    -> float32 latents (B, t_bucket, latent_dim), zero past each sequence length.
    `params` is a backbone tree in the split or the fused serving layout;
    a float32 tree keeps its layout (a fused float32 tree cannot run on the
    card), any other is fused."""

    @torch.no_grad()
    def sample(params, ref, ref_len, ph, ph_len, seq_lens, noises, t_bucket: int):
        if noises.shape[0] != num_steps or noises.shape[2] != t_bucket:
            raise ValueError(f"noises {tuple(noises.shape)}: want ({num_steps}, B, {t_bucket}, {cfg.latent_dim})")
        dtype = params["velocity"]["w"].dtype
        if dtype != torch.float32:
            params = fuse_serving_projections(params)
        b, dev = ref.shape[0], ref.device
        mask = length_mask(seq_lens, t_bucket)
        ts = torch.linspace(1.0, 0.0, num_steps, dtype=torch.float32, device=dev)
        cond3 = _cfg_conditions(params, cfg, ref, ref_len, ph, length_mask(ph_len, ph.shape[1]))
        mask3 = torch.cat([mask] * 3)
        t_embs = time_embedding(params["time_embedding"], ts, cfg.time_embed_dim)
        mods, finals = precompute_step_modulations(params["dit"], t_embs)
        alphas, sigmas = get_alpha_sigma(ts)
        x_pred = torch.zeros((b, t_bucket, cfg.latent_dim), dtype=torch.float32, device=dev)
        for i in range(num_steps):
            alpha, sigma = alphas[i], sigmas[i]
            x_t = alpha * x_pred + sigma * noises[i].float()
            v3 = denoise_step(params, cfg, torch.cat([x_t.to(dtype)] * 3), mask3, ts[i].expand(3 * b), cond3,
                              t_emb=t_embs[i].expand(3 * b, -1), step_mods=(mods[:, i], finals[i]))
            v_c, v_no_text, v_no_spk = torch.chunk(v3.float(), 3)
            v = v_c + cfg_scale_text * (v_c - v_no_text) + cfg_scale_speaker * (v_c - v_no_spk)
            x_pred = alpha * x_t - sigma * v
        return torch.where(mask[..., None], x_pred, 0.0)

    return sample

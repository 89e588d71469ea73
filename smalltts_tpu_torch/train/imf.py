"""The integral-velocity (IMF) few-step student: its serving parts (port of
smalltts_tpu/train/imf.py:119-137, 543-577).

An IMF student is a backbone with one more leaf, `r_gate` (H,), that mixes
the embedding of an interval's end time r into the embedding of its start
time t: te(t) + r_gate * te(r). It predicts the average velocity u over
[r, t], so that x_r = x_t - (t - r) * u. The training steps come with the
trainers.
"""

from __future__ import annotations

import torch

from smalltts_tpu_torch.models.backbone import BackboneConfig, denoise_step, time_embedding
from smalltts_tpu_torch.models.dit import precompute_step_modulations
from smalltts_tpu_torch.ops.masking import length_mask


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree.clone()


def init_imf_student(teacher_params) -> dict:
    """A copy of the teacher plus a zero `r_gate` in fp32 (the student equals
    the teacher at init)."""
    student = _copy_tree(teacher_params)
    w = teacher_params["time_embedding"]["l2"]["w"]
    student["r_gate"] = torch.zeros((w.shape[-1],), dtype=torch.float32, device=w.device)
    return student


def imf_time_emb(p, cfg: BackboneConfig, t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """te(t) + r_gate * te(r); r_gate is cast to the embedding's dtype first."""
    te = time_embedding(p["time_embedding"], t, cfg.time_embed_dim)
    re = time_embedding(p["time_embedding"], r, cfg.time_embed_dim)
    return te + p["r_gate"].to(te.dtype) * re


def imf_velocity(p, cfg: BackboneConfig, x_t, mask, t, r, cond) -> torch.Tensor:
    """Average velocity u(x_t, t, r): the backbone with the mixed embedding."""
    return denoise_step(p, cfg, x_t, mask, t, cond, t_emb=imf_time_emb(p, cfg, t, r))


def imf_sample(student, cfg: BackboneConfig, cond, seq_lengths: torch.Tensor, t_bucket: int,
               noise: torch.Tensor, num_steps: int = 1) -> torch.Tensor:
    """Few-step sampling over the intervals of linspace(1, 0, num_steps + 1)
    from the start noise `noise` (B, t_bucket, latent_dim) -> masked latents.
    Every interval is known up front, so the mixed time embeddings and all
    intervals' adaLN modulations are computed once before the loop."""
    b = seq_lengths.shape[0]
    dev = seq_lengths.device
    mask = length_mask(seq_lengths, t_bucket)
    dtype = student["velocity"]["w"].dtype
    x = noise.to(dtype)
    ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=dev)
    t_embs = imf_time_emb(student, cfg, ts[:-1], ts[1:])  # (S, H)
    mods, finals = precompute_step_modulations(student["dit"], t_embs)
    for i in range(num_steps):
        t0, t1 = ts[i].expand(b), ts[i + 1].expand(b)
        u = denoise_step(student, cfg, x, mask, t0, cond, t_emb=t_embs[i].expand(b, -1),
                         step_mods=(mods[:, i], finals[i]))
        x = x - (t0 - t1)[:, None, None].to(dtype) * u
    return torch.where(mask[..., None], x, torch.zeros((), dtype=dtype, device=dev))

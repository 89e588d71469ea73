"""Latent-domain ASR, forward only: the frozen CTC loss model of DMD2
distillation (port of smalltts_tpu/models/asr.py). Depthwise transposed
conv x4 temporal upsample -> conformer (7 layers, 16 heads of 4, ffn 1024,
kernel 9, BatchNorm) -> linear to the phoneme vocabulary -> log-softmax."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smalltts_tpu_torch.models import conformer as _conformer
from smalltts_tpu_torch.models.conformer import ConformerConfig, conformer, init_conformer
from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.text.vocab import phoneme_len


@dataclass(frozen=True)
class ASRConfig:
    input_dim: int = 64
    upsample: int = 4
    vocab: int = phoneme_len
    conformer: ConformerConfig = ConformerConfig(
        input_dim=64, num_heads=16, ffn_dim=1024, num_layers=7,
        depthwise_conv_kernel_size=9, use_group_norm=False,
    )


# the conv kernels of init_asr's tree (utils/convert): the conformer's; the
# upsample kernel (r, 1, d) is not one (asr_forward reshapes it to (r, d))
CONV_PATHS = rf"conformer/{_conformer.CONV_PATHS}"


def init_asr(gen, cfg: ASRConfig = ASRConfig(), dtype=torch.float32, device="cpu"):
    d, r = cfg.input_dim, cfg.upsample
    w = torch.empty((r, 1, d), device=device, dtype=torch.float32).uniform_(-(d ** -0.5), d ** -0.5, generator=gen)
    return {
        # the depthwise transposed conv's kernel (r, 1, d), kept in the JAX layout (not a conv leaf)
        "upsample": {"w": w.to(dtype), "b": torch.zeros(d, dtype=dtype, device=device)},
        "conformer": init_conformer(gen, cfg.conformer, dtype, device),
        "proj": nn.init_linear(gen, d, cfg.vocab, dtype=dtype, device=device),
    }


def _deconv_upsample(p, x: torch.Tensor, r: int) -> torch.Tensor:
    """ConvTranspose1d(kernel = stride = r, groups = d): each frame expands
    to r frames, frame j of channel c scaled by tap (j, c); a broadcast
    product and a reshape, the bias added in float32."""
    b, t, d = x.shape
    w = p["w"].to(x.dtype).reshape(r, d)
    y = (x[:, :, None, :] * w[None, None]).reshape(b, t * r, d)
    return (y.float() + p["b"].float()).to(x.dtype)


def asr_forward(p, cfg: ASRConfig, latents, lengths, train: bool = False):
    """latents (B, T, 64), lengths (B,) -> (log_probs (B, T*r, vocab) in
    float32, out_lengths (B,), new_params)."""
    x = _deconv_upsample(p["upsample"], latents, cfg.upsample)
    out_lengths = lengths * cfg.upsample
    x, new_conf = conformer(p["conformer"], cfg.conformer, x, length_mask(out_lengths, x.shape[1]), train)
    log_probs = torch.log_softmax(nn.linear(p["proj"], x).float(), dim=-1)
    return log_probs, out_lengths, {**p, "conformer": new_conf}

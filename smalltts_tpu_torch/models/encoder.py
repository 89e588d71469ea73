"""Shared pre-norm transformer encoder block (port of smalltts_tpu/models/encoder.py).

RMSNorm pre-norm, per-head q/k RMSNorm, complex-pair RoPE over the full head
dim, masked attention (the attention kernel on the card), sigmoid output
gate, SwiGLU MLP; all projections bias-free. Block parameters are stacked
with a leading layer dim L, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.parallel import comm
from smalltts_tpu_torch.ops.rope import apply_rope_pairs


@dataclass(frozen=True)
class EncoderConfig:
    model_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    norm_eps: float
    max_seq: int = 4096

    @property
    def head_dim(self) -> int:
        return self.model_size // self.num_heads


def init_encoder_blocks(gen, cfg: EncoderConfig, dtype=torch.float32, device="cpu"):
    """All cfg.num_layers blocks, each leaf stacked with a leading L."""
    m, h, d, L = cfg.model_size, cfg.num_heads, cfg.head_dim, cfg.num_layers
    lin = lambda i, o: nn.init_linear(gen, i, o, bias=False, dtype=dtype, device=device, lead=(L,))  # noqa: E731
    return {
        "attn": {
            "wq": lin(m, m), "wk": lin(m, m), "wv": lin(m, m), "wo": lin(m, m), "gate": lin(m, m),
            "q_norm": nn.init_rmsnorm((L, h, d), dtype, device),
            "k_norm": nn.init_rmsnorm((L, h, d), dtype, device),
        },
        "mlp": {
            "w1": lin(m, cfg.intermediate_size),
            "w3": lin(m, cfg.intermediate_size),
            "w2": lin(cfg.intermediate_size, m),
        },
        "attention_norm": nn.init_rmsnorm((L, m), dtype, device),
        "mlp_norm": nn.init_rmsnorm((L, m), dtype, device),
    }


def _self_attention(p, cfg: EncoderConfig, x, mask, rope_cos, rope_sin):
    """Over the heads the params hold: all of them, or this rank's under
    tensor parallelism (column-parallel wq/wk/wv/gate, row-parallel wo)."""
    b, t, _ = x.shape
    d = cfg.head_dim
    h = nn.out_features(p["wq"]) // d
    tp = h != cfg.num_heads
    if tp:
        x = comm.tp_input(x)
    q = nn.linear(p["wq"], x).reshape(b, t, h, d)
    k = nn.linear(p["wk"], x).reshape(b, t, h, d)
    v = nn.linear(p["wv"], x).reshape(b, t, h, d)
    gate = nn.linear(p["gate"], x)
    q = apply_rope_pairs(nn.rmsnorm(p["q_norm"], q, cfg.norm_eps), rope_cos[:t], rope_sin[:t])
    k = apply_rope_pairs(nn.rmsnorm(p["k_norm"], k, cfg.norm_eps), rope_cos[:t], rope_sin[:t])
    out = nn.sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), key_mask=mask)
    out = out.transpose(1, 2).reshape(b, t, h * d)
    out = out * nn.sigmoid(gate)
    return nn.linear(p["wo"], out, reduce=comm.tp_sum if tp else None)


def _mlp(p, cfg: EncoderConfig, x):
    """SwiGLU; under tensor parallelism over this rank's columns of w1/w3
    and rows of w2."""
    tp = nn.out_features(p["w1"]) != cfg.intermediate_size
    if tp:
        x = comm.tp_input(x)
    return nn.linear(p["w2"], nn.silu(nn.linear(p["w1"], x)) * nn.linear(p["w3"], x),
                     reduce=comm.tp_sum if tp else None)


def encoder_block(p, cfg: EncoderConfig, x, mask, rope_cos, rope_sin):
    x = x + _self_attention(
        p["attn"], cfg, nn.rmsnorm(p["attention_norm"], x, cfg.norm_eps), mask, rope_cos, rope_sin
    )
    return x + _mlp(p["mlp"], cfg, nn.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))


def encoder_stack(stacked, cfg: EncoderConfig, x, mask, rope_cos, rope_sin):
    """Run the layers in order over the stacked block params."""
    for blk in nn.layers(stacked, cfg.num_layers):
        x = encoder_block(blk, cfg, x, mask, rope_cos, rope_sin)
    return x

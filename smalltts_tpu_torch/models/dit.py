"""DiT backbone (port of smalltts_tpu/models/dit.py).

12 joint-attention blocks, hidden 960, adaLN-zero with tanh gates, SwiGLU FF
(ratio 2.5), a grouped Conv1d(k=31, groups=16) + Mish positional stem.

Two paths. The cached inference path computes the per-block cross K/V for
the [ref | text] conditioning once per utterance. On the fused serving
layout ([q|k|v|gate] and [w1|w3] products) its block scan runs through the
hand-written Hopper kernels of ops/kernels/dit_block.py (the port of the
Pallas whole-scan kernel); on the split layout of training it is a loop of
`_block_core` in PyTorch ops, differentiable, as the JAX package's
lax.scan is. The full forward of training, `dit_forward`, runs the split
layout the same way. Both split paths reach the attention kernel through
nn.sdpa (behind its autograd Function where a gradient is wanted).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from smalltts_tpu_torch.ops import kernels, nn
from smalltts_tpu_torch.ops.kernels.dit_block import fused_dit_scan
from smalltts_tpu_torch.ops.kernels.w8 import quantize_w8, w8_matmul_all_layers
from smalltts_tpu_torch.ops.rope import interleaved_cos_sin, rotate_interleaved
from smalltts_tpu_torch.parallel import comm


@dataclass(frozen=True)
class DiTConfig:
    latent_dim: int = 64
    phoneme_dim: int = 512
    hidden_dim: int = 960
    n_blocks: int = 12
    heads: int = 8
    mlp_ratio: float = 2.5
    rot_dim: int = 64
    conv_kernel: int = 31
    conv_groups: int = 16
    max_seq: int = 4096
    remat: bool = False  # dit_forward recomputes each block in the backward

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.heads

    @property
    def ff_dim(self) -> int:
        return int(self.hidden_dim * self.mlp_ratio)


class CrossKV(NamedTuple):
    """Per-layer cross-attention K/V, each (L, B, heads, S, head_dim)."""

    k_ref: torch.Tensor
    v_ref: torch.Tensor
    k_text: torch.Tensor
    v_text: torch.Tensor


def init_dit(gen, cfg: DiTConfig, dtype=torch.float32, device="cpu"):
    """Torch-default init in the JAX package's split layout; the adaLN
    modulation and norm_out are zero-init (adaLN-zero)."""
    h, hd, L = cfg.hidden_dim, cfg.head_dim, cfg.n_blocks
    kw = dict(dtype=dtype, device=device)
    lin = lambda i, o, bias=True: nn.init_linear(gen, i, o, bias, lead=(L,), **kw)  # noqa: E731
    blocks = {
        "attn_norm": {"linear": nn.init_zeros_linear(h, 6 * h, lead=(L,), **kw)},
        "attn": {
            "qkv_self": lin(h, 3 * h),
            "gate": lin(h, h, bias=False),
            "to_out": lin(h, h, bias=False),
            "q_norm": nn.init_rmsnorm((L, cfg.heads, hd), **kw),
            "k_norm": nn.init_rmsnorm((L, cfg.heads, hd), **kw),
            "kv_ref": lin(h, 2 * h),
            "kv_text": lin(h, 2 * h),
            "k_norm_cross": nn.init_rmsnorm((L, cfg.heads, hd), **kw),
        },
        "ff": {"w1": lin(h, cfg.ff_dim), "w3": lin(h, cfg.ff_dim), "w2": lin(cfg.ff_dim, h)},
    }
    k, g = cfg.conv_kernel, cfg.conv_groups
    return {
        "input_embed": {
            "proj": nn.init_linear(gen, cfg.latent_dim, h, **kw),
            "conv1": nn.init_conv1d(gen, h, h, k, g, **kw),
            "conv2": nn.init_conv1d(gen, h, h, k, g, **kw),
        },
        "phoneme_proj": nn.init_linear(gen, cfg.phoneme_dim, h, **kw),
        "emb_proj": {
            "l1": nn.init_linear(gen, h, 2 * h, **kw),
            "l2": nn.init_linear(gen, 2 * h, h, **kw),
        },
        "blocks": blocks,
        "norm_out": {"linear": nn.init_zeros_linear(h, 2 * h, **kw)},
    }


def _with_blocks(params, fn):
    """A new tree (a backbone's or a DiT's) whose DiT `blocks` are
    fn(a shallow copy of them); leaves are shared, not copied."""
    params = dict(params)
    dit = dict(params["dit"]) if "dit" in params else params
    dit["blocks"] = fn(dict(dit["blocks"]))
    if "dit" in params:
        params["dit"] = dit
        return params
    return dit


def fuse_serving_projections(params):
    """[qkv_self | gate] -> one (H, 4H) product (zero gate bias), [w1 | w3] ->
    one (H, 2F) product: the same math in fewer weight streams (port of
    dit.py:295-324). Returns a new tree; leaves are shared, not copied."""

    def fuse(blocks):
        attn, ff = dict(blocks["attn"]), dict(blocks["ff"])
        if "qkvg" not in attn:
            qkv, gate = attn.pop("qkv_self"), attn.pop("gate")
            zeros_g = torch.zeros(gate["w"].shape[:1] + gate["w"].shape[2:],
                                  dtype=qkv["b"].dtype, device=qkv["b"].device)
            attn["qkvg"] = {"w": torch.cat([qkv["w"], gate["w"]], dim=-1),
                            "b": torch.cat([qkv["b"], zeros_g], dim=-1)}
        if "w13" not in ff:
            w1, w3 = ff.pop("w1"), ff.pop("w3")
            ff["w13"] = {"w": torch.cat([w1["w"], w3["w"]], dim=-1),
                         "b": torch.cat([w1["b"], w3["b"]], dim=-1)}
        blocks["attn"], blocks["ff"] = attn, ff
        return blocks

    return _with_blocks(params, fuse)


def quantize_modulations(params):
    """The stacked adaLN modulation weights (L, H, 6H) -> int8 `w_q` with an
    fp32 per-layer, per-channel `scale` (L, 6H) from quantize_w8 (port of
    dit.py:187-206). The hoisted modulation product then streams half the
    bytes through the w8 kernel. Returns a new tree; other leaves are shared."""

    def quant(blocks):
        lin = blocks["attn_norm"]["linear"]
        if "w_q" not in lin:
            w_q, scale = quantize_w8(lin["w"])
            blocks["attn_norm"] = {**blocks["attn_norm"], "linear": {"w_q": w_q, "scale": scale, "b": lin["b"]}}
        return blocks

    return _with_blocks(params, quant)


def quantize_stream_weights(params):
    """The denoise scan's weight streams (attn qkvg/to_out, ff w13/w2) ->
    int8 `w_q` with a per-layer, per-output-channel `scale` (L, 1, O) (port
    of dit.py:327-368). The scan's GEMM then streams 138 MB a step instead
    of 276. The tree must hold the fused serving layout
    (fuse_serving_projections first): the scan runs on no other.

    The arithmetic is in the weights' own dtype, as in the JAX package, which
    quantizes after the cast to the serving dtype: bf16 on the card, so
    max|w| / 127, the 1e-12 floor and w / scale all round in bf16; only the
    stored scale is fp32. This quantizer is not quantize_w8: the floor for an
    all-zero channel differs (1e-12 against 1), and so does the arithmetic."""

    def quant(lin):
        if "w_q" in lin:
            return lin
        w = lin["w"]
        scale = torch.clamp_min(torch.amax(torch.abs(w), dim=-2, keepdim=True) / 127.0, 1e-12)
        out = {"w_q": torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8),
               "scale": scale.float()}
        if "b" in lin:
            out["b"] = lin["b"]
        return out

    def quant_blocks(blocks):
        split = [k for g, ks in (("attn", ("qkv_self", "gate")), ("ff", ("w1", "w3"))) for k in ks
                 if k in blocks.get(g, {})]
        if split:
            raise ValueError(f"quantize_stream_weights needs the fused serving layout, found {split}: "
                             "call fuse_serving_projections first")
        for group, names in (("attn", ("qkvg", "to_out")), ("ff", ("w13", "w2"))):
            blocks[group] = {k: quant(v) if k in names else v for k, v in blocks[group].items()}
        return blocks

    return _with_blocks(params, quant_blocks)


def _input_embed(p, cfg: DiTConfig, x, mask):
    """Linear in-proj + masked grouped-conv positional stem (dit.py:140-148)."""
    x = nn.linear(p["proj"], x)
    m3 = mask[..., None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    h = torch.where(m3, x, zero)
    h = nn.mish(nn.conv1d(p["conv1"], h, groups=cfg.conv_groups)) * m3.to(x.dtype)
    h = nn.mish(nn.conv1d(p["conv2"], h, groups=cfg.conv_groups))
    return torch.where(m3, h, zero) + x


def _emb_proj(p, emb):
    return nn.linear(p["l2"], nn.silu(nn.linear(p["l1"], emb)))


def _all_block_modulations(blocks, emb):
    """Every block's adaLN modulation in one product: (B, H) x (L, H, 6H) -> (L, B, 6H).

    With int8 modulation weights (quantize_modulations) the product is the
    w8 kernel's, which rounds to the dtype; the fp32 bias is then added and
    the sum rounded again, as the JAX package's w8 branch does (dit.py:174-179)."""
    lin = blocks["attn_norm"]["linear"]
    s = nn.silu(emb)
    if "w_q" in lin:
        mod = w8_matmul_all_layers(s, lin["w_q"], lin["scale"])
        return (mod.float() + lin["b"].float()[:, None, :]).to(s.dtype)
    w = lin["w"].to(s.dtype)
    mod = nn.matmul_f32(s.expand(w.shape[0], *s.shape), w)  # fp32 accumulation, as in JAX
    return (mod + lin["b"].float()[:, None, :]).to(s.dtype)


def _adaln_final_from_mod(mod, x, eps=1e-6):
    scale, shift = torch.chunk(mod, 2, dim=-1)
    return nn.layernorm_noaffine(x, eps) * (1 + scale[:, None]) + shift[:, None]


def precompute_step_modulations(p_dit, t_embs):
    """All sampling steps' adaLN modulations in one weight pass:
    t_embs (S, H) -> (mods (L, S, 6H), final (S, 2H))."""
    emb = _emb_proj(p_dit["emb_proj"], t_embs)
    mods = _all_block_modulations(p_dit["blocks"], emb)
    final = nn.linear(p_dit["norm_out"]["linear"], nn.silu(emb))
    return mods, final


def _project_cross(p_attn, cfg: DiTConfig, seq, which: str):
    """Cross K/V projection of one block; K is RMS-normed per head. Over the
    heads the params hold (this rank's under tensor parallelism)."""
    b, t, _ = seq.shape
    d = cfg.head_dim
    h = nn.out_features(p_attn[f"kv_{which}"]) // (2 * d)
    if h != cfg.heads:
        seq = comm.tp_input(seq)
    k, v = torch.chunk(nn.linear(p_attn[f"kv_{which}"], seq), 2, dim=-1)
    k = nn.rmsnorm(p_attn["k_norm_cross"], k.reshape(b, t, h, d), 1e-6)
    return k.transpose(1, 2), v.reshape(b, t, h, d).transpose(1, 2)


def dit_encode_cross_kv(p, cfg: DiTConfig, ref_seq, phoneme_embedding, phonemes_mask) -> CrossKV:
    """All-layer cross K/V, once per utterance (dit.py:439-460)."""
    mem = nn.linear(p["phoneme_proj"], phoneme_embedding)
    mem = torch.where(phonemes_mask[..., None], mem, torch.zeros((), dtype=mem.dtype, device=mem.device))
    attn = p["blocks"]["attn"]
    out = [[], [], [], []]
    for blk in nn.layers({k: attn[k] for k in ("kv_ref", "kv_text", "k_norm_cross")}, cfg.n_blocks):
        kv = _project_cross(blk, cfg, ref_seq, "ref") + _project_cross(blk, cfg, mem, "text")
        for acc, t in zip(out, kv):
            acc.append(t)
    return CrossKV(*(torch.stack(a, dim=0) for a in out))


def rope_cos_sin(cfg: DiTConfig, seq_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, rot_dim) fp32 cos/sin of the duplicated-frequency table, cached on the device."""
    return interleaved_cos_sin(seq_len, cfg.rot_dim, device)


_SELF_ATTN = ("qkv_self", "gate", "to_out", "q_norm", "k_norm")  # the attention leaves a cached split block reads


def dit_forward_cached(p, cfg: DiTConfig, x, time_embedding, mask, cross_k, cross_v, cross_mask,
                       step_mods=None, rope=None):
    """Denoise-step forward over the precomputed cross K/V (dit.py:515-578).

    cross_k/v (L, B, heads, Sc, D) hold the [ref | text] keys concatenated
    once per utterance, cross_mask (B, Sc) their mask. `step_mods` =
    (mods (L, 6H), final (2H)) from precompute_step_modulations; without it
    the modulations are computed from `time_embedding` (B, H). `rope`, the
    (cos, sin) tables (T, rot_dim), defaults to rope_cos_sin's. A tree in
    the fused serving layout runs the scan kernels (bf16 or int8 weights on
    the card); any other runs `_block_core` layer by layer."""
    b = x.shape[0]
    x = _input_embed(p["input_embed"], cfg, x, mask)
    if step_mods is None:
        emb = _emb_proj(p["emb_proj"], time_embedding)
        mods = _all_block_modulations(p["blocks"], emb)
        final = nn.linear(p["norm_out"]["linear"], nn.silu(emb))
    else:
        mods_i, final_i = step_mods
        mods = mods_i[:, None, :].expand(mods_i.shape[0], b, mods_i.shape[-1])
        final = final_i[None, :].expand(b, final_i.shape[-1])
    cos, sin = rope_cos_sin(cfg, x.shape[1], x.device) if rope is None else rope
    if "qkvg" in p["blocks"]["attn"]:
        blocks = p["blocks"]
        heads = blocks["attn"]["q_norm"]["scale"].shape[-2]  # this rank's under tensor parallelism
        tp = (heads != cfg.heads, nn.out_features(blocks["ff"]["w13"]) != 2 * cfg.ff_dim)
        x = fused_dit_scan(x, mods, mask, cross_k, cross_v, cross_mask, blocks, cos, sin,
                           heads=heads, head_dim=cfg.head_dim, tp=tp)
    else:  # the split layout: the blocks in PyTorch ops (dit.py:561-576), without remat as there
        used = {"attn": {k: v for k, v in p["blocks"]["attn"].items() if k in _SELF_ATTN}, "ff": p["blocks"]["ff"]}
        joint_key_mask = torch.cat([mask, cross_mask], dim=1)
        for l, blk in enumerate(nn.layers(used, cfg.n_blocks)):
            x = _block_core(blk, cfg, x, mods[l], mask, joint_key_mask, cos, sin, cross_k[l], cross_v[l])
    return _adaln_final_from_mod(final, x)


# ------------------------------------------------------- full (training) path


def _apply_adaln_zero(mod, x, eps=1e-6):
    """AdaLN-zero with a precomputed modulation (B, 6H) (dit.py:209-213)."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = torch.chunk(mod, 6, dim=-1)
    x = nn.layernorm_noaffine(x, eps) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    return x, gate_msa, shift_mlp, scale_mlp, gate_mlp


def _self_qkv_gate(p_attn, cfg: DiTConfig, x, cos, sin):
    """q/k_self/v_self and the attention output gate, split layout
    (dit.py:252-273), over the heads the params hold (this rank's under
    tensor parallelism: column-parallel qkv_self and gate)."""
    b, t, _ = x.shape
    d = cfg.head_dim
    h = nn.out_features(p_attn["qkv_self"]) // (3 * d)
    if h != cfg.heads:
        x = comm.tp_input(x)
    q, k, v = torch.chunk(nn.linear(p_attn["qkv_self"], x), 3, dim=-1)
    gate = nn.linear(p_attn["gate"], x)
    q = nn.rmsnorm(p_attn["q_norm"], q.reshape(b, t, h, d), 1e-6)
    k = nn.rmsnorm(p_attn["k_norm"], k.reshape(b, t, h, d), 1e-6)
    v = v.reshape(b, t, h, d).transpose(1, 2)
    return rotate_interleaved(q.transpose(1, 2), cos, sin), rotate_interleaved(k.transpose(1, 2), cos, sin), v, gate


def _attend(p_attn, cfg: DiTConfig, gate, q, k, v, mask, joint_key_mask):
    """One SDPA over [self | ref | text] keys, then the sigmoid gate
    (dit.py:277-284); to_out row-parallel over this rank's heads under
    tensor parallelism."""
    out = nn.sdpa(q, k, v, key_mask=joint_key_mask)
    b, h, t, d = out.shape
    out = out.transpose(1, 2).reshape(b, t, h * d) * nn.sigmoid(gate)
    out = nn.linear(p_attn["to_out"], out, reduce=comm.tp_sum if h != cfg.heads else None)
    return torch.where(mask[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def _ff(p, cfg: DiTConfig, x):
    """SwiGLU; under tensor parallelism over this rank's columns of w1/w3
    and rows of w2, whose bias is added once, after the sum."""
    tp = nn.out_features(p["w1"]) != cfg.ff_dim
    if tp:
        x = comm.tp_input(x)
    return nn.linear(p["w2"], nn.silu(nn.linear(p["w1"], x)) * nn.linear(p["w3"], x),
                     reduce=comm.tp_sum if tp else None)


def _block_core(blk, cfg: DiTConfig, x, mod, mask, joint_key_mask, cos, sin, k_cross, v_cross):
    """One block over projected cross K/V (B, heads, Sc, D), `mod` its
    adaLN modulation (B, 6H) (dit.py:371-385)."""
    norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = _apply_adaln_zero(mod, x)
    q, k_self, v_self, gate = _self_qkv_gate(blk["attn"], cfg, norm, cos, sin)
    k = torch.cat([k_self, k_cross], dim=2)
    v = torch.cat([v_self, v_cross], dim=2)
    x = x + torch.tanh(gate_msa)[:, None] * _attend(blk["attn"], cfg, gate, q, k, v, mask, joint_key_mask)
    norm2 = nn.layernorm_noaffine(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    return x + torch.tanh(gate_mlp)[:, None] * _ff(blk["ff"], cfg, norm2)


def _block(blk, cfg: DiTConfig, x, mod, mask, joint_key_mask, cos, sin, ref_seq, phoneme_mem):
    """One uncached block: its cross K/V projections, then _block_core (dit.py:408-415)."""
    k_ref, v_ref = _project_cross(blk["attn"], cfg, ref_seq, "ref")
    k_text, v_text = _project_cross(blk["attn"], cfg, phoneme_mem, "text")
    return _block_core(blk, cfg, x, mod, mask, joint_key_mask, cos, sin, torch.cat([k_ref, k_text], dim=2),
                       torch.cat([v_ref, v_text], dim=2))


def dit_forward(p, cfg: DiTConfig, x, ref_seq, ref_mask, phoneme_embedding, phonemes_mask, time_embedding,
                mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full (uncached) forward on the split layout -> (hidden (B, T, H),
    features (B, L, T, H), each block's output) (dit.py:392-436). With
    cfg.remat each block runs under torch.utils.checkpoint and is computed
    again in the backward (with the plain versions where the forward had
    them forced)."""
    x = _input_embed(p["input_embed"], cfg, x, mask)
    cos, sin = rope_cos_sin(cfg, x.shape[1], x.device)
    mem = nn.linear(p["phoneme_proj"], phoneme_embedding)
    mem = torch.where(phonemes_mask[..., None], mem, torch.zeros((), dtype=mem.dtype, device=mem.device))
    emb = _emb_proj(p["emb_proj"], time_embedding)
    joint_key_mask = torch.cat([mask, ref_mask, phonemes_mask], dim=1)
    mods = torch.unbind(_all_block_modulations(p["blocks"], emb), 0)
    blocks = nn.layers({k: v for k, v in p["blocks"].items() if k != "attn_norm"}, cfg.n_blocks)
    feats = []
    for blk, mod in zip(blocks, mods):
        args = (blk, cfg, x, mod, mask, joint_key_mask, cos, sin, ref_seq, mem)
        x = (checkpoint(_block, *args, use_reentrant=False, context_fn=kernels.checkpoint_contexts) if cfg.remat
             else _block(*args))
        feats.append(x)
    x = _adaln_final_from_mod(nn.linear(p["norm_out"]["linear"], nn.silu(emb)), x)
    return x, torch.stack(feats, dim=1)

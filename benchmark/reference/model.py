"""smalltts in plain PyTorch: the reference the benchmark holds the program to.

Parameters are nested dicts of tensors in the published model's split layout
(a linear's weight is (in, out); a stack of blocks carries a leading layer
dim). Every function takes a `Prec`, which says where the arithmetic rounds:

- `Prec(torch.float32)`: float32 throughout, TF32 off (the caller turns
  cuBLAS's and cuDNN's TF32 off; `tf32_off()` does);
- `Prec(torch.bfloat16)`: bf16 activations at the points where the served
  model rounds them: a product accumulates in float32 and rounds once, after
  its float32 bias; norms and softmax compute in float32 and round; the
  elementwise chains (sigmoid, silu, softplus, the adaLN and the gated
  residuals) round after each op;
- `Prec(torch.bfloat16, fp8=True)`: the same, with every linear product's
  two operands rounded to float8 e4m3 under a per-tensor scale, and the
  gradient reaching each operand rounded to e5m2: the fp8-GEMM training
  recipe, one precision below bf16.

The codec runs in float32; `codec_decode(..., operand=tf32_round)` rounds
each convolution's two operands to TF32, as the tensor cores read them: the
codec one precision below its configuration's.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ config


@dataclass(frozen=True)
class EncoderCfg:
    model_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    norm_eps: float

    @property
    def head_dim(self) -> int:
        return self.model_size // self.num_heads


@dataclass(frozen=True)
class DiTCfg:
    n_blocks: int
    heads: int
    mlp_ratio: float
    rot_dim: int
    conv_kernel: int
    conv_groups: int


@dataclass(frozen=True)
class CodecCfg:
    latent_dim: int
    strides: tuple
    channels: tuple
    res_dilations: tuple
    kernel: int
    head_kernel: int


@dataclass(frozen=True)
class ModelCfg:
    latent_dim: int
    hidden_dim: int
    phoneme_dim: int
    vocab_size: int
    time_embed_dim: int
    dit: DiTCfg
    text: EncoderCfg
    style: EncoderCfg
    codec: CodecCfg

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.dit.heads

    @property
    def ff_dim(self) -> int:
        return int(self.hidden_dim * self.dit.mlp_ratio)

    @property
    def hop(self) -> int:
        return math.prod(self.codec.strides)


def model_cfg(d: dict) -> ModelCfg:
    """A configuration file's sizes as a ModelCfg."""
    c = d["codec"]
    return ModelCfg(
        latent_dim=d["latent_dim"], hidden_dim=d["hidden_dim"], phoneme_dim=d["phoneme_dim"],
        vocab_size=d["vocab_size"], time_embed_dim=d["time_embed_dim"], dit=DiTCfg(**d["dit"]),
        text=EncoderCfg(**d["text"]), style=EncoderCfg(**d["style"]),
        codec=CodecCfg(c["latent_dim"], tuple(c["strides"]), tuple(c["channels"]), tuple(c["res_dilations"]),
                       c["kernel"], c["head_kernel"]))


# ------------------------------------------------------------ param shapes
# (path, shape, init): "fan_in:<n>" draws N(0, 1/(3n)), the variance of
# PyTorch's default uniform(-1/sqrt(n), 1/sqrt(n)); "std:<s>" draws N(0, s^2);
# "const:<c>" is the constant c.


def _linear(path, i, o, bias=True, lead=(), std=None):
    init = f"std:{std}" if std is not None else f"fan_in:{i}"
    out = [(f"{path}/w", (*lead, i, o), init)]
    if bias:
        out.append((f"{path}/b", (*lead, o), f"std:{5 * std}" if std is not None else f"fan_in:{i}"))
    return out


def _encoder_blocks(path, e: EncoderCfg):
    m, L = e.model_size, (e.num_layers,)
    out = []
    for n in ("wq", "wk", "wv", "wo", "gate"):
        out += _linear(f"{path}/attn/{n}", m, m, bias=False, lead=L)
    out += [(f"{path}/attn/q_norm/scale", (*L, e.num_heads, e.head_dim), "const:1"),
            (f"{path}/attn/k_norm/scale", (*L, e.num_heads, e.head_dim), "const:1")]
    out += _linear(f"{path}/mlp/w1", m, e.intermediate_size, bias=False, lead=L)
    out += _linear(f"{path}/mlp/w3", m, e.intermediate_size, bias=False, lead=L)
    out += _linear(f"{path}/mlp/w2", e.intermediate_size, m, bias=False, lead=L)
    out += [(f"{path}/attention_norm/scale", (*L, m), "const:1"), (f"{path}/mlp_norm/scale", (*L, m), "const:1")]
    return out


def backbone_shapes(cfg: ModelCfg):
    """Every backbone leaf. The leaves the published model zero-initializes
    (the adaLN modulation, norm_out, the velocity head) are drawn at std
    0.02 (biases 0.1): at zero every block is the identity and the velocity
    0, and a check of such weights would pass whatever the blocks compute."""
    h, L, d = cfg.hidden_dim, (cfg.dit.n_blocks,), cfg.dit
    te, st = cfg.text, cfg.style
    k, g = d.conv_kernel, d.conv_groups
    out = _linear("time_embedding/l1", cfg.time_embed_dim, h) + _linear("time_embedding/l2", h, h)
    out += [("phoneme_embedding/text_embedding/w", (cfg.vocab_size, te.model_size), "std:1")]
    out += _encoder_blocks("phoneme_embedding/blocks", te)
    out += [("phoneme_embedding/norm/scale", (te.model_size,), "const:1")]
    out += _linear("style_encoder/in_proj", cfg.latent_dim, st.model_size)
    out += [("style_encoder/log_scale", (), "const:-1.8")]
    out += _encoder_blocks("style_encoder/blocks", st)
    out += [("style_encoder/norm/scale", (st.model_size,), "const:1")]
    out += _linear("style_encoder/out_proj", st.model_size, h)
    out += _linear("dit/input_embed/proj", cfg.latent_dim, h)
    for c in ("conv1", "conv2"):
        out += [(f"dit/input_embed/{c}/w", (h, h // g, k), f"fan_in:{h // g * k}"),
                (f"dit/input_embed/{c}/b", (h,), f"fan_in:{h // g * k}")]
    out += _linear("dit/phoneme_proj", cfg.phoneme_dim, h)
    out += _linear("dit/emb_proj/l1", h, 2 * h) + _linear("dit/emb_proj/l2", 2 * h, h)
    out += _linear("dit/blocks/attn_norm/linear", h, 6 * h, lead=L, std=0.02)
    a = "dit/blocks/attn"
    out += _linear(f"{a}/qkv_self", h, 3 * h, lead=L) + _linear(f"{a}/gate", h, h, bias=False, lead=L)
    out += _linear(f"{a}/to_out", h, h, bias=False, lead=L)
    for n in ("q_norm", "k_norm", "k_norm_cross"):
        out.append((f"{a}/{n}/scale", (*L, d.heads, cfg.head_dim), "const:1"))
    out += _linear(f"{a}/kv_ref", h, 2 * h, lead=L) + _linear(f"{a}/kv_text", h, 2 * h, lead=L)
    f = cfg.ff_dim
    out += (_linear("dit/blocks/ff/w1", h, f, lead=L) + _linear("dit/blocks/ff/w3", h, f, lead=L)
            + _linear("dit/blocks/ff/w2", f, h, lead=L))
    out += _linear("dit/norm_out/linear", h, 2 * h, std=0.02)
    out += _linear("velocity", h, cfg.latent_dim, std=0.02)
    return out


def codec_decoder_shapes(cfg: ModelCfg):
    """The codec decoder's leaves (the encoder is not served: the traffic
    brings its references as latents). Snake's log-alphas are 0, as
    initialized."""
    c = cfg.codec
    ch, n = c.channels, len(c.strides)

    def conv(path, i, o, kk):
        return [(f"{path}/w", (o, i, kk), f"fan_in:{i * kk}"), (f"{path}/b", (o,), f"fan_in:{i * kk}")]

    out = conv("dec_in", c.latent_dim, ch[0], 3)
    for i in range(n):
        s = f"dec_stages#{i}"
        for j in range(len(c.res_dilations)):
            r = f"{s}/res#{j}"
            out += [(f"{r}/log_alpha1", (ch[i],), "const:0")] + conv(f"{r}/conv1", ch[i], ch[i], c.kernel)
            out += [(f"{r}/log_alpha2", (ch[i],), "const:0")] + conv(f"{r}/conv2", ch[i], ch[i], 1)
        out += [(f"{s}/log_alpha", (ch[i],), "const:0")] + conv(f"{s}/conv", ch[i], ch[i + 1] * c.strides[i], c.kernel)
    wide = ch[-1] * c.strides[-1]
    out += [("dec_log_alpha", (wide,), "const:0")] + conv("dec_out", wide, c.strides[-1], c.head_kernel)
    return out


def make_params(shapes, gen: torch.Generator, dtype, device) -> Dict[str, torch.Tensor]:
    """Flat {path: tensor} for `shapes`, every random leaf cut from one
    normal draw of `gen` on `device`, scaled, in `dtype`."""
    total = sum(math.prod(s) for _, s, init in shapes if not init.startswith("const"))
    z = torch.randn((total,), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for path, shape, init in shapes:
        kind, val = init.split(":")
        n = math.prod(shape)
        if kind == "const":
            out[path] = torch.full(shape, float(val), dtype=dtype, device=device)
            continue
        std = float(val) if kind == "std" else 1.0 / math.sqrt(3.0 * float(val))
        out[path] = (z[pos:pos + n].view(shape) * std).to(dtype)
        pos += n
    return out


def nest(flat: Dict[str, torch.Tensor]):
    """{"a/b#0/c": t} -> {"a": {"b": [{"c": t}]}}."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        parts = path.split("/")
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            if "#" in part:
                name, idx = part.split("#")
                lst = node.setdefault(name, [])
                while len(lst) <= int(idx):
                    lst.append({})
                if last:
                    lst[int(idx)] = t
                else:
                    node = lst[int(idx)]
            elif last:
                node[part] = t
            else:
                node = node.setdefault(part, {})
    return root


# --------------------------------------------------------------- precision


@contextlib.contextmanager
def tf32_off():
    """Full float32 products and convolutions while the block runs."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _fp8_round(x: torch.Tensor, fmt) -> torch.Tensor:
    """x rounded to `fmt` under a per-tensor scale that maps its largest
    magnitude to the format's largest value; returned in x's dtype."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.where(amax > 0, amax / torch.finfo(fmt).max, torch.ones_like(amax))
    return ((xf / scale).to(fmt).float() * scale).to(x.dtype)


class _FP8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero."""
    i = x.float().contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Prec:
    def __init__(self, dtype=torch.float32, fp8: bool = False):
        self.dtype = dtype
        self.fp8 = fp8

    def operand(self, x):
        return _FP8Operand.apply(x) if self.fp8 else x


# ------------------------------------------------------------------ ops


def linear(p, x, P: Prec):
    w = p["w"].to(x.dtype)
    y = torch.matmul(P.operand(x).float(), P.operand(w).float())
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def rmsnorm(scale, x, eps):
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * scale.float()).to(x.dtype)


def layernorm(x, eps=1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def sigmoid(x):
    return 1 / (1 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


def mish(x):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    sp = torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(x - zero)))
    return x * torch.tanh(sp)


def conv1d(p, x, groups=1, dilation=1, padding=None, operand=None):
    """Channel-last conv (B, T, C): the taps accumulate in float32 (exact
    products of bf16 values), round to x's dtype, the float32 bias adds and
    the sum rounds again. SAME padding puts the odd tap low-first.
    `operand`, where given, rounds the input and the weight first."""
    k = p["w"].shape[-1]
    if padding is None:
        total = (k - 1) * dilation
        lo, hi = total // 2, total - total // 2
    else:
        lo = hi = padding
    h, w = F.pad(x.transpose(1, 2).float(), (lo, hi)), p["w"].float()
    if operand is not None:
        h, w = operand(h), operand(w)
    y = F.conv1d(h, w, None, dilation=dilation, groups=groups).to(x.dtype)
    return (y.float() + p["b"].float()[:, None]).to(x.dtype).transpose(1, 2)


def length_mask(lengths, n):
    return torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]


def sdpa(q, k, v, key_mask):
    """(B, H, Tq, D) over (B, H, S, D): float32 scores, masked keys -1e9,
    float32 softmax, probabilities rounded to q's dtype, PV in float32."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(key_mask[:, None, None, :], scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype)


def layer(stacked, l):
    """Layer l of a tree of stacked block params."""
    if isinstance(stacked, dict):
        return {k: layer(v, l) for k, v in stacked.items()}
    return stacked[l]


# -------------------------------------------------------------- encoders


def _pair_cos_sin(t, head_dim, device):
    inv = 1.0 / (1e4 ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = np.outer(np.arange(t, dtype=np.float32), inv)
    return torch.from_numpy(np.cos(freqs)).to(device), torch.from_numpy(np.sin(freqs)).to(device)


def _rope_pairs(x, cos, sin):
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    re, im = x2[..., 0], x2[..., 1]
    cos, sin = cos[None, :, None, :].to(x.dtype), sin[None, :, None, :].to(x.dtype)
    return torch.stack([re * cos - im * sin, re * sin + im * cos], dim=-1).reshape(x.shape)


def encoder_stack(blocks, e: EncoderCfg, x, mask, P: Prec):
    b, t, m = x.shape
    h, d = e.num_heads, e.head_dim
    cos, sin = _pair_cos_sin(t, d, x.device)
    for l in range(e.num_layers):
        p = layer(blocks, l)
        a = p["attn"]
        n = rmsnorm(p["attention_norm"]["scale"], x, e.norm_eps)
        q = _rope_pairs(rmsnorm(a["q_norm"]["scale"], linear(a["wq"], n, P).reshape(b, t, h, d), e.norm_eps), cos, sin)
        k = _rope_pairs(rmsnorm(a["k_norm"]["scale"], linear(a["wk"], n, P).reshape(b, t, h, d), e.norm_eps), cos, sin)
        v = linear(a["wv"], n, P).reshape(b, t, h, d)
        gate = linear(a["gate"], n, P)
        o = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask).transpose(1, 2).reshape(b, t, m)
        x = x + linear(a["wo"], o * sigmoid(gate), P)
        n = rmsnorm(p["mlp_norm"]["scale"], x, e.norm_eps)
        mp = p["mlp"]
        x = x + linear(mp["w2"], silu(linear(mp["w1"], n, P)) * linear(mp["w3"], n, P), P)
    return x


def text_encoder(p, cfg: ModelCfg, ids, mask, P: Prec):
    x = p["text_embedding"]["w"][ids.long()]
    return rmsnorm(p["norm"]["scale"], encoder_stack(p["blocks"], cfg.text, x, mask, P), cfg.text.norm_eps)


def style_encoder(p, cfg: ModelCfg, latents, lengths, P: Prec):
    mask = length_mask(lengths, latents.shape[1])
    x = linear(p["in_proj"], latents, P)
    x = x * torch.exp(p["log_scale"]).to(x.dtype)
    x = encoder_stack(p["blocks"], cfg.style, x, mask, P)
    x = linear(p["out_proj"], rmsnorm(p["norm"]["scale"], x, cfg.style.norm_eps), P)
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device)), mask


def time_embedding(p, t, dim):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(1e4) / (half - 1)))
    ang = 1e3 * t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(p["l1"]["w"].dtype)
    return emb


# ------------------------------------------------------------------- DiT


def _interleaved_cos_sin(t, rot, device):
    inv = 1.0 / (1e4 ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    freqs = np.einsum("i,j->ij", np.arange(t, dtype=np.float32), inv)
    freqs = torch.from_numpy(np.stack([freqs, freqs], axis=-1).reshape(t, rot)).to(device)
    return torch.cos(freqs), torch.sin(freqs)


def _rotate_interleaved(x, cos, sin):
    rot = cos.shape[-1]
    xr, rest = x[..., :rot].float(), x[..., rot:]
    x2 = xr.reshape(*xr.shape[:-1], -1, 2)
    half = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(xr.shape)
    return torch.cat([(xr * cos + half * sin).to(x.dtype), rest], dim=-1)


def _mlp_pair(p, x, P):
    return linear(p["l2"], silu(linear(p["l1"], x, P)), P)


def _input_embed(p, cfg: ModelCfg, x, mask, P):
    x = linear(p["proj"], x, P)
    m3 = mask[..., None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    h = torch.where(m3, x, zero)
    h = mish(conv1d(p["conv1"], h, groups=cfg.dit.conv_groups)) * m3.to(x.dtype)
    h = mish(conv1d(p["conv2"], h, groups=cfg.dit.conv_groups))
    return torch.where(m3, h, zero) + x


def _modulations(blocks, emb, P):
    """(B, H) -> (L, B, 6H): every block's adaLN modulation."""
    lin = blocks["attn_norm"]["linear"]
    s = silu(emb)
    w = lin["w"].to(s.dtype)
    mod = torch.matmul(P.operand(s).float()[None], P.operand(w).float())
    return (mod + lin["b"].float()[:, None, :]).to(s.dtype)


def _cross_kv(p_attn, cfg: ModelCfg, seq, which, P):
    b, t, _ = seq.shape
    h, d = cfg.dit.heads, cfg.head_dim
    k, v = torch.chunk(linear(p_attn[f"kv_{which}"], seq, P), 2, dim=-1)
    k = rmsnorm(p_attn["k_norm_cross"]["scale"], k.reshape(b, t, h, d), 1e-6)
    return k.transpose(1, 2), v.reshape(b, t, h, d).transpose(1, 2)


def cross_kv(p_dit, cfg: ModelCfg, ref_seq, phoneme_embedding, ph_mask, P):
    """Per layer [(k, v)], each (B, heads, R + P, D): the [ref | text] keys."""
    mem = linear(p_dit["phoneme_proj"], phoneme_embedding, P)
    mem = torch.where(ph_mask[..., None], mem, torch.zeros((), dtype=mem.dtype, device=mem.device))
    out = []
    for l in range(cfg.dit.n_blocks):
        a = layer(p_dit["blocks"]["attn"], l)
        kr, vr = _cross_kv(a, cfg, ref_seq, "ref", P)
        kt, vt = _cross_kv(a, cfg, mem, "text", P)
        out.append((torch.cat([kr, kt], dim=2), torch.cat([vr, vt], dim=2)))
    return out


def _block(p, cfg: ModelCfg, x, mod, mask, key_mask, cos, sin, kc, vc, P):
    b, t, hid = x.shape
    h, d = cfg.dit.heads, cfg.head_dim
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = torch.chunk(mod, 6, dim=-1)
    a = p["attn"]
    n = layernorm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    q, k, v = torch.chunk(linear(a["qkv_self"], n, P), 3, dim=-1)
    gate = linear(a["gate"], n, P)
    q = rmsnorm(a["q_norm"]["scale"], q.reshape(b, t, h, d), 1e-6).transpose(1, 2)
    k = rmsnorm(a["k_norm"]["scale"], k.reshape(b, t, h, d), 1e-6).transpose(1, 2)
    q, k = _rotate_interleaved(q, cos, sin), _rotate_interleaved(k, cos, sin)
    v = v.reshape(b, t, h, d).transpose(1, 2)
    o = sdpa(q, torch.cat([k, kc], dim=2), torch.cat([v, vc], dim=2), key_mask)
    o = o.transpose(1, 2).reshape(b, t, hid) * sigmoid(gate)
    o = linear(a["to_out"], o, P)
    o = torch.where(mask[..., None], o, torch.zeros((), dtype=o.dtype, device=o.device))
    x = x + torch.tanh(gate_msa)[:, None] * o
    n = layernorm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    f = p["ff"]
    y = linear(f["w2"], silu(linear(f["w1"], n, P)) * linear(f["w3"], n, P), P)
    return x + torch.tanh(gate_mlp)[:, None] * y


def dit(p, cfg: ModelCfg, x, mask, emb, kv, cross_mask, P):
    """The DiT over its cross K/V: x (B, T, latent) noised, emb (B, H) the
    time embedding after the backbone's MLP -> (B, T, H)."""
    x = _input_embed(p["input_embed"], cfg, x, mask, P)
    e = _mlp_pair(p["emb_proj"], emb, P)
    mods = _modulations(p["blocks"], e, P)
    final = linear(p["norm_out"]["linear"], silu(e), P)
    cos, sin = _interleaved_cos_sin(x.shape[1], cfg.dit.rot_dim, x.device)
    key_mask = torch.cat([mask, cross_mask], dim=1)
    blocks = {k: v for k, v in p["blocks"].items() if k != "attn_norm"}
    for l in range(cfg.dit.n_blocks):
        x = _block(layer(blocks, l), cfg, x, mods[l], mask, key_mask, cos, sin, kv[l][0], kv[l][1], P)
    scale, shift = torch.chunk(final, 2, dim=-1)
    return layernorm(x) * (1 + scale[:, None]) + shift[:, None]


def _alpha_sigma(t):
    t = torch.clamp(t, 1e-5, 1.0 - 1e-5)
    a2 = torch.cos(math.pi / 2.0 * t) ** 2
    s = torch.sigmoid(torch.log(a2 / (1.0 - a2)) + 2.0 * math.log(0.5))
    return torch.sqrt(s), torch.sqrt(1.0 - s)


def velocity(p, cfg: ModelCfg, noised, mask, t_emb_mlp_in, kv, cross_mask, P):
    """Velocity (B, T, latent) from the DiT and the head; `t_emb_mlp_in` the
    sinusoidal embedding (B, time_embed_dim) in the compute dtype."""
    te = _mlp_pair(p["time_embedding"], t_emb_mlp_in, P)
    return linear(p["velocity"], dit(p["dit"], cfg, noised, mask, te, kv, cross_mask, P), P)


def conditions(p, cfg: ModelCfg, ref, ref_len, ph, ph_len, P):
    ph_mask = length_mask(ph_len, ph.shape[1])
    ref_seq, ref_mask = style_encoder(p["style_encoder"], cfg, ref, ref_len, P)
    emb = text_encoder(p["phoneme_embedding"], cfg, ph, ph_mask, P)
    return cross_kv(p["dit"], cfg, ref_seq, emb, ph_mask, P), torch.cat([ref_mask, ph_mask], dim=1)


def sample_latents(p, cfg: ModelCfg, ref, ref_len, ph, ph_len, seq_len, t_bucket, noises, P, num_steps=4):
    """The DMD loop: x_pred from zeros; at each t of linspace(1, 0, steps)
    x_t = alpha x_pred + sigma noise_i, x_pred = alpha x_t - sigma v."""
    dt = P.dtype
    kv, cross_mask = conditions(p, cfg, ref, ref_len, ph, ph_len, P)
    b, dev = ref.shape[0], ref.device
    mask = length_mask(seq_len, t_bucket)
    ts = torch.linspace(1.0, 0.0, num_steps, dtype=torch.float32, device=dev)
    embs = time_embedding(p["time_embedding"], ts, cfg.time_embed_dim)
    alphas, sigmas = _alpha_sigma(ts)
    x_pred = torch.zeros((b, t_bucket, cfg.latent_dim), dtype=dt, device=dev)
    for i in range(num_steps):
        a, s = alphas[i].to(dt), sigmas[i].to(dt)
        x_t = a * x_pred + s * noises[i].to(dt)
        v = velocity(p, cfg, x_t, mask, embs[i:i + 1].expand(b, -1), kv, cross_mask, P)
        x_pred = a * x_t - s * v
    return torch.where(mask[..., None], x_pred, torch.zeros((), dtype=dt, device=dev))


# ----------------------------------------------------------------- codec


def _snake(x, log_alpha):
    a = torch.exp(log_alpha).to(x.dtype)
    y = a * x * (1.0 / math.pi)
    f = y - torch.floor(y)
    g = f * (1.0 - f)
    s = 16.0 * g / (5.0 - 4.0 * g)
    return x + (s * s) / a


def codec_decode(p, cfg: ModelCfg, latents, operand=None):
    """(B, T, latent) float32 -> (B, T * hop) waveform in [-1, 1];
    `operand` rounds each convolution's operands (conv1d)."""
    c = cfg.codec
    n = len(c.strides)
    x = conv1d(p["dec_in"], latents, operand=operand)
    for i, (stage, r) in enumerate(zip(p["dec_stages"], c.strides)):
        for ru, d in zip(stage["res"], c.res_dilations):
            h = conv1d(ru["conv1"], _snake(x, ru["log_alpha1"]), dilation=d, operand=operand)
            x = x + conv1d(ru["conv2"], _snake(h, ru["log_alpha2"]), padding=0, operand=operand)
        x = conv1d(stage["conv"], _snake(x, stage["log_alpha"]), operand=operand)
        if i < n - 1:
            b, t, ch = x.shape
            x = x.reshape(b, t * r, ch // r)
    x = torch.tanh(conv1d(p["dec_out"], _snake(x, p["dec_log_alpha"]), operand=operand))
    return x.reshape(x.shape[0], -1)


def pcm16(audio):
    return torch.round(torch.clamp(audio.float(), -1.0, 1.0) * 32767.0).to(torch.int16)


def synthesize(p, codec_p, cfg: ModelCfg, ref, ref_len, ph, ph_len, seq_len, t_bucket, noises, P, num_steps=4):
    """Waveform (B, t_bucket * hop) int16 of a padded batch."""
    lat = sample_latents(p, cfg, ref, ref_len, ph, ph_len, seq_len, t_bucket, noises, P, num_steps)
    return pcm16(codec_decode(codec_p, cfg, lat.float()))


# ------------------------------------------------------- teacher training


def cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def teacher_sq_error(params, cfg: ModelCfg, batch, draws, P: Prec, drops=(0.1, 0.1)):
    """(sum of squared velocity errors over the valid elements, their count)
    of a block of rows, in float32. The text is dropped where text_u <
    drops[0], the reference where speaker_u < drops[1]."""
    text_drop, spk_drop = draws["text_u"] < drops[0], draws["speaker_u"] < drops[1]
    ph = torch.where(text_drop[:, None], 0, batch["phonemes"])
    ph_len = torch.where(text_drop, 0, batch["phonemes_lengths"])
    ref = torch.where(spk_drop[:, None, None], torch.zeros((), device=ph.device), batch["ref_latents"])
    ref_len = torch.where(spk_drop, 0, batch["ref_latents_lengths"])
    lat, t = batch["latents"], draws["t"]
    mask = length_mask(batch["latents_lengths"], lat.shape[1])
    a, s = _alpha_sigma(t)
    a, s = a[:, None, None], s[:, None, None]
    noised, target = a * lat + s * draws["noise"], a * draws["noise"] - s * lat
    p = cast_floats(params, P.dtype)
    noised, ref = noised.to(P.dtype), ref.to(P.dtype)
    kv, cross_mask = conditions(p, cfg, ref, ref_len, ph, ph_len, P)
    emb = time_embedding(p["time_embedding"], t, cfg.time_embed_dim)
    v = velocity(p, cfg, noised, mask, emb, kv, cross_mask, P)
    valid = mask[..., None].expand(v.shape).float()
    return (((v.float() - target.float()) ** 2) * valid).sum(), valid.sum()


def warmup_cosine(count, peak=1.5e-4, total=330_000, warmup=1_500, end=1e-5, start_factor=1e-6):
    """optax's warmup then cosine schedule at the 0-based update count, float32."""
    init = np.float32(peak * start_factor)
    if count < warmup:
        return float(np.float32((init - np.float32(peak)) * (np.float32(1) - np.float32(count) / np.float32(warmup))
                                + np.float32(peak)))
    c = np.float32(min(count - warmup, total - warmup))
    cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * c / np.float32(total - warmup)))
    alpha = np.float32(end / peak)
    return float(np.float32(peak) * ((np.float32(1) - alpha) * cosine + alpha))


def teacher_step(params, state, batch, draws, cfg: ModelCfg, P: Prec, rows_per_block: int, drops=(0.1, 0.1),
                 total=330_000, warmup=1_500, clip=1.0, wd=1e-2, b1=0.9, b2=0.999, eps=1e-8):
    """One AdamW step of the teacher on a flat {path: float32 tensor} tree:
    the masked velocity MSE and its gradients summed over blocks of rows,
    the global-norm clip, Adam's moments and bias correction, decoupled
    weight decay, the schedule at the step's count. `state` holds mu, nu and
    count. Returns (new params, new state, loss, the clipped gradients)."""
    names = list(params)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    tree = nest(dict(zip(names, leaves)))
    b = batch["latents"].shape[0]
    count_valid = (length_mask(batch["latents_lengths"], batch["latents"].shape[1]).sum() * cfg.latent_dim).float()
    grads = [torch.zeros_like(x) for x in leaves]
    loss = torch.zeros((), device=leaves[0].device)
    for lo in range(0, b, rows_per_block):
        rows = slice(lo, lo + rows_per_block)
        with torch.enable_grad():
            sq, _ = teacher_sq_error(tree, cfg, {k: v[rows] for k, v in batch.items()},
                                     {k: v[rows] for k, v in draws.items()}, P, drops)
            part = sq / torch.clamp_min(count_valid, 1.0)
            g = torch.autograd.grad(part, leaves, allow_unused=True)
        loss = loss + part.detach()
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi.float()
    with torch.no_grad():
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if norm >= clip:
            grads = [g / norm * clip for g in grads]
        count = state["count"]
        lr = warmup_cosine(count, total=total, warmup=warmup)
        new_p, mu, nu = {}, {}, {}
        for n, p, g in zip(names, leaves, grads):
            mu[n] = (1 - b1) * g + b1 * state["mu"][n]
            nu[n] = (1 - b2) * g * g + b2 * state["nu"][n]
            mu_hat = mu[n] / (1 - b1 ** (count + 1))
            nu_hat = nu[n] / (1 - b2 ** (count + 1))
            u = mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p.detach()
            new_p[n] = p.detach() + (-lr) * u
    return new_p, {"mu": mu, "nu": nu, "count": count + 1}, loss, dict(zip(names, grads))


def adam_init(params):
    return {"mu": {n: torch.zeros_like(t) for n, t in params.items()},
            "nu": {n: torch.zeros_like(t) for n, t in params.items()}, "count": 0}


"""Reference (torch) checkpoints -> the JAX package's parameter layout.

The port's own copy of smalltts_tpu/utils/torch_convert.py. The reference
distributes teacher / DMD student checkpoints as torch state_dicts
(reference: src/scripts/train/teacher.py:160-171,
src/scripts/train/dmd2/distill.py:465-479). This module maps those key
layouts onto the JAX package's stacked-tree layout, numpy leaves:

* torch Linear weight (out, in)     -> (in, out)      [transpose]
* torch Conv1d  weight (out, in, k) -> (k, in, out)   [HIO, channel-last]
* per-block weights ....{i}....     -> stacked leading-dim-L leaves

and implements the reference's tolerant prefix-cleaning rules
(distill.py:39-57: strip module./_orig_mod./ema_model./online_model.,
drop initted/step keys) so EMA / compiled / DDP checkpoints all load.
`utils.convert.params_from_jax` then maps the tree to the port's params,
so a torch checkpoint and an npz take one path from the JAX layout on.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_PREFIXES = ("module.", "_orig_mod.", "ema_model.", "online_model.")


def clean_state_dict_keys(sd: Dict[str, "np.ndarray"]) -> Dict[str, "np.ndarray"]:
    cleaned = {}
    for k, v in sd.items():
        if k in ("initted", "step"):
            continue
        # loop until stable: a single ordered pass left residue on nested
        # spellings like '_orig_mod.module.' (compiled DDP) because
        # 'module.' had already been tried before '_orig_mod.' stripped
        while True:
            for prefix in _PREFIXES:
                if k.startswith(prefix):
                    k = k[len(prefix):]
                    break
            else:
                break
        k = k.replace("._orig_mod.", ".")
        cleaned[k] = v
    return cleaned


def state_dict_to_numpy(sd) -> Dict[str, np.ndarray]:
    return {
        k: v.detach().cpu().float().numpy()
        for k, v in sd.items()
        if isinstance(v, torch.Tensor)
    }


def _lin(sd, key, bias=True):
    p = {"w": np.ascontiguousarray(sd[f"{key}.weight"].T)}
    if bias:
        p["b"] = sd[f"{key}.bias"]
    return p


def _conv1d(sd, key):
    # torch (C_out, C_in/groups, K) -> HIO (K, C_in/groups, C_out)
    return {
        "w": np.ascontiguousarray(sd[f"{key}.weight"].transpose(2, 1, 0)),
        "b": sd[f"{key}.bias"],
    }


def _norm(sd, key):
    return {"scale": sd[f"{key}.weight"]}


def _encoder_block(sd, pre):
    return {
        "attn": {
            "wq": _lin(sd, f"{pre}.attention.wq", bias=False),
            "wk": _lin(sd, f"{pre}.attention.wk", bias=False),
            "wv": _lin(sd, f"{pre}.attention.wv", bias=False),
            "wo": _lin(sd, f"{pre}.attention.wo", bias=False),
            "gate": _lin(sd, f"{pre}.attention.gate", bias=False),
            "q_norm": _norm(sd, f"{pre}.attention.q_norm"),
            "k_norm": _norm(sd, f"{pre}.attention.k_norm"),
        },
        "mlp": {
            "w1": _lin(sd, f"{pre}.mlp.w1", bias=False),
            "w3": _lin(sd, f"{pre}.mlp.w3", bias=False),
            "w2": _lin(sd, f"{pre}.mlp.w2", bias=False),
        },
        "attention_norm": _norm(sd, f"{pre}.attention_norm"),
        "mlp_norm": _norm(sd, f"{pre}.mlp_norm"),
    }


def _cat_lins(sd, keys):
    """Concatenate reference per-projection Linears into one fused weight:
    our DiT packs q/k_self/v_self (and each cross k/v pair) into single wide
    matmuls (models/dit.py), so torch weights concatenate on the out dim."""
    ws = [np.ascontiguousarray(sd[f"{k}.weight"].T) for k in keys]
    bs = [sd[f"{k}.bias"] for k in keys]
    return {"w": np.concatenate(ws, axis=1), "b": np.concatenate(bs, axis=0)}


def _dit_block(sd, pre):
    return {
        "attn_norm": {"linear": _lin(sd, f"{pre}.attn_norm.linear")},
        "attn": {
            "qkv_self": _cat_lins(
                sd,
                [f"{pre}.attn.to_q", f"{pre}.attn.to_k_self", f"{pre}.attn.to_v_self"],
            ),
            "gate": _lin(sd, f"{pre}.attn.gate", bias=False),
            "to_out": _lin(sd, f"{pre}.attn.to_out.0", bias=False),
            "q_norm": _norm(sd, f"{pre}.attn.q_norm"),
            "k_norm": _norm(sd, f"{pre}.attn.k_norm"),
            "kv_ref": _cat_lins(sd, [f"{pre}.attn.to_k_ref", f"{pre}.attn.to_v_ref"]),
            "kv_text": _cat_lins(sd, [f"{pre}.attn.to_k_text", f"{pre}.attn.to_v_text"]),
            "k_norm_cross": _norm(sd, f"{pre}.attn.k_norm_cross"),
        },
        "ff": {
            "w1": _lin(sd, f"{pre}.ff.w1"),
            "w3": _lin(sd, f"{pre}.ff.w3"),
            "w2": _lin(sd, f"{pre}.ff.w2"),
        },
    }


def _stack(blocks):
    """Per-block trees -> one tree whose leaves stack the blocks' on a new
    leading axis (the block stacks of the JAX layout)."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks, axis=0)


def _count_blocks(sd, prefix: str) -> int:
    idx = len(prefix.split("."))
    return max(int(k.split(".")[idx]) + 1 for k in sd if k.startswith(prefix + "."))


def convert_text_encoder_state_dict(sd: Dict[str, np.ndarray], prefix: str = ""):
    """Standalone reference TextEncoder state_dict -> our pytree (blocks
    stacked for lax.scan)."""
    p = (prefix + ".") if prefix else ""
    n = _count_blocks(sd, f"{p}blocks" if p else "blocks")
    return {
        "text_embedding": {"w": sd[f"{p}text_embedding.weight"]},
        "blocks": _stack([_encoder_block(sd, f"{p}blocks.{i}") for i in range(n)]),
        "norm": _norm(sd, f"{p}norm"),
    }


def convert_style_encoder_state_dict(sd: Dict[str, np.ndarray], prefix: str = ""):
    p = (prefix + ".") if prefix else ""
    n = _count_blocks(sd, f"{p}blocks" if p else "blocks")
    return {
        "in_proj": _lin(sd, f"{p}in_proj"),
        "log_scale": sd[f"{p}log_scale"],
        "blocks": _stack([_encoder_block(sd, f"{p}blocks.{i}") for i in range(n)]),
        "norm": _norm(sd, f"{p}norm"),
        "out_proj": _lin(sd, f"{p}out_proj"),
    }


def convert_dit_state_dict(sd: Dict[str, np.ndarray], prefix: str = ""):
    p = (prefix + ".") if prefix else ""
    n = _count_blocks(sd, f"{p}transformer_blocks" if p else "transformer_blocks")
    return {
        "input_embed": {
            "proj": _lin(sd, f"{p}input_embed.proj"),
            "conv1": _conv1d(sd, f"{p}input_embed.conv_pos_embed.conv1"),
            "conv2": _conv1d(sd, f"{p}input_embed.conv_pos_embed.conv2"),
        },
        "phoneme_proj": _lin(sd, f"{p}phoneme_proj"),
        "emb_proj": {
            "l1": _lin(sd, f"{p}emb_proj.0"),
            "l2": _lin(sd, f"{p}emb_proj.2"),
        },
        "blocks": _stack(
            [_dit_block(sd, f"{p}transformer_blocks.{i}") for i in range(n)]
        ),
        "norm_out": {"linear": _lin(sd, f"{p}norm_out.linear")},
    }


def convert_backbone_state_dict(sd: Dict[str, np.ndarray],
                                n_dit_blocks: Optional[int] = None):
    """Reference DiTModel state_dict -> our backbone param pytree (numpy
    leaves). The DiT block count is always derived from the state_dict;
    `n_dit_blocks`, when given, is a cross-check that fails loudly instead
    of silently converting a different depth than the caller expected
    (it used to be accepted and ignored, review r3)."""
    sd = clean_state_dict_keys(sd)
    if n_dit_blocks is not None:
        found = _count_blocks(sd, "dit.transformer_blocks")
        if found != n_dit_blocks:
            raise ValueError(
                f"checkpoint has {found} DiT blocks, caller expected "
                f"{n_dit_blocks}")
    return {
        "time_embedding": {
            "l1": _lin(sd, "time_embedding.mlp.0"),
            "l2": _lin(sd, "time_embedding.mlp.2"),
        },
        "phoneme_embedding": convert_text_encoder_state_dict(sd, "phoneme_embedding"),
        "style_encoder": convert_style_encoder_state_dict(sd, "style_encoder"),
        "dit": convert_dit_state_dict(sd, "dit"),
        "velocity": _lin(sd, "velocity"),
    }


# ---------------------------------------------------------------------------
# DMD sidecar models: ASR / SV / discriminator (reference publishes these in
# dmd_checkpoints, saved at src/scripts/train/dmd2/distill.py:465-479)
# ---------------------------------------------------------------------------


def _ln_affine(sd, key):
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _bn_state(sd, key):
    """torch BatchNorm1d (weight/bias/running_mean/running_var) -> our
    batchnorm params+state (ops/nn.init_batchnorm layout)."""
    return {
        "scale": sd[f"{key}.weight"],
        "bias": sd[f"{key}.bias"],
        "mean": sd[f"{key}.running_mean"],
        "var": sd[f"{key}.running_var"],
    }


def _ffn_module(sd, pre):
    # torchaudio _FeedForwardModule.sequential: 0=LayerNorm, 1=Linear,
    # 2=SiLU, 3=Dropout, 4=Linear, 5=Dropout
    return {
        "ln": _ln_affine(sd, f"{pre}.sequential.0"),
        "w1": _lin(sd, f"{pre}.sequential.1"),
        "w2": _lin(sd, f"{pre}.sequential.4"),
    }


def _conformer_layer(sd, pre, use_group_norm: bool):
    # torchaudio ConformerLayer; conv_module.sequential: 0=pw Conv1d(d->2d,1),
    # 1=GLU, 2=depthwise Conv1d(k, groups=d), 3=BatchNorm1d|GroupNorm,
    # 4=SiLU, 5=pw Conv1d(d->d,1)
    conv = {
        "pw1": _conv1d(sd, f"{pre}.conv_module.sequential.0"),
        "dw": _conv1d(sd, f"{pre}.conv_module.sequential.2"),
        "pw2": _conv1d(sd, f"{pre}.conv_module.sequential.5"),
    }
    if use_group_norm:
        conv["gn_scale"] = sd[f"{pre}.conv_module.sequential.3.weight"]
        conv["gn_bias"] = sd[f"{pre}.conv_module.sequential.3.bias"]
    else:
        conv["bn"] = _bn_state(sd, f"{pre}.conv_module.sequential.3")
    return {
        "ffn1": _ffn_module(sd, f"{pre}.ffn1"),
        "attn_ln": _ln_affine(sd, f"{pre}.self_attn_layer_norm"),
        "attn": {
            # nn.MultiheadAttention packs q/k/v rows in in_proj_weight
            "in_proj": {
                "w": np.ascontiguousarray(sd[f"{pre}.self_attn.in_proj_weight"].T),
                "b": sd[f"{pre}.self_attn.in_proj_bias"],
            },
            "out_proj": _lin(sd, f"{pre}.self_attn.out_proj"),
        },
        "conv_ln": _ln_affine(sd, f"{pre}.conv_module.layer_norm"),
        "conv": conv,
        "ffn2": _ffn_module(sd, f"{pre}.ffn2"),
        "final_ln": _ln_affine(sd, f"{pre}.final_layer_norm"),
    }


def _conformer_stack(sd, pre, use_group_norm: bool):
    n = _count_blocks(sd, pre)
    return {
        "layers": [
            _conformer_layer(sd, f"{pre}.{i}", use_group_norm) for i in range(n)
        ]
    }


def convert_asr_state_dict(sd: Dict[str, np.ndarray]):
    """Reference ASR (src/smalltts/models/asr.py: depthwise ConvTranspose1d
    upsample + torchaudio Conformer + Linear head) -> our pytree."""
    sd = clean_state_dict_keys(sd)
    return {
        # ConvTranspose1d(d, d, r, stride=r, groups=d) weight (d, 1, r) ->
        # ours (r, 1, d)
        "upsample": {
            "w": np.ascontiguousarray(
                sd["upsample.deconv.weight"].transpose(2, 1, 0)
            ),
            "b": sd["upsample.deconv.bias"],
        },
        "conformer": _conformer_stack(
            sd, "encoder.conformer_layers", use_group_norm=False
        ),
        "proj": _lin(sd, "proj"),
    }


def convert_discriminator_state_dict(sd: Dict[str, np.ndarray]):
    """Reference Discriminator (src/smalltts/models/discriminator.py:47-112)
    -> our pytree (local torchaudio-ConformerLayer stack, group norm)."""
    sd = clean_state_dict_keys(sd)
    return {
        "layers_proj": _lin(sd, "layers_proj"),
        "audio_proj": _lin(sd, "audio_proj"),
        "phoneme_embed": {"w": sd["phoneme_embed.weight"]},
        "ref_proj": _lin(sd, "ref_proj"),
        "cond_proj": _lin(sd, "cond_proj"),
        "enc": _conformer_stack(sd, "enc_a.conformer_layers", use_group_norm=True),
        "out": _conv1d(sd, "out"),
    }


def _sb_conv(sd, key):
    """speechbrain Conv1d wrapper (self.conv = nn.Conv1d) -> ours."""
    return _conv1d(sd, f"{key}.conv")


def _sb_tdnn(sd, key):
    """speechbrain TDNNBlock: Conv1d wrapper + activation + BatchNorm1d
    wrapper (self.norm.norm)."""
    return {"conv": _sb_conv(sd, f"{key}.conv"), "bn": _bn_state(sd, f"{key}.norm.norm")}


def convert_sv_state_dict(sd: Dict[str, np.ndarray],
                          res2net_scale: Optional[int] = None):
    """Reference SV student (speechbrain ECAPA_TDNN under the `ecapa.`
    prefix, src/smalltts/models/sv/model.py:13-24) -> our pytree.

    The converted params include `asp.attn_tdnn_bn` (speechbrain's ASP runs
    its attention conv through a TDNNBlock: conv -> ReLU -> BN -> tanh);
    sv_forward enables that sub-path when the key is present."""
    sd = clean_state_dict_keys(sd)
    if any(k.startswith("ecapa.") for k in sd):
        sd = {k[len("ecapa."):]: v for k, v in sd.items() if k.startswith("ecapa.")}

    def se_res2net(pre):
        # scale is self-describing: count the res2net blocks actually in
        # the state_dict (scale-1 of them). A hardcoded default dropped or
        # KeyError'd on checkpoints with a different scale — the standard
        # speechbrain VoxCeleb ECAPA uses 8 where ours uses 12 (review r3).
        n = (res2net_scale - 1 if res2net_scale is not None
             else _count_blocks(sd, f"{pre}.res2net_block.blocks"))
        return {
            "in_tdnn": _sb_tdnn(sd, f"{pre}.tdnn1"),
            "res2net": [
                _sb_tdnn(sd, f"{pre}.res2net_block.blocks.{j}")
                for j in range(n)
            ],
            "out_tdnn": _sb_tdnn(sd, f"{pre}.tdnn2"),
            "se1": _sb_conv(sd, f"{pre}.se_block.conv1"),
            "se2": _sb_conv(sd, f"{pre}.se_block.conv2"),
        }

    return {
        "block0": _sb_tdnn(sd, "blocks.0"),
        "blocks": [se_res2net(f"blocks.{i}") for i in (1, 2, 3)],
        "mfa": _sb_tdnn(sd, "mfa"),
        "asp": {
            "attn1": _sb_conv(sd, "asp.tdnn.conv"),
            "attn_tdnn_bn": _bn_state(sd, "asp.tdnn.norm.norm"),
            "attn2": _sb_conv(sd, "asp.conv"),
        },
        "asp_bn": _bn_state(sd, "asp_bn.norm"),
        "fc": _sb_conv(sd, "fc"),
    }


# ---------------------------------------------------------------------------
# the inverse, for the backbone: a JAX-layout tree -> the reference's keys
# ---------------------------------------------------------------------------


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def backbone_state_dict(tree) -> Dict[str, torch.Tensor]:
    """The inverse of convert_backbone_state_dict: a JAX-layout backbone
    tree (numpy or torch leaves; `utils.convert.params_to_jax` of the port's
    params) -> the reference DiTModel's state_dict of fp32 CPU tensors, for
    torch.save. Fused projections split back into the reference's Linears."""
    sd: Dict[str, np.ndarray] = {}

    def lin(key, p, bias=True):
        sd[f"{key}.weight"] = _np32(p["w"]).T
        if bias:
            sd[f"{key}.bias"] = _np32(p["b"])

    def lins(keys, p):  # one (in, n * out) weight -> n Linears
        for k, w, b in zip(keys, np.split(_np32(p["w"]), len(keys), axis=1), np.split(_np32(p["b"]), len(keys))):
            sd[f"{k}.weight"], sd[f"{k}.bias"] = w.T, b

    def conv(key, p):  # HIO (K, C_in/groups, C_out) -> (C_out, C_in/groups, K)
        sd[f"{key}.weight"] = _np32(p["w"]).transpose(2, 1, 0)
        sd[f"{key}.bias"] = _np32(p["b"])

    def block(stacked, i):
        if isinstance(stacked, dict):
            return {k: block(v, i) for k, v in stacked.items()}
        return _np32(stacked)[i]

    def n_blocks(stacked):
        while isinstance(stacked, dict):
            stacked = next(iter(stacked.values()))
        return stacked.shape[0]

    def encoder(pre, p):
        for i in range(n_blocks(p["blocks"])):
            b, k = block(p["blocks"], i), f"{pre}.blocks.{i}"
            for name in ("wq", "wk", "wv", "wo", "gate"):
                lin(f"{k}.attention.{name}", b["attn"][name], bias=False)
            sd[f"{k}.attention.q_norm.weight"] = b["attn"]["q_norm"]["scale"]
            sd[f"{k}.attention.k_norm.weight"] = b["attn"]["k_norm"]["scale"]
            for name in ("w1", "w3", "w2"):
                lin(f"{k}.mlp.{name}", b["mlp"][name], bias=False)
            sd[f"{k}.attention_norm.weight"] = b["attention_norm"]["scale"]
            sd[f"{k}.mlp_norm.weight"] = b["mlp_norm"]["scale"]
        sd[f"{pre}.norm.weight"] = _np32(p["norm"]["scale"])

    lin("time_embedding.mlp.0", tree["time_embedding"]["l1"])
    lin("time_embedding.mlp.2", tree["time_embedding"]["l2"])
    text, style, dit = tree["phoneme_embedding"], tree["style_encoder"], tree["dit"]
    sd["phoneme_embedding.text_embedding.weight"] = _np32(text["text_embedding"]["w"])
    encoder("phoneme_embedding", text)
    lin("style_encoder.in_proj", style["in_proj"])
    sd["style_encoder.log_scale"] = _np32(style["log_scale"])
    encoder("style_encoder", style)
    lin("style_encoder.out_proj", style["out_proj"])
    lin("dit.input_embed.proj", dit["input_embed"]["proj"])
    conv("dit.input_embed.conv_pos_embed.conv1", dit["input_embed"]["conv1"])
    conv("dit.input_embed.conv_pos_embed.conv2", dit["input_embed"]["conv2"])
    lin("dit.phoneme_proj", dit["phoneme_proj"])
    lin("dit.emb_proj.0", dit["emb_proj"]["l1"])
    lin("dit.emb_proj.2", dit["emb_proj"]["l2"])
    for i in range(n_blocks(dit["blocks"])):
        b, k = block(dit["blocks"], i), f"dit.transformer_blocks.{i}"
        a = b["attn"]
        lin(f"{k}.attn_norm.linear", b["attn_norm"]["linear"])
        lins([f"{k}.attn.to_q", f"{k}.attn.to_k_self", f"{k}.attn.to_v_self"], a["qkv_self"])
        lin(f"{k}.attn.gate", a["gate"], bias=False)
        lin(f"{k}.attn.to_out.0", a["to_out"], bias=False)
        sd[f"{k}.attn.q_norm.weight"] = a["q_norm"]["scale"]
        sd[f"{k}.attn.k_norm.weight"] = a["k_norm"]["scale"]
        lins([f"{k}.attn.to_k_ref", f"{k}.attn.to_v_ref"], a["kv_ref"])
        lins([f"{k}.attn.to_k_text", f"{k}.attn.to_v_text"], a["kv_text"])
        sd[f"{k}.attn.k_norm_cross.weight"] = a["k_norm_cross"]["scale"]
        for name in ("w1", "w3", "w2"):
            lin(f"{k}.ff.{name}", b["ff"][name])
    lin("dit.norm_out.linear", dit["norm_out"]["linear"])
    lin("velocity", tree["velocity"])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}  # keeps 0-d leaves 0-d

"""The JAX package's parameter trees -> the port's parameter trees, and back.

The trees keep their keys and nesting. Linear weights stay (in, out) and
block stacks keep their leading L. Convolution kernels go from the JAX
package's HIO layout (k, c_in/groups, c_out) to torch's (c_out, c_in/groups,
k): in the backbone and the codec the kernels under a conv parent name
(conv, conv1, enc_in, ...); in the distiller's discriminator, ASR and SV
trees exactly the conv leaves each config names. Both the split block layout (qkv_self/gate, w1/w3) and the fused serving
layout (qkvg, w13) convert as they are; the pipeline fuses at load. The
int8 `w_q` and fp32 `scale` leaves of a quantized tree (quantize_modulations,
quantize_stream_weights) keep their dtypes and values. `params_to_jax` is
the inverse, for the checkpoints the port writes; `train_state_from_jax`
carries a JAX trainer's state over, so a run continues in the port.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# parent keys whose "w" leaf is a convolution kernel, in the backbone
# (dit/input_embed) and in the codec
_CONV_PARENTS = {"conv", "conv1", "conv2", "enc_in", "enc_out", "dec_in", "dec_out"}


def _conv_rule(cfg):
    """path -> is a conv kernel. The distiller's models hold conv kernels
    under names that are linears elsewhere (out, fc, proj), so for their
    configs exactly the conv leaves their module names (CONV_PATHS, beside
    its init); the parent-name rule of the backbone and the codec for any
    other config."""
    from smalltts_tpu_torch.models import asr, discriminator, sv

    for cls, mod in ((discriminator.DiscriminatorConfig, discriminator), (asr.ASRConfig, asr), (sv.SVConfig, sv)):
        if isinstance(cfg, cls):
            pattern = re.compile(mod.CONV_PATHS)
            return lambda path: pattern.fullmatch(path) is not None
    return _is_conv


def _is_conv(path: str) -> bool:
    parts = path.split("/")
    return parts[-1] == "w" and len(parts) > 1 and parts[-2].split("#")[0] in _CONV_PARENTS


def _convert(node, path: str, is_conv=_is_conv):
    if isinstance(node, dict):
        return {k: _convert(v, f"{path}/{k}" if path else k, is_conv) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, f"{path}#{i}", is_conv) for i, v in enumerate(node)]
    arr = np.asarray(node)
    if arr.dtype.kind not in "fiub":  # e.g. ml_dtypes.bfloat16
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))  # a writable copy; keeps 0-d leaves 0-d
    if is_conv(path):
        if t.ndim != 3:
            raise ValueError(f"{path}: conv kernel must be (k, c_in/g, c_out), got {tuple(t.shape)}")
        t = t.permute(2, 1, 0).contiguous()
    return t


def params_from_jax(tree, cfg):
    """Convert a JAX-layout parameter tree of numpy leaves. `cfg` is the
    config the tree was built for: a BackboneConfig (whose block stacks are
    checked against it), a CodecConfig, or a DiscriminatorConfig,
    ASRConfig or SVConfig (whose conv leaves are named by the config)."""
    from smalltts_tpu_torch.models.backbone import BackboneConfig

    out = _convert(tree, "", _conv_rule(cfg))
    if isinstance(cfg, BackboneConfig):
        want = {"dit": cfg.dit.n_blocks, "phoneme_embedding": cfg.text.num_layers,
                "style_encoder": cfg.style.num_layers}
        for key, n in want.items():
            blocks = out[key]["blocks"]
            lead = {t.shape[0] for t in tree_leaves(blocks)}
            if lead != {n}:
                raise ValueError(f"{key}: block stacks lead with {sorted(lead)}, config says {n}")
    return out


def tree_leaves(tree):
    """The leaves of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def params_to_jax(tree, cfg=None):
    """The port's tree -> the JAX package's layout: the same leaves (as
    detached tensors, their dtypes kept), convolution kernels back in HIO
    (k, c_in/groups, c_out). `cfg` names the conv leaves as in
    params_from_jax (None: the backbone's and the codec's rule).
    save_pytree writes the result as the JAX package writes its
    checkpoints."""
    is_conv = _conv_rule(cfg)

    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, f"{path}#{i}") for i, v in enumerate(node)]
        t = node.detach()
        return t.permute(2, 1, 0).contiguous() if is_conv(path) else t

    return rec(tree, "")


def train_state_from_jax(params, mu, nu, count, ema, step, cfg=None, device="cpu"):
    """A JAX teacher run's state as numpy trees -> the port's trainer state
    {"params", "opt_state": {"mu", "nu", "count"}, "ema", "step"} on
    `device`. mu and nu are the Adam moments of the optax state, in the
    params' tree layout; count is its update count, step the trainer's
    step. With `cfg` the block stacks are checked as params_from_jax does."""
    from smalltts_tpu_torch.utils.checkpoint import map_pytree

    def tree(t):
        return map_pytree(lambda x: x.to(device), params_from_jax(t, cfg) if cfg is not None else _convert(t, ""))

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)

    return {"params": tree(params), "opt_state": {"mu": tree(mu), "nu": tree(nu), "count": scalar(count)},
            "ema": tree(ema), "step": scalar(step)}

"""The JAX package's parameter trees -> the port's parameter trees.

The trees keep their keys and nesting. Linear weights stay (in, out) and
block stacks keep their leading L. Convolution kernels go from the JAX
package's HIO layout (k, c_in/groups, c_out) to torch's (c_out, c_in/groups,
k). Both the split block layout (qkv_self/gate, w1/w3) and the fused serving
layout (qkvg, w13) convert as they are; the pipeline fuses at load. The
int8 `w_q` and fp32 `scale` leaves of a quantized tree (quantize_modulations,
quantize_stream_weights) keep their dtypes and values.
"""

from __future__ import annotations

import numpy as np
import torch

# parent keys whose "w" leaf is a convolution kernel, in the backbone
# (dit/input_embed) and in the codec
_CONV_PARENTS = {"conv", "conv1", "conv2", "enc_in", "enc_out", "dec_in", "dec_out"}


def _convert(node, path: str):
    if isinstance(node, dict):
        return {k: _convert(v, f"{path}/{k}" if path else k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, f"{path}#{i}") for i, v in enumerate(node)]
    arr = np.asarray(node)
    if arr.dtype.kind not in "fiub":  # e.g. ml_dtypes.bfloat16
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))  # a writable copy; keeps 0-d leaves 0-d
    parts = path.split("/")
    if parts[-1] == "w" and len(parts) > 1 and parts[-2].split("#")[0] in _CONV_PARENTS:
        if t.ndim != 3:
            raise ValueError(f"{path}: conv kernel must be (k, c_in/g, c_out), got {tuple(t.shape)}")
        t = t.permute(2, 1, 0).contiguous()
    return t


def params_from_jax(tree, cfg):
    """Convert a JAX-layout parameter tree of numpy leaves. `cfg` is the
    BackboneConfig or CodecConfig the tree was built for; the block stacks
    of a backbone tree are checked against it."""
    from smalltts_tpu_torch.models.backbone import BackboneConfig

    out = _convert(tree, "")
    if isinstance(cfg, BackboneConfig):
        want = {"dit": cfg.dit.n_blocks, "phoneme_embedding": cfg.text.num_layers,
                "style_encoder": cfg.style.num_layers}
        for key, n in want.items():
            blocks = out[key]["blocks"]
            lead = {t.shape[0] for t in _leaves(blocks)}
            if lead != {n}:
                raise ValueError(f"{key}: block stacks lead with {sorted(lead)}, config says {n}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree

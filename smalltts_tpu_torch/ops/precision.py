"""Mixed-precision policy of the training steps (port of
smalltts_tpu/ops/precision.py): master params, optimizer moments and EMA
stay float32; the forward and backward run on a bf16 compute view of the
params, cast once at the top of the loss; loss reductions accumulate in
float32 (ops/masking.masked_mse). No loss scaling: bf16 has float32's
exponent range."""

from __future__ import annotations

import torch

# the trainers' compute_dtype names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_floats(tree, dtype):
    """Every floating leaf of a tree of tensors cast to `dtype` (a
    differentiable cast: gradients reach the masters); other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree

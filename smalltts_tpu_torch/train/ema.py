"""Exponential moving average of parameters (port of smalltts_tpu/train/ema.py).

ema_pytorch's decay warmup, as the reference leaves it: the EMA copies the
model (decay 0) through step 101, then tracks with decay
1 - (1 + epoch)^(-2/3), clamped at beta. The EMA weights are what the DMD2
distiller starts from.
"""

from __future__ import annotations

import numpy as np
import torch

from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree, unflatten_pytree


def ema_init(params):
    """Independent copies of the params' leaves."""
    return map_pytree(lambda t: t.detach().clone(), params)


def ema_decay(step: int, beta: float = 0.9999, update_after_step: int = 100,
              inv_gamma: float = 1.0, power: float = 2.0 / 3.0) -> float:
    """Effective decay at `step` (ema_pytorch.get_current_decay): 0 through
    update_after_step + 1, then 1 - (1 + epoch / inv_gamma)^-power clamped
    to [0, beta]."""
    epoch = max(step - update_after_step - 1, 0)
    if epoch <= 0:
        return 0.0
    return min(beta, 1.0 - (1.0 + epoch / inv_gamma) ** -power)


def ema_update(ema_params, params, beta=0.9999):
    """beta * e + (1 - beta) * p, leaf by leaf, as a new tree. A Python float
    `beta` gives 1 - beta in double precision, a float32 one (numpy or a
    0-d tensor) in float32, as JAX's weak and strong types do."""
    if isinstance(beta, float):
        b, ob = beta, 1.0 - beta
    else:
        b = np.float32(beta.item() if isinstance(beta, torch.Tensor) else beta)
        b, ob = float(b), float(np.float32(1.0) - b)
    flat_e, flat_p = flatten_pytree(ema_params), flatten_pytree(params)
    names = list(flat_e)
    with torch.no_grad():
        new = torch._foreach_add(torch._foreach_mul([flat_e[n] for n in names], b),
                                 torch._foreach_mul([flat_p[n].detach() for n in names], ob))
    return unflatten_pytree(dict(zip(names, new)))

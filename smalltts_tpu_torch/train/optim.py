"""Optimizers and schedules with optax's semantics, over dicts of tensors
(port of smalltts_tpu/train/optim.py).

Teacher: AdamW lr 1.5e-4, betas (0.9, 0.999), wd 1e-2, linear warmup 1500
steps (start factor 1e-6) then cosine to 1e-5, grad-clip 1.0. Distill:
AdamW lr 1e-5. ASR/SV: AdamW 1e-4. IMF (train/imf.py): clip 1.0, then
AdamW 1e-5 at optax's default wd 1e-4, the student's conditioning frozen.

`AdamW` is the JAX package's optax chain, multi_transform({"train":
chain(clip_by_global_norm, adamw), "freeze": set_to_zero}), written out:

- the global norm is taken over the trainable leaves, and a gradient is
  clipped as (g / norm) * max_norm only where norm >= max_norm (not
  torch.nn.utils.clip_grad_norm_'s max_norm / (norm + 1e-6));
- Adam moments mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, bias
  corrected by 1 - b^count at the incremented count, update mu_hat /
  (sqrt(nu_hat) + eps) with eps 1e-8;
- decoupled weight decay, + wd * p, on every trainable leaf, before the
  learning rate;
- the learning rate is the schedule at the update's 0-based count;
- batch-norm running statistics (`mean`/`var` leaves) get a zero update.

The count, the moments and the schedule live on the device, so a step
never waits for the card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from smalltts_tpu_torch.parallel import comm
from smalltts_tpu_torch.parallel.mesh import use
from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree, unflatten_pytree

_STATE_LEAVES = ("mean", "var")

Schedule = Callable[[Union[int, torch.Tensor]], torch.Tensor]


def trainable_mask(params):
    """A tree of bools: False for batch-norm running-stat leaves, True elsewhere."""
    if isinstance(params, dict):
        return {k: (trainable_mask(v) if isinstance(v, (dict, list, tuple)) else k not in _STATE_LEAVES)
                for k, v in params.items()}
    return [trainable_mask(v) if isinstance(v, (dict, list, tuple)) else True for v in params]


def _count(count) -> torch.Tensor:
    return count if isinstance(count, torch.Tensor) else torch.tensor(count, dtype=torch.int32)


def warmup_cosine(peak_lr: float, total_steps: int, warmup_steps: int, end_lr: float,
                  warmup_start_factor: float = 1e-6) -> Schedule:
    """optax.join_schedules([linear_schedule(peak * factor -> peak over
    warmup_steps), cosine_decay_schedule(peak, total - warmup, alpha = end /
    peak)], [warmup_steps]), in float32: a function of the count (an int or
    an int tensor on any device) returning a float32 tensor there."""
    init = peak_lr * warmup_start_factor
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = end_lr / peak_lr

    def schedule(count):
        count = _count(count)
        c = torch.clamp(count, 0, warmup_steps).float()
        warm = (init - peak_lr) * (1 - c / warmup_steps) + peak_lr
        c = torch.clamp(count - warmup_steps, max=decay_steps).float()
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        cos_lr = peak_lr * ((1 - alpha) * cosine + alpha)
        return torch.where(count < warmup_steps, warm, cos_lr)

    return schedule


def _constant(lr: float) -> Schedule:
    return lambda count: torch.full((), lr, dtype=torch.float32, device=_count(count).device)


def global_norm(leaves, names=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared entries (optax.global_norm).
    With a tensor-parallel `mesh` and the leaves' flat `names`, the norm of
    the whole tree: the shards' squares summed over tp."""
    if mesh is not None and mesh.tp > 1 and mesh.layout:
        return torch.sqrt(comm.sharded_sq_norm(dict(zip(names, leaves)), mesh))
    norms = torch._foreach_norm([g.float() for g in leaves])
    return torch.sqrt(sum(n * n for n in norms))


class AdamW(NamedTuple):
    """The optimizer; `init(params)` makes its state, `update(grads, state,
    params)` returns (updates, new_state), and `apply_updates` adds the
    updates, as optax's GradientTransformation does. The state is
    {"mu": tree, "nu": tree, "count": int32 scalar}; frozen leaves keep zero
    moments."""

    learning_rate: Schedule
    weight_decay: float
    b1: float
    b2: float
    eps: float
    clip_norm: Union[float, None]
    trainable: Dict[str, bool]  # flat path -> trainable

    def init(self, params):
        zeros = lambda t: torch.zeros_like(t, memory_format=torch.contiguous_format)  # noqa: E731
        dev = next(iter(flatten_pytree(params).values())).device
        return {"mu": map_pytree(zeros, params), "nu": map_pytree(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params, mesh=None):
        """(updates, new_state); `mesh`, a tensor-parallel mesh whose
        shards `params` holds, makes the clip's norm the whole tree's."""
        flat_g, flat_p = flatten_pytree(grads), flatten_pytree(params)
        flat_mu, flat_nu = flatten_pytree(state["mu"]), flatten_pytree(state["nu"])
        names = [n for n in flat_p if self.trainable[n]]
        g = [flat_g[n] for n in names]
        if self.clip_norm is not None:
            norm = global_norm(g, names, mesh)
            clipped = torch._foreach_mul(torch._foreach_div(g, norm), self.clip_norm)
            keep = norm < self.clip_norm
            g = [torch.where(keep, a, b) for a, b in zip(g, clipped)]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul([flat_mu[n] for n in names], self.b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
                                torch._foreach_mul([flat_nu[n] for n in names], self.b2))
        count = state["count"]
        count_inc = count + 1
        mu_hat = torch._foreach_div(mu, 1 - self.b1 ** count_inc.float())
        nu_hat = torch._foreach_div(nu, 1 - self.b2 ** count_inc.float())
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        u = torch._foreach_add(u, torch._foreach_mul([flat_p[n] for n in names], self.weight_decay))
        u = torch._foreach_mul(u, -self.learning_rate(count).to(count.device))
        by_name = dict(zip(names, zip(u, mu, nu)))
        updates = {n: by_name[n][0] if n in by_name else torch.zeros_like(p) for n, p in flat_p.items()}
        new_mu = {n: by_name[n][1] if n in by_name else flat_mu[n] for n in flat_p}
        new_nu = {n: by_name[n][2] if n in by_name else flat_nu[n] for n in flat_p}
        return unflatten_pytree(updates), {"mu": unflatten_pytree(new_mu), "nu": unflatten_pytree(new_nu),
                                           "count": count_inc.to(torch.int32)}


def value_and_grad(params, loss_fn, mesh=None):
    """(loss, aux, grads) of loss_fn(params) -> (loss, aux), the gradient of
    every leaf of `params` (zero where the loss does not reach it), as
    JAX's value_and_grad(has_aux=True) gives them. With a `mesh` the loss
    runs with it in use (its batch sums over dp) and the gradients are
    summed over dp: the global batch's."""
    flat = flatten_pytree(params)
    leaves = [p.detach().requires_grad_(True) for p in flat.values()]
    with torch.enable_grad(), use(mesh):
        loss, aux = loss_fn(unflatten_pytree(dict(zip(flat, leaves))))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = comm.all_reduce_grads([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)], mesh)
    return loss.detach(), aux, unflatten_pytree(dict(zip(flat, grads)))


def apply_updates(params, updates):
    """p + u in p's dtype (optax.apply_updates)."""
    flat_u = flatten_pytree(updates)
    return unflatten_pytree({k: (p + flat_u[k]).to(p.dtype) for k, p in flatten_pytree(params).items()})


def adamw(params, learning_rate, weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
          clip_norm: Union[float, None] = None, frozen: Tuple[str, ...] = ()) -> AdamW:
    """AdamW over `params`' trainable leaves; `learning_rate` is a float or a
    schedule (warmup_cosine). A leaf whose path holds one of the names in
    `frozen` is not trainable (optax.masked over the chain: no update, no
    moment, and its gradient stays out of the global norm)."""
    lr = learning_rate if callable(learning_rate) else _constant(float(learning_rate))
    trainable = {n: t and not set(n.replace("#", "/").split("/")) & set(frozen)
                 for n, t in flatten_pytree(trainable_mask(params)).items()}
    return AdamW(lr, weight_decay, b1, b2, 1e-8, clip_norm, trainable)


def teacher_optimizer(params, num_steps: int = 330_000, warmup: int = 1_500):
    sched = warmup_cosine(1.5e-4, num_steps, warmup, 1e-5)
    return adamw(params, sched, weight_decay=1e-2, clip_norm=1.0), sched


def distill_optimizer(params):
    return adamw(params, 1e-5, weight_decay=1e-2)


def aux_optimizer(params, num_steps: int, warmup: int = 4_000, peak: float = 1e-4,
                  clip_norm: Union[float, None] = None):
    sched = warmup_cosine(peak, num_steps, warmup, 1e-5)
    return adamw(params, sched, weight_decay=1e-2, clip_norm=clip_norm), sched

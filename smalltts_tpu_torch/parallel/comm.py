"""The collectives of the parallel layer, as the models and the step
factories call them under a mesh in use (parallel.mesh.use).

Each is the identity where it has nothing to do: with no mesh in use, or a
dp of 1, a step runs the single-device path unchanged.

Gradients across an all-reduce follow one rule. A sum that every rank then
uses the same way (a loss over the global batch) has an identity backward:
each rank's cotangent is already the whole one, and the dp all-reduce of
the parameter gradients adds the ranks' paths. A sum that each rank uses on
its own rows (a batch statistic normalizing them, a column-parallel input)
is all-reduced in the backward as well, since every rank's use contributes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from smalltts_tpu_torch.parallel.mesh import Mesh, current, unshard
from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, unflatten_pytree


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group` in place; returns x."""
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """The group's tensors of x's shape, concatenated along `dim` (not the
    last) in rank order. The bytes move, so any dtype goes (NCCL has no
    int16, the pcm16 waveform's)."""
    raw = x.contiguous().view(torch.uint8)
    out = [torch.empty_like(raw) for _ in range(size)]
    dist.all_gather(out, raw, group=group)
    return torch.cat(out, dim=dim).view(x.dtype)


class _SumForward(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's row-parallel output)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's column-parallel input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _SumBoth(torch.autograd.Function):
    """All-reduce forward and backward: a sum that each rank uses on its own rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


# ------------------------------------------------------------------ tensor parallel


def _tp_mesh() -> Mesh:
    m = current()
    if m is None or m.tp == 1 or m.tp_group is None:
        raise RuntimeError("a tensor-parallel shard of the params runs only with its mesh in use "
                           "(parallel.mesh.use(mesh), under the process group that sharded it)")
    return m


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """The input of column-parallel products: the identity, whose gradient
    is summed over tp."""
    m = _tp_mesh()
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumBackward.apply(x, m.tp_group)
    return x


def tp_sum(y: torch.Tensor) -> torch.Tensor:
    """The row-parallel partial products summed over tp (identity backward);
    in place where no gradient is wanted."""
    m = _tp_mesh()
    if torch.is_grad_enabled() and y.requires_grad:
        return _SumForward.apply(y, m.tp_group)
    return all_reduce_(y, m.tp_group)


def tp_rank() -> int:
    return _tp_mesh().tp_rank


def tp_sum_(y: torch.Tensor) -> torch.Tensor:
    """tp_sum in place, for the inference scan (no gradient)."""
    return all_reduce_(y, _tp_mesh().tp_group)


# -------------------------------------------------------------------- data parallel


def _dp_mesh():
    m = current()
    return m if m is not None and m.dp > 1 else None


def dp_ways() -> int:
    """The dp of the mesh in use (1 without one)."""
    m = current()
    return 1 if m is None else m.dp


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over dp, for a value every rank uses alike (a loss's
    numerator or count); x itself without dp."""
    m = _dp_mesh()
    return x if m is None else _SumForward.apply(x, m.dp_group)


def dp_stat(x: torch.Tensor) -> torch.Tensor:
    """x summed over dp, for a statistic each rank applies to its own rows
    (batch norm's sums); its gradient is summed over dp too."""
    m = _dp_mesh()
    return x if m is None else _SumBoth.apply(x, m.dp_group)


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the global batch (every rank holding as many
    elements); x.mean() without dp."""
    m = _dp_mesh()
    if m is None:
        return x.mean()
    return dp_sum(x.sum()) / (x.numel() * m.dp)


def all_reduce_grads(grads: List[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Gradients summed over dp: one all-reduce per dtype over a flat
    buffer. The list itself without dp."""
    if mesh is None or mesh.dp == 1:
        return grads
    out: List[torch.Tensor] = list(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        buf = torch.cat([grads[i].reshape(-1) for i in idx])
        all_reduce_(buf, mesh.dp_group)
        for i, part in zip(idx, torch.split(buf, [grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def sharded_sq_norm(named: Dict[str, torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of squares of the named leaves over the whole (unsharded)
    tree: the tp shards' sums all-reduced over tp, the replicated leaves'
    counted once."""
    shard = [t.float() for n, t in named.items() if mesh.leaf_layout(n)]
    rest = [t.float() for n, t in named.items() if not mesh.leaf_layout(n)]
    dev = next(iter(named.values())).device
    zero = torch.zeros((), device=dev)
    sq = lambda ts: sum((n * n for n in torch._foreach_norm(ts)), zero) if ts else zero  # noqa: E731
    return sq(rest) + all_reduce_(sq(shard).clone(), mesh.tp_group)


def gather_tree(tree, mesh: Mesh):
    """Every tp-sharded leaf of `tree` (by mesh.layout) all-gathered over tp
    back to the whole tensor; replicated leaves as they are."""
    flat = flatten_pytree(tree)
    out = {}
    for n, t in flat.items():
        lay = mesh.leaf_layout(n) if mesh.tp > 1 else None
        if lay is None:
            out[n] = t
            continue
        out[n] = unshard(torch.chunk(all_gather(t, mesh.tp_group, mesh.tp), mesh.tp), *lay)
    return unflatten_pytree(out)

"""Device mesh and sharding rules (port of smalltts_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("dp", "tp") mesh and lets the
compiler insert the collectives. Here one rank is one device, so `Mesh`
holds this rank's dp and tp process groups and its place in the grid, and
the collectives are explicit (parallel/comm.py):

* data parallel: each rank computes its own dp rows; batch sums and batch
  statistics are summed over dp and the gradients all-reduced over dp
  before the optimizer, so a step equals the step on the global batch;
* tensor parallel, Megatron-style: the projections the rules shard are
  column-parallel (this rank's heads and FF columns), the output
  projections row-parallel, their partial products all-reduced over tp.

The rules are the JAX package's: a leaf is sharded on an axis only where
that dimension divides by tp, the first matching substring wins, so any tp
in {1, 2, 4, 8} works on every submodule. `param_shardings` gives exactly
that choice. `shard_params` departs in storage: the JAX package stores a
contiguous slice of a fused leaf's columns, while the Megatron compute needs
whole heads of each part ([q|k|v], [q|k|v|gate], [k|v], [w1|w3]), so a shard
here holds 1/tp of every part; and the per-head norms follow their heads,
where the JAX rules leave them whole.

A mesh is in use in a thread inside `use(mesh)`: the models and the step
factories read it there (`current`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree, unflatten_pytree


class Mesh:
    """The ranks `ranks` as a (dp, tp) grid, row-major: rank index i sits at
    dp index i // tp and tp index i % tp, so each tp group is consecutive
    ranks (one host, where tp's all-reduces are cheapest) and dp crosses
    them. Under a process group every rank builds every group, in the same
    order, as torch.distributed requires; without one the mesh only lays
    out shards (rank 0's) and no collective can run.

    `layout` records, by flat leaf name, the (axis, parts) of each leaf that
    `shard_params` split, so the optimizer's norm and `fetch_replicated`
    know the shards from the replicated leaves."""

    def __init__(self, dp: int, tp: int, ranks: Sequence[int]):
        self.dp, self.tp = dp, tp
        self.shape = {"dp": dp, "tp": tp}
        self.ranks = list(ranks)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else self.ranks[0]
        self.dp_rank, self.tp_rank = divmod(self.ranks.index(self.rank), tp)
        self.backend = dist.get_backend() if self.distributed else None
        self.dp_group = self.tp_group = None
        self.layout: Dict[str, Tuple[int, int]] = {}
        if self.distributed:
            for j in range(tp):
                g = dist.new_group([self.ranks[i * tp + j] for i in range(dp)])
                if j == self.tp_rank:
                    self.dp_group = g
            for i in range(dp):
                g = dist.new_group(self.ranks[i * tp:(i + 1) * tp])
                if i == self.dp_rank:
                    self.tp_group = g

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, backend={self.backend})"

    def rows(self, x, axis: int = 0):
        """This rank's dp rows of a global tensor or array (its dp index's
        contiguous 1/dp of `axis`)."""
        n = x.shape[axis]
        if n % self.dp:
            raise ValueError(f"a batch of {n} rows does not divide over dp={self.dp}")
        lo, hi = self.dp_rank * (n // self.dp), (self.dp_rank + 1) * (n // self.dp)
        index = (slice(None),) * axis + (slice(lo, hi),)
        return x[index]

    def leaf_layout(self, name: str) -> Optional[Tuple[int, int]]:
        """The (axis, parts) of the sharded leaf `name`, or of the one it
        ends with (the same leaf inside an optimizer state, "mu/<name>")."""
        if name in self.layout:
            return self.layout[name]
        for key, lay in self.layout.items():
            if name.endswith("/" + key):
                return lay
        return None


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices: Optional[Sequence[int]] = None) -> Mesh:
    """A (dp, tp) mesh over `devices` (ranks; default every rank of the
    process group, or the one process without a group); dp defaults to
    len(devices) // tp."""
    if devices is None:
        n_world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        devices = range(n_world)
    devices = list(devices)
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    return Mesh(dp, tp, devices)


_state = threading.local()


@contextlib.contextmanager
def use(mesh: Optional[Mesh]):
    """Run the block with `mesh` in use in this thread (None: no mesh)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current() -> Optional[Mesh]:
    """The mesh in use in this thread, or None."""
    return getattr(_state, "mesh", None)


# (substring, which dim of the *matmul* to shard): "out" = last axis, "in" =
# second-to-last. Order matters: first match wins. The JAX package's rules.
_TP_RULES = [
    ("attn/to_out/w", "in"),
    ("attn/wo/w", "in"),
    ("mlp/w2/w", "in"),
    ("ff/w2/w", "in"),
    ("attn/qkv_self", "out"),
    ("attn/qkvg", "out"),
    ("ff/w13", "out"),
    ("attn/kv_ref", "out"),
    ("attn/kv_text", "out"),
    ("attn/gate", "out"),
    ("attn/wq", "out"),
    ("attn/wk", "out"),
    ("attn/wv", "out"),
    ("mlp/w1", "out"),
    ("mlp/w3", "out"),
    ("ff/w1", "out"),
    ("ff/w3", "out"),
]

# fused column leaves: how many parts lie side by side in the last axis
_PARTS = (("attn/qkv_self", 3), ("attn/qkvg", 4), ("attn/kv_ref", 2), ("attn/kv_text", 2), ("ff/w13", 2))
# per-head norms (L, heads, head_dim) and the projections whose heads they follow
_HEAD_NORMS = (("attn/q_norm/", ("qkv_self", "qkvg", "wq")), ("attn/k_norm/", ("qkv_self", "qkvg", "wk")),
               ("attn/k_norm_cross/", ("kv_ref",)))


def _leaf_spec(path: str, leaf, tp_size: int) -> tuple:
    """The JAX rule's PartitionSpec of one leaf as a tuple: () replicated,
    else None per axis with "tp" on the sharded one."""
    shape = tuple(leaf.shape)
    if tp_size == 1 or len(shape) == 0:
        return ()
    for pattern, which in _TP_RULES:
        if pattern in path:
            axis = len(shape) - 1 if which == "out" else max(len(shape) - 2, 0)
            if shape[axis] % tp_size == 0:
                spec = [None] * len(shape)
                spec[axis] = "tp"
                return tuple(spec)
            return ()
    return ()


def param_shardings(params, mesh: Mesh):
    """Tree of specs (tuples, as _leaf_spec gives): tp-sharded projections,
    replicated rest. Leaves need only a `.shape`."""
    tp = mesh.shape["tp"]

    def rule(tree, path):
        if isinstance(tree, dict):
            return {k: rule(v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
        return _leaf_spec(path, tree, tp)

    return rule(params, "")


def _layouts(flat, tp: int) -> Dict[str, Tuple[int, int]]:
    """name -> (axis, parts) of every leaf shard_params splits: the rule's
    leaves, each part of a fused column leaf split alike, and the per-head
    norms of a sharded projection on their heads axis."""
    out = {}
    for name, leaf in flat.items():
        spec = _leaf_spec(name, leaf, tp)
        if not spec:
            continue
        axis = spec.index("tp")
        parts = 1
        if axis == leaf.dim() - 1:
            parts = next((k for pat, k in _PARTS if pat in name), 1)
        if leaf.shape[axis] % (parts * tp):
            raise ValueError(f"{name}: {parts} parts of {leaf.shape[axis] // parts} do not split over tp={tp}")
        out[name] = (axis, parts)
    for name, leaf in flat.items():
        for pat, owners in _HEAD_NORMS:
            if pat not in name:
                continue
            prefix = name[:name.index(pat) + len("attn/")]
            if any(n.startswith(prefix + o + "/") for n in out for o in owners):
                if leaf.shape[-2] % tp:
                    raise ValueError(f"{name}: tp={tp} does not divide its {leaf.shape[-2]} heads; "
                                     "a tensor-parallel shard holds whole heads")
                out[name] = (leaf.dim() - 2, 1)
    return out


def _local(leaf: torch.Tensor, axis: int, parts: int, tp: int, r: int) -> torch.Tensor:
    chunks = torch.chunk(leaf, parts, dim=axis)
    w = chunks[0].shape[axis] // tp
    return torch.cat([c.narrow(axis, r * w, w) for c in chunks], dim=axis).contiguous()


def unshard(shards, axis: int, parts: int) -> torch.Tensor:
    """The whole leaf from its tp shards in tp order (the inverse of
    shard_params' split: part by part, each part's shards side by side)."""
    split = [torch.chunk(s, parts, dim=axis) for s in shards]
    return torch.cat([torch.cat([s[p] for s in split], dim=axis) for p in range(parts)], dim=axis)


def shard_params(params, mesh: Mesh):
    """This rank's tensor-parallel shard of `params` (a new tree; replicated
    leaves are shared, not copied), recorded in `mesh.layout`."""
    flat = flatten_pytree(params)
    lays = _layouts(flat, mesh.tp) if mesh.tp > 1 else {}
    mesh.layout.update(lays)
    return unflatten_pytree({n: _local(v, *lays[n], mesh.tp, mesh.tp_rank) if n in lays else v
                             for n, v in flat.items()})


def global_draws(draw_fn, gen, batch, mesh: Optional[Mesh], *args, axis: int = 0):
    """draw_fn(gen, batch, *args)'s draws for the global batch, this rank's
    dp rows of each kept (the batch on `axis`): every rank draws the same
    global draws from the same generator, so a data-parallel run draws what
    the single-process run draws. The draw functions read only the
    latents' shape, dtype and device; each rank's local batch has one
    shape. Without dp, draw_fn's own draws."""
    if mesh is None or mesh.dp == 1:
        return draw_fn(gen, batch, *args)
    lat = batch["latents"]
    standin = {"latents": torch.empty((lat.shape[0] * mesh.dp,) + tuple(lat.shape[1:]), dtype=lat.dtype,
                                      device=lat.device)}
    return map_pytree(lambda t: mesh.rows(t, axis), draw_fn(gen, standin, *args))


def data_sharding(mesh: Mesh, ndim: int) -> tuple:
    """Batch axis over dp, everything else replicated."""
    return ("dp",) + (None,) * (ndim - 1)


def shard_batch(batch, mesh: Mesh):
    """A global batch -> this rank's dp rows of it; `texts` dropped."""
    return {k: mesh.rows(v) if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items() if k != "texts"}


def replicated(tree, mesh: Mesh):
    """Every tensor leaf made equal to the mesh's first rank's, in place (a
    broadcast over the mesh; nothing to do without a process group).
    Returns the tree."""
    if mesh.distributed and len(mesh.ranks) > 1:
        map_pytree(lambda t: dist.broadcast(t, src=mesh.ranks[0]), tree)
    return tree

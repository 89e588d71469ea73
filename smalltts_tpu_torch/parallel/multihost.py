"""Multi-process training initialization (port of smalltts_tpu/parallel/multihost.py).

One process drives one device. Processes join one torch.distributed job
described by the environment, the same variables as the JAX package's:

    SMALLTTS_COORDINATOR      host:port of process 0          (required)
    SMALLTTS_NUM_PROCESSES    total process count             (required)
    SMALLTTS_PROCESS_ID       this process's rank             (required)
    SMALLTTS_LOCAL_DEVICE_IDS this process's CUDA device      (optional)

or a launcher's own (torchrun's WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), the counterpart of the JAX package's auto-discovered Cloud TPU
pod. The backend is NCCL where there is a card and gloo on the CPU.

Checkpointing is single-writer: only rank 0 touches the filesystem
(`save_on_coordinator`), with the tensor-parallel shards gathered first by
every rank. Validated end to end by
`python -m smalltts_tpu_torch.scripts.dryrun_multihost`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from smalltts_tpu_torch.parallel.mesh import Mesh, current, make_mesh


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _summary(coordinator: str) -> dict:
    return {"distributed": True, "coordinator": coordinator, "process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(), "local_devices": 1, "global_devices": dist.get_world_size(),
            "backend": dist.get_backend()}


def _use_device(local_id: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(local_id % torch.cuda.device_count())


def initialize_from_env(backend: Optional[str] = None) -> dict:
    """Join the distributed job that the environment describes.

    Returns a summary dict (coordinator, process_id, counts). Without the
    variables it is a no-op with a single-process summary, so the same
    training entry point runs unchanged in one process; so is a launcher's
    environment of one process. `backend` defaults to "nccl" with a card,
    "gloo" without; this process's card is SMALLTTS_LOCAL_DEVICE_IDS' first
    id, else the launcher's LOCAL_RANK, else the rank modulo the cards."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    coord = os.environ.get("SMALLTTS_COORDINATOR")
    if coord is None:
        # a launcher's environment (torchrun): join through env:// when it names several processes
        world = os.environ.get("WORLD_SIZE", "")
        if world.isdigit() and int(world) > 1 and "RANK" in os.environ and os.environ.get("MASTER_ADDR"):
            if not _initialized():
                _use_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
                dist.init_process_group(backend, init_method="env://")
            return _summary("env:// (launcher environment)")
        return {"distributed": False, "process_id": 0, "num_processes": 1,
                "note": "SMALLTTS_COORDINATOR unset: single-process"}
    try:
        num = int(os.environ["SMALLTTS_NUM_PROCESSES"])
        pid = int(os.environ["SMALLTTS_PROCESS_ID"])
    except (KeyError, ValueError) as exc:  # missing or malformed (e.g. '')
        raise RuntimeError(
            "SMALLTTS_COORDINATOR is set but SMALLTTS_NUM_PROCESSES / "
            "SMALLTTS_PROCESS_ID are missing or not integers — all three "
            "are required to join a distributed job "
            "(see parallel/multihost.py)") from exc
    if not _initialized():
        local_ids = os.environ.get("SMALLTTS_LOCAL_DEVICE_IDS")
        _use_device(int(local_ids.split(",")[0]) if local_ids else int(os.environ.get("LOCAL_RANK", pid)))
        dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=num, rank=pid)
    return _summary(coord)


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def global_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """Mesh over every rank of the job. dp defaults to world / tp. tp groups
    are consecutive ranks, so with ranks numbered host by host a tp group
    stays on one host (its all-reduces on NVLink) and dp crosses hosts."""
    return make_mesh(dp=dp, tp=tp)


def local_batch_to_global(batch: dict, mesh: Mesh) -> dict:
    """Each process's own slice of the global batch (local batch size =
    global / dp) -> this rank's rows of the global batch, as tensors, with
    `texts` dropped. The ranks of one tp group compute on the same rows, so
    with tp > 1 they take their group's first rank's slice."""
    out = {k: torch.as_tensor(v) for k, v in batch.items() if k != "texts"}
    if mesh.tp > 1 and mesh.tp_group is not None:
        src = mesh.ranks[mesh.dp_rank * mesh.tp]
        for t in out.values():
            dist.broadcast(t, src=src, group=mesh.tp_group)
    return out


def fetch_replicated(tree, mesh: Optional[Mesh] = None):
    """A tree of tensors -> CPU tensors, each tp-sharded leaf all-gathered
    over its tp group to the whole tensor (in the order shard_params split
    it). `mesh` defaults to the one in use; every rank of it must call."""
    from smalltts_tpu_torch.parallel.comm import gather_tree
    from smalltts_tpu_torch.utils.checkpoint import map_pytree

    mesh = mesh if mesh is not None else current()
    if mesh is not None and mesh.tp > 1 and mesh.tp_group is not None:
        tree = gather_tree(tree, mesh)
    return map_pytree(lambda t: torch.as_tensor(t).detach().cpu(), tree)


def save_on_coordinator(path: str, tree, mesh: Optional[Mesh] = None, meta: Optional[dict] = None) -> bool:
    """Single-writer checkpoint: rank 0 writes the npz (the JAX package's
    format, utils.checkpoint.save_pytree), every other rank returns False.
    Every rank takes part in the gather before the writer check, so
    tp-sharded state never deadlocks."""
    host_tree = fetch_replicated(tree, mesh)
    if not is_coordinator():
        return False
    from smalltts_tpu_torch.utils.checkpoint import save_pytree

    save_pytree(path, host_tree, meta)
    return True


def auto_mesh(dp: int = 0, tp: int = 1) -> Optional[Mesh]:
    """Trainer-CLI helper: one call that covers every launch mode.

    * a job in the environment (SMALLTTS_COORDINATOR, or a launcher's) ->
      join it and return a mesh over every rank, `dp` (when > 1) the global
      dp ways;
    * dp > 1 or tp > 1 in one process -> an error: one process drives one
      device here, so several ways need several processes;
    * otherwise -> None (single device).
    """
    info = initialize_from_env()
    if info["distributed"]:
        mesh = global_mesh(dp=dp if dp and dp > 1 else None, tp=tp)
        if is_coordinator():
            print(f"distributed: {info['num_processes']} processes, "
                  f"{info['global_devices']} global devices, mesh dp={mesh.dp} tp={mesh.tp}")
        return mesh
    if (dp and dp > 1) or tp > 1:
        n = max(dp or 1, 1) * tp
        raise RuntimeError(f"dp={dp} tp={tp} needs {n} processes, one per device: launch them with "
                           f"`torchrun --nproc-per-node {n} ...` or set SMALLTTS_COORDINATOR, "
                           "SMALLTTS_NUM_PROCESSES and SMALLTTS_PROCESS_ID in each")
    return None


def barrier(name: str = "smalltts") -> None:
    """Cross-process sync point (e.g. 'checkpoint written, all may read')."""
    if _initialized() and dist.get_world_size() > 1:
        dist.barrier()

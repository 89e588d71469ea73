"""Multi-process dry run: four local ranks, one global mesh, one teacher step
(port of scripts/dryrun_multihost.py).

One rank drives one device here, so where the JAX package runs two
processes of two devices each, this runs four gloo ranks. Each joins through
parallel.multihost.initialize_from_env (the SMALLTTS_* variables), forms the
global mesh, takes its rows of one seeded global batch through
local_batch_to_global, runs one teacher step of a tiny backbone, and writes a
single-writer checkpoint from rank 0. Two phases:

  phase 1  dp=4, tp=1: pure data parallel, the gradient all-reduce across
           every rank.
  phase 2  dp=2 x tp=2: tensor-parallel pairs on consecutive ranks (one host
           in production), data parallel across the pairs. The params and
           the EMA hold tp shards, so save_on_coordinator must all-gather
           them before the single write: this phase proves that path.

PASS (checked by the parent, per phase): every rank reports the same finite
loss; the loss is within 2e-4 relative of a single-process run of the same
step on the same global batch and draws; exactly one rank wrote the
checkpoint, and in phase 2 its leaves have the whole (unsharded) shapes.
The parent reaps every rank before it judges.

    python -m smalltts_tpu_torch.scripts.dryrun_multihost [--device cpu|cuda] [--backend gloo|nccl]

With --device cuda every rank runs on the card (all on one card where there
is one; NCCL refuses two ranks on one card, so use --backend gloo there) at a
head dim the attention kernel takes (64).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

NUM_PROCESSES = 4
GLOBAL_BATCH = 4
SEED = 11


def _config(device: str):
    """The tiny backbone of the port's CPU tests; on the card two heads of 64
    in every attention (the kernel's head dims)."""
    from smalltts_tpu_torch.models.backbone import BackboneConfig
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig

    if device == "cuda":
        h, heads, enc, enc_heads = 128, 2, 128, 2
    else:
        h, heads, enc, enc_heads = 64, 4, 32, 2
    dit = DiTConfig(latent_dim=64, phoneme_dim=enc, hidden_dim=h, n_blocks=2, heads=heads, rot_dim=8, conv_groups=16)
    return BackboneConfig(latent_dim=64, hidden_dim=h, phoneme_dim=enc, dit=dit,
                          text=EncoderConfig(enc, 2, enc_heads, 2 * enc, 1e-6),
                          style=EncoderConfig(enc, 2, enc_heads, 2 * enc, 1e-5))


def _make_global_batch():
    """The seeded global batch that every rank and the single-process check
    take their rows from."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    b, t_len, r, p = GLOBAL_BATCH, 12, 8, 10
    return {
        "latents": rng.randn(b, t_len, 64).astype(np.float32),
        "latents_lengths": np.full((b,), t_len, np.int32),
        "ref_latents": rng.randn(b, r, 64).astype(np.float32),
        "ref_latents_lengths": np.full((b,), r, np.int32),
        "phonemes": rng.randint(1, 190, size=(b, p)).astype(np.int32),
        "phonemes_lengths": np.full((b,), p, np.int32),
    }


def _run_step(cfg, mesh, batch, device, ckpt_path=None):
    """One teacher step from the same seeded init on every rank; the loss and
    whether this rank wrote the checkpoint."""
    import numpy as np
    import torch

    from smalltts_tpu_torch.models.backbone import init_backbone
    from smalltts_tpu_torch.parallel.mesh import global_draws, replicated, shard_params
    from smalltts_tpu_torch.parallel.multihost import save_on_coordinator
    from smalltts_tpu_torch.train.ema import ema_init
    from smalltts_tpu_torch.train.optim import adamw
    from smalltts_tpu_torch.train.teacher import make_teacher_step, teacher_draws

    params = init_backbone(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    if mesh is not None:
        params = replicated(params, mesh)
        if mesh.tp > 1:
            # the optimizer moments and the EMA mirror the params' shards, the layout a real tp run uses
            params = shard_params(params, mesh)
    tx = adamw(params, 1e-4)
    step = make_teacher_step(cfg, tx, mesh=mesh)
    draws = global_draws(teacher_draws, torch.Generator(device=device).manual_seed(3), batch, mesh)
    params, _, ema, loss = step(params, tx.init(params), ema_init(params), batch, draws, np.float32(0.9))
    wrote = False
    if ckpt_path is not None:
        if mesh.tp > 1:  # the point of phase 2: the EMA's leaves are shards, so the writer must gather
            assert mesh.layout, "expected tp-sharded params and EMA"
        wrote = save_on_coordinator(ckpt_path, ema, mesh)
    return float(loss), wrote


def worker(rank: int, coordinator: str, ckpt_path: str, tp: int, device: str, backend: str) -> None:
    os.environ["SMALLTTS_COORDINATOR"] = coordinator
    os.environ["SMALLTTS_NUM_PROCESSES"] = str(NUM_PROCESSES)
    os.environ["SMALLTTS_PROCESS_ID"] = str(rank)
    import torch

    torch.set_num_threads(1)
    from smalltts_tpu_torch.parallel.multihost import (
        barrier,
        global_mesh,
        initialize_from_env,
        local_batch_to_global,
        process_index,
    )

    info = initialize_from_env(backend)
    assert info["distributed"] and info["global_devices"] == NUM_PROCESSES, info
    # tp=1 -> dp=4 over every rank; tp=2 -> dp=2 with each tp pair on consecutive ranks
    mesh = global_mesh(tp=tp)
    assert (mesh.dp_rank, mesh.tp_rank) == divmod(rank, tp), (rank, mesh)
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    local = {k: torch.from_numpy(mesh.rows(v)).to(dev) for k, v in _make_global_batch().items()}
    batch = local_batch_to_global(local, mesh)
    for v in batch.values():
        assert v.shape[0] == GLOBAL_BATCH // mesh.dp, v.shape  # this rank's rows of the global batch

    loss, wrote = _run_step(_config(device), mesh, batch, dev, ckpt_path)
    barrier("dryrun-step-done")
    print(json.dumps({"rank": rank, "loss": loss, "wrote_ckpt": wrote, "process_index": process_index(),
                      "global_devices": info["global_devices"], "backend": info["backend"]}), flush=True)


def single_process_reference(device: str) -> float:
    """The same step in one process on the whole global batch: the anchor."""
    import torch

    dev = torch.device(device)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _make_global_batch().items()}
    loss, _ = _run_step(_config(device), None, batch, dev)
    return loss


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_phase(tp: int, ckpt_path: str, device: str, backend: str, timeout: float = 600) -> dict:
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SMALLTTS_", "MASTER_", "WORLD_SIZE", "RANK",
                                                                    "LOCAL_RANK"))}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "smalltts_tpu_torch.scripts.dryrun_multihost", "--worker", str(rank),
             coordinator, ckpt_path, str(tp), "--device", device, "--backend", backend],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
        for rank in range(NUM_PROCESSES)
    ]
    # reap every rank before judging: raising on the first failure would orphan
    # the others blocked in a collective (holding the coordinator's port) and
    # hide their error output
    outs, failures = {}, []
    for rank, p in enumerate(procs):
        try:
            outs[rank] = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            outs[rank] = p.communicate()
            failures.append(f"tp={tp} rank {rank} TIMED OUT")
        if p.returncode != 0:
            failures.append(f"tp={tp} rank {rank} FAILED rc={p.returncode}\n{outs[rank][1][-2000:]}")
    if failures:
        for p in procs:  # no worker may outlive the phase
            if p.poll() is None:
                p.kill()
        raise SystemExit("\n".join(failures))
    results = {}
    for rank, (out, _err) in outs.items():
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        results[rank] = json.loads(line)

    import math

    losses = [results[r]["loss"] for r in range(NUM_PROCESSES)]
    writers = [results[r]["wrote_ckpt"] for r in range(NUM_PROCESSES)]
    assert all(math.isfinite(x) for x in losses), losses
    assert len(set(losses)) == 1, f"tp={tp} replica divergence: {losses}"
    assert writers == [True] + [False] * (NUM_PROCESSES - 1), f"tp={tp} single-writer violated: {writers}"
    assert os.path.isfile(ckpt_path), f"tp={tp} coordinator ckpt missing"
    return {"tp": tp, "loss": losses[0], "ckpt": ckpt_path, "backend": results[0]["backend"]}


def _check_ckpt_shapes_full(ckpt_path: str, device: str) -> int:
    """Phase 2's guarantee: the gathered checkpoint holds whole tensors (the
    tp shards put back together, not stacked or truncated)."""
    import torch

    from smalltts_tpu_torch.models.backbone import init_backbone
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, load_pytree

    ref = flatten_pytree(init_backbone(torch.Generator().manual_seed(0), _config(device)))
    got = flatten_pytree(load_pytree(ckpt_path))
    assert {k: tuple(v.shape) for k, v in ref.items()} == {k: tuple(v.shape) for k, v in got.items()}, (
        "tp checkpoint shapes != full param shapes: the gather is broken")
    return len(got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Four-rank dry run of the port's data and tensor parallelism.")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "COORDINATOR", "CKPT", "TP"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, coordinator, ckpt, tp = args.worker
        worker(int(rank), coordinator, ckpt, int(tp), args.device, args.backend)
        return 0

    with tempfile.TemporaryDirectory(prefix="dryrun_multihost_") as tmp:
        r_dp = _run_phase(1, os.path.join(tmp, "ema_dp.npz"), args.device, args.backend)
        r_tp = _run_phase(2, os.path.join(tmp, "ema_dp_tp.npz"), args.device, args.backend)
        ref_loss = single_process_reference(args.device)
        n_leaves = _check_ckpt_shapes_full(r_tp["ckpt"], args.device)
    rels = {}
    for r in (r_dp, r_tp):
        rel = abs(r["loss"] - ref_loss) / max(abs(ref_loss), 1e-9)
        assert rel < 2e-4, f"tp={r['tp']} loss {r['loss']} != single-process {ref_loss} (rel {rel:.2e})"
        rels[f"rel_diff_tp{r['tp']}"] = rel
    print(json.dumps({
        "ok": True, "loss_dp": r_dp["loss"], "loss_dp_tp": r_tp["loss"], "single_process_loss": ref_loss, **rels,
        "tp_ckpt_leaves": n_leaves, "device": args.device, "backend": r_dp["backend"],
        "summary": f"{NUM_PROCESSES} ranks: dp=4 and dp=2 x tp=2 teacher steps replica-consistent, both match "
                   "single-process, single-writer checkpoints, tp ckpt gathered to full shapes",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

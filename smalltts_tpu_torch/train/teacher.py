"""Flow-matching teacher trainer (port of smalltts_tpu/train/teacher.py).

t = sigmoid(randn), shifted-cosine noising, masked velocity MSE, CFG
dropout (text 0.1 / speaker 0.1), AdamW 1.5e-4 with 1500 warmup steps then
cosine to 1e-5, grad-clip 1.0, EMA beta 0.9999 with ema_pytorch's warmup,
a save every 1500 steps.

The random draws of a step (the two CFG drop uniforms, t and the noise)
come from `teacher_draws`, apart from the loss, so a test can pass the JAX
package's draws in. The step keeps the JAX package's guard on the device:
on a non-finite loss or gradient norm the params, the moments and the
optimizer count stay as they were, and the EMA still updates; nothing in
the step waits for the card.

While a torch.profiler runs, a step is the span teacher.step
(utils/profiling.py) over teacher.forward, teacher.backward and
teacher.update, the last over teacher.guard (the dp all-reduce, the
finite check and the global norm), teacher.optimizer (AdamW, its updates
applied and the guard's selects) and teacher.ema.

    python -m smalltts_tpu_torch.train.teacher --steps N [--batch-size 16]
        [--compute-dtype bfloat16] [--resume DIR/train_state.npz] [--dp N]
        [--checkpoint-dir assets/teacher_checkpoints] [--data-dir DIR] [--codec-checkpoint C]
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from smalltts_tpu_torch.models.backbone import BackboneConfig, backbone_forward, init_backbone
from smalltts_tpu_torch.ops.masking import length_mask, masked_mse
from smalltts_tpu_torch.ops.precision import DTYPES, cast_floats
from smalltts_tpu_torch.ops.schedule import apply_noise
from smalltts_tpu_torch.parallel import comm
from smalltts_tpu_torch.parallel.mesh import use
from smalltts_tpu_torch.train.ema import ema_decay, ema_init, ema_update
from smalltts_tpu_torch.train.optim import apply_updates, global_norm, teacher_optimizer
from smalltts_tpu_torch.utils import profiling
from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, unflatten_pytree


@dataclass(frozen=True)
class TeacherTrainConfig:
    num_steps: int = 330_000
    batch_size: int = 2
    save_every: int = 1_500
    text_cfg_drop: float = 0.10
    speaker_cfg_drop: float = 0.10
    ema_beta: float = 0.9999
    remat: bool = False
    # forward/backward compute dtype; master params, moments and EMA stay float32 (ops/precision.py)
    compute_dtype: str = "float32"


def teacher_draws(gen: torch.Generator, batch):
    """One step's random draws from `gen`, on the batch's device: the
    uniforms of the text and speaker CFG drops (B,), t = sigmoid(randn) (B,)
    and the noise, the latents' shape."""
    lat = batch["latents"]
    b, dev = lat.shape[0], lat.device
    return {"text_u": torch.rand((b,), generator=gen, device=dev),
            "speaker_u": torch.rand((b,), generator=gen, device=dev),
            "t": torch.sigmoid(torch.randn((b,), generator=gen, device=dev)),
            "noise": torch.randn(lat.shape, generator=gen, device=dev, dtype=lat.dtype)}


def apply_cfg_drops(batch, text_mask, speaker_mask):
    """Zero the text (phonemes and their lengths) where text_mask (B,) and
    the reference (latents and lengths) where speaker_mask (B,)."""
    zero = torch.zeros((), dtype=batch["ref_latents"].dtype, device=text_mask.device)
    phonemes = torch.where(text_mask[:, None], 0, batch["phonemes"])
    ph_lengths = torch.where(text_mask, 0, batch["phonemes_lengths"])
    ref = torch.where(speaker_mask[:, None, None], zero, batch["ref_latents"])
    ref_lengths = torch.where(speaker_mask, 0, batch["ref_latents_lengths"])
    return phonemes, ph_lengths, ref, ref_lengths


def teacher_loss(params, cfg: BackboneConfig, batch, draws, train_cfg: TeacherTrainConfig = TeacherTrainConfig()):
    """Masked velocity MSE of one batch with the given draws, in float32."""
    phonemes, ph_lengths, ref, ref_lengths = apply_cfg_drops(
        batch, draws["text_u"] < train_cfg.text_cfg_drop, draws["speaker_u"] < train_cfg.speaker_cfg_drop)
    latents = batch["latents"]
    ph_mask = length_mask(ph_lengths, phonemes.shape[1])
    mask = length_mask(batch["latents_lengths"], latents.shape[1])
    noised, v_target = apply_noise(latents, draws["t"], draws["noise"])
    cdt = DTYPES[train_cfg.compute_dtype]
    if cdt != torch.float32:
        # the bf16 compute view: gradients reach the fp32 masters through the cast
        params = cast_floats(params, cdt)
        noised, ref = noised.to(cdt), ref.to(cdt)
    velocity = backbone_forward(params, cfg, noised, ref, ref_lengths, mask, phonemes, ph_mask, draws["t"])
    return masked_mse(velocity, v_target, mask)


def _where(cond, new, old):
    flat_old = flatten_pytree(old)
    return unflatten_pytree({k: torch.where(cond, v, flat_old[k]) for k, v in flatten_pytree(new).items()})


def make_teacher_step(cfg: BackboneConfig, tx, train_cfg: TeacherTrainConfig = TeacherTrainConfig(), mesh=None):
    """step(params, opt_state, ema_params, batch, draws, ema_decay=None) ->
    (params, opt_state, ema_params, loss): new trees; `ema_decay` is the
    scheduled decay (train/ema.ema_decay), train_cfg.ema_beta without it.

    With a `mesh` (parallel/mesh.py) the step is the JAX package's step on
    the global batch: `batch` and `draws` hold this rank's dp rows of it,
    the loss is the global batch's on every rank, the gradients are summed
    over dp before the guard, the clip and AdamW, and `params` may hold
    this rank's tensor-parallel shards (shard_params with this mesh), the
    guard's and the clip's norm then the whole tree's."""

    def step(params, opt_state, ema_params, batch, draws, ema_decay=None):
        with profiling.annotate("teacher.step"):
            flat = flatten_pytree(params)
            leaves = [p.detach().requires_grad_(True) for p in flat.values()]
            with torch.enable_grad(), use(mesh):
                with profiling.annotate("teacher.forward"):
                    loss = teacher_loss(unflatten_pytree(dict(zip(flat, leaves))), cfg, batch, draws, train_cfg)
                with profiling.annotate("teacher.backward"):
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            with torch.no_grad(), profiling.annotate("teacher.update"):
                with profiling.annotate("teacher.guard"):
                    grads = comm.all_reduce_grads(
                        [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)], mesh)
                    params = unflatten_pytree(dict(zip(flat, (p.detach() for p in leaves))))
                    finite = torch.isfinite(loss) & torch.isfinite(global_norm(grads, list(flat), mesh))
                    zero = torch.zeros((), device=loss.device)
                    grads = unflatten_pytree({k: torch.where(finite, g, zero) for k, g in zip(flat, grads)})
                with profiling.annotate("teacher.optimizer"):
                    updates, new_state = tx.update(grads, opt_state, params, mesh)
                    params = _where(finite, apply_updates(params, updates), params)
                    opt_state = _where(finite, new_state, opt_state)
                with profiling.annotate("teacher.ema"):
                    ema_params = ema_update(ema_params, params,
                                            train_cfg.ema_beta if ema_decay is None else ema_decay)
            return params, opt_state, ema_params, loss.detach()

    return step


def _draw_seed(seed: int, start_step: int) -> int:
    """The draws' generator seed: a run resumed at start_step draws a stream
    of its own, not the one step 0 drew."""
    return int(np.random.SeedSequence([seed, start_step]).generate_state(1)[0])


def train_teacher(
    train_cfg: TeacherTrainConfig = TeacherTrainConfig(),
    model_cfg: Optional[BackboneConfig] = None,
    data_iter=None,
    seed: int = 0,
    checkpoint_dir: str = "assets/teacher_checkpoints",
    pretrained: Optional[str] = None,
    resume_from: Optional[str] = None,
    log_every: int = 100,
    device=None,
    on_step=None,
    mesh=None,
):
    """The training loop, on the dummy data unless `data_iter` yields
    batches (dicts of numpy arrays). Runs on the card unless `device` says
    otherwise. With a `mesh` (parallel.multihost.auto_mesh) it is data
    parallel: each process's batches are its slice of the global batch
    (train_cfg.batch_size per process), the params are replicated from
    rank 0, every rank draws the global batch's draws and keeps its rows,
    and only rank 0 writes checkpoints and metrics. Every save_every steps (past step 1) it writes
    checkpoint_latest.npz and checkpoint_ema.npz (the JAX package's format
    and layout, with the config as metadata) and train_state.npz (the
    port's own) into checkpoint_dir, off the training thread. `on_step(step,
    loss)`, when given, is called after each step with the loss on the
    device. `pretrained`, a reference torch checkpoint (.pt/.pth/.bin) of
    `model_cfg`'s shape, gives the starting params in place of the init.
    Returns (params, ema_params)."""
    from smalltts_tpu_torch.data.dummy import get_dummy_dataloader
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.parallel.mesh import global_draws, replicated
    from smalltts_tpu_torch.parallel.multihost import is_coordinator, local_batch_to_global
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_meta
    from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax
    from smalltts_tpu_torch.utils.profiling import MetricsLogger
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    dev = resolve_device(device)
    model_cfg = model_cfg or BackboneConfig(dit=DiTConfig(remat=train_cfg.remat))
    gen = torch.Generator(device=dev).manual_seed(seed)
    if pretrained:
        params = ckpt.map_pytree(lambda t: t.to(dev),
                            params_from_jax(ckpt.load_reference_backbone_checkpoint(pretrained), model_cfg))
    else:
        params = init_backbone(gen, model_cfg, device=dev)
    if mesh is not None:
        params = replicated(params, mesh)
    tx, sched = teacher_optimizer(params, train_cfg.num_steps)
    opt_state = tx.init(params)
    ema_params = ema_init(params)

    start_step = 0
    if resume_from:
        state = ckpt.load_train_state(resume_from, dev)
        params, opt_state, ema_params = state["params"], state["opt_state"], state["ema"]
        start_step = int(state["step"])
        print(f"resumed from {resume_from} at step {start_step}")
    draw_gen = torch.Generator(device=dev).manual_seed(_draw_seed(seed, start_step))

    step_fn = make_teacher_step(model_cfg, tx, train_cfg, mesh=mesh)
    data_iter = data_iter or get_dummy_dataloader(train_cfg.batch_size, seed + start_step)
    saver = ckpt.AsyncCheckpointer()
    writer = is_coordinator()  # single-writer checkpoints and coordinator-only logs
    logger = MetricsLogger(os.path.join(checkpoint_dir, "metrics.jsonl") if writer else None, echo=writer)
    try:
        for step in range(start_step, train_cfg.num_steps):
            batch = {k: to_device(v, dev) for k, v in next(data_iter).items() if k != "texts"}
            if mesh is not None:
                batch = local_batch_to_global(batch, mesh)
            decay = ema_decay(step, train_cfg.ema_beta)
            params, opt_state, ema_params, loss = step_fn(
                params, opt_state, ema_params, batch, global_draws(teacher_draws, draw_gen, batch, mesh),
                np.float32(decay))
            if on_step is not None:
                on_step(step, loss)
            if step % log_every == 0 and writer:
                logger.log({"teacher_loss": float(loss), "lr": float(sched(step)), "ema_decay": decay}, step)
            if step % train_cfg.save_every == 0 and step > 1 and writer:
                saver.wait()  # the previous save is on disk before the next snapshot
                meta = backbone_meta(model_cfg)
                saver.save_pytree(f"{checkpoint_dir}/checkpoint_latest.npz", params_to_jax(params), meta)
                saver.save_pytree(f"{checkpoint_dir}/checkpoint_ema.npz", params_to_jax(ema_params), meta)
                saver.save_train_state(f"{checkpoint_dir}/train_state.npz", {
                    "params": params, "opt_state": opt_state, "ema": ema_params,
                    "step": torch.tensor(step, dtype=torch.int32)})
    finally:
        saver.close()
        logger.close()
    return params, ema_params


def main(argv=None) -> None:
    from smalltts_tpu_torch.data.local import cli_data_iter

    ap = argparse.ArgumentParser(description="Train the flow-matching teacher on the card.")
    ap.add_argument("--steps", type=int, default=330_000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="forward/backward compute dtype; masters stay fp32 (ops/precision.py)")
    ap.add_argument("--pretrained", default=None,
                    help="a reference torch checkpoint (.pt/.pth/.bin) to fine-tune from")
    ap.add_argument("--resume", default=None, help="a train_state.npz written by this trainer")
    ap.add_argument("--dp", type=int, default=0, help="data-parallel ways (0 = single device)")
    ap.add_argument("--checkpoint-dir", default="assets/teacher_checkpoints")
    ap.add_argument("--data-dir", default=None,
                    help="local corpus: metadata.csv ('wav|text') or paired .wav/.txt files "
                         "(default: dummy random tensors)")
    ap.add_argument("--codec-checkpoint", default=None,
                    help="native codec weights for corpus encoding (with assets/codec/*.onnx present the "
                         "imported encoder is used instead)")
    args = ap.parse_args(argv)
    from smalltts_tpu_torch.parallel.multihost import auto_mesh

    # single device, or a job of several processes (SMALLTTS_COORDINATOR/NUM_PROCESSES/PROCESS_ID, or
    # torchrun's variables; parallel/multihost.py): then --batch-size is per process and checkpoints
    # and logs are rank 0's
    mesh = auto_mesh(dp=args.dp, tp=1)
    train_teacher(TeacherTrainConfig(num_steps=args.steps, batch_size=args.batch_size,
                                     compute_dtype=args.compute_dtype),
                  pretrained=args.pretrained, resume_from=args.resume, checkpoint_dir=args.checkpoint_dir,
                  data_iter=cli_data_iter(args.data_dir, args.codec_checkpoint, args.batch_size), mesh=mesh)


if __name__ == "__main__":
    main()

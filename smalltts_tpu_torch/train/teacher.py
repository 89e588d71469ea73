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

    python -m smalltts_tpu_torch.train.teacher --steps N [--batch-size 16]
        [--compute-dtype bfloat16] [--resume DIR/train_state.npz]
        [--checkpoint-dir assets/teacher_checkpoints]
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
from smalltts_tpu_torch.train.ema import ema_decay, ema_init, ema_update
from smalltts_tpu_torch.train.optim import apply_updates, global_norm, teacher_optimizer
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


def make_teacher_step(cfg: BackboneConfig, tx, train_cfg: TeacherTrainConfig = TeacherTrainConfig()):
    """step(params, opt_state, ema_params, batch, draws, ema_decay=None) ->
    (params, opt_state, ema_params, loss): new trees; `ema_decay` is the
    scheduled decay (train/ema.ema_decay), train_cfg.ema_beta without it."""

    def step(params, opt_state, ema_params, batch, draws, ema_decay=None):
        flat = flatten_pytree(params)
        leaves = [p.detach().requires_grad_(True) for p in flat.values()]
        with torch.enable_grad():
            loss = teacher_loss(unflatten_pytree(dict(zip(flat, leaves))), cfg, batch, draws, train_cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            params = unflatten_pytree(dict(zip(flat, (p.detach() for p in leaves))))
            finite = torch.isfinite(loss) & torch.isfinite(global_norm(grads))
            zero = torch.zeros((), device=loss.device)
            grads = unflatten_pytree({k: torch.where(finite, g, zero) for k, g in zip(flat, grads)})
            updates, new_state = tx.update(grads, opt_state, params)
            params = _where(finite, apply_updates(params, updates), params)
            opt_state = _where(finite, new_state, opt_state)
            ema_params = ema_update(ema_params, params, train_cfg.ema_beta if ema_decay is None else ema_decay)
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
):
    """The training loop, on the dummy data unless `data_iter` yields
    batches (dicts of numpy arrays). Runs on the card unless `device` says
    otherwise. Every save_every steps (past step 1) it writes
    checkpoint_latest.npz and checkpoint_ema.npz (the JAX package's format
    and layout, with the config as metadata) and train_state.npz (the
    port's own) into checkpoint_dir, off the training thread. `on_step(step,
    loss)`, when given, is called after each step with the loss on the
    device. `pretrained`, a reference torch checkpoint (.pt/.pth/.bin) of
    `model_cfg`'s shape, gives the starting params in place of the init.
    Returns (params, ema_params)."""
    from smalltts_tpu_torch.data.dummy import get_dummy_dataloader
    from smalltts_tpu_torch.models.dit import DiTConfig
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

    step_fn = make_teacher_step(model_cfg, tx, train_cfg)
    data_iter = data_iter or get_dummy_dataloader(train_cfg.batch_size, seed + start_step)
    saver = ckpt.AsyncCheckpointer()
    logger = MetricsLogger(os.path.join(checkpoint_dir, "metrics.jsonl"))
    try:
        for step in range(start_step, train_cfg.num_steps):
            batch = {k: to_device(v, dev) for k, v in next(data_iter).items() if k != "texts"}
            decay = ema_decay(step, train_cfg.ema_beta)
            params, opt_state, ema_params, loss = step_fn(
                params, opt_state, ema_params, batch, teacher_draws(draw_gen, batch), np.float32(decay))
            if on_step is not None:
                on_step(step, loss)
            if step % log_every == 0:
                logger.log({"teacher_loss": float(loss), "lr": float(sched(step)), "ema_decay": decay}, step)
            if step % train_cfg.save_every == 0 and step > 1:
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
    ap = argparse.ArgumentParser(description="Train the flow-matching teacher on the card (dummy data).")
    ap.add_argument("--steps", type=int, default=330_000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--compute-dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="forward/backward compute dtype; masters stay fp32 (ops/precision.py)")
    ap.add_argument("--pretrained", default=None,
                    help="a reference torch checkpoint (.pt/.pth/.bin) to fine-tune from")
    ap.add_argument("--resume", default=None, help="a train_state.npz written by this trainer")
    ap.add_argument("--checkpoint-dir", default="assets/teacher_checkpoints")
    args = ap.parse_args(argv)
    train_teacher(TeacherTrainConfig(num_steps=args.steps, batch_size=args.batch_size,
                                     compute_dtype=args.compute_dtype),
                  pretrained=args.pretrained, resume_from=args.resume, checkpoint_dir=args.checkpoint_dir)


if __name__ == "__main__":
    main()

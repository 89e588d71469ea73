"""The latent-domain ASR's CTC trainer (port of
smalltts_tpu/train/asr_train.py): batch 2, 200k steps, AdamW 1e-4 with 4000
warmup steps then cosine to 1e-5, a save every 2000 steps. Its checkpoint is
the frozen ASR that train/distill.py loads.

The step is functional (new trees back), and the BatchNorm running
statistics its forward moves are the params the update applies to, as in
JAX. On the card the conformer's attention runs the head-dim-4 kernel and
the CTC loss the recurrence kernels (ops/kernels/ctc).

    python -m smalltts_tpu_torch.train.asr_train [--steps 200000] [--batch-size 2]
        [--checkpoint-dir assets/asr_checkpoints] [--data-dir DIR] [--data-codec-checkpoint C]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import torch

from smalltts_tpu_torch.models.asr import ASRConfig, asr_forward, init_asr
from smalltts_tpu_torch.ops.losses import ctc_loss
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.train.optim import apply_updates, value_and_grad
from smalltts_tpu_torch.utils.checkpoint import map_pytree


@dataclass(frozen=True)
class ASRTrainConfig:
    num_steps: int = 200_000
    batch_size: int = 2
    save_every: int = 2_000
    warmup: int = 4_000


def asr_ctc_loss(params, cfg: ASRConfig, batch, train: bool = True):
    """(the mean over the batch of each sample's CTC loss over its label
    count, the params with the BatchNorm running statistics moved)."""
    log_probs, out_lens, new_params = asr_forward(params, cfg, batch["latents"], batch["latents_lengths"], train=train)
    logit_pad = 1.0 - length_mask(out_lens, log_probs.shape[1]).float()
    ph, ph_len = batch["phonemes"], batch["phonemes_lengths"]
    label_pad = 1.0 - length_mask(ph_len, ph.shape[1]).float()
    per = ctc_loss(log_probs, logit_pad, ph, label_pad)
    return (per / torch.clamp_min(ph_len.float(), 1.0)).mean(), new_params


def make_asr_step(cfg: ASRConfig, tx):
    """step(params, opt_state, batch) -> (params, opt_state, loss): the
    update computed against the params (weight decay), applied to the
    params with moved BatchNorm statistics."""

    def step(params, opt_state, batch):
        loss, new_params, grads = value_and_grad(params, lambda p: asr_ctc_loss(p, cfg, batch))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(map_pytree(torch.Tensor.detach, new_params), updates)
        return params, opt_state, loss

    return step


def train_asr(
    train_cfg: ASRTrainConfig = ASRTrainConfig(),
    model_cfg: ASRConfig = ASRConfig(),
    data_iter=None,
    seed: int = 0,
    checkpoint_dir: str = "assets/asr_checkpoints",
    log_every: int = 100,
    device=None,
    on_step=None,
):
    """The training loop, on the dummy data unless `data_iter` yields
    batches (dicts of numpy arrays); on the card unless `device` says
    otherwise. The init draws from a torch.Generator seeded with `seed`. At
    step % save_every == 0 past step 1 it writes checkpoint_latest.npz in
    the JAX package's format and layout. `on_step(step, loss)`, when given,
    is called after each step with the loss on the device. Returns the
    params."""
    from smalltts_tpu_torch.data.dummy import get_dummy_dataloader
    from smalltts_tpu_torch.train.optim import aux_optimizer
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    dev = resolve_device(device)
    params = init_asr(torch.Generator(device=dev).manual_seed(seed), model_cfg, device=dev)
    tx, _ = aux_optimizer(params, train_cfg.num_steps, train_cfg.warmup)
    opt_state = tx.init(params)
    step_fn = make_asr_step(model_cfg, tx)
    data_iter = data_iter or get_dummy_dataloader(train_cfg.batch_size, seed)
    for step in range(train_cfg.num_steps):
        batch = {k: to_device(v, dev) for k, v in next(data_iter).items() if k != "texts"}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if on_step is not None:
            on_step(step, loss)
        if step % log_every == 0:
            print(f"step {step}: asr_ctc={float(loss):.4f}")
        if step % train_cfg.save_every == 0 and step > 1:
            ckpt.save_pytree(f"{checkpoint_dir}/checkpoint_latest.npz", params_to_jax(params, model_cfg))
    return params


def main(argv=None) -> None:
    from smalltts_tpu_torch.data.local import cli_data_iter

    ap = argparse.ArgumentParser(description="Train the latent-domain ASR (CTC) on the card.")
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--checkpoint-dir", default="assets/asr_checkpoints")
    ap.add_argument("--data-dir", default=None,
                    help="local corpus (metadata.csv or paired .wav/.txt); default: dummy random tensors")
    ap.add_argument("--data-codec-checkpoint", default=None, help="native codec weights for corpus encoding")
    args = ap.parse_args(argv)
    train_asr(ASRTrainConfig(num_steps=args.steps, batch_size=args.batch_size), checkpoint_dir=args.checkpoint_dir,
              data_iter=cli_data_iter(args.data_dir, args.data_codec_checkpoint, args.batch_size))


if __name__ == "__main__":
    main()

"""The latent-domain SV trainer (port of smalltts_tpu/train/sv_train.py):
the ECAPA over codec latents learns to match a waveform speaker encoder by
cosine loss. Latents are decoded to audio in the step, the frozen teacher
embeds the audio up to each utterance's length, a row whose teacher
embedding is not finite is left out of the loss, gradients are clipped at
norm 5; AdamW 1e-4, 200k steps, a save every 1000. Its checkpoint is the
frozen SV that train/distill.py loads.

The teacher is `teacher_fn(teacher_params, audio, lengths)`: the converted
speechbrain ECAPA of models/sv_teacher.py where its checkpoint is given,
else `make_fallback_teacher`, a fixed random convolution with tanh and
masked mean pooling. Its weight is drawn from a torch.Generator, so its
values are not the JAX package's; a test passes the JAX package's weight in.

    python -m smalltts_tpu_torch.train.sv_train [--steps 200000] [--batch-size 2]
        [--codec-checkpoint C] [--teacher-checkpoint T] [--checkpoint-dir assets/sv_checkpoints]
        [--data-dir DIR] [--data-codec-checkpoint C]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode
from smalltts_tpu_torch.models.sv import SVConfig, init_sv, sv_forward
from smalltts_tpu_torch.ops import nn
from smalltts_tpu_torch.ops.losses import cosine_loss
from smalltts_tpu_torch.train.optim import apply_updates, value_and_grad
from smalltts_tpu_torch.utils.checkpoint import map_pytree


@dataclass(frozen=True)
class SVTrainConfig:
    num_steps: int = 200_000
    batch_size: int = 2
    save_every: int = 1_000
    grad_clip: float = 5.0


def make_fallback_teacher(emb_dim: int = 192, seed: int = 1234, device="cpu"):
    """The stand-in waveform embedder where no pretrained speaker encoder is
    given: a fixed random convolution (256 taps, stride 128, `emb_dim`
    channels, weight N(0, 1) / 16 in the JAX package's (k, 1, emb_dim)
    layout), tanh, and the mean over the frames that lie within `lengths`.
    -> (teacher_fn(teacher_params, audio (B, 1, T), lengths=None), teacher_params)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((256, 1, emb_dim), generator=gen, device=device) / 16.0

    def teacher_fn(tp, audio: torch.Tensor, lengths=None) -> torch.Tensor:
        with nn.no_tf32():
            feats = torch.tanh(F.conv1d(audio, tp["w"].permute(2, 1, 0), stride=128).transpose(1, 2))  # (B, F, emb)
        if lengths is None:
            return feats.mean(dim=1)
        n_frames = torch.clamp((lengths - 256) // 128 + 1, 1, feats.shape[1])
        m = (torch.arange(feats.shape[1], device=feats.device)[None, :] < n_frames[:, None])[..., None].to(feats.dtype)
        return (feats * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)

    return teacher_fn, {"w": w}


def make_sv_step(cfg: SVConfig, codec_cfg: CodecConfig, tx, teacher_fn: Callable):
    """step(params, opt_state, codec_params, teacher_params, batch) ->
    (params, opt_state, loss): the latents decoded by the codec and embedded
    by the teacher without grad; the cosine loss averaged over the rows with
    a finite teacher embedding; the update against the params, applied to
    the params with moved BatchNorm statistics."""

    def step(params, opt_state, codec_params, teacher_params, batch):
        latents, lengths = batch["latents"], batch["latents_lengths"]
        with torch.no_grad():
            audio = codec_decode(codec_params, latents, codec_cfg)
            # the teacher masked to each utterance's samples, as the student masks its frames
            true_emb = teacher_fn(teacher_params, audio, lengths * codec_cfg.hop)
            bad = (~torch.isfinite(true_emb)).any(dim=-1)
            true_emb = torch.nan_to_num(true_emb)

        def loss_fn(p):
            emb, new_p = sv_forward(p, cfg, latents, lengths, train=True)
            per = torch.where(bad, 0.0, cosine_loss(emb, true_emb))
            return per.sum() / torch.clamp_min((~bad).sum(), 1), new_p

        loss, new_params, grads = value_and_grad(params, loss_fn)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(map_pytree(torch.Tensor.detach, new_params), updates)
        return params, opt_state, loss

    return step


def train_sv(
    train_cfg: SVTrainConfig = SVTrainConfig(),
    model_cfg: SVConfig = SVConfig(),
    codec_cfg: CodecConfig = CodecConfig(),
    codec_params=None,
    teacher_fn: Optional[Callable] = None,
    teacher_params=None,
    data_iter=None,
    seed: int = 0,
    checkpoint_dir: str = "assets/sv_checkpoints",
    log_every: int = 100,
    device=None,
    on_step=None,
):
    """The training loop, on the dummy data unless `data_iter` yields
    batches (dicts of numpy arrays); on the card unless `device` says
    otherwise. The SV's init draws from a torch.Generator seeded with
    `seed`, a codec's (where `codec_params`, the port's tree, is not given)
    from one seeded with seed + 1; the teacher is `make_fallback_teacher`
    unless `teacher_fn` is given. At step % save_every == 0 past step 1 it
    writes checkpoint_latest.npz in the JAX package's format and layout.
    `on_step(step, loss)`, when given, is called after each step with the
    loss on the device. Returns the params."""
    from smalltts_tpu_torch.data.dummy import get_dummy_dataloader
    from smalltts_tpu_torch.models.codec import init_codec
    from smalltts_tpu_torch.train.optim import aux_optimizer
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    dev = resolve_device(device)
    params = init_sv(torch.Generator(device=dev).manual_seed(seed), model_cfg, device=dev)
    if codec_params is None:
        codec_params = init_codec(torch.Generator(device=dev).manual_seed(seed + 1), codec_cfg, device=dev)
    codec_params = map_pytree(lambda t: t.to(dev), codec_params)
    if teacher_fn is None:
        teacher_fn, teacher_params = make_fallback_teacher(model_cfg.emb_dim, device=dev)
    teacher_params = map_pytree(lambda t: t.to(dev), teacher_params)
    tx, _ = aux_optimizer(params, train_cfg.num_steps, 4_000, clip_norm=train_cfg.grad_clip)
    opt_state = tx.init(params)
    step_fn = make_sv_step(model_cfg, codec_cfg, tx, teacher_fn)
    data_iter = data_iter or get_dummy_dataloader(train_cfg.batch_size, seed)
    for step in range(train_cfg.num_steps):
        batch = {k: to_device(v, dev) for k, v in next(data_iter).items() if k != "texts"}
        params, opt_state, loss = step_fn(params, opt_state, codec_params, teacher_params, batch)
        if on_step is not None:
            on_step(step, loss)
        if step % log_every == 0:
            print(f"step {step}: sv_cosine={float(loss):.4f}")
        if step % train_cfg.save_every == 0 and step > 1:
            ckpt.save_pytree(f"{checkpoint_dir}/checkpoint_latest.npz", params_to_jax(params, model_cfg))
    return params


def main(argv=None) -> None:
    from smalltts_tpu_torch.data.local import cli_data_iter
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.convert import params_from_jax
    from smalltts_tpu_torch.utils.transfer import resolve_device

    ap = argparse.ArgumentParser(description="Train the latent-domain SV against a waveform teacher on the card.")
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--codec-checkpoint", default=None)
    ap.add_argument("--checkpoint-dir", default="assets/sv_checkpoints")
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="speechbrain embedding_model.ckpt (torch) or an .npz of the voxceleb ECAPA teacher; "
                         "falls back to the deterministic stand-in when omitted")
    ap.add_argument("--data-dir", default=None,
                    help="local corpus (metadata.csv or paired .wav/.txt); default: dummy random tensors")
    ap.add_argument("--data-codec-checkpoint", default=None, help="native codec weights for corpus encoding")
    args = ap.parse_args(argv)
    codec_params = (params_from_jax(ckpt.load_pytree(args.codec_checkpoint), CodecConfig())
                    if args.codec_checkpoint else None)
    teacher_fn = teacher_params = None
    if args.teacher_checkpoint:
        from smalltts_tpu_torch.models.sv_teacher import load_teacher, make_teacher_fn

        teacher_fn, teacher_params = make_teacher_fn(load_teacher(args.teacher_checkpoint, resolve_device(None)))
    train_sv(SVTrainConfig(num_steps=args.steps, batch_size=args.batch_size), codec_params=codec_params,
             teacher_fn=teacher_fn, teacher_params=teacher_params, checkpoint_dir=args.checkpoint_dir,
             data_iter=cli_data_iter(args.data_dir, args.data_codec_checkpoint, args.batch_size))


if __name__ == "__main__":
    main()

"""DMD2 distillation of the 128-step teacher into the 4-step student (port
of smalltts_tpu/train/distill.py).

One iteration is three steps, in this order, each seeing the params the
JAX package gives it:

1. the student step (`make_student_step`), with the scorer before its
   update: `targets` without grad (backward simulation over TIMESTEPS, the
   frozen teacher's double-CFG x0 on a 3x batch, the scorer's x0 and
   features, the DMD target in float32), then `update`, which recomputes the
   student's x0 with grad: a pseudo-MSE to the target, 1e-3 x the LSGAN
   generator loss through the frozen discriminator (its gradient reaches the
   student through x_t = apply_noise(x0, ts, noise_t) and the
   discriminator's audio_proj), the frozen ASR's CTC loss (step >
   asr_start_step) and the frozen SV's cosine loss (step > sv_start_step);
   below a gate that model does not run and its metric is 0.0;
2. the discriminator step (`make_disc_step`) on [real | fake], the fake
   half the update's x_t and the scorer's features from step 1;
3. the scorer step (`make_scorer_step`): `scorer_updates` flow-matching
   updates, each on the updated student's x0 re-noised at t_cur.

The frozen discriminator, ASR and SV get no gradient (their params do not
require one). With compute_dtype "bfloat16" the frozen teacher is stored in
bf16, the student, scorer and discriminator keep float32 masters and run
their backbone forwards through bf16 views, every x0 is upcast at each
boundary, and the discriminator, ASR and SV run in float32. As in the JAX
package, no step guards against a non-finite loss.

The random draws of each step come from `student_draws`, `disc_draws` and
`scorer_draws`, apart from the math, so a test can pass the JAX package's
draws in.

    python -m smalltts_tpu_torch.train.distill --teacher T.npz --asr A.npz --sv S.npz
        [--steps 40000] [--batch-size 2] [--checkpoint-dir assets/dmd_checkpoints]
        [--data-dir DIR] [--data-codec-checkpoint C] [--dp N]
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, replace
from typing import Optional

import torch

from smalltts_tpu_torch.models.asr import ASRConfig, asr_forward
from smalltts_tpu_torch.models.backbone import BackboneConfig, backbone_forward, cfg_velocity
from smalltts_tpu_torch.models.discriminator import DiscriminatorConfig, discriminator_forward
from smalltts_tpu_torch.models.style_encoder import style_encoder
from smalltts_tpu_torch.models.sv import SVConfig, sv_forward
from smalltts_tpu_torch.ops.losses import cosine_loss, ctc_loss
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.ops.precision import DTYPES, cast_floats
from smalltts_tpu_torch.ops.schedule import apply_noise, x_pred_from_velocity
from smalltts_tpu_torch.parallel import comm
from smalltts_tpu_torch.parallel.mesh import use
from smalltts_tpu_torch.train.optim import apply_updates, value_and_grad
from smalltts_tpu_torch.utils.checkpoint import map_pytree

TIMESTEPS = (1.0, 1.0, 0.75, 0.50, 0.25)
SCORER_UPDATES = 5
CFG_SCALE_TEXT = 2.0
CFG_SCALE_SPEAKER = 1.5


@dataclass(frozen=True)
class DistillConfig:
    num_steps: int = 40_000
    batch_size: int = 2
    save_every: int = 800
    asr_start_step: int = 5_000
    sv_start_step: int = 7_000
    gan_weight: float = 1e-3
    scorer_updates: int = SCORER_UPDATES
    # the backbone forwards' compute dtype; masters, targets and every loss stay float32
    compute_dtype: str = "float32"


def _x_pred(params, cfg, x_t, ref, ref_len, mask, ph, ph_mask, t, return_features=False):
    """velocity -> x0 estimate, and with return_features the DiT's features."""
    out = backbone_forward(params, cfg, x_t, ref, ref_len, mask, ph, ph_mask, t, return_features=return_features)
    if return_features:
        velocity, feats = out
        return x_pred_from_velocity(x_t, velocity, t), feats
    return x_pred_from_velocity(x_t, out, t)


def _x_pred_cfg(params, cfg, x_t, ref, ref_len, mask, ph, ph_mask, t):
    """The teacher's x0 with double CFG (text 2.0, speaker 1.5)."""
    velocity = cfg_velocity(params, cfg, x_t, ref, ref_len, mask, ph, ph_mask, t, CFG_SCALE_TEXT, CFG_SCALE_SPEAKER)
    return x_pred_from_velocity(x_t, velocity, t)


def _unpack(batch):
    latents, ph = batch["latents"], batch["phonemes"]
    return (latents, batch["latents_lengths"], length_mask(batch["latents_lengths"], latents.shape[1]), ph,
            batch["phonemes_lengths"], length_mask(batch["phonemes_lengths"], ph.shape[1]),
            batch["ref_latents"], batch["ref_latents_lengths"])


def student_draws(gen: torch.Generator, batch):
    """The student step's draws from `gen`: the backward-simulation index
    (B,) in [0, len(TIMESTEPS) - 1), the noises at t_prev and t_cur, ts (B,)
    uniform and noise_t, the latents' shape."""
    lat = batch["latents"]
    b, dev = lat.shape[0], lat.device
    noise = lambda: torch.randn(lat.shape, generator=gen, device=dev)  # noqa: E731
    return {"idx": torch.randint(0, len(TIMESTEPS) - 1, (b,), generator=gen, device=dev),
            "noise_prev": noise(), "noise_cur": noise(),
            "ts": torch.rand((b,), generator=gen, device=dev), "noise_t": noise()}


def disc_draws(gen: torch.Generator, batch):
    """The discriminator step's draw: the noise of the real half."""
    lat = batch["latents"]
    return {"noise": torch.randn(lat.shape, generator=gen, device=lat.device)}


def scorer_draws(gen: torch.Generator, batch, n_updates: int):
    """The scorer step's draws, n_updates of each: the noise that re-noises
    x0_prev at t_cur, ts (B,) uniform and the flow-matching noise."""
    lat = batch["latents"]
    n, dev = (n_updates,) + tuple(lat.shape), lat.device
    return {"noise_z": torch.randn(n, generator=gen, device=dev),
            "ts": torch.rand((n_updates, lat.shape[0]), generator=gen, device=dev),
            "noise_t": torch.randn(n, generator=gen, device=dev)}


def make_student_step(cfg: BackboneConfig, disc_cfg: DiscriminatorConfig, asr_cfg: ASRConfig, sv_cfg: SVConfig, tx,
                      train_cfg: DistillConfig = DistillConfig(), mesh=None):
    """student_step(student, student_opt, teacher, scorer, disc, asr, sv,
    batch, step, draws) -> (student, student_opt, carry, metrics): new
    trees; `step` is the host's step count, which opens the ASR and SV
    gates; the metrics stay on the device. With a data-parallel `mesh`
    (parallel/mesh.py), `batch` and `draws` are this rank's rows of the
    global batch's, every mean and the discriminator's batch statistics are
    the global batch's, and the gradients are summed over dp: the step on
    the global batch."""
    cdt = DTYPES[train_cfg.compute_dtype]
    mp = cdt != torch.float32

    @torch.no_grad()
    def targets(student, teacher, scorer, batch, draws):
        latents, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
        b = latents.shape[0]
        if mp:  # the bf16 views of every backbone forward here; each x0 upcast at once
            student, teacher, scorer = (cast_floats(t, cdt) for t in (student, teacher, scorer))
        ref_c = ref.to(cdt)
        # the frozen teacher's style sequence, for the discriminator
        ref_seq, ref_mask = style_encoder(teacher["style_encoder"], ref_c, ref_len, cfg.style)
        ref_seq = ref_seq.float()
        # backward simulation: the student at t_prev, re-noised at t_cur
        timesteps = torch.tensor(TIMESTEPS, device=latents.device)
        idx = draws["idx"].long()
        t_prev, t_cur = timesteps[idx], timesteps[idx + 1]
        z_prev, _ = apply_noise(latents, t_prev, draws["noise_prev"])
        x0_prev = _x_pred(student, cfg, z_prev.to(cdt), ref_c, ref_len, mask, ph, ph_mask, t_prev).float()
        z, _ = apply_noise(x0_prev, t_cur, draws["noise_cur"])
        x0 = _x_pred(student, cfg, z.to(cdt), ref_c, ref_len, mask, ph, ph_mask, t_cur).float()
        ts, noise_t = draws["ts"], draws["noise_t"]
        x_t, _ = apply_noise(x0, ts, noise_t)

        # the DMD target, in float32
        valid = mask[..., None].float()
        p_real = (x0 - _x_pred_cfg(teacher, cfg, x_t.to(cdt), ref_c, ref_len, mask, ph, ph_mask, ts).float()) * valid
        x_pred_fake, feats_fake = _x_pred(scorer, cfg, x_t.to(cdt), ref_c, ref_len, mask, ph, ph_mask, ts,
                                          return_features=True)
        p_fake = (x0 - x_pred_fake.float()) * valid
        denom = p_real.abs().mean(dim=(1, 2), keepdim=True)  # over padded positions too, as JAX does
        grad = torch.nan_to_num((p_real - p_fake) / denom)
        return {"z": z, "t_cur": t_cur, "ts": ts, "noise_t": noise_t, "target": x0 - grad,
                "feats_fake": feats_fake.float(), "x0_prev": x0_prev, "ref_seq": ref_seq, "ref_mask": ref_mask,
                "dmd_grad_mag": comm.dp_mean(torch.linalg.vector_norm(grad.reshape(b, -1), dim=-1))}

    def update(student, student_opt, disc, asr, sv, batch, tgt, step: int):
        latents, lat_len, mask, ph, ph_len, ph_mask, ref, ref_len = _unpack(batch)
        valid = mask[..., None].float()
        zero = torch.zeros((), device=latents.device)

        def student_loss(student_p):
            if mp:  # bf16 forward and backward through the student; gradients reach the fp32 masters
                student_p = cast_floats(student_p, cdt)
            x0 = _x_pred(student_p, cfg, tgt["z"].to(cdt), ref.to(cdt), ref_len, mask, ph, ph_mask,
                         tgt["t_cur"]).float()
            # valid elements: frames x channels, over the global batch
            n_valid = torch.clamp_min(comm.dp_sum(valid.sum()) * x0.shape[-1], 1.0)
            pseudo = 0.5 * comm.dp_sum((((x0 - tgt["target"]) ** 2) * valid).sum()) / n_valid
            # LSGAN generator loss: the gradient goes through x_t into the frozen discriminator
            x_t, _ = apply_noise(x0, tgt["ts"], tgt["noise_t"])
            logits, _ = discriminator_forward(disc, disc_cfg, tgt["feats_fake"], x_t, tgt["ref_seq"], tgt["ref_mask"],
                                              mask, ph, tgt["ts"], train=True)
            gan = comm.dp_mean((logits - 1.0) ** 2)
            ctc = sv_loss = zero
            if step > train_cfg.asr_start_step:  # the frozen ASR's CTC, per sample over its label count
                log_probs, out_lens, _ = asr_forward(asr, asr_cfg, x0, lat_len)
                logit_pad = 1.0 - length_mask(out_lens, log_probs.shape[1]).float()
                ctc_per = ctc_loss(log_probs, logit_pad, ph, 1.0 - ph_mask.float())
                ctc = comm.dp_mean(ctc_per / torch.clamp_min(ph_len.float(), 1.0))
            if step > train_cfg.sv_start_step:  # the frozen SV's cosine loss against the real latents' embedding
                with torch.no_grad():
                    true_emb, _ = sv_forward(sv, sv_cfg, latents, lat_len)
                stu_emb, _ = sv_forward(sv, sv_cfg, x0, lat_len)
                sv_loss = comm.dp_mean(cosine_loss(stu_emb, true_emb))
            total = pseudo + train_cfg.gan_weight * gan + ctc + sv_loss
            return total, {"st_pseudo": pseudo.detach(), "st_gan": gan.detach(), "st_asr": ctc.detach(),
                           "st_sv": sv_loss.detach(), "x_t": x_t.detach()}

        _, aux, grads = value_and_grad(student, student_loss, mesh)
        with torch.no_grad():
            updates, student_opt = tx.update(grads, student_opt, student)
            student = apply_updates(student, updates)
        return student, student_opt, aux

    def student_step(student, student_opt, teacher, scorer, disc, asr, sv, batch, step: int, draws):
        with use(mesh):
            tgt = targets(student, teacher, scorer, batch, draws)
        student, student_opt, aux = update(student, student_opt, disc, asr, sv, batch, tgt, step)
        carry = {"x0_prev": tgt["x0_prev"], "x_t": aux["x_t"], "feats_fake": tgt["feats_fake"],
                 "ref_seq": tgt["ref_seq"], "ref_mask": tgt["ref_mask"], "ts": tgt["ts"], "t_cur": tgt["t_cur"]}
        metrics = {k: aux[k] for k in ("st_pseudo", "st_gan", "st_asr", "st_sv")}
        metrics["dmd_grad_mag"] = tgt["dmd_grad_mag"]
        return student, student_opt, carry, metrics

    return student_step


def make_disc_step(cfg: BackboneConfig, disc_cfg: DiscriminatorConfig, tx, compute_dtype: str = "float32",
                   mesh=None):
    """disc_step(disc, disc_opt, scorer, batch, carry, draws) -> (disc,
    disc_opt, loss): the LSGAN update on [real | fake], the BatchNorm stats
    (if any) of the forward kept through the update. With a data-parallel
    `mesh`, on this rank's rows, as make_student_step's."""
    cdt = DTYPES[compute_dtype]

    def disc_step(disc, disc_opt, scorer, batch, carry, draws):
        latents, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
        ts = carry["ts"]
        x_real, _ = apply_noise(latents, ts, draws["noise"])
        with torch.no_grad():  # the frozen scorer's features, in the compute dtype
            _, feats_real = backbone_forward(cast_floats(scorer, cdt), cfg, x_real.to(cdt), ref.to(cdt), ref_len,
                                             mask, ph, ph_mask, ts, return_features=True)
        feats = torch.cat([feats_real.float(), carry["feats_fake"]])
        xs = torch.cat([x_real, carry["x_t"]])
        two = lambda t: torch.cat([t, t])  # noqa: E731

        def disc_loss(disc_p):
            logits, new_p = discriminator_forward(disc_p, disc_cfg, feats, xs, two(carry["ref_seq"]),
                                                  two(carry["ref_mask"]), two(mask), two(ph), two(ts), train=True)
            real, fake = torch.chunk(logits, 2)
            return comm.dp_mean(fake ** 2 + (real - 1.0) ** 2), new_p

        loss, new_p, grads = value_and_grad(disc, disc_loss, mesh)
        with torch.no_grad():
            updates, disc_opt = tx.update(grads, disc_opt, disc)
            disc = apply_updates(map_pytree(torch.Tensor.detach, new_p), updates)
        return disc, disc_opt, loss

    return disc_step


def make_scorer_step(cfg: BackboneConfig, tx, n_updates: int = SCORER_UPDATES, compute_dtype: str = "float32",
                     mesh=None):
    """scorer_step(scorer, scorer_opt, student, batch, carry, draws) ->
    (scorer, scorer_opt, the last update's loss). With a data-parallel
    `mesh`, on this rank's rows, as make_student_step's."""
    cdt = DTYPES[compute_dtype]
    mp = cdt != torch.float32

    def scorer_step(scorer, scorer_opt, student, batch, carry, draws):
        latents, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
        valid = mask[..., None].float()
        x0_prev, t_cur = carry["x0_prev"], carry["t_cur"]
        student_c, ref_c = cast_floats(student, cdt), ref.to(cdt)
        loss = None
        for i in range(n_updates):
            with torch.no_grad():
                z, _ = apply_noise(x0_prev, t_cur, draws["noise_z"][i])
                x0 = _x_pred(student_c, cfg, z.to(cdt), ref_c, ref_len, mask, ph, ph_mask, t_cur).float()
                ts = draws["ts"][i]
                noised, v_target = apply_noise(x0, ts, draws["noise_t"][i])

            def fm_loss(sp):
                if mp:
                    sp = cast_floats(sp, cdt)
                v_pred = backbone_forward(sp, cfg, noised.to(cdt), ref_c, ref_len, mask, ph, ph_mask, ts).float()
                diff = ((v_pred - v_target) * valid) ** 2
                n_valid = torch.clamp_min(comm.dp_sum(valid.sum()) * v_pred.shape[-1], 1.0)
                return comm.dp_sum(diff.sum()) / n_valid, None

            loss, _, grads = value_and_grad(scorer, fm_loss, mesh)
            with torch.no_grad():
                updates, scorer_opt = tx.update(grads, scorer_opt, scorer)
                scorer = apply_updates(scorer, updates)
        return scorer, scorer_opt, loss

    return scorer_step


def train_distill(
    train_cfg: DistillConfig = DistillConfig(),
    model_cfg: Optional[BackboneConfig] = None,
    disc_cfg: Optional[DiscriminatorConfig] = None,
    asr_cfg: Optional[ASRConfig] = None,
    sv_cfg: Optional[SVConfig] = None,
    teacher_checkpoint: str = "assets/teacher_checkpoints/checkpoint_ema.npz",
    asr_checkpoint: str = "assets/asr_checkpoints/checkpoint_latest.npz",
    sv_checkpoint: str = "assets/sv_checkpoints/checkpoint_latest.npz",
    checkpoint_dir: str = "assets/dmd_checkpoints",
    data_iter=None,
    seed: int = 0,
    params_override: Optional[dict] = None,
    device=None,
    on_step=None,
    mesh=None,
):
    """The distillation loop, on the dummy data unless `data_iter` yields
    batches (dicts of numpy arrays); on the card unless `device` says
    otherwise. A `mesh` (parallel.multihost.auto_mesh) makes the whole
    iteration data parallel, as train_teacher's does: each process's
    batches its slice of the global batch, every model replicated from rank
    0, global draws with this rank's rows kept, checkpoints and metrics
    rank 0's. Student and scorer start as copies of the teacher; the
    teacher, ASR and SV are frozen; three AdamW 1e-5 optimizers.
    `params_override` (a dict with teacher, asr, sv, disc and optionally
    student and scorer, JAX-layout trees converted by params_from_jax or
    the port's own) stands in for the checkpoints. At step % save_every == 0
    past step 1 it writes student_latest.npz and scorer_latest.npz (with the
    backbone config as metadata) and discriminator_latest.npz, in the JAX
    package's format and layout. `on_step(step, metrics)`, when given, is
    called after each iteration with the metrics on the device. Returns
    (student, scorer, disc, the last metrics as floats)."""
    from smalltts_tpu_torch.data.dummy import get_dummy_dataloader
    from smalltts_tpu_torch.models.discriminator import init_discriminator
    from smalltts_tpu_torch.parallel.mesh import global_draws, replicated
    from smalltts_tpu_torch.parallel.multihost import is_coordinator, local_batch_to_global
    from smalltts_tpu_torch.train.optim import distill_optimizer
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_meta
    from smalltts_tpu_torch.utils.convert import params_from_jax, params_to_jax
    from smalltts_tpu_torch.utils.profiling import MetricsLogger
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    dev = resolve_device(device)
    if model_cfg is None:  # the student step backpropagates through the student: remat its DiT blocks
        base = BackboneConfig()
        model_cfg = replace(base, dit=replace(base.dit, remat=True))
    disc_cfg = disc_cfg or DiscriminatorConfig(transformer_dim=model_cfg.hidden_dim, ref_dim=model_cfg.hidden_dim)
    asr_cfg = asr_cfg or ASRConfig(input_dim=model_cfg.latent_dim)
    sv_cfg = sv_cfg or SVConfig(input_dim=model_cfg.latent_dim)
    gen = torch.Generator(device=dev).manual_seed(seed)
    on_dev = lambda tree: map_pytree(lambda t: t.to(dev), tree)  # noqa: E731
    copy = lambda tree: map_pytree(torch.clone, tree)  # noqa: E731

    if params_override is not None:
        teacher, asr, sv = (on_dev(params_override[k]) for k in ("teacher", "asr", "sv"))
        student = on_dev(params_override["student"]) if params_override.get("student") is not None else copy(teacher)
        scorer = on_dev(params_override["scorer"]) if params_override.get("scorer") is not None else copy(teacher)
        disc = on_dev(params_override["disc"])
    else:
        teacher = on_dev(params_from_jax(ckpt.load_pytree(teacher_checkpoint), model_cfg))
        asr = on_dev(params_from_jax(ckpt.load_pytree(asr_checkpoint), asr_cfg))
        sv = on_dev(params_from_jax(ckpt.load_pytree(sv_checkpoint), sv_cfg))
        student, scorer = copy(teacher), copy(teacher)
        disc = init_discriminator(gen, disc_cfg, device=dev)
    if mesh is not None:
        for tree in (teacher, asr, sv, student, scorer, disc):
            replicated(tree, mesh)
    cdt = DTYPES[train_cfg.compute_dtype]
    if cdt != torch.float32:  # the frozen teacher never trains: stored in the compute dtype
        teacher = cast_floats(teacher, cdt)

    tx_student, tx_scorer, tx_disc = distill_optimizer(student), distill_optimizer(scorer), distill_optimizer(disc)
    opt_student, opt_scorer, opt_disc = tx_student.init(student), tx_scorer.init(scorer), tx_disc.init(disc)
    student_step = make_student_step(model_cfg, disc_cfg, asr_cfg, sv_cfg, tx_student, train_cfg, mesh=mesh)
    disc_step = make_disc_step(model_cfg, disc_cfg, tx_disc, train_cfg.compute_dtype, mesh=mesh)
    scorer_step = make_scorer_step(model_cfg, tx_scorer, train_cfg.scorer_updates, train_cfg.compute_dtype, mesh=mesh)

    data_iter = data_iter or get_dummy_dataloader(train_cfg.batch_size, seed)
    saver = ckpt.AsyncCheckpointer()
    writer = is_coordinator()  # single-writer checkpoints and coordinator-only logs
    logger = MetricsLogger(os.path.join(checkpoint_dir, "metrics.jsonl") if writer else None, echo=writer)
    metrics = {}
    try:
        for step in range(train_cfg.num_steps):
            batch = {k: to_device(v, dev) for k, v in next(data_iter).items() if k != "texts"}
            if mesh is not None:
                batch = local_batch_to_global(batch, mesh)
            student, opt_student, carry, metrics = student_step(
                student, opt_student, teacher, scorer, disc, asr, sv, batch, step,
                global_draws(student_draws, gen, batch, mesh))
            disc, opt_disc, disc_loss = disc_step(disc, opt_disc, scorer, batch, carry,
                                                  global_draws(disc_draws, gen, batch, mesh))
            scorer, opt_scorer, scorer_loss = scorer_step(
                scorer, opt_scorer, student, batch, carry,
                global_draws(scorer_draws, gen, batch, mesh, train_cfg.scorer_updates, axis=1))
            # the metrics stay on the device between logs: float() would wait for the card every step
            metrics = {**metrics, "disc_loss": disc_loss, "scorer_loss": scorer_loss}
            if on_step is not None:
                on_step(step, metrics)
            if step % 50 == 0 and writer:
                logger.log({k: float(v) for k, v in metrics.items()}, step)
            if step % train_cfg.save_every == 0 and step > 1 and writer:
                saver.wait()  # the previous save is on disk before the next snapshot
                meta = backbone_meta(model_cfg)
                saver.save_pytree(f"{checkpoint_dir}/student_latest.npz", params_to_jax(student), meta)
                saver.save_pytree(f"{checkpoint_dir}/scorer_latest.npz", params_to_jax(scorer), meta)
                saver.save_pytree(f"{checkpoint_dir}/discriminator_latest.npz", params_to_jax(disc, disc_cfg))
    finally:
        saver.close()
        logger.close()
    return student, scorer, disc, {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> None:
    from smalltts_tpu_torch.data.local import cli_data_iter

    ap = argparse.ArgumentParser(description="DMD2 distillation of the teacher into the 4-step student, on the card.")
    ap.add_argument("--steps", type=int, default=40_000)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--teacher", default="assets/teacher_checkpoints/checkpoint_ema.npz")
    ap.add_argument("--asr", default="assets/asr_checkpoints/checkpoint_latest.npz")
    ap.add_argument("--sv", default="assets/sv_checkpoints/checkpoint_latest.npz")
    ap.add_argument("--checkpoint-dir", default="assets/dmd_checkpoints")
    ap.add_argument("--data-dir", default=None,
                    help="local corpus (metadata.csv or paired .wav/.txt); default: dummy random tensors")
    ap.add_argument("--data-codec-checkpoint", default=None, help="native codec weights for corpus encoding")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ways (0 = single device); several processes via the SMALLTTS_COORDINATOR "
                         "env or torchrun (parallel/multihost.py)")
    args = ap.parse_args(argv)
    missing = [f"--{name} {path}" for name, path in (("teacher", args.teacher), ("asr", args.asr), ("sv", args.sv))
               if not os.path.isfile(path)]
    if missing:
        print("distill needs the trained teacher, ASR and SV checkpoints; not found: " + ", ".join(missing),
              file=sys.stderr)
        raise SystemExit(2)
    from smalltts_tpu_torch.parallel.multihost import auto_mesh

    # under a job of several processes --batch-size is per process
    train_distill(DistillConfig(num_steps=args.steps, batch_size=args.batch_size), teacher_checkpoint=args.teacher,
                  asr_checkpoint=args.asr, sv_checkpoint=args.sv, checkpoint_dir=args.checkpoint_dir,
                  data_iter=cli_data_iter(args.data_dir, args.data_codec_checkpoint, args.batch_size),
                  mesh=auto_mesh(dp=args.dp, tp=1))


if __name__ == "__main__":
    main()

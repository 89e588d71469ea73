"""The integral-velocity (IMF) few-step student: its serving parts and its
trainer (port of smalltts_tpu/train/imf.py).

An IMF student is a backbone with one more leaf, `r_gate` (H,), that mixes
the embedding of an interval's end time r into the embedding of its start
time t: te(t) + r_gate * te(r). It predicts the average velocity u over
[r, t], so that x_r = x_t - (t - r) * u. With r_gate = 0 it is the teacher.

Training: each step draws intervals (t, r), uniform or (with focus_prob)
the serving grid's, noises the latents at t, rolls the frozen teacher from
t to r in `rollout_substeps` DDIM substeps without grad, and regresses
u(x_t, t, r) on (x_t - x_r) / (t - r); optionally the boundary pair r = t
against the teacher's velocity, and the second serving interval from the
student's own first step (roll-in). Two variants add a term:
`make_imf_adv_steps` an LSGAN loss on the full-interval x0 through a
discriminator over the teacher's last-layer features (gan_weight),
`make_imf_dmd_steps` the DMD distribution-matching loss on the served
few-step composition with a fake-score model (dmd_weight). The
conditioning is encoded outside the loss, so the style and text encoders
and the cross K/V projections get no gradient, and the optimizer freezes
them (IMF_FROZEN).

Dtypes follow the JAX package's promotions: the latents and every draw are
float32, so a forward on a float32 x_t runs float32 activations over the
params, bf16 or not. The teacher rolls out on its split tree, as in JAX.

The draws of a step come from `imf_draws`, `train.distill.disc_draws` and
`imf_scorer_draws`, apart from the math, so a test can pass JAX's in.

    python -m smalltts_tpu_torch.train.imf [--teacher T.npz|T.pt] [--steps 40000]
        [--gan-weight W | --dmd-weight W] [--data-dir DIR] ...
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import Optional

import torch

from smalltts_tpu_torch.models.backbone import (
    BackboneConfig,
    backbone_forward,
    cfg_velocity,
    denoise_step,
    encode_conditions,
    time_embedding,
)
from smalltts_tpu_torch.models.discriminator import DiscriminatorConfig, discriminator_forward
from smalltts_tpu_torch.models.dit import precompute_step_modulations
from smalltts_tpu_torch.models.style_encoder import style_encoder
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.ops.schedule import apply_noise, get_alpha_sigma, x_pred_from_velocity
from smalltts_tpu_torch.parallel import comm
from smalltts_tpu_torch.train.distill import CFG_SCALE_SPEAKER, CFG_SCALE_TEXT, _unpack, disc_draws
from smalltts_tpu_torch.train.optim import adamw, apply_updates, value_and_grad
from smalltts_tpu_torch.utils.checkpoint import map_pytree


@dataclass(frozen=True)
class ImfConfig:
    """The JAX package's ImfConfig (imf.py:51-116); its comments give the
    corpus measurements behind each default."""

    num_steps: int = 40_000
    batch_size: int = 2
    lr: float = 1e-5
    grad_clip: float = 1.0
    rollout_substeps: int = 4  # teacher DDIM substeps per (t, r) interval
    min_interval: float = 0.1
    t_floor: float = 0.02
    boundary_prob: float = 0.0  # samples trained on r = t against the teacher's velocity
    focus_prob: float = 0.5  # samples trained on the serving grid's intervals
    focus_num_steps: int = 2
    rollin_prob: float = 0.0  # samples trained as the 2nd serving interval from the student's 1st step
    gan_weight: float = 0.0  # > 0: make_imf_adv_steps
    dmd_weight: float = 0.0  # > 0: make_imf_dmd_steps
    dmd_scorer_updates: int = 2
    save_every: int = 800


# the student's leaves the optimizer leaves alone (imf.py:610-623): the conditioning
IMF_FROZEN = ("style_encoder", "phoneme_embedding", "kv_ref", "kv_text", "k_norm_cross")


def imf_optimizer(params, train_cfg: ImfConfig, frozen=()):
    """clip_by_global_norm(grad_clip) then optax.adamw(lr) at its default
    weight decay 1e-4, over the leaves not named in `frozen`."""
    return adamw(params, train_cfg.lr, weight_decay=1e-4, clip_norm=train_cfg.grad_clip, frozen=frozen)


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree.clone()


def init_imf_student(teacher_params) -> dict:
    """A copy of the teacher plus a zero `r_gate` in fp32 (the student equals
    the teacher at init)."""
    student = _copy_tree(teacher_params)
    w = teacher_params["time_embedding"]["l2"]["w"]
    student["r_gate"] = torch.zeros((w.shape[-1],), dtype=torch.float32, device=w.device)
    return student


def imf_time_emb(p, cfg: BackboneConfig, t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """te(t) + r_gate * te(r); r_gate is cast to the embedding's dtype first."""
    te = time_embedding(p["time_embedding"], t, cfg.time_embed_dim)
    re = time_embedding(p["time_embedding"], r, cfg.time_embed_dim)
    return te + p["r_gate"].to(te.dtype) * re


def imf_velocity(p, cfg: BackboneConfig, x_t, mask, t, r, cond) -> torch.Tensor:
    """Average velocity u(x_t, t, r): the backbone with the mixed embedding."""
    return denoise_step(p, cfg, x_t, mask, t, cond, t_emb=imf_time_emb(p, cfg, t, r))


# ------------------------------------------------------------------ training


def imf_draws(gen: torch.Generator, batch, train_cfg: ImfConfig):
    """A student step's draws from `gen`: t uniform in [t_floor +
    min_interval, 1) and r in [t_floor, t - min_interval) (B,), eps, the
    focus bits and grid index, the boundary and roll-in bits, the roll-in's
    x1; with gan_weight or dmd_weight ts (B,) and noise; with dmd_weight
    the composition's start x1."""
    lat = batch["latents"]
    b, dev = lat.shape[0], lat.device
    uniform = lambda: torch.rand((b,), generator=gen, device=dev)  # noqa: E731
    normal = lambda: torch.randn(lat.shape, generator=gen, device=dev)  # noqa: E731
    lo = train_cfg.t_floor + train_cfg.min_interval
    t = lo + uniform() * (1.0 - lo)
    d = {"t": t, "r": train_cfg.t_floor + uniform() * (t - train_cfg.min_interval - train_cfg.t_floor),
         "eps": normal(), "focus": uniform() < train_cfg.focus_prob,
         "idx": torch.randint(0, train_cfg.focus_num_steps, (b,), generator=gen, device=dev),
         "boundary": uniform() < train_cfg.boundary_prob, "roll": uniform() < train_cfg.rollin_prob,
         "x1_rollin": normal()}
    if train_cfg.dmd_weight > 0.0:
        d["x1"] = normal()
    if train_cfg.gan_weight > 0.0 or train_cfg.dmd_weight > 0.0:
        d["ts"], d["noise"] = uniform(), normal()
    return d


def imf_scorer_draws(gen: torch.Generator, batch, n_updates: int):
    """The scorer step's draws, one of each an update: ts (B,) uniform and
    the flow-matching noise."""
    lat = batch["latents"]
    return {"ts": torch.rand((n_updates, lat.shape[0]), generator=gen, device=lat.device),
            "noise": torch.randn((n_updates,) + tuple(lat.shape), generator=gen, device=lat.device)}


@torch.no_grad()
def teacher_rollout(teacher, cfg: BackboneConfig, x_t, mask, t, r, cond, substeps: int):
    """Deterministic DDIM-style rollout of the teacher's v-prediction flow
    from per-sample time t to r (B,) (imf.py:140-161): x0 = a x - s v, eps
    = s x + a v, re-noised at the next sub-time with the same eps, in x_t's
    dtype."""
    x = x_t
    for i in range(substeps):
        t0 = t + (r - t) * (i / substeps)
        t1 = t + (r - t) * ((i + 1) / substeps)
        a0, s0 = (c[:, None, None].to(x.dtype) for c in get_alpha_sigma(t0))
        a1, s1 = (c[:, None, None].to(x.dtype) for c in get_alpha_sigma(t1))
        v = denoise_step(teacher, cfg, x, mask, t0, cond)
        x0 = a0 * x - s0 * v
        eps = s0 * x + a0 * v
        x = a1 * x0 + s1 * eps
    return x


def _interval_targets(cfg: BackboneConfig, train_cfg: ImfConfig, student, teacher, batch, draws):
    """Sample (t, r) (uniform, focus, roll-in, boundary), noise the latents,
    roll the frozen teacher to r -> dict(cond, mask, x_t, t, r_eff,
    u_target) (imf.py:164-251). Nothing here carries a gradient: the
    conditioning is the student's, encoded outside the loss."""
    latents, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
    b, dev = latents.shape[0], latents.device
    with torch.no_grad():
        cond = encode_conditions(student, cfg, ref, ref_len, ph, ph_mask)
    t, r = draws["t"], draws["r"]
    if train_cfg.focus_prob > 0.0:  # the serving grid's intervals, r floored at t_floor
        grid = torch.linspace(1.0, 0.0, train_cfg.focus_num_steps + 1, device=dev)
        idx, focus = draws["idx"].long(), draws["focus"]
        t = torch.where(focus, grid[idx], t)
        r = torch.where(focus, torch.clamp_min(grid[idx + 1], train_cfg.t_floor), r)
    a, s = get_alpha_sigma(t)
    x_t = a[:, None, None] * latents + s[:, None, None] * draws["eps"]
    if train_cfg.rollin_prob > 0.0:  # the 2nd serving interval from the student's own 1st step
        t_mid = 1.0 - 1.0 / train_cfg.focus_num_steps
        ones = torch.ones((b,), device=dev)
        x1, roll = draws["x1_rollin"], draws["roll"]
        with torch.no_grad():
            u1 = imf_velocity(student, cfg, x1, mask, ones, t_mid * ones, cond)
        x_mid = x1 - (1.0 - t_mid) * u1
        t = torch.where(roll, t_mid, t)
        r = torch.where(roll, train_cfg.t_floor, r)
        x_t = torch.where(roll[:, None, None], x_mid, x_t)
    x_r = teacher_rollout(teacher, cfg, x_t, mask, t, r, cond, train_cfg.rollout_substeps)
    u_target = (x_t - x_r) / (t - r)[:, None, None]
    r_eff = r
    if train_cfg.boundary_prob > 0.0:  # the pair r = t against the teacher's instantaneous velocity
        boundary = draws["boundary"]
        with torch.no_grad():
            v_teacher = denoise_step(teacher, cfg, x_t, mask, t, cond)
        r_eff = torch.where(boundary, t, r)
        u_target = torch.where(boundary[:, None, None], v_teacher, u_target)
    return {"cond": cond, "mask": mask, "x_t": x_t, "t": t, "r_eff": r_eff, "u_target": u_target}


def _imf_base_loss(p, cfg: BackboneConfig, tgt):
    u = imf_velocity(p, cfg, tgt["x_t"], tgt["mask"], tgt["t"], tgt["r_eff"], tgt["cond"])
    per = ((u - tgt["u_target"]) ** 2).float()
    per = torch.where(tgt["mask"][..., None], per, 0.0)
    return comm.dp_sum(per.sum()) / torch.clamp_min(comm.dp_sum(tgt["mask"].sum()) * per.shape[-1], 1)


def _update(tx, grads, opt_state, params):
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state


def make_imf_step(cfg: BackboneConfig, tx, train_cfg: ImfConfig = ImfConfig(), mesh=None):
    """step(student, opt_state, teacher, batch, draws) -> (student,
    opt_state, loss): new trees, the loss on the device. With a
    data-parallel `mesh` (parallel/mesh.py), `batch` and `draws` are this
    rank's rows of the global batch's, the loss is the global batch's and
    the gradients are summed over dp: the step on the global batch. So for
    the adversarial and DMD factories' steps."""

    def step(student, opt_state, teacher, batch, draws):
        tgt = _interval_targets(cfg, train_cfg, student, teacher, batch, draws)
        loss, _, grads = value_and_grad(student, lambda p: (_imf_base_loss(p, cfg, tgt), None), mesh)
        student, opt_state = _update(tx, grads, opt_state, student)
        return student, opt_state, loss

    return step


def make_imf_adv_steps(cfg: BackboneConfig, disc_cfg: DiscriminatorConfig, tx, tx_disc, train_cfg: ImfConfig,
                       mesh=None):
    """The base loss plus gan_weight x an LSGAN generator loss on the
    full-interval x0 = x_t - (t - t_floor) u(x_t, t, t_floor), re-noised at
    ts and judged by the discriminator over the frozen teacher's features
    of that (detached) input; the gradient reaches the student through the
    discriminator's noised-x input only (imf.py:275-385).

        student_step(student, opt, teacher, disc, batch, draws)
            -> student, opt, carry, {"imf_loss", "gan_loss"}
        disc_step(disc, disc_opt, teacher, batch, carry, draws) -> disc, disc_opt, loss
    """

    def student_step(student, opt_state, teacher, disc, batch, draws):
        tgt = _interval_targets(cfg, train_cfg, student, teacher, batch, draws)
        _, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
        with torch.no_grad():
            ref_seq, ref_mask = style_encoder(teacher["style_encoder"], ref, ref_len, cfg.style)
        ts, noise = draws["ts"], draws["noise"]
        floor_vec = torch.full_like(ts, train_cfg.t_floor)

        def loss_fn(p):
            base = _imf_base_loss(p, cfg, tgt)
            u_full = imf_velocity(p, cfg, tgt["x_t"], mask, tgt["t"], floor_vec, tgt["cond"])
            span = (tgt["t"] - train_cfg.t_floor)[:, None, None]
            x0_pred = torch.where(mask[..., None], tgt["x_t"] - span.to(u_full.dtype) * u_full, 0.0)
            x_t_g, _ = apply_noise(x0_pred, ts, noise)
            with torch.no_grad():
                _, feats_fake = backbone_forward(teacher, cfg, x_t_g, ref, ref_len, mask, ph, ph_mask, ts,
                                                 return_features=True)
            logits, _ = discriminator_forward(disc, disc_cfg, feats_fake, x_t_g, ref_seq, ref_mask, mask, ph, ts,
                                              train=True)
            gan = comm.dp_mean((logits - 1.0) ** 2)
            aux = {"imf_loss": base.detach(), "gan_loss": gan.detach(), "x_t_g": x_t_g.detach(),
                   "feats_fake": feats_fake}
            return base + train_cfg.gan_weight * gan, aux

        _, aux, grads = value_and_grad(student, loss_fn, mesh)
        student, opt_state = _update(tx, grads, opt_state, student)
        carry = {"x_t_g": aux["x_t_g"], "feats_fake": aux["feats_fake"], "ref_seq": ref_seq, "ref_mask": ref_mask,
                 "ts": ts}
        return student, opt_state, carry, {"imf_loss": aux["imf_loss"], "gan_loss": aux["gan_loss"]}

    def disc_step(disc, disc_opt, teacher, batch, carry, draws):
        latents, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
        ts = carry["ts"]
        x_real, _ = apply_noise(latents, ts, draws["noise"])
        with torch.no_grad():
            _, feats_real = backbone_forward(teacher, cfg, x_real, ref, ref_len, mask, ph, ph_mask, ts,
                                             return_features=True)
        feats = torch.cat([feats_real, carry["feats_fake"]])
        xs = torch.cat([x_real, carry["x_t_g"]])
        two = lambda t: torch.cat([t, t])  # noqa: E731

        def disc_loss(dp):
            logits, new_p = discriminator_forward(dp, disc_cfg, feats, xs, two(carry["ref_seq"]),
                                                  two(carry["ref_mask"]), two(mask), two(ph), two(ts), train=True)
            real, fake = torch.chunk(logits, 2)
            return comm.dp_mean(fake ** 2 + (real - 1.0) ** 2), new_p

        loss, new_p, grads = value_and_grad(disc, disc_loss, mesh)
        with torch.no_grad():
            updates, disc_opt = tx_disc.update(grads, disc_opt, disc)
            disc = apply_updates(map_pytree(torch.Tensor.detach, new_p), updates)
        return disc, disc_opt, loss

    return student_step, disc_step


def make_imf_dmd_steps(cfg: BackboneConfig, tx, tx_scorer, train_cfg: ImfConfig, mesh=None):
    """The base loss plus dmd_weight x the DMD pseudo-loss on the served
    composition x0: the student rolled over linspace(1, 0, focus_num_steps
    + 1) from the noise x1, every interval without grad but the last,
    re-noised at ts; its target x0 - normalized(p_real - p_fake), p_real
    from the frozen teacher's double CFG, p_fake from the scorer
    (imf.py:388-540). The composition is computed once, with the gradient
    of its last interval; the target comes from its detached value, which
    is what the JAX package recomputes without grad.

        student_step(student, opt, teacher, scorer, batch, draws)
            -> student, opt, carry, {"imf_loss", "dmd_loss", "grad_mag"}
        scorer_step(scorer, opt, batch, carry, draws) -> scorer, opt, the last update's loss
    """
    n_steps, t_floor = train_cfg.focus_num_steps, train_cfg.t_floor
    grid = torch.linspace(1.0, 0.0, n_steps + 1).tolist()  # float32 values

    def composition(p, x1, mask, cond):
        """The serving-grid rollout from x1, the gradient through the last interval only."""
        full = lambda v: torch.full((x1.shape[0],), v, dtype=torch.float32, device=x1.device)  # noqa: E731
        x = x1
        with torch.no_grad():
            for i in range(n_steps - 1):
                t0, r0 = full(grid[i]), full(max(grid[i + 1], t_floor))
                x = x - (t0 - r0)[:, None, None].to(x.dtype) * imf_velocity(p, cfg, x, mask, t0, r0, cond)
        # t_last floored like the intermediate r0: the state arrived at max(grid[-2], t_floor)
        t_last, r_last = full(max(grid[n_steps - 1], t_floor)), full(t_floor)
        x0 = x - (t_last - r_last)[:, None, None].to(x.dtype) * imf_velocity(p, cfg, x, mask, t_last, r_last, cond)
        return torch.where(mask[..., None], x0, 0.0)

    def student_step(student, opt_state, teacher, scorer, batch, draws):
        tgt = _interval_targets(cfg, train_cfg, student, teacher, batch, draws)
        latents, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
        b = latents.shape[0]
        valid = mask[..., None].float()
        ts, noise = draws["ts"], draws["noise"]

        def loss_fn(p):
            base = _imf_base_loss(p, cfg, tgt)
            x0 = composition(p, draws["x1"], mask, tgt["cond"])
            with torch.no_grad():  # the DMD target from the detached composition
                x0_d = x0.detach()
                x_t, _ = apply_noise(x0_d, ts, noise)
                v_real = cfg_velocity(teacher, cfg, x_t, ref, ref_len, mask, ph, ph_mask, ts, CFG_SCALE_TEXT,
                                      CFG_SCALE_SPEAKER)
                p_real = (x0_d - x_pred_from_velocity(x_t, v_real, ts)) * valid
                v_fake = backbone_forward(scorer, cfg, x_t, ref, ref_len, mask, ph, ph_mask, ts)
                p_fake = (x0_d - x_pred_from_velocity(x_t, v_fake, ts)) * valid
                # over all T x D positions, padding included, as the reference and JAX divide
                denom = p_real.abs().mean(dim=(1, 2), keepdim=True)
                grad = torch.nan_to_num((p_real - p_fake) / denom)
                target = x0_d - grad
            n_valid = torch.clamp_min(comm.dp_sum(valid.sum()) * x0.shape[-1], 1.0)
            dmd = 0.5 * comm.dp_sum((((x0 - target) ** 2) * valid).sum()) / n_valid
            aux = {"imf_loss": base.detach(), "dmd_loss": dmd.detach(), "x0": x0_d,
                   "grad_mag": comm.dp_mean(torch.linalg.vector_norm(grad.reshape(b, -1), dim=-1))}
            return base + train_cfg.dmd_weight * dmd, aux

        _, aux, grads = value_and_grad(student, loss_fn, mesh)
        student, opt_state = _update(tx, grads, opt_state, student)
        return student, opt_state, {"x0": aux.pop("x0")}, aux

    def scorer_step(scorer, scorer_opt, batch, carry, draws):
        _, _, mask, ph, _, ph_mask, ref, ref_len = _unpack(batch)
        valid = mask[..., None].float()
        loss = None
        for i in range(train_cfg.dmd_scorer_updates):
            ts = draws["ts"][i]
            noised, v_target = apply_noise(carry["x0"], ts, draws["noise"][i])

            def fm_loss(sp):
                v = backbone_forward(sp, cfg, noised, ref, ref_len, mask, ph, ph_mask, ts)
                diff = ((v - v_target) * valid) ** 2
                return comm.dp_sum(diff.sum()) / torch.clamp_min(comm.dp_sum(valid.sum()) * v.shape[-1], 1.0), None

            loss, _, grads = value_and_grad(scorer, fm_loss, mesh)
            scorer, scorer_opt = _update(tx_scorer, grads, scorer_opt, scorer)
        return scorer, scorer_opt, loss

    return student_step, scorer_step


def load_teacher(path: str, cfg: BackboneConfig):
    """A teacher checkpoint, the JAX package's npz or a reference torch
    .pt/.pth/.bin, as the port's tree (CPU tensors)."""
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.convert import params_from_jax

    tree = ckpt.load_reference_backbone_checkpoint(path) if ckpt.is_torch_checkpoint(path) else ckpt.load_pytree(path)
    return params_from_jax(tree, cfg)


def train_imf(
    train_cfg: ImfConfig = ImfConfig(),
    model_cfg: Optional[BackboneConfig] = None,
    teacher_checkpoint: str = "assets/teacher_checkpoints/checkpoint_ema.npz",
    checkpoint_dir: str = "assets/imf_checkpoints",
    data_iter=None,
    teacher_params=None,
    seed: int = 0,
    log_every: int = 100,
    device=None,
    on_step=None,
):
    """The IMF loop (imf.py:580-707), on the dummy data unless `data_iter`
    yields batches (dicts of numpy arrays); on the card unless `device` says
    otherwise. `teacher_params` (the port's tree, in the dtype to train in)
    stands in for the checkpoint. The student starts as the teacher with a
    zero r_gate; with dmd_weight a scorer starts as a copy of the teacher,
    with gan_weight a discriminator from `seed`'s generator. At step % save_every == 0 past
    step 1 it writes imf_student_latest.npz (the backbone config as
    metadata) and the imf_discriminator / imf_scorer sidecars, in the JAX
    package's format. `on_step(step, metrics)`, when given, is called after
    each step with the metrics on the device. Returns (student, the last
    imf_loss as a float)."""
    from smalltts_tpu_torch.data.dummy import get_dummy_dataloader
    from smalltts_tpu_torch.models.discriminator import init_discriminator
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_meta
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    # before any resource: the checkpointer starts a thread that only close() ends
    if train_cfg.gan_weight > 0.0 and train_cfg.dmd_weight > 0.0:
        raise ValueError("gan_weight and dmd_weight are separate variants; the JAX package's corpus runs found "
                         "neither stacks with the focus/roll-in regression targeting: pick one")
    dev = resolve_device(device)
    model_cfg = model_cfg or BackboneConfig()
    gen = torch.Generator(device=dev).manual_seed(seed)
    if teacher_params is None:
        teacher_params = load_teacher(teacher_checkpoint, model_cfg)
    teacher = map_pytree(lambda t: t.to(dev), teacher_params)
    student = init_imf_student(teacher)
    tx = imf_optimizer(student, train_cfg, IMF_FROZEN)
    opt_state = tx.init(student)
    disc = scorer = None
    if train_cfg.dmd_weight > 0.0:
        scorer = _copy_tree(teacher)

    if scorer is not None:
        tx_aux = imf_optimizer(scorer, train_cfg)
        aux_opt = tx_aux.init(scorer)
        step_fn, aux_step = make_imf_dmd_steps(model_cfg, tx, tx_aux, train_cfg)
    elif train_cfg.gan_weight > 0.0:
        # the discriminator reads the last N stacked DiT layers; a shallower backbone caps N at its depth
        disc_cfg = DiscriminatorConfig(transformer_dim=model_cfg.hidden_dim, ref_dim=model_cfg.hidden_dim,
                                       num_tail_layers=min(3, model_cfg.dit.n_blocks))
        disc = init_discriminator(gen, disc_cfg, device=dev)
        tx_aux = imf_optimizer(disc, train_cfg)
        aux_opt = tx_aux.init(disc)
        step_fn, aux_step = make_imf_adv_steps(model_cfg, disc_cfg, tx, tx_aux, train_cfg)
    else:
        step_fn = make_imf_step(model_cfg, tx, train_cfg)

    data_iter = data_iter or get_dummy_dataloader(train_cfg.batch_size, seed)
    saver = ckpt.AsyncCheckpointer()
    loss = None
    try:
        for step in range(train_cfg.num_steps):
            batch = {k: to_device(v, dev) for k, v in next(data_iter).items() if k != "texts"}
            draws = imf_draws(gen, batch, train_cfg)
            if scorer is not None:
                student, opt_state, carry, metrics = step_fn(student, opt_state, teacher, scorer, batch, draws)
                scorer, aux_opt, metrics["scorer_loss"] = aux_step(
                    scorer, aux_opt, batch, carry, imf_scorer_draws(gen, batch, train_cfg.dmd_scorer_updates))
            elif disc is not None:
                student, opt_state, carry, metrics = step_fn(student, opt_state, teacher, disc, batch, draws)
                disc, aux_opt, metrics["disc_loss"] = aux_step(disc, aux_opt, teacher, batch, carry,
                                                               disc_draws(gen, batch))
            else:
                student, opt_state, imf_loss = step_fn(student, opt_state, teacher, batch, draws)
                metrics = {"imf_loss": imf_loss}
            loss = metrics["imf_loss"]  # stays on the device between logs: float() waits for the card
            if on_step is not None:
                on_step(step, metrics)
            if step % log_every == 0:
                print(f"step {step}: " + " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items()), flush=True)
            if step % train_cfg.save_every == 0 and step > 1:
                saver.wait()  # the previous save is on disk before the next snapshot
                saver.save_pytree(f"{checkpoint_dir}/imf_student_latest.npz", params_to_jax(student),
                                  backbone_meta(model_cfg))
                if disc is not None:
                    saver.save_pytree(f"{checkpoint_dir}/imf_discriminator_latest.npz", params_to_jax(disc, disc_cfg))
                if scorer is not None:
                    saver.save_pytree(f"{checkpoint_dir}/imf_scorer_latest.npz", params_to_jax(scorer))
    finally:
        saver.close()
    return student, float(loss) if loss is not None else None


def main(argv=None) -> None:
    from smalltts_tpu_torch.data.local import cli_data_iter

    ap = argparse.ArgumentParser(description="IMF distillation of the teacher into a 1-2 step student, on the card.")
    ap.add_argument("--steps", type=int, default=40_000)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--teacher", default="assets/teacher_checkpoints/checkpoint_ema.npz",
                    help="teacher weights (.npz or reference torch .pt/.pth/.bin)")
    ap.add_argument("--checkpoint-dir", default="assets/imf_checkpoints")
    ap.add_argument("--substeps", type=int, default=4, help="teacher DDIM substeps per distilled interval")
    ap.add_argument("--boundary-prob", type=float, default=0.0,
                    help="fraction of samples trained on the r = t pair against the teacher's velocity")
    ap.add_argument("--focus-prob", type=float, default=0.5,
                    help="fraction of samples trained on the exact serving-grid intervals")
    ap.add_argument("--gan-weight", type=float, default=0.0,
                    help="LSGAN weight on the full-interval x0 (adds a discriminator and its sidecar)")
    ap.add_argument("--dmd-weight", type=float, default=0.0,
                    help="DMD pseudo-loss weight on the served few-step composition (adds a fake-score model "
                         "and its sidecar)")
    ap.add_argument("--rollin-prob", type=float, default=0.0,
                    help="fraction of samples trained as the second serving interval from the student's own "
                         "first step")
    ap.add_argument("--data-dir", default=None,
                    help="local corpus (metadata.csv or paired .wav/.txt); default: dummy random tensors")
    ap.add_argument("--data-codec-checkpoint", default=None, help="native codec weights for corpus encoding")
    args = ap.parse_args(argv)
    if not os.path.isfile(args.teacher):
        print(f"imf needs the trained teacher checkpoint; not found: --teacher {args.teacher}", file=sys.stderr)
        raise SystemExit(2)
    train_imf(ImfConfig(num_steps=args.steps, batch_size=args.batch_size, rollout_substeps=args.substeps,
                        boundary_prob=args.boundary_prob, focus_prob=args.focus_prob, gan_weight=args.gan_weight,
                        dmd_weight=args.dmd_weight, rollin_prob=args.rollin_prob),
              teacher_checkpoint=args.teacher, checkpoint_dir=args.checkpoint_dir,
              data_iter=cli_data_iter(args.data_dir, args.data_codec_checkpoint, args.batch_size))


# ------------------------------------------------------------------- serving


def imf_sample(student, cfg: BackboneConfig, cond, seq_lengths: torch.Tensor, t_bucket: int,
               noise: torch.Tensor, num_steps: int = 1) -> torch.Tensor:
    """Few-step sampling over the intervals of linspace(1, 0, num_steps + 1)
    from the start noise `noise` (B, t_bucket, latent_dim) -> masked latents.
    Every interval is known up front, so the mixed time embeddings and all
    intervals' adaLN modulations are computed once before the loop."""
    b = seq_lengths.shape[0]
    dev = seq_lengths.device
    mask = length_mask(seq_lengths, t_bucket)
    dtype = student["velocity"]["w"].dtype
    x = noise.to(dtype)
    ts = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=dev)
    t_embs = imf_time_emb(student, cfg, ts[:-1], ts[1:])  # (S, H)
    mods, finals = precompute_step_modulations(student["dit"], t_embs)
    for i in range(num_steps):
        t0, t1 = ts[i].expand(b), ts[i + 1].expand(b)
        u = denoise_step(student, cfg, x, mask, t0, cond, t_emb=t_embs[i].expand(b, -1),
                         step_mods=(mods[:, i], finals[i]))
        x = x - (t0 - t1)[:, None, None].to(dtype) * u
    return torch.where(mask[..., None], x, torch.zeros((), dtype=dtype, device=dev))


if __name__ == "__main__":
    main()

"""Training cells: the program's teacher step (train/teacher.make_teacher_step)
on batches and draws the benchmark makes from the seed, and the check of
its first three steps against the plain reference.

Set-up builds one object, the step with its params, optimizer state and
EMA, resumed at START_STEP, and drives it through its first three steps,
which the reference follows; the window then goes on with the same object. The first gradient is
read as the optimizer got it, from its first moment after step 0 (mu =
(1 - b1) g); the change of the params and of the EMA after the three steps
against the params the run started from."""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from harness import traffic as T
from harness.core import Run, to_device
from reference import model as ref

CHECKED_STEPS = 3
# The run resumes training at this step, the end of the published warmup:
# the optimizer's count (so the schedule's peak rate) and the EMA's decay
# are this step's, with fresh moments. At step 0 the rate is 1.5e-10, and
# the EMA, whose decay is 0 through step 101, copies the params.
START_STEP = 1500


@dataclass
class Step:
    index: int
    dispatch_s: float  # host time until step() returned
    done: float        # perf_counter when its completion was seen
    frames: int        # true latent frames
    flops: float       # forward and backward at the true lengths
    loss: object = None  # device scalar


def make_batch(mix: dict, seed: int, step: int, latent_dim: int, vocab: int, dev):
    """One step's batch and draws: lengths from the mix's grid in the
    seed's order, copied from pinned host memory without waiting for the
    device; contents from a generator on the device."""
    lens = T.train_lengths(mix, seed, step)
    b = mix["batch"]
    pp, pl, pr = mix["phonemes"]["pad"], mix["latents"]["pad"], mix["refs"]["pad"]
    g = torch.Generator(device=dev).manual_seed(T.torch_seed(seed, 20, step))
    ar = lambda n: torch.arange(n, device=dev)[None, :]  # noqa: E731

    def tens(a, dt):
        return to_device(torch.as_tensor(a).to(dt), dev)
    ph_len, lat_len, ref_len = tens(lens["phonemes"], torch.int32), tens(lens["latents"], torch.int32), \
        tens(lens["refs"], torch.int32)
    phonemes = torch.randint(1, vocab, (b, pp), generator=g, device=dev, dtype=torch.int32)
    phonemes = torch.where(ar(pp) < ph_len[:, None], phonemes, 0)
    latents = torch.randn((b, pl, latent_dim), generator=g, device=dev)
    latents = torch.where((ar(pl) < lat_len[:, None])[..., None], latents, 0.0)
    refs = torch.randn((b, pr, latent_dim), generator=g, device=dev)
    refs = torch.where((ar(pr) < ref_len[:, None])[..., None], refs, 0.0)
    batch = {"phonemes": phonemes, "phonemes_lengths": ph_len, "latents": latents, "latents_lengths": lat_len,
             "ref_latents": refs, "ref_latents_lengths": ref_len}
    draws = {"text_u": tens(lens["text_u"], torch.float32), "speaker_u": tens(lens["speaker_u"], torch.float32),
             "t": tens(lens["t"], torch.float32), "noise": torch.randn(latents.shape, generator=g, device=dev)}
    return batch, draws, lens


def step_work(m, mix, lens, drops) -> tuple:
    """(true latent frames, FLOPs) of a step: each row at its own lengths,
    its text or reference left out where the step's draws drop them."""
    from harness import flops as F

    frames = int(lens["latents"].sum())
    fl = 0.0
    for p, t, r, tu, su in zip(lens["phonemes"], lens["latents"], lens["refs"], lens["text_u"], lens["speaker_u"]):
        fl += F.teacher_row_flops(m, 0 if su < drops[1] else int(r), 0 if tu < drops[0] else int(p), int(t))
    return frames, fl


class TrainInputs:
    """What the benchmark makes from the seed for a training cell and what
    the reference needs: the starting params (float32 masters, kept on the
    host) and the checked steps' batches and draws."""

    def __init__(self, run: Run, keep_on_device: bool = False):
        tr = run.cell.config["training"]
        self.run, self.m, self.mix = run, run.model, run.cell.traffic
        self.drops = (tr["text_cfg_drop"], tr["speaker_cfg_drop"])
        gen = torch.Generator(device=run.device).manual_seed(T.torch_seed(run.seed, 11))
        flat = ref.make_params(ref.backbone_shapes(self.m), gen, torch.float32, run.device)
        self.p0 = {k: v.cpu() for k, v in flat.items()}
        self.flat = flat if keep_on_device else None
        self.kept_inputs = []  # the checked steps' batches and draws, on the host

    def checked_inputs(self):
        """The checked steps' batches and draws, made as the window makes them."""
        while len(self.kept_inputs) < CHECKED_STEPS:
            k = len(self.kept_inputs)
            batch, draws, _ = make_batch(self.mix, self.run.seed, k, self.m.latent_dim, self.m.vocab_size,
                                         self.run.device)
            self.kept_inputs.append(({n: v.cpu() for n, v in batch.items()}, {n: v.cpu() for n, v in draws.items()}))
        return self.kept_inputs

    def decay(self, k):
        from smalltts_tpu_torch.train.ema import ema_decay

        return np.float32(ema_decay(START_STEP + k, self.run.cell.config["training"]["ema_beta"]))


class Trainer(TrainInputs):
    """The program's teacher step, its params, optimizer state and EMA."""

    def __init__(self, run: Run):
        from smalltts_tpu_torch.train.ema import ema_init
        from smalltts_tpu_torch.train.optim import teacher_optimizer
        from smalltts_tpu_torch.train.teacher import TeacherTrainConfig, make_teacher_step
        from smalltts_tpu_torch.utils.checkpoint import flatten_pytree

        from harness.serve import program_configs

        if run.device.type == "cuda":
            from smalltts_tpu_torch.ops import kernels

            kernels.build_all()
        super().__init__(run, keep_on_device=True)
        tr = run.cell.config["training"]
        bcfg, _ = program_configs(run.cell.config)
        params = ref.nest(self.flat)
        self.flat = None
        self.tx, _ = teacher_optimizer(params, tr["num_steps"], tr["warmup_steps"])
        opt = self.tx.init(params)
        opt["count"] = torch.full_like(opt["count"], START_STEP)
        self.state = (params, opt, ema_init(params))
        self.step_fn = make_teacher_step(bcfg, self.tx, TeacherTrainConfig(
            batch_size=self.mix["batch"], text_cfg_drop=self.drops[0], speaker_cfg_drop=self.drops[1],
            ema_beta=tr["ema_beta"], remat=tr["remat"], compute_dtype=tr["compute_dtype"]))
        self.flatten = flatten_pytree
        self.k = 0
        self.readings: Dict[str, object] = {}

    def one(self) -> Step:
        """Make the next batch and dispatch its step; returns without
        waiting for the device."""
        batch, draws, lens = make_batch(self.mix, self.run.seed, self.k, self.m.latent_dim, self.m.vocab_size,
                                        self.run.device)
        if self.k < CHECKED_STEPS:
            self.kept_inputs.append(({k: v.cpu() for k, v in batch.items()}, {k: v.cpu() for k, v in draws.items()}))
        t0 = time.perf_counter()
        params, opt, ema, loss = self.step_fn(*self.state, batch, draws, self.decay(self.k))
        dispatch = time.perf_counter() - t0
        self.state = (params, opt, ema)
        frames, fl = step_work(self.m, self.mix, lens, self.drops)
        s = Step(self.k, dispatch, 0.0, frames, fl, loss)
        self.k += 1
        return s

    def warm(self) -> None:
        """Steps 0-2, with the readings the check compares."""
        losses = []
        for _ in range(CHECKED_STEPS):
            s = self.one()
            losses.append(float(s.loss))
            if s.index == 0:
                mu = self.flatten(self.state[1]["mu"])
                self.readings["grad"] = {n: float(torch.linalg.vector_norm(t) / (1 - self.tx.b1)) for n, t in mu.items()}
        self.readings["loss"] = losses
        dev = self.run.device
        for what, tree in (("change", self.state[0]), ("ema_change", self.state[2])):
            flat = self.flatten(tree)
            self.readings[what] = {n: float(torch.linalg.vector_norm(flat[n].float() - self.p0[n].to(dev)))
                                   for n in flat}
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def free_program(self) -> None:
        self.state = self.step_fn = None
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def reference_readings(trainer: TrainInputs, prec: "ref.Prec", rows_per_block: int) -> Dict[str, object]:
    """The same readings from the plain reference at `prec`, from the same
    start and the same three batches and draws."""
    dev, m = trainer.run.device, trainer.m
    params = {k: v.to(dev) for k, v in trainer.p0.items()}
    state = {**ref.adam_init(params), "count": START_STEP}
    ema = dict(params)
    out = {"loss": []}
    tr = trainer.run.cell.config["training"]
    with ref.tf32_off():
        for k, (batch, draws) in enumerate(trainer.checked_inputs()):
            batch = {n: v.to(dev) for n, v in batch.items()}
            draws = {n: v.to(dev) for n, v in draws.items()}
            params, state, loss, grads = ref.teacher_step(
                params, state, batch, draws, m, prec, rows_per_block, drops=trainer.drops,
                total=tr["num_steps"], warmup=tr["warmup_steps"])
            d = float(trainer.decay(k))
            ema = {n: d * ema[n] + (1 - d) * params[n] for n in params}
            out["loss"].append(float(loss))
            if k == 0:
                out["grad"] = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    out["change"] = {n: float(torch.linalg.vector_norm(params[n] - trainer.p0[n].to(dev))) for n in params}
    out["ema_change"] = {n: float(torch.linalg.vector_norm(ema[n] - trainer.p0[n].to(dev))) for n in params}
    return out


def gaps(got: Dict[str, object], want: Dict[str, object]) -> Dict[str, float]:
    """The compared numbers: the worst step's relative loss gap, and for the
    first gradient, the change of the params and of the EMA, the worst
    leaf's gap between the two norms over the larger of the reference's
    norm of that leaf and of the median leaf. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the changes."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))}
    g_med = statistics.median(want["grad"].values())
    live = [n for n, v in want["grad"].items() if v >= 1e-3 * g_med]
    for key, names in (("grad", list(want["grad"])), ("change", live), ("ema_change", live)):
        med = statistics.median(want[key][n] for n in names)
        out[f"{key}_gap"] = max(abs(got[key][n] - want[key][n]) / max(want[key][n], med, 1e-30) for n in names)
    return out


def check(run: Run, trainer: Trainer, limits: Dict[str, float], rows_per_block: int) -> Dict[str, float]:
    want = reference_readings(trainer, ref.Prec(torch.float32), rows_per_block)
    got = gaps(trainer.readings, want)
    for k, v in got.items():
        if k in limits:
            run.checks[k] = (v, limits[k])
        else:
            run.note(f"check: {k} {v!r} (not compared: no control or fault reads three times its sound runs)")
    return got



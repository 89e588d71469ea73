"""One rank of a gloo job that the tests of the port's parallel layer start
(tests/test_torch_parallel.py): it joins the job through
parallel.multihost.initialize_from_env (the SMALLTTS_* variables), runs every
check the job file names on the CPU, and saves what each returned for the
test process to compare with the JAX package and with the port's
single-process run. It imports neither JAX nor the JAX package.

    python tests/torch_parallel_job.py JOB.pt OUT_DIR RANK WORLD PORT
"""

import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smalltts_tpu_torch.parallel import multihost  # noqa: E402
from smalltts_tpu_torch.parallel.mesh import make_mesh, replicated, shard_params, use  # noqa: E402
from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree  # noqa: E402


def flat_np(tree):
    return {k: v.detach().float().numpy().copy() for k, v in flatten_pytree(tree).items()}


def rows(mesh, tree, axis=0):
    return {k: mesh.rows(torch.as_tensor(v), axis) for k, v in tree.items()}


def clone(tree):
    return map_pytree(torch.clone, tree)


def teacher_step(job, mesh, data):
    """One teacher step on this rank's rows of the global batch and draws,
    AdamW at a rate that moves the params; the params, first moments and
    EMA after it, whole (gathered over tp)."""
    from smalltts_tpu_torch.train import optim
    from smalltts_tpu_torch.train.ema import ema_init
    from smalltts_tpu_torch.train.teacher import TeacherTrainConfig, make_teacher_step

    params = replicated(clone(job[data]["params"]), mesh)
    if mesh.tp > 1:
        params = shard_params(params, mesh)
    tx = optim.adamw(params, job["lr"], clip_norm=1.0)
    step = make_teacher_step(job[data]["cfg"], tx, TeacherTrainConfig(), mesh=mesh)
    batch, draws = rows(mesh, job[data]["batch"]), rows(mesh, job[data]["draws"])
    p, opt, ema, loss = step(params, tx.init(params), ema_init(params), batch, draws, np.float32(0.5))
    return {"loss": float(loss), "params": flat_np(multihost.fetch_replicated(p, mesh)),
            "mu": flat_np(multihost.fetch_replicated(opt["mu"], mesh)),
            "ema": flat_np(multihost.fetch_replicated(ema, mesh))}


def teacher_loss(job, mesh, data):
    from smalltts_tpu_torch.train.teacher import teacher_loss as loss_fn

    params = shard_params(job[data]["params"], mesh)
    batch, draws = rows(mesh, job[data]["batch"]), rows(mesh, job[data]["draws"])
    with torch.no_grad(), use(mesh):
        return {"loss": float(loss_fn(params, job[data]["cfg"], batch, draws))}


def round_trip(job, mesh, data):
    """shard_params then fetch_replicated, on the split layout and on the
    fused int8 serving layout: the whole tree back bit for bit."""
    from smalltts_tpu_torch.models.dit import fuse_serving_projections, quantize_stream_weights

    out = {}
    params = job[data]["params"]
    for name, tree in (("split", params), ("fused_w8", quantize_stream_weights(fuse_serving_projections(params)))):
        local = shard_params(tree, mesh)
        back = flatten_pytree(multihost.fetch_replicated(local, mesh))
        want = flatten_pytree(tree)
        out[name] = {"equal": back.keys() == want.keys() and all(torch.equal(back[k], want[k]) for k in want),
                     "sharded": sorted(mesh.layout),
                     "local_shapes": {k: tuple(v.shape) for k, v in flatten_pytree(local).items()}}
    return out


def save(job, mesh, out_dir):
    path = os.path.join(out_dir, "ema_dp.npz")
    return {"wrote": multihost.save_on_coordinator(path, job["tiny"]["params"], mesh), "path": path}


def train_teacher_run(job, mesh):
    """train_teacher(mesh=): three steps on this rank's rows, a save at step 2."""
    from smalltts_tpu_torch.train.teacher import TeacherTrainConfig, train_teacher

    local = {k: mesh.rows(v) for k, v in job["tiny"]["batch"].items()}

    def loader():
        while True:
            yield local

    losses = []
    params, _ = train_teacher(TeacherTrainConfig(num_steps=3, save_every=2), job["tiny"]["cfg"], data_iter=loader(),
                              checkpoint_dir=job["teacher_train"]["dir"], device="cpu", mesh=mesh,
                              on_step=lambda step, loss: losses.append(float(loss)))
    return {"losses": losses, "params": flat_np(params)}


def distill(job, mesh):
    """One train_distill iteration, every rank on its rows of the global batch."""
    from smalltts_tpu_torch.train.distill import train_distill

    d = job["distill"]
    local = {k: mesh.rows(v) for k, v in d["batch"].items()}

    def loader():
        while True:
            yield local

    with tempfile.TemporaryDirectory() as tmp:
        student, scorer, disc, metrics = train_distill(
            d["train_cfg"], d["cfg"], d["disc_cfg"], d["asr_cfg"], d["sv_cfg"], data_iter=loader(),
            params_override=clone(d["nets"]), checkpoint_dir=tmp, device="cpu", mesh=mesh)
    return {"metrics": metrics, "student": flat_np(student), "scorer": flat_np(scorer), "disc": flat_np(disc)}


def imf(job, mesh):
    from smalltts_tpu_torch.train.imf import imf_optimizer, make_imf_step

    d = job["imf"]
    student = clone(d["student"])
    tx = imf_optimizer(student, d["train_cfg"], d["frozen"])
    step = make_imf_step(d["cfg"], tx, d["train_cfg"], mesh=mesh)
    student, opt, loss = step(student, tx.init(student), d["teacher"], rows(mesh, d["batch"]),
                              rows(mesh, d["draws"]))
    return {"loss": float(loss), "student": flat_np(student), "mu": flat_np(opt["mu"])}


def pipeline(job, mesh):
    """SmallTTS(mesh=) on the CPU: the sharded params' latents and the
    pipeline's waveform on the injected noise."""
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.infer.sampler import sample_latents

    d = job["pipeline"]
    tts = SmallTTS(clone(d["params"]), clone(d["codec"]), cfg=d["cfg"], codec_cfg=d["codec_cfg"], device="cpu",
                   mesh=mesh)
    ref, ref_len, ph, ph_len, seq, noises = d["inputs"]
    T = torch.from_numpy
    with torch.inference_mode(), use(mesh):
        lat = sample_latents(tts.params, d["cfg"], T(ref), T(ref_len), T(ph).long(), T(ph_len), T(seq),
                             num_steps=noises.shape[0], noises=T(noises))
    audio = tts.synthesize_padded(ref, ref_len, ph, ph_len, seq, noises.shape[2], noises=noises)
    heads = tts.params["dit"]["blocks"]["attn"]["q_norm"]["scale"].shape[-2]
    return {"latents": lat.numpy(), "audio": audio, "heads": heads, "graphs": tts.graphs}


def run(job, out_dir):
    res = {}
    world = multihost.initialize_from_env()["num_processes"]
    if world == 2:
        dp2, tp2 = make_mesh(dp=2, tp=1), make_mesh(dp=1, tp=2)
        checks = [("teacher_dp2", lambda: teacher_step(job, dp2, "tiny")),
                  ("teacher_tp2", lambda: teacher_step(job, tp2, "tiny")),
                  ("loss_dp2", lambda: teacher_loss(job, dp2, "tiny")),
                  ("loss_tp2", lambda: teacher_loss(job, tp2, "tiny")),
                  ("round_trip_tp2", lambda: round_trip(job, tp2, "tiny")),
                  ("save_dp2", lambda: save(job, dp2, out_dir)),
                  ("distill_dp2", lambda: distill(job, dp2)),
                  ("imf_dp2", lambda: imf(job, dp2)),
                  ("pipeline_tp2", lambda: pipeline(job, tp2)),
                  ("pipeline_dp2", lambda: pipeline(job, dp2)),
                  ("train_teacher_dp2", lambda: train_teacher_run(job, dp2))]
    else:
        tp4, dp2tp2 = make_mesh(dp=1, tp=4), make_mesh(dp=2, tp=2)
        checks = [("loss_mid_tp4", lambda: teacher_loss(job, tp4, "mid")),
                  ("loss_dp2tp2", lambda: teacher_loss(job, dp2tp2, "tiny")),
                  ("teacher_dp2tp2", lambda: teacher_step(job, dp2tp2, "tiny")),
                  ("round_trip_tp4", lambda: round_trip(job, tp4, "mid"))]
    res["seconds"] = {}
    for name, fn in checks:
        t0 = time.perf_counter()
        res[name] = fn()
        res["seconds"][name] = time.perf_counter() - t0
    multihost.barrier()
    return res


def main(job_path, out_dir, rank, world, port):
    os.environ.update(SMALLTTS_COORDINATOR=f"127.0.0.1:{port}", SMALLTTS_NUM_PROCESSES=str(world),
                      SMALLTTS_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)  # written by the test process
    try:
        res = run(job, out_dir)
    except Exception:  # noqa: BLE001 -- reported to the test process, which fails
        res = {"error": traceback.format_exc()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    return 1 if "error" in res else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])))

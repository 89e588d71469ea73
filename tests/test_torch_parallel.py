"""The port's parallel layer (smalltts_tpu_torch/parallel/ and its call sites)
against the JAX package's, on the CPU.

The sharding rules are held leaf by leaf against the JAX package's
`_leaf_spec` here. The process-group checks run in two gloo jobs, started
once for this module: two ranks (dp = 2, then tp = 2 on the same ranks) and
four (tp = 4, dp = 2 x tp = 2). Each rank (tests/torch_parallel_job.py, no
JAX) runs every check and saves what it got; the tests compare that with the
JAX package (losses) and with the port's single-process run (steps,
iterations, audio), computed here.

Tolerances: teacher losses against JAX's single-device loss 2e-4 relative
(the JAX tests' own bound for dp/tp against one device); the same step's
params, first moments and EMA on every dp replica equal bit for bit; a
parallel step or iteration against the port's single-process one 1e-5 of
the largest value for losses and metrics and 1e-5 rel-L2 per leaf for
params and moments (fp32 sums in another order: the batch split and the
row-parallel partial sums), 1e-4 for the discriminator after AdamW (a
bias before a training-mode BatchNorm, its gradient zero but for rounding,
as tests/test_torch_distill.py holds it); SmallTTS(mesh=) latents and waveform 1e-5 of
the largest value against the single-process port and against JAX's
sampler and codec (tests/test_torch_pipeline.py's bound); shard and gather
back bit for bit.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu.data import dummy as JDD  # noqa: E402
from smalltts_tpu.infer.sampler import sample_latents as j_sample_latents  # noqa: E402
from smalltts_tpu.models import backbone as JBK  # noqa: E402
from smalltts_tpu.models.codec import codec_decode as j_codec_decode  # noqa: E402
from smalltts_tpu.models.dit import DiTConfig as JDiTConfig  # noqa: E402
from smalltts_tpu.models.encoder import EncoderConfig as JEncoderConfig  # noqa: E402
from smalltts_tpu.parallel import mesh as JM  # noqa: E402
from smalltts_tpu.train import teacher as JT  # noqa: E402
from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu_torch.infer.pipeline import SmallTTS  # noqa: E402
from smalltts_tpu_torch.models import asr as PA  # noqa: E402
from smalltts_tpu_torch.models.backbone import init_backbone  # noqa: E402
from smalltts_tpu_torch.models.codec import init_codec  # noqa: E402
from smalltts_tpu_torch.models import conformer as PC  # noqa: E402
from smalltts_tpu_torch.models import discriminator as PDi  # noqa: E402
from smalltts_tpu_torch.models import sv as PSV  # noqa: E402
from smalltts_tpu_torch.models.dit import fuse_serving_projections, quantize_stream_weights  # noqa: E402
from smalltts_tpu_torch.parallel import mesh as PM  # noqa: E402
from smalltts_tpu_torch.train import distill as PDS  # noqa: E402
from smalltts_tpu_torch.train import imf as PI  # noqa: E402
from smalltts_tpu_torch.train import optim as PO  # noqa: E402
from smalltts_tpu_torch.train.ema import ema_init  # noqa: E402
from smalltts_tpu_torch.train.teacher import TeacherTrainConfig, make_teacher_step, train_teacher  # noqa: E402
from smalltts_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402
from smalltts_tpu_torch.utils.convert import params_to_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_job.py")
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
# tests/test_fullsize_sharding.py's mid-size config: hidden 512, 4 blocks, head dim 64
MID = JBK.BackboneConfig(hidden_dim=512, phoneme_dim=256,
                         dit=JDiTConfig(hidden_dim=512, phoneme_dim=256, n_blocks=4),
                         text=JEncoderConfig(256, 4, 4, 512, 1e-6), style=JEncoderConfig(256, 4, 4, 768, 1e-5))
PMID = backbone_config_from_dict(dataclasses.asdict(MID))
DATA = dict(max_phonemes=12, min_phonemes=4, max_latents=24, min_latents=8, max_ref=10, min_ref=4)
LR = 1e-3  # AdamW's rate in the steps compared here: the step moves the params
T = torch.from_numpy


def rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


def worst_l2(got: dict, want: dict):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    k = max(errs, key=errs.get)
    return errs[k], k


def flat_np(tree):
    return {k: v.detach().float().numpy().copy() for k, v in pckpt.flatten_pytree(tree).items()}


def backbone(cfg, seed):
    """The port's seeded init with seeded values in the zero-init leaves
    (adaLN modulation, norm_out, velocity head): at zero every block is the
    identity and the loss would not depend on what the blocks compute."""
    gen = torch.Generator().manual_seed(seed)
    params = init_backbone(gen, cfg)
    dit = params["dit"]
    for lin in (dit["blocks"]["attn_norm"]["linear"], dit["norm_out"]["linear"], params["velocity"]):
        for k, t in lin.items():
            t.copy_((0.2 if k == "w" else 0.5) * torch.randn(t.shape, generator=gen))
    return params


def jax_tree(tree, cfg=None):
    """A port tree in the JAX package's layout, as JAX arrays."""
    return jax.tree.map(jnp.asarray, pckpt.map_pytree(lambda t: t.numpy(), params_to_jax(tree, cfg)))


def jax_draws(key, batch):
    """JAX teacher_loss's draws from `key`, its splits replicated (as tests/test_torch_train.py)."""
    k_drop, k_t, k_noise = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_drop)
    b = batch["latents"].shape[0]
    draws = {"text_u": jax.random.uniform(k1, (b,)), "speaker_u": jax.random.uniform(k2, (b,)),
             "t": jax.nn.sigmoid(jax.random.normal(k_t, (b,))),
             "noise": jax.random.normal(k_noise, batch["latents"].shape, jnp.float32)}
    return {k: np.asarray(v) for k, v in draws.items()}


def np_batch(seed, b, **data):
    cfg = JDD.DummyDataConfig(batch_size=b, **data)
    return {k: v for k, v in JDD.dummy_batch(np.random.default_rng(seed), cfg).items() if k != "texts"}


def tensors(d):
    return {k: T(np.array(v)) for k, v in d.items()}


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(job, world, tmp, timeout=300):
    """Run the job on `world` gloo ranks; every rank's results (every rank is
    reaped before any failure is reported)."""
    path = os.path.join(tmp, "job.pt")
    torch.save(job, path)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SMALLTTS_", "MASTER_", "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, WORKER, path, tmp, str(r), str(world), str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    for p in procs:
        if p.poll() is None:
            p.kill()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        f = os.path.join(tmp, f"rank{r}.pt")
        res = torch.load(f, weights_only=False) if os.path.exists(f) else {"error": f"no result, rc={p.returncode}"}
        assert "error" not in res and p.returncode == 0, f"rank {r}: {res.get('error')}\n{err[-3000:]}"
        results.append(res)
    print(f"{world}-rank job, rank 0's seconds per check: {results[0]['seconds']}")
    return results


# --------------------------------------------------------------------- inputs


def jax_loss(params, cfg, batch, key):
    """JAX teacher_loss on one device, the whole batch."""
    loss = jax.jit(JT.teacher_loss, static_argnums=1)(jax_tree(params), cfg,
                                                      {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return float(loss)


@pytest.fixture(scope="module")
def tiny():
    params = backbone(PCFG, 0)
    batch = np_batch(3, 4, **DATA)
    key = jax.random.PRNGKey(7)
    return {"params": params, "cfg": PCFG, "batch": batch, "draws": jax_draws(key, batch),
            "jax_loss": jax_loss(params, TINY_BACKBONE, batch, key)}


@pytest.fixture(scope="module")
def mid():
    params = backbone(PMID, 2)
    rng = np.random.RandomState(0)
    b, t_len, r, p = 4, 32, 16, 24
    batch = {"latents": rng.randn(b, t_len, 64).astype(np.float32), "latents_lengths": np.full((b,), t_len, np.int32),
             "ref_latents": rng.randn(b, r, 64).astype(np.float32), "ref_latents_lengths": np.full((b,), r, np.int32),
             "phonemes": rng.randint(1, 190, size=(b, p)).astype(np.int32),
             "phonemes_lengths": np.full((b,), p, np.int32)}
    key = jax.random.PRNGKey(5)
    return {"params": params, "cfg": PMID, "batch": batch, "draws": jax_draws(key, batch),
            "jax_loss": jax_loss(params, MID, batch, key)}


# the distiller's tiny discriminator (batch norm in its conformer), ASR (16 heads of 4) and SV,
# as tests/test_torch_distill.py's; their weights from the port's own seeded init
P_DISC_BN = PDi.DiscriminatorConfig(
    latent_dim=64, transformer_dim=64, ref_dim=64, model_dim=32, num_tail_layers=2,
    conformer=PC.ConformerConfig(input_dim=32, num_heads=4, ffn_dim=64, num_layers=2, depthwise_conv_kernel_size=7))
P_ASR = PA.ASRConfig(input_dim=64, conformer=PC.ConformerConfig(input_dim=64, num_heads=16, ffn_dim=64, num_layers=2,
                                                                depthwise_conv_kernel_size=9))
P_SV = PSV.SVConfig(input_dim=64, emb_dim=8, channels=(24, 24, 24, 24, 72), attention_channels=8, res2net_scale=4,
                    se_channels=8)


def distill_job(tiny):
    gen = torch.Generator().manual_seed(0)
    nets = {"teacher": tiny["params"], "asr": PA.init_asr(gen, P_ASR), "sv": PSV.init_sv(gen, P_SV),
            "disc": PDi.init_discriminator(gen, P_DISC_BN)}
    # gates open at step 0: the ASR's CTC and the SV's cosine losses are means over the global batch too
    train_cfg = PDS.DistillConfig(num_steps=1, scorer_updates=1, asr_start_step=-1, sv_start_step=-1)
    return {"nets": nets, "cfg": PCFG, "disc_cfg": P_DISC_BN, "asr_cfg": P_ASR, "sv_cfg": P_SV,
            "train_cfg": train_cfg, "batch": np_batch(5, 4, max_phonemes=10, min_phonemes=4, max_latents=16,
                                                      min_latents=8, max_ref=8, min_ref=4)}


def imf_job(tiny):
    teacher = tiny["params"]
    student = PI.init_imf_student(teacher)
    student["r_gate"] = 0.3 * torch.randn(student["r_gate"].shape, generator=torch.Generator().manual_seed(4))
    tc = PI.ImfConfig(rollout_substeps=2, boundary_prob=0.5, rollin_prob=0.5)
    batch = tensors(tiny["batch"])
    return {"teacher": teacher, "student": student, "cfg": PCFG, "train_cfg": tc, "frozen": PI.IMF_FROZEN,
            "batch": batch, "draws": PI.imf_draws(torch.Generator().manual_seed(6), batch, tc)}


@pytest.fixture(scope="module")
def pipeline_inputs():
    """Tiny weights and a batch of two, with the JAX package's latents and
    waveform and the single-process port's on them."""
    params, codec = backbone(PCFG, 0), init_codec(torch.Generator().manual_seed(1), PCODEC)
    rs = np.random.RandomState(2)
    b, r, p, tb, steps = 2, 64, 128, 16, 4
    inputs = (rs.randn(b, r, 64).astype(np.float32), np.array([40, 9], np.int32),
              rs.randint(1, 198, size=(b, p)).astype(np.int32), np.array([100, 31], np.int32),
              np.array([tb, 11], np.int32), rs.randn(steps, b, tb, 64).astype(np.float32))
    ref, ref_len, ph, ph_len, seq, noises = inputs
    sample = jax.jit(j_sample_latents, static_argnums=1, static_argnames="num_steps")  # jitted: fewer compiles
    lat_j = sample(jax_tree(params), TINY_BACKBONE, *(jnp.asarray(a) for a in inputs[:5]), jax.random.PRNGKey(9),
                   num_steps=steps, noises=jnp.asarray(noises))
    audio_j = np.asarray(jax.jit(j_codec_decode, static_argnums=2)(jax_tree(codec), lat_j, TINY_CODEC))
    tts = SmallTTS(params, codec, cfg=PCFG, codec_cfg=PCODEC, device="cpu")
    audio_p = tts.synthesize_padded(ref, ref_len, ph, ph_len, seq, tb, noises=noises)
    return {"params": params, "codec": codec, "cfg": PCFG, "codec_cfg": PCODEC, "inputs": inputs,
            "want": {"latents_jax": np.asarray(lat_j), "audio_jax": audio_j, "audio_port": audio_p}}


@pytest.fixture(scope="module")
def job2(tiny, pipeline_inputs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("job2"))
    job = {"lr": LR, "tiny": {k: tiny[k] for k in ("params", "cfg", "batch", "draws")},
           "distill": distill_job(tiny), "imf": imf_job(tiny),
           "pipeline": {k: pipeline_inputs[k] for k in ("params", "codec", "cfg", "codec_cfg", "inputs")},
           "teacher_train": {"dir": os.path.join(tmp, "teacher")}}
    return job, spawn(job, 2, tmp), tmp


@pytest.fixture(scope="module")
def job4(tiny, mid, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("job4"))
    job = {"lr": LR, "tiny": {k: tiny[k] for k in ("params", "cfg", "batch", "draws")},
           "mid": {k: mid[k] for k in ("params", "cfg", "batch", "draws")}}
    return job, spawn(job, 4, tmp)


def single_teacher_step(data):
    """The port's step on the whole global batch in one process: the reference of the parallel steps."""
    params = pckpt.map_pytree(torch.clone, data["params"])
    tx = PO.adamw(params, LR, clip_norm=1.0)
    step = make_teacher_step(data["cfg"], tx, TeacherTrainConfig())
    p, opt, ema, loss = step(params, tx.init(params), ema_init(params), tensors(data["batch"]),
                             tensors(data["draws"]), np.float32(0.5))
    return {"loss": float(loss), "params": flat_np(p), "mu": flat_np(opt["mu"]), "ema": flat_np(ema)}


# ---------------------------------------------------------------------- rules


def _shape_tree(which):
    cfg = TINY_BACKBONE if which == "tiny" else JBK.BackboneConfig()  # the 328M tree by shape only
    return jax.eval_shape(lambda k: JBK.init_backbone(k, cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("which", ["tiny", "328M"])
def test_param_shardings_match_jax_rules(which, tp):
    """The port's param_shardings chooses the JAX package's leaves and axes,
    leaf by leaf, on the whole backbone tree (by shape)."""
    tree = _shape_tree(which)
    want = {JM._path_str(path): tuple(JM._leaf_spec(JM._path_str(path), leaf, tp))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    specs = PM.param_shardings(tree, PM.make_mesh(dp=1, tp=tp, devices=range(tp)))

    def spec(path):
        node = specs
        for k in path.split("/"):
            node = node[k]
        return node

    assert {k: spec(k) for k in want} == want
    assert any(want.values()) == (tp > 1)


def _shards(params, tp):
    """Every tp rank's shard_params of `params`, in one process (a mesh
    without a process group lays out rank 0's; its rank is set by hand)."""
    out = []
    for r in range(tp):
        m = PM.make_mesh(dp=1, tp=tp, devices=range(tp))
        m.tp_rank = r
        out.append(PM.shard_params(params, m))
    return m.layout, out


@pytest.mark.parametrize("which,tp", [("tiny", 2), ("mid", 4)])
def test_shards_hold_whole_heads_and_unshard_bit_for_bit(request, which, tp):
    """A shard of a fused leaf holds whole heads of each part (q|k|v of
    qkv_self and qkvg, k|v, each half of w13), the per-head norms follow
    their heads, and the shards put back are the leaf, bit for bit."""
    data = request.getfixturevalue(which)
    cfg = data["cfg"].dit
    d, h = cfg.head_dim, cfg.hidden_dim
    params = quantize_stream_weights(fuse_serving_projections(data["params"]))
    layout, shards = _shards(params, tp)
    flat = pckpt.flatten_pytree(params)
    local = [pckpt.flatten_pytree(s) for s in shards]
    for name, (axis, parts) in layout.items():
        assert torch.equal(PM.unshard([s[name] for s in local], axis, parts), flat[name]), name
    qkvg, per = flat["dit/blocks/attn/qkvg/w_q"], cfg.heads // tp
    for r in range(tp):
        got = local[r]["dit/blocks/attn/qkvg/w_q"]
        assert got.shape[-1] == 4 * per * d
        for part in range(4):  # this rank's heads of q, k, v and the gate, in order
            lo = part * h + r * per * d
            assert torch.equal(got[..., part * per * d:(part + 1) * per * d], qkvg[..., lo:lo + per * d])
        assert torch.equal(local[r]["dit/blocks/attn/q_norm/scale"],
                           flat["dit/blocks/attn/q_norm/scale"][:, r * per:(r + 1) * per])
    assert "dit/blocks/attn/to_out/scale" not in layout  # a row shard keeps its columns' whole scale
    assert layout["dit/blocks/attn/to_out/w_q"] == (1, 1) and layout["dit/blocks/ff/w13/b"] == (1, 2)


def test_shard_params_needs_whole_heads(tiny):
    """tp = 8 divides the tiny DiT's 64 columns (the JAX rule shards them)
    but not its 4 heads: the port refuses rather than split a head."""
    with pytest.raises(ValueError, match="whole heads"):
        PM.shard_params(tiny["params"], PM.make_mesh(dp=1, tp=8, devices=range(8)))


# ------------------------------------------------------------- the 2-rank job


@pytest.mark.parametrize("check", ["loss_dp2", "loss_tp2"])
def test_teacher_loss_matches_jax(job2, tiny, check):
    _, res, _ = job2
    want = tiny["jax_loss"]
    losses = [r[check]["loss"] for r in res]
    assert losses[0] == losses[1]
    assert abs(losses[0] - want) <= 2e-4 * abs(want), (losses, want)


@pytest.mark.parametrize("check", ["teacher_dp2", "teacher_tp2"])
def test_teacher_step_matches_single_process(job2, tiny, check):
    """One step at dp = 2 (each rank 2 rows of 4) and at tp = 2: the loss
    is JAX's; params, moments and EMA (gathered over tp) are equal on both
    ranks bit for bit and within 1e-5 rel-L2 of the single-process step."""
    _, res, _ = job2
    want = single_teacher_step(tiny)
    assert abs(res[0][check]["loss"] - tiny["jax_loss"]) <= 2e-4 * abs(want["loss"])
    assert abs(res[0][check]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for tree in ("params", "mu", "ema"):
        a, b = res[0][check][tree], res[1][check][tree]
        assert all(np.array_equal(a[k], b[k]) for k in a), tree
        err, leaf = worst_l2(a, want[tree])
        assert err <= 1e-5, (tree, leaf, err)


@pytest.mark.parametrize("layout", ["split", "fused_w8"])
def test_shard_then_fetch_replicated_round_trip(job2, layout):
    _, res, _ = job2
    for r in res:
        got = r["round_trip_tp2"][layout]
        assert got["equal"]
        assert "dit/blocks/attn/k_norm_cross/scale" in got["sharded"]
        assert any(n.startswith("style_encoder/") for n in got["sharded"])
    shapes = [r["round_trip_tp2"][layout]["local_shapes"] for r in res]
    assert shapes[0] == shapes[1]


def test_save_on_coordinator_one_writer(job2, tiny):
    """At dp = 2 rank 0 alone writes; the JAX package's load_pytree reads
    the file back to the tree."""
    _, res, _ = job2
    assert [r["save_dp2"]["wrote"] for r in res] == [True, False]
    loaded = jckpt.flatten_pytree(jckpt.load_pytree(res[0]["save_dp2"]["path"]))
    want = flat_np(tiny["params"])
    assert loaded.keys() == want.keys() and all(np.array_equal(loaded[k], want[k]) for k in want)


def test_train_distill_dp2_matches_single_process(job2, tiny):
    """train_distill(mesh=dp2), one iteration with every gate open and a
    batch-norm discriminator: its metrics (the student's pseudo, GAN, CTC
    and SV losses, the discriminator's and the scorer's) and the updated
    student, scorer and discriminator are the single-process iteration's."""
    job, res, _ = job2
    d = job["distill"]

    def loader():
        while True:
            yield d["batch"]

    student, scorer, disc, metrics = PDS.train_distill(
        d["train_cfg"], d["cfg"], d["disc_cfg"], d["asr_cfg"], d["sv_cfg"], data_iter=loader(),
        params_override=pckpt.map_pytree(torch.clone, d["nets"]), checkpoint_dir=os.path.join(job2[2], "distill"),
        device="cpu")
    for r in res:
        got = r["distill_dp2"]
        assert got["metrics"].keys() == metrics.keys()
        for k, v in metrics.items():
            assert abs(got["metrics"][k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, got["metrics"][k], v)
        # the disc at 1e-4: its depthwise conv's bias before a training-mode BatchNorm has a zero gradient,
        # whose rounding noise Adam normalizes (4.6e-5 measured, as in tests/test_torch_distill.py)
        for name, tree, tol in (("student", student, 1e-5), ("scorer", scorer, 1e-5), ("disc", disc, 1e-4)):
            err, leaf = worst_l2(got[name], flat_np(tree))
            assert err <= tol, (name, leaf, err)
    assert all(np.array_equal(res[0]["distill_dp2"]["disc"][k], res[1]["distill_dp2"]["disc"][k])
               for k in res[0]["distill_dp2"]["disc"])


def test_imf_step_dp2_matches_single_process(job2):
    """make_imf_step on dp = 2 (boundary and roll-in samples in the batch)
    equals the single-process step: the counterpart of JAX's
    test_imf_step_on_dp_mesh."""
    job, res, _ = job2
    d = job["imf"]
    student = pckpt.map_pytree(torch.clone, d["student"])
    tx = PI.imf_optimizer(student, d["train_cfg"], d["frozen"])
    step = PI.make_imf_step(d["cfg"], tx, d["train_cfg"])
    student, opt, loss = step(student, tx.init(student), d["teacher"], d["batch"], d["draws"])
    for r in res:
        got = r["imf_dp2"]
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for tree, want in (("student", student), ("mu", opt["mu"])):
            err, leaf = worst_l2(got[tree], flat_np(want))
            assert err <= 1e-5, (tree, leaf, err)


@pytest.mark.parametrize("check", ["pipeline_tp2", "pipeline_dp2"])
def test_smalltts_mesh_matches_single_process_and_jax(job2, pipeline_inputs, check):
    """SmallTTS(mesh=) at tp = 2 (2 heads of 4 a rank) and at dp = 2 (a row
    a rank, the audio gathered): latents and waveform on the injected noise
    against the single-process port and JAX's sampler and codec."""
    _, res, _ = job2
    want = pipeline_inputs["want"]
    for r in res:
        got = r[check]
        assert got["heads"] == (2 if check == "pipeline_tp2" else 4) and got["graphs"] is False
        assert rel_max(got["latents"], want["latents_jax"]) < 1e-5
        assert rel_max(got["audio"], want["audio_port"]) < 1e-5 and rel_max(got["audio"], want["audio_jax"]) < 1e-5
    assert np.array_equal(res[0][check]["audio"], res[1][check]["audio"])


def test_train_teacher_dp2_runs(job2, tiny):
    """train_teacher(mesh=dp2): three steps, each rank on its rows of the
    global batch; the losses are the single-process run's (1e-5), the
    params equal on both ranks, and rank 0 alone wrote the checkpoints and
    the metrics."""
    job, res, _ = job2
    losses = []
    batch = tiny["batch"]

    def loader():
        while True:
            yield batch

    params, ema = train_teacher(TeacherTrainConfig(num_steps=3, save_every=2), PCFG, data_iter=loader(),
                                checkpoint_dir=os.path.join(job2[2], "single"), device="cpu",
                                on_step=lambda s, loss: losses.append(float(loss)))
    got = [r["train_teacher_dp2"] for r in res]
    assert got[0]["losses"] == got[1]["losses"]
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got[0]["losses"], losses)), (got[0]["losses"], losses)
    assert all(np.array_equal(got[0]["params"][k], got[1]["params"][k]) for k in got[0]["params"])
    err, leaf = worst_l2(got[0]["params"], flat_np(params))
    assert err <= 1e-5, (leaf, err)
    assert sorted(os.listdir(job["teacher_train"]["dir"])) == [
        "checkpoint_ema.npz", "checkpoint_latest.npz", "metrics.jsonl", "train_state.npz"]


# ------------------------------------------------------------- the 4-rank job


def test_tp4_matches_jax_at_midsize(job4, mid):
    """tp = 4 at the mid-size config (head dim 64, 8 DiT heads, 4 in each
    encoder), 4 ranks: the counterpart of JAX's
    test_tp4_matches_single_device_at_midsize, with the zero-init leaves
    re-drawn so the loss depends on the blocks."""
    _, res = job4
    want = mid["jax_loss"]
    losses = [r["loss_mid_tp4"]["loss"] for r in res]
    assert len(set(losses)) == 1 and np.isfinite(losses[0])
    assert abs(losses[0] - want) <= 2e-4 * abs(want), (losses[0], want)
    for r in res:
        assert r["round_trip_tp4"]["split"]["equal"] and r["round_trip_tp4"]["fused_w8"]["equal"]


def test_dp2_tp2_teacher_step(job4, tiny):
    """dp = 2 x tp = 2 on 4 ranks (tp pairs on consecutive ranks): the loss
    is JAX's; the gathered params, moments and EMA equal on all four ranks
    and within 1e-5 rel-L2 of the single-process step: the counterpart of
    JAX's test_teacher_step_on_dp_tp_mesh."""
    _, res = job4
    want = single_teacher_step(tiny)
    jl = tiny["jax_loss"]
    for r in res:
        assert abs(r["loss_dp2tp2"]["loss"] - jl) <= 2e-4 * abs(jl)
        assert abs(r["teacher_dp2tp2"]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for tree in ("params", "mu", "ema"):
        a = res[0]["teacher_dp2tp2"][tree]
        for r in res[1:]:
            assert all(np.array_equal(a[k], r["teacher_dp2tp2"][tree][k]) for k in a), tree
        err, leaf = worst_l2(a, want[tree])
        assert err <= 1e-5, (tree, leaf, err)

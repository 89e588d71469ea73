"""Card-only: the program's spans share the clock of torch.profiler's device
trace (smalltts_tpu_torch/utils/profiling.py stamps them with
time.time_ns()). Skipped where there is no CUDA card. On a card machine,
which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py

Under a CUDA-only profiler, started after the pipeline's graph was
captured, with no offset applied:
- each cudaGraphLaunch runtime record lies inside its pipeline.replay span;
- in a tiny teacher step, each runtime record that launched a
  multi_tensor_apply_kernel (AdamW's, the EMA's and the norm's foreach ops)
  lies inside teacher.update.
"Inside" allows TOL_NS at either end: torch converts its own clock to the
wall clock by a linear fit, taken once a process.
"""

import time

import pytest
import torch

from test_torch_graphs_cuda import batch, small_tts

from smalltts_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
TOL_NS = 100_000  # 0.1 ms


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def cuda_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def runtime_records(prof):
    """(name, start ns, end ns, correlation id) of the host's CUDA runtime
    calls, and the device's records by correlation id."""
    host, device = [], {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            device.setdefault(e.correlation_id(), []).append(e.name())
        else:
            host.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    return host, device


def residual(rec, spans):
    """How far the record (start, end) lies outside the nearest span, ns."""
    return min(max(s.start - rec[0], rec[1] - s.end, 0) for s in spans)


def test_graph_launches_lie_inside_their_replay_spans(dev):
    tts = small_tts(dev)
    args = batch(2, 64, 128, 16, seed=7)
    tts.synthesize_padded(*args)  # captured outside the trace
    with cuda_profile():  # the first start initializes CUPTI
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    t0 = time.time_ns()
    with cuda_profile() as prof:
        for _ in range(6):
            tts.synthesize_padded(*args, fetch=False)
        torch.cuda.synchronize()
    host, _ = runtime_records(prof)
    launches = [(s, e) for name, s, e, _ in host if name == "cudaGraphLaunch"]
    replays = [s for s in profiling.spans() if s.name == "pipeline.replay" and s.start >= t0]
    assert len(launches) == len(replays) == 6
    worst = max(residual(rec, replays) for rec in launches)
    assert worst <= TOL_NS, worst


def test_foreach_launches_of_a_teacher_step_lie_inside_its_update(dev):
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.train.ema import ema_init
    from smalltts_tpu_torch.train.optim import teacher_optimizer
    from smalltts_tpu_torch.train.teacher import make_teacher_step, teacher_draws

    enc = EncoderConfig(model_size=32, num_layers=1, num_heads=2, intermediate_size=64, norm_eps=1e-6)
    cfg = BackboneConfig(latent_dim=64, hidden_dim=64, phoneme_dim=32, text=enc, style=enc,
                         dit=DiTConfig(latent_dim=64, phoneme_dim=32, hidden_dim=64, n_blocks=1, heads=4,
                                       rot_dim=8, conv_groups=16))
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_backbone(g, cfg, device=dev)
    tx, _ = teacher_optimizer(params, 10, 2)
    lens = lambda *v: torch.tensor(v, device=dev)  # noqa: E731
    b = {"phonemes": torch.randint(1, 50, (2, 12), generator=g, device=dev), "phonemes_lengths": lens(12, 7),
         "latents": torch.randn((2, 16, 64), generator=g, device=dev), "latents_lengths": lens(16, 11),
         "ref_latents": torch.randn((2, 8, 64), generator=g, device=dev), "ref_latents_lengths": lens(8, 5)}
    step = make_teacher_step(cfg, tx)
    state = (params, tx.init(params), ema_init(params))
    with kernels.force_plain():  # the tiny widths need no hand-written kernel; the foreach ops are PyTorch's
        state = step(*state, b, teacher_draws(g, b))[:3]  # first use outside the trace
        with cuda_profile():
            torch.cuda.synchronize()
        t0 = time.time_ns()
        with cuda_profile() as prof:
            step(*state, b, teacher_draws(g, b))
            torch.cuda.synchronize()
    host, device = runtime_records(prof)
    foreach = [(s, e) for _, s, e, corr in host
               if any("multi_tensor_apply_kernel" in n for n in device.get(corr, ()))]
    updates = [s for s in profiling.spans() if s.name == "teacher.update" and s.start >= t0]
    assert len(updates) == 1 and foreach
    worst = max(residual(rec, updates) for rec in foreach)
    assert worst <= TOL_NS, worst

"""Card-only: the distiller's attention shapes and one student step on the
card. Skipped where there is no CUDA card (the attention kernel has no CPU
mode). On a card machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_distill_cuda.py

- The head-dim-4 kernel (the ASR conformer's 16 heads of 4) against
  attention_plain at the ASR's shape (2, 16, 1024, 4) with a key mask and a
  fully-masked row, fp32 and bf16: the forward within 1e-5 / 2e-2 of the
  largest plain value (fp32 sums in another order; bf16 output rounded
  once), the Function's dq/dk/dv against autograd through attention_plain
  within 1e-4 / 2e-2 (the backward reads the kernel's output), one launch a
  call; the second key source and the gate at D = 4 likewise; any head dim
  outside (4, 64, 120, 128) raises.
- The discriminator's self-attention, (4, 8, 1030, 64) fp32, and the
  backbone's bf16 shapes at the distiller's batches 2 and 6 (the teacher's
  CFG batch), where the bf16 kernel splits the keys across a cluster, the
  same way. Each launch is counted under its shape as well.
- One full-width student step (default configs, batch 2, fp32, gates open)
  with the kernels against kernels.force_plain(): the metrics within 1e-4
  relative, each student module's gradient within 1e-4 rel-L2 (fp32 sums in
  another order), and exactly the attention launches the step makes:
  style 12 + 5 backbone forwards x 32 + the DiT's 12 again in the remat
  backward + the discriminator's 6 + the ASR's 7 = 197.
"""

import pytest
import torch

from smalltts_tpu_torch.ops import kernels
from smalltts_tpu_torch.ops.kernels import attention as A

pytestmark = pytest.mark.cuda
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (B, H, Tq, S, D)
SHAPES = {"asr": (2, 16, 1024, 1024, 4), "disc": (4, 8, 1030, 1030, 64),
          **{f"{name}-B{b}": (b,) + shape for b in (2, 6) for name, shape in
             (("text", (4, 198, 198, 128)), ("style", (8, 64, 64, 64)), ("dit", (8, 256, 518, 120)))}}
BACKBONE = [(f"{name}-B{b}", torch.bfloat16) for b in (2, 6) for name in ("text", "style", "dit")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("case", [("asr", torch.float32), ("asr", torch.bfloat16), ("disc", torch.float32)] + BACKBONE,
                         ids=["asr-fp32", "asr-bf16", "disc-fp32"] + [f"{n}-bf16" for n, _ in BACKBONE])
def test_distill_attention_shapes_match_plain(dev, case):
    shape, dtype = case
    B, H, T, S, D = SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(0)
    q, dout = (torch.randn((B, H, T, D), generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, H, S, D), generator=g, device=dev).to(dtype) for _ in range(2))
    mask = torch.arange(S, device=dev)[None] < torch.tensor([S, S // 3, S // 2, S, S, S // 5][:B], device=dev)[:, None]
    mask[-1] = False  # a fully-masked row: a uniform average, and no gradient to q or k
    kernels.reset_launches()
    out = A.fused_attention(q, k, v, mask)
    assert kernels.LAUNCHES["attention"] == 1
    assert kernels.SHAPE_LAUNCHES == {("attention", (B, H, T, S, D, dtype)): 1}
    assert out.dtype == dtype and rel(out, A.attention_plain(q, k, v, mask)) <= FWD_TOL[dtype]
    grads = []
    for fn in (A.attention, A.attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves, mask)
        o.backward(dout)
        grads.append([t.grad for t in leaves])
    for got, want, name in zip(*grads, ("dq", "dk", "dv")):
        assert rel(got, want) <= GRAD_TOL[dtype], (name, rel(got, want))
    assert float(grads[0][0][-1].abs().max()) == 0.0 and float(grads[0][1][-1].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_4_second_source_gate_and_views(dev, dtype):
    """The small-head kernel takes the wrapper's whole interface: a second
    key source with its own mask, the gate, and q/k/v as strided views of
    one (B, T, 3 * H * 4) buffer (the conformer's in_proj output)."""
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, T, S2, D = 2, 16, 70, 33, 4
    qkv = torch.randn((B, T, 3 * H * D), generator=g, device=dev).to(dtype)
    q, k, v = (a.reshape(B, T, H, D).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
    k2, v2, gate = (torch.randn((B, H, n, D), generator=g, device=dev).to(dtype) for n in (S2, S2, T))
    m1 = torch.arange(T, device=dev)[None] < torch.tensor([T, 20], device=dev)[:, None]
    m2 = torch.arange(S2, device=dev)[None] < torch.tensor([5, S2], device=dev)[:, None]
    got = A.fused_attention(q, k, v, m1, k2=k2, v2=v2, key_mask2=m2, gate=gate)
    want = A.attention_plain(q, k, v, m1, k2=k2, v2=v2, key_mask2=m2, gate=gate)
    assert rel(got, want) <= FWD_TOL[dtype]


def test_other_head_dims_raise(dev):
    for D in (8, 16, 32, 96):
        z = torch.zeros((1, 2, 8, D), device=dev)
        with pytest.raises(ValueError, match="head dim"):
            A.fused_attention(z, z, z, torch.ones((1, 8), dtype=torch.bool, device=dev))


def test_full_width_student_step_kernels_vs_plain(dev):
    import dataclasses

    import numpy as np

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.models.asr import ASRConfig, init_asr
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.discriminator import DiscriminatorConfig, init_discriminator
    from smalltts_tpu_torch.models.sv import SVConfig, init_sv
    from smalltts_tpu_torch.train import distill as D
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree

    base = BackboneConfig()
    cfg = dataclasses.replace(base, dit=dataclasses.replace(base.dit, remat=True))
    disc_cfg, asr_cfg, sv_cfg = DiscriminatorConfig(), ASRConfig(), SVConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    teacher = redraw_zero_init(init_backbone(gen, cfg, device=dev), gen)
    disc, asr, sv = (init_discriminator(gen, disc_cfg, device=dev), init_asr(gen, asr_cfg, device=dev),
                     init_sv(gen, sv_cfg, device=dev))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             dummy_batch(np.random.default_rng(0), DummyDataConfig(batch_size=2)).items() if k != "texts"}
    draws = D.student_draws(torch.Generator(device=dev).manual_seed(1), batch)

    class Capture:
        def init(self, params):
            return {}

        def update(self, grads, state, params):
            self.grads = flatten_pytree(grads)
            return map_pytree(torch.zeros_like, grads), state

    out = []
    for plain in (False, True):
        tx = Capture()
        step = D.make_student_step(cfg, disc_cfg, asr_cfg, sv_cfg, tx, D.DistillConfig(asr_start_step=0,
                                                                                      sv_start_step=0))
        kernels.reset_launches()
        with kernels.force_plain() if plain else torch.enable_grad():
            _, _, _, metrics = step(teacher, {}, teacher, teacher, disc, asr, sv, batch, 1, draws)
        out.append(({k: float(v) for k, v in metrics.items()}, tx.grads, kernels.LAUNCHES.get("attention", 0)))
    (m_k, g_k, n_k), (m_p, g_p, n_p) = out
    assert n_k == 197 and n_p == 0
    assert all(np.isfinite(v) for v in m_k.values()) and m_k["st_asr"] > 0 and m_k["st_sv"] > 0
    for k in m_k:
        assert abs(m_k[k] - m_p[k]) <= 1e-4 * abs(m_p[k]), (k, m_k[k], m_p[k])
    modules = {}
    for name, g in g_k.items():
        mod = "/".join(name.split("/")[:2])
        a, b = modules.get(mod, (0.0, 0.0))
        modules[mod] = (a + float((g - g_p[name]).norm()) ** 2, b + float(g_p[name].norm()) ** 2)
    errs = {m: (a / max(b, 1e-60)) ** 0.5 for m, (a, b) in modules.items() if b > 0}
    assert max(errs.values()) <= 1e-4, errs

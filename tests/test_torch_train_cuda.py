"""Card-only: the training path's gradients on the card. Skipped where there
is no CUDA card (the attention kernel has no CPU mode). On a card machine,
which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

- The attention Function (the kernel forward, attention_backward) against
  autograd through attention_plain at the teacher step's three shapes (text
  (2, 4, 198, 128) over 198 keys, style (2, 8, 64, 64) over 64, DiT (2, 8,
  256, 120) over 256 + 64 + 198 = 518), fp32 and bf16: max |diff| / max
  |plain| within 1e-4 in fp32 (fp32 sums in another order, and the backward
  reads the kernel's output) and 2e-2 in bf16 (the output that the
  backward reads is rounded to bf16; each gradient is rounded once).
- matmul_f32 in bf16 with a gradient: the product and both gradients
  against float32 products rounded to bf16 (1e-2: one bf16 rounding of a
  float32 sum taken in another order), 2-D and the modulations' stacked 3-D.
- nn.conv1d in fp32 at the DiT stem's shape (960 channels in 16 groups,
  kernel 31, (2, 256, 960)): output and both gradients against the same
  conv on the CPU, 1e-5 of the largest value (fp32 sums in another order;
  TF32, which cuDNN would take by default, is ~1e-3 off).
- One full-width teacher_loss backward (default BackboneConfig, seed-0
  weights with the zero-init leaves re-drawn) with the kernels against
  kernels.force_plain(): loss within 1e-5 relative in fp32 (1e-2 in bf16),
  each module's gradient within 1e-4 rel-L2 in fp32 (5e-2 in bf16: bf16
  roundings that flip with the attention's sum order, carried through 32
  attention layers); 32 attention launches a forward, 44 with remat.
"""

import pytest
import torch

from smalltts_tpu_torch.ops import kernels, nn
from smalltts_tpu_torch.ops.kernels import attention as A

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SHAPES = {"text": (2, 4, 198, 198, 128), "style": (2, 8, 64, 64, 64), "dit": (2, 8, 256, 518, 120)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_attention_function_gradients_match_plain_autograd(dev, shape, dtype):
    B, H, Tq, S, D = SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, H, n, D), generator=g, device=dev).to(dtype) for n in (Tq, S, S))
    dout = torch.randn((B, H, Tq, D), generator=g, device=dev).to(dtype)
    mask = torch.arange(S, device=dev)[None] < torch.tensor([S, S // 3], device=dev)[:, None]
    mask[-1] = False  # a fully-masked row: a uniform average, and no gradient to q or k
    grads = []
    for fn in (A.attention, A.attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, mask)
        out.backward(dout)
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want, name in zip(*grads, ("out", "dq", "dk", "dv")):
        assert got.dtype == dtype and rel(got, want) <= TOL[dtype], (name, rel(got, want))
    assert float(grads[0][1][-1].abs().max()) == 0.0 and float(grads[0][2][-1].abs().max()) == 0.0


def test_sdpa_routes_gradients_through_the_function(dev):
    B, H, Tq, S, D = SHAPES["style"]
    q, k, v = (torch.randn((B, H, n, D), device=dev, requires_grad=True) for n in (Tq, S, S))
    mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    kernels.reset_launches()
    out = nn.sdpa(q, k, v, key_mask=mask)
    assert type(out.grad_fn).__name__ == "_AttentionBackward" and kernels.LAUNCHES["attention"] == 1
    with torch.no_grad():
        assert nn.sdpa(q, k, v, key_mask=mask).grad_fn is None
    assert kernels.LAUNCHES["attention"] == 2


@pytest.mark.parametrize("stacked", [False, True])
def test_matmul_f32_bf16_gradients(dev, stacked):
    g = torch.Generator(device=dev).manual_seed(1)
    if stacked:  # the modulations' form: one (B, H) row block expanded over L layers
        s = torch.randn((4, 960), generator=g, device=dev).bfloat16().requires_grad_(True)
        x = s.expand(12, 4, 960)
        w = (0.03 * torch.randn((12, 960, 1920), generator=g, device=dev)).bfloat16().requires_grad_(True)
    else:
        x = torch.randn((2, 256, 960), generator=g, device=dev).bfloat16().requires_grad_(True)
        w = (0.03 * torch.randn((960, 2880), generator=g, device=dev)).bfloat16().requires_grad_(True)
    y = nn.matmul_f32(x, w)
    assert y.dtype == torch.float32 and type(y.grad_fn).__name__ == "_MatmulF32Backward"
    dy = torch.randn(y.shape, generator=g, device=dev).bfloat16().float()  # a bf16 cotangent, as linear gives
    y.backward(dy)
    xf, wf, dyf = x.detach().float(), w.detach().float(), dy
    assert rel(y.detach(), torch.matmul(xf, wf)) <= 1e-5
    dx = torch.matmul(dyf, wf.transpose(-1, -2))
    if stacked:
        dx, leaf = dx.sum(0), s
    else:
        leaf = x
    dw = torch.matmul(xf.transpose(-1, -2), dyf) if stacked else xf.reshape(-1, 960).t() @ dyf.reshape(-1, 2880)
    assert leaf.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    assert rel(leaf.grad, dx) <= 1e-2 and rel(w.grad, dw.bfloat16()) <= 1e-2


def test_fp32_stem_conv_and_gradients_match_the_cpu(dev):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 256, 960), generator=g)
    p = nn.init_conv1d(g, 960, 960, 31, groups=16)
    dy = torch.randn((2, 256, 960), generator=g)
    res = []
    for d in ("cpu", dev):
        leaves = [t.detach().to(d).requires_grad_(True) for t in (x, p["w"], p["b"])]
        y = nn.conv1d({"w": leaves[1], "b": leaves[2]}, leaves[0], groups=16)
        y.backward(dy.to(d))
        res.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want, name in zip(res[1], res[0], ("y", "dx", "dw", "db")):
        assert rel(got, want) <= 1e-5, (name, rel(got, want))
    assert torch.backends.cudnn.allow_tf32  # PyTorch's default, left as it was


def _full_width_loss_grads(dev, dtype, remat=False):
    import dataclasses

    import numpy as np

    from smalltts_tpu_torch.data.dummy import DummyDataConfig, dummy_batch
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone, redraw_zero_init
    from smalltts_tpu_torch.train.teacher import TeacherTrainConfig, teacher_draws, teacher_loss
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, unflatten_pytree

    cfg = BackboneConfig()
    cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, remat=remat))
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = flatten_pytree(redraw_zero_init(init_backbone(gen, cfg, device=dev), gen))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             dummy_batch(np.random.default_rng(0), DummyDataConfig(batch_size=2)).items() if k != "texts"}
    draws = teacher_draws(torch.Generator(device=dev).manual_seed(1), batch)
    draws["text_u"].fill_(1.0)  # no CFG drop: every attention sees its keys
    draws["speaker_u"].fill_(1.0)
    tcfg = TeacherTrainConfig(compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    out = []
    for plain in (False, True):
        req = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        kernels.reset_launches()
        with kernels.force_plain() if plain else torch.enable_grad():
            loss = teacher_loss(unflatten_pytree(req), cfg, batch, draws, tcfg)
            launches = kernels.LAUNCHES.get("attention", 0)
            grads = torch.autograd.grad(loss, list(req.values()))
        out.append((loss.detach(), dict(zip(req, grads)), launches, kernels.LAUNCHES.get("attention", 0)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_width_teacher_loss_backward_kernels_vs_plain(dev, dtype):
    (loss_k, g_k, fwd_k, all_k), (loss_p, g_p, _, all_p) = _full_width_loss_grads(dev, dtype)
    assert fwd_k == 32 and all_k == 32 and all_p == 0  # 8 text + 12 style + 12 DiT, none in the backward
    tol_loss, tol_g = (1e-5, 1e-4) if dtype == torch.float32 else (1e-2, 5e-2)
    assert torch.isfinite(loss_k) and abs(float(loss_k - loss_p)) <= tol_loss * abs(float(loss_p))
    modules = {}
    for name, g in g_k.items():  # rel-L2 over each module's gradients together
        mod = "/".join(name.split("/")[:2])
        a, b = modules.get(mod, (0.0, 0.0))
        modules[mod] = (a + float((g - g_p[name]).float().norm()) ** 2, b + float(g_p[name].float().norm()) ** 2)
    errs = {m: (a / max(b, 1e-60)) ** 0.5 for m, (a, b) in modules.items()}
    assert max(errs.values()) <= tol_g, errs
    assert all(float(g_p[n].norm()) > 0 for n in g_p if "velocity" in n)


def test_remat_recomputes_the_dit_attention(dev):
    (loss_k, _, fwd_k, all_k), _ = _full_width_loss_grads(dev, torch.bfloat16, remat=True)
    assert torch.isfinite(loss_k) and fwd_k == 32 and all_k == 44  # the 12 DiT blocks again in the backward

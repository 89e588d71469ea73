"""Card-only: the CTC kernels (csrc/ctc.cu) against their plain versions.
Skipped where there is no CUDA card (the kernels have no CPU mode). On a
card machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ctc_cuda.py

- `ops/losses.ctc_loss`, forward loss and the gradient with respect to the
  logits, kernels against kernels.force_plain() on the same inputs, fp32,
  at chip_smoke.py's phase A batches (`ctc_case`): the trainers' shape (2,
  1024, 198) over 198 labels with the dummy loader's lengths, a feasible, a
  repeated-label and an infeasible batch (loss ~1e5), 384 labels (the
  serving contract's phoneme bucket), padded frames inside feasible
  samples, N at either side of the kernels' switch from one state a
  thread to several (N + 1 = 512), N = 512 and 4095, T = 2500 and B = 8. The
  loss within 1e-5 of the plain loss relative to itself, the gradient
  within 1e-4 of the largest plain value (the blank adjoint's sum over the
  states in another order); exactly one launch of each kernel a call.
- A CUDA tensor never reaches a plain version outside force_plain(); the
  wrappers raise on other dtypes and on mismatched shapes.
"""

import pytest
import torch

from chip_smoke import CTC_CASES, ctc_case
from smalltts_tpu_torch.ops import kernels
from smalltts_tpu_torch.ops.kernels import ctc as C
from smalltts_tpu_torch.ops.losses import ctc_loss

pytestmark = pytest.mark.cuda
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CTC kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CTC_CASES)
def test_ctc_kernels_match_plain(dev, name):
    logits, logit_pad, labels, label_pad = (torch.as_tensor(a, device=dev) for a in ctc_case(name))
    out = []
    for plain in (False, True):
        x = logits.clone().requires_grad_(True)
        kernels.reset_launches()
        if plain:
            with kernels.force_plain():
                loss = ctc_loss(x, logit_pad, labels, label_pad)
                (loss * torch.arange(1, len(loss) + 1, device=dev)).sum().backward()
        else:
            loss = ctc_loss(x, logit_pad, labels, label_pad)
            (loss * torch.arange(1, len(loss) + 1, device=dev)).sum().backward()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
        assert counts == ({} if plain else {"ctc_forward": 1, "ctc_backward": 1}), counts
        out.append((loss.detach(), x.grad))
    (lk, gk), (lp, gp) = out
    assert torch.isfinite(lk).all() and torch.isfinite(gk).all()
    assert float(((lk - lp).abs() / lp.abs()).max()) <= LOSS_TOL, (lk, lp)
    assert float((gk - gp).abs().max() / gp.abs().max()) <= GRAD_TOL
    if name == "infeasible":
        assert float(lk[1]) > 5e4 and float(lk[2]) > 5e4


def test_cuda_tensors_never_take_the_plain_versions(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version outside force_plain()")

    monkeypatch.setattr(C, "ctc_forward_plain", refuse)
    monkeypatch.setattr(C, "ctc_backward_plain", refuse)
    logits, logit_pad, labels, label_pad = (torch.as_tensor(a, device=dev) for a in ctc_case("feasible"))
    x = logits.requires_grad_(True)
    ctc_loss(x, logit_pad, labels, label_pad).sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()
    lp_emit = torch.zeros((2, 8, 4), device=dev)
    args = (torch.zeros((2, 8), device=dev), torch.zeros((2, 8), device=dev), torch.zeros((2, 4), device=dev),
            torch.full((2,), 4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        C.ctc_forward(lp_emit.double(), *args)
    with pytest.raises(ValueError):
        C.ctc_forward(lp_emit, args[0], args[1], args[2], args[3].long())
    with pytest.raises(ValueError):
        C.ctc_forward(torch.zeros((2, 8, 0), device=dev), *args)

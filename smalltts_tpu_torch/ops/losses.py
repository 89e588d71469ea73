"""Loss primitives of the trainers (port of smalltts_tpu/ops/losses.py), and
the CTC loss with optax's semantics (its recurrence in ops/kernels/ctc)."""

from __future__ import annotations

import torch

from smalltts_tpu_torch.ops.kernels.ctc import ctc

_BLANK = 0  # optax.ctc_loss's blank_id


def cosine_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity along the last axis, each norm clamped at 1e-8."""
    x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-8)
    y = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-8)
    return 1.0 - (x * y).sum(dim=-1)


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC loss (B,) as optax.ctc_loss computes it: log_softmax
    of `logits` (B, T, K) and the gathers of the blank (phi) and label (emit)
    log-probs in PyTorch ops, then the forward recurrence over time and its
    adjoint through ops/kernels/ctc (the CUDA kernels on the card, their
    plain versions on the CPU), differentiable in the logits.

    Blank 0. log(0) is -1e5, never -inf, so a sample with no alignment
    (fewer valid frames than labels plus a blank between repeats) gets a
    finite loss of the order of 1e5, where F.ctc_loss gives inf (or 0 with
    zero_infinity). Paddings are 1.0 at padded frames / labels; labels are
    right-padded."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = (n - label_paddings.sum(dim=1)).to(torch.int32)
    repeat = torch.nn.functional.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    lp_phi = logprobs[:, :, _BLANK]                                                   # (B, T)
    lp_emit = torch.gather(logprobs, 2, labels.to(torch.int64)[:, None, :].expand(b, t, n))  # (B, T, N)
    return ctc(lp_emit, lp_phi, logit_paddings.float(), repeat, labellens)

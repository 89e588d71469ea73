"""Loss primitives of the trainers (port of smalltts_tpu/ops/losses.py), and
the CTC loss with optax's semantics."""

from __future__ import annotations

import torch

_BLANK = 0         # optax.ctc_loss's blank_id
_LOG_EPS = -1e5    # optax.ctc_loss's log_epsilon: log(0), finite


def cosine_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity along the last axis, each norm clamped at 1e-8."""
    x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-8)
    y = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-8)
    return 1.0 - (x * y).sum(dim=-1)


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) of two tensors of one shape, with JAX's
    derivative, exp(a - out) and exp(b - out) (torch.logaddexp's is 1 / (1 +
    exp(b - a))): the two differ where out is large, as at CTC's log(0) =
    -1e5, by the float32 rounding of out."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC loss (B,) as optax.ctc_loss computes it: log_softmax
    of `logits` (B, T, K), then the forward recurrence over time of the
    blank (phi) and label (emit) log-alphas, in PyTorch ops, differentiable
    (logaddexp with JAX's derivative).

    Blank 0. log(0) is -1e5, never -inf, so a sample with no
    alignment (fewer valid frames than labels plus a blank between repeats)
    gets a finite loss of the order of 1e5, where F.ctc_loss gives inf (or 0
    with zero_infinity). Paddings are 1.0 at padded frames / labels; labels
    are right-padded."""
    b, _, _ = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_paddings.sum(dim=1).to(torch.int64)
    repeat = torch.nn.functional.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    eps_repeat = _LOG_EPS * repeat               # emit -> phi epsilon, blocked before a repeat
    eps_not_repeat = _LOG_EPS * (1.0 - repeat)   # emit -> phi through a blank, only before a repeat
    lp_phi = logprobs[:, :, _BLANK:_BLANK + 1].transpose(0, 1)                           # (T, B, 1)
    idx = labels.to(torch.int64)[:, None, :].expand(b, logprobs.shape[1], n)
    lp_emit = torch.gather(logprobs, 2, idx).transpose(0, 1)                                # (T, B, N)
    pad = logit_paddings.transpose(0, 1)[..., None].bool()                                  # (T, B, 1)

    phi = torch.full((b, n + 1), _LOG_EPS, dtype=logprobs.dtype, device=logprobs.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), _LOG_EPS, dtype=logprobs.dtype, device=logprobs.device)

    def add_phi(ph, score):  # phi[:, 1:] <- logaddexp(phi[:, 1:], score)
        return torch.cat([ph[:, :1], _LogAddExp.apply(ph[:, 1:], score)], dim=-1)

    # one view a frame, unbound once: the backward stacks their gradients in one op
    for lp_e, lp_p, pd in zip(lp_emit.unbind(0), lp_phi.unbind(0), pad.unbind(0)):
        prev_phi, prev_emit = phi, emit
        phi_in = add_phi(prev_phi, prev_emit + eps_repeat)
        next_emit = _LogAddExp.apply(phi_in[:, :-1] + lp_e, prev_emit + lp_e)
        next_phi = add_phi(phi_in + lp_p, prev_emit + lp_p + eps_not_repeat)
        emit = torch.where(pd, prev_emit, next_emit)
        phi = torch.where(pd, prev_phi, next_phi)
    phi_last = add_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]

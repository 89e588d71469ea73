"""The CTC recurrence with optax's semantics: wrappers of csrc/ctc.cu (the
forward and the backward kernel), their plain versions, and the autograd
Function that ops/losses.ctc_loss runs. No Pallas kernel corresponds: the
JAX package leaves optax.ctc_loss's scan to XLA.

The arguments of both directions, per sequence b of B over T frames and N
label positions, all fp32 but the counts:

- `lp_emit` (B, T, N): the log-prob of label n at frame t;
- `lp_phi` (B, T): the blank's log-prob;
- `pad` (B, T): nonzero at a padded frame, which keeps its states;
- `repeat` (B, N): 1.0 where label n equals label n + 1 (the last 0.0);
- `labellens` (B,) int32: the label count, 0..N, where the loss is read.

`ctc_forward` returns the per-sequence loss (B,) and the states after every
frame, alpha (B, T + 1, 2N + 1): phi (N + 1), then emit (N), frame 0 the
initial states. `ctc_backward(g, ..., alpha)` returns d lp_emit (B, T, N)
and d lp_phi (B, T) for the loss's cotangent g (B,). csrc/ctc.cu writes the
recurrence out; the plain versions below are the same fp32 operations in
PyTorch ops, a loop over frames vectorised over the states.

The routes (csrc/ctc.cu says why): the forward holds a sequence's states in
one block, one state a thread up to 512 and several above; the backward is
one launch whose factor blocks compute every exp/log of the adjoint across
the card while one chain block a sequence runs the adjoint's products and
sums (`backward_per` states a consumer thread).

Each wrapper takes its plain version for CPU tensors (and under the
test-only `kernels.force_plain()`), and otherwise launches its kernel or
raises. The Function decides once, in its forward (autograd runs the
backward in a thread of its own on the card, outside force_plain()).
"""

from __future__ import annotations

import torch

from smalltts_tpu_torch.ops import kernels

LOG_EPS = -1e5  # optax.ctc_loss's log_epsilon: log(0), finite
MAX_LABELS = 4095  # the kernels' largest N: 512 threads of 8 states, 512 consumers of 8


def _eps(repeat):
    """The emit -> phi epsilons: blocked before a repeat (er), and through a
    blank only before a repeat (enr)."""
    return LOG_EPS * repeat, LOG_EPS * (1.0 - repeat)


def ctc_forward_plain(lp_emit, lp_phi, pad, repeat, labellens):
    b, t, n = lp_emit.shape
    er, enr = _eps(repeat)
    phi = torch.full((b, n + 1), LOG_EPS, dtype=lp_emit.dtype, device=lp_emit.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPS, dtype=lp_emit.dtype, device=lp_emit.device)
    alpha = torch.empty((b, t + 1, 2 * n + 1), dtype=lp_emit.dtype, device=lp_emit.device)
    alpha[:, 0] = torch.cat([phi, emit], dim=1)
    padded = (pad != 0)[..., None]
    for i in range(t):
        lpe, lpp = lp_emit[:, i], lp_phi[:, i:i + 1]
        pin = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], emit + er)], dim=1)
        next_emit = torch.logaddexp(pin[:, :-1] + lpe, emit + lpe)
        next_phi = torch.cat([pin[:, :1] + lpp, torch.logaddexp(pin[:, 1:] + lpp, emit + lpp + enr)], dim=1)
        emit = torch.where(padded[:, i], emit, next_emit)
        phi = torch.where(padded[:, i], phi, next_phi)
        alpha[:, i + 1] = torch.cat([phi, emit], dim=1)
    last = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], emit)], dim=1)
    return -torch.gather(last, 1, labellens.long()[:, None])[:, 0], alpha


def ctc_backward_plain(g, lp_emit, lp_phi, pad, repeat, labellens, alpha):
    b, t, n = lp_emit.shape
    er, enr = _eps(repeat)
    # the final gather's adjoint: -g at phi_last[labellens], through its logaddexp
    phi, emit = alpha[:, t, :n + 1], alpha[:, t, n + 1:]
    cot = -g[:, None] * (torch.arange(n + 1, device=g.device)[None] == labellens.long()[:, None]).to(g.dtype)
    out = torch.logaddexp(phi[:, 1:], emit)
    g_phi = torch.cat([cot[:, :1], cot[:, 1:] * torch.exp(phi[:, 1:] - out)], dim=1)
    g_emit = cot[:, 1:] * torch.exp(emit - out)
    d_emit = torch.zeros_like(lp_emit)
    d_phi = torch.zeros_like(lp_phi)
    padded = pad != 0
    for i in range(t - 1, -1, -1):
        phi, emit = alpha[:, i, :n + 1], alpha[:, i, n + 1:]
        lpe, lpp = lp_emit[:, i], lp_phi[:, i:i + 1]
        e_r = emit + er
        pin_tail = torch.logaddexp(phi[:, 1:], e_r)
        pin = torch.cat([phi[:, :1], pin_tail], dim=1)
        a, bv = pin[:, :-1] + lpe, emit + lpe
        ne = torch.logaddexp(a, bv)
        d_a, d_b = g_emit * torch.exp(a - ne), g_emit * torch.exp(bv - ne)
        c, d = pin_tail + lpp, emit + lpp + enr
        nphi = torch.logaddexp(c, d)
        d_c, d_d = g_phi[:, 1:] * torch.exp(c - nphi), g_phi[:, 1:] * torch.exp(d - nphi)
        # pin[j]'s adjoint: next_emit[j]'s (j < N), and next_phi[0]'s at j = 0, next_phi[j]'s else
        d_pin = torch.cat([d_a[:, :1] + g_phi[:, :1], d_a[:, 1:] + d_c[:, :-1], d_c[:, -1:]], dim=1)
        new_phi = torch.cat([d_pin[:, :1], d_pin[:, 1:] * torch.exp(phi[:, 1:] - pin_tail)], dim=1)
        new_emit = d_b + d_d + d_pin[:, 1:] * torch.exp(e_r - pin_tail)
        keep = padded[:, i:i + 1]
        d_emit[:, i] = torch.where(keep, 0.0, d_a + d_b)
        # the blank's adjoint: next_phi[0]'s and every next_phi[j]'s, broadcast over the states
        d_phi[:, i] = torch.where(keep[:, 0], 0.0, g_phi[:, 0] + (d_c + d_d).sum(dim=1))
        g_phi = torch.where(keep, g_phi, new_phi)
        g_emit = torch.where(keep, g_emit, new_emit)
    return d_emit, d_phi


def _check(what, lp_emit, lp_phi, pad, repeat, labellens, *more):
    b, t, n = lp_emit.shape
    if any(x.dtype != torch.float32 for x in (lp_emit, lp_phi, pad, repeat) + more):
        raise ValueError(f"{what}: fp32 log-probs, paddings and repeats only")
    if labellens.dtype != torch.int32 or labellens.shape != (b,):
        raise ValueError(f"{what}: labellens must be int32 (B,), got {labellens.dtype} {tuple(labellens.shape)}")
    if lp_phi.shape != (b, t) or pad.shape != (b, t) or repeat.shape != (b, n):
        raise ValueError(f"{what}: lp_emit {tuple(lp_emit.shape)}, lp_phi {tuple(lp_phi.shape)}, "
                         f"pad {tuple(pad.shape)}, repeat {tuple(repeat.shape)}")
    if not 1 <= n <= MAX_LABELS:
        raise ValueError(f"{what}: {n} label positions; the kernel takes 1 to {MAX_LABELS}")
    if any(x.device != lp_emit.device for x in (lp_phi, pad, repeat, labellens) + more):
        raise ValueError(f"{what}: all inputs must be on one device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# The backward's chain gives each consumer thread PER contiguous states, at
# most 256 consumers below 1025 states and 512 above (chip_smoke.py --ctc
# sweeps PER).
def backward_per(n: int) -> int:
    """States a consumer thread of ctc_backward's chain holds."""
    return next(p for p in (1, 2, 4, 8) if n + 1 <= 256 * p or p == 8)


def forward_launch(lp_emit, lp_phi, pad, repeat, labellens):
    """The forward kernel (checked inputs); counts nothing: ctc_forward
    counts its launches."""
    b, t, n = lp_emit.shape
    ins = [x.contiguous() for x in (lp_emit, lp_phi, pad, repeat, labellens)]
    alpha = torch.empty((b, t + 1, 2 * n + 1), dtype=torch.float32, device=lp_emit.device)
    loss = torch.empty((b,), dtype=torch.float32, device=lp_emit.device)
    lib = kernels.load("ctc")
    status = lib.st_ctc_forward(*(x.data_ptr() for x in ins), alpha.data_ptr(), loss.data_ptr(), b, t, n,
                                _stream(lp_emit))
    kernels.check(lib, "ctc", status, "ctc_forward")
    return loss, alpha


def backward_launch(g, lp_emit, lp_phi, pad, repeat, labellens, alpha, per):
    """The backward kernel (checked inputs), `per` states a consumer thread:
    (d_emit, d_phi). Counts nothing: ctc_backward counts its launches."""
    b, t, n = lp_emit.shape
    ins = [x.contiguous() for x in (g, lp_emit, lp_phi, pad, repeat, labellens, alpha)]
    lib = kernels.load("ctc")
    factors = torch.empty((lib.st_ctc_factor_floats(b, t, n),), dtype=torch.float32, device=lp_emit.device)
    sync = torch.zeros((1 + b * t,), dtype=torch.int32, device=lp_emit.device)  # claim counter, ready flags
    d_emit = torch.empty((b, t, n), dtype=torch.float32, device=lp_emit.device)
    d_phi = torch.empty((b, t), dtype=torch.float32, device=lp_emit.device)
    status = lib.st_ctc_backward(*(x.data_ptr() for x in ins), factors.data_ptr(), sync.data_ptr(),
                                 d_emit.data_ptr(), d_phi.data_ptr(), b, t, n, per, _stream(lp_emit))
    kernels.check(lib, "ctc", status, "ctc_backward")
    return d_emit, d_phi


def ctc_forward(lp_emit, lp_phi, pad, repeat, labellens):
    """(loss (B,), alpha (B, T + 1, 2N + 1)) of optax's recurrence."""
    if kernels.use_plain(lp_emit):
        return ctc_forward_plain(lp_emit, lp_phi, pad, repeat, labellens)
    _check("ctc_forward", lp_emit, lp_phi, pad, repeat, labellens)
    out = forward_launch(lp_emit, lp_phi, pad, repeat, labellens)
    kernels.count_launch("ctc_forward")
    return out


def ctc_backward(g, lp_emit, lp_phi, pad, repeat, labellens, alpha):
    """(d lp_emit (B, T, N), d lp_phi (B, T)) for the loss's cotangent g (B,)."""
    if kernels.use_plain(lp_emit):
        return ctc_backward_plain(g, lp_emit, lp_phi, pad, repeat, labellens, alpha)
    _check("ctc_backward", lp_emit, lp_phi, pad, repeat, labellens, g, alpha)
    b, t, n = lp_emit.shape
    if g.shape != (b,) or alpha.shape != (b, t + 1, 2 * n + 1):
        raise ValueError(f"ctc_backward: g {tuple(g.shape)}, alpha {tuple(alpha.shape)}")
    d_emit, d_phi = backward_launch(g, lp_emit, lp_phi, pad, repeat, labellens, alpha, backward_per(n))
    kernels.count_launch("ctc_backward")
    return d_emit, d_phi


class CTC(torch.autograd.Function):
    """ctc(lp_emit, lp_phi, pad, repeat, labellens) -> the per-sequence loss
    (B,), differentiable in lp_emit and lp_phi through the backward
    recurrence. The gathers that make lp_emit and lp_phi from the
    log-probs (B, T, K) stay PyTorch ops outside: their backward scatters
    d lp_emit into (B, T, K) by label (scatter_add, as labels repeat) and
    d lp_phi into the blank column."""

    @staticmethod
    def forward(ctx, lp_emit, lp_phi, pad, repeat, labellens):
        ctx.plain = kernels.use_plain(lp_emit)
        loss, alpha = (ctc_forward_plain if ctx.plain else ctc_forward)(lp_emit, lp_phi, pad, repeat, labellens)
        ctx.save_for_backward(lp_emit, lp_phi, pad, repeat, labellens, alpha)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        fn = ctc_backward_plain if ctx.plain else ctc_backward
        d_emit, d_phi = fn(g.contiguous(), *ctx.saved_tensors)
        return d_emit, d_phi, None, None, None


ctc = CTC.apply

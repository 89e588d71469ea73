"""Card-only: the codec decoder's pointwise pass (csrc/codec.cu) and the
decode built on it, against their plain versions, bit for bit. Skipped
where there is no CUDA card (the kernel has no CPU mode). On a card
machine, which has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_codec_cuda.py

The pass rounds where the PyTorch op chain rounds, so every comparison is
exact: max |kernel - plain| = 0.
"""

import pytest
import torch

from smalltts_tpu_torch.models import codec as M
from smalltts_tpu_torch.ops import kernels
from smalltts_tpu_torch.ops.kernels import codec as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


# (B, C, T, r, kind, pad): kind "plain" (the value kept), "res" (the residual,
# kept), "res-only" (the residual, not kept), "head" (tanh), "snake-only"
CASES = {
    "plain b3": (8, 48, 40, 1, "plain", (3, 3)),
    "residual b9": (2, 36, 33, 1, "res", (9, 9)),
    "residual only b3": (1, 5, 7, 1, "res-only", (3, 3)),
    "residual b0 odd": (3, 7, 19, 1, "res", (0, 0)),
    "residual T1": (1, 6, 1, 1, "res", (1, 1)),
    "residual long rows": (2, 8, 5003, 1, "res", (9, 9)),
    "snake only B1": (1, 130, 17, 1, "snake-only", (3, 3)),
    "head r8": (3, 1, 37, 8, "head", (0, 0)),
    "head r8 long": (2, 1, 4001, 8, "head", (0, 0)),
    "d2t r4 b3": (2, 12, 19, 4, "plain", (3, 3)),
    "d2t r5 b1": (1, 7, 21, 5, "plain", (1, 1)),
    "d2t r5 long": (2, 16, 2501, 5, "plain", (3, 3)),
    "d2t r8 b9 T1": (2, 3, 1, 8, "plain", (9, 9)),
    "d2t r4 B8 t16": (8, 512, 16, 4, "plain", (3, 3)),
}


def run_case(dev, case, misalign=False):
    B, C, T, r, kind, pad = CASES[case]
    g = torch.Generator(device=dev).manual_seed(sorted(CASES).index(case))
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    y, bias = rnd(B, C * r, T), 0.1 * rnd(C * r)
    x = rnd(B, C, T * r) if kind.startswith("res") else None
    if misalign and x is not None:  # x one float off a 16-byte boundary, unlike the output
        x = torch.cat([torch.zeros(1, device=dev), x.reshape(-1)])[1:].reshape(x.shape)
    alpha = torch.exp(0.5 * rnd(C)) if kind != "head" else None
    args = dict(r=r, tanh=kind == "head", keep=kind in ("plain", "res", "head"), alpha=alpha, pad=pad)
    n0 = kernels.LAUNCHES.get("codec_pointwise", 0)
    got = K.codec_pointwise(y, bias, x, **args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["codec_pointwise"] == n0 + 1
    with kernels.force_plain():
        want = K.codec_pointwise(y, bias, x, **args)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and torch.equal(a, b), f"max diff {float((a - b).abs().max())}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_bits(dev, case):
    run_case(dev, case)


@pytest.mark.parametrize("case", ["residual b9", "residual long rows"])
def test_pass_bits_misaligned_residual(dev, case):
    run_case(dev, case, misalign=True)


def served_codec(dev, seed=3):
    """CodecConfig() with every leaf off its init: non-zero log_alphas and biases."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if isinstance(t, list):
            return [move(v) for v in t]
        return t + 0.1 * torch.randn(t.shape, generator=g, device=dev)

    cfg = M.CodecConfig()
    return cfg, move(M.init_codec(g, cfg, device=dev)), g


def test_decode_bits_served_widths(dev, monkeypatch):
    """codec_decode on the kernel against force_plain() and against the
    channel-last path, B 8, t 40: bit for bit, 27 launches."""
    cfg, p, g = served_codec(dev)
    lat = torch.randn((8, 40, cfg.latent_dim), generator=g, device=dev)
    with torch.inference_mode():
        n0 = kernels.LAUNCHES.get("codec_pointwise", 0)
        got = M.codec_decode(p, lat, cfg)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["codec_pointwise"] == n0 + 27
        with kernels.force_plain():
            plain = M.codec_decode(p, lat, cfg)
        monkeypatch.setattr(M, "_on_card", lambda t: False)
        chain = M.codec_decode(p, lat, cfg)
    assert got.shape == (8, 1, 40 * cfg.hop) and float(got.abs().max()) > 0
    assert torch.equal(got, plain) and torch.equal(got, chain)


def test_decode_graph_replay(dev):
    """The decode captured in a CUDA graph: 27 launches counted into the
    graph, a replay on new latents equal to the eager decode bit for bit."""
    cfg, p, g = served_codec(dev, seed=4)
    static = torch.randn((2, 16, cfg.latent_dim), generator=g, device=dev)
    with torch.inference_mode():
        M.codec_decode(p, static, cfg)  # warm: cuDNN's plans
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with kernels.recording() as counts, torch.cuda.graph(graph):
            out = M.codec_decode(p, static, cfg)
        assert counts == {"codec_pointwise": 27}
        new = torch.randn(static.shape, generator=g, device=dev)
        static.copy_(new)
        n0 = kernels.LAUNCHES.get("codec_pointwise", 0)
        graph.replay()
        kernels.add_launches(counts)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["codec_pointwise"] == n0 + 27
        assert torch.equal(out, M.codec_decode(p, new, cfg))

"""The codec decoder's two paths (models/codec.py) and its pointwise pass's
plain version (ops/kernels/codec.py), on the CPU.

- The NCW decode, composed of the plain pass, equals the channel-last
  decode bit for bit on random weights with non-zero log_alphas, at several
  codec shapes (the served widths among them).
- The plain pass, at every boundary kind the decoder has (plain, residual,
  tanh head; depth to time r = 4, 5, 8; borders 0, 1, 3, 9) and at ragged
  shapes, equals the channel-last op chain it stands for, bit for bit.
- The path choice: only float32 latents on the card with no gradient
  wanted, outside a jit trace and an ONNX export, take the NCW decode.
"""

import pytest
import torch
import torch.nn.functional as F

from smalltts_tpu_torch.models import codec as M
from smalltts_tpu_torch.ops.kernels import codec as K

SMALL = M.CodecConfig(strides=(4, 5), channels=(32, 24, 8), res_dilations=(1,))
CONFIGS = {
    "mini": SMALL,
    "odd": M.CodecConfig(strides=(2, 3, 4), channels=(20, 12, 7, 3), res_dilations=(1, 3)),
    "narrow": M.CodecConfig(channels=(48, 32, 24, 16, 8, 4)),
    "served": M.CodecConfig(),
}


def random_codec(cfg, seed=0):
    """init_codec with every leaf moved off its init: non-zero log_alphas
    and biases."""
    g = torch.Generator().manual_seed(seed)

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if isinstance(t, list):
            return [move(v) for v in t]
        return t + 0.3 * torch.randn(t.shape, generator=g)

    return move(M.init_codec(g, cfg)), g


@pytest.mark.parametrize("name,b,t", [("mini", 3, 5), ("odd", 1, 3), ("narrow", 2, 4), ("served", 2, 2)])
def test_ncw_decode_equals_channel_last(name, b, t):
    cfg = CONFIGS[name]
    p, g = random_codec(cfg)
    lat = torch.randn(b, t, cfg.latent_dim, generator=g)
    with torch.no_grad():
        want = M.codec_decode(p, lat, cfg)  # the CPU takes the channel-last path
        got = M._decode_ncw(p, lat, cfg)
    assert got.shape == want.shape == (b, 1, t * cfg.hop)
    assert torch.equal(got, want)


def chain(y, bias, x, la, r, kind, pad):
    """The channel-last decode's ops from a convolution's output (nn.conv1d's
    bias add and transposed view) to the next convolution's padded input."""
    b = y.shape[0]
    v = (y + bias[:, None]).transpose(1, 2)
    if kind == "res":
        v = x.transpose(1, 2) + v
    if kind == "head":
        return torch.tanh(v).reshape(b, 1, -1), None
    if r > 1:
        v = M._depth_to_time(v, r)
    return v.transpose(1, 2), F.pad(M.snake(v, la).transpose(1, 2), pad)


# (B, C, T, r, kind, pad): kind "plain" (x kept), "res" (the residual), "head" (tanh)
CASES = {
    "plain b3": (2, 12, 9, 1, "plain", (3, 3)),
    "residual b9": (2, 10, 11, 1, "res", (9, 9)),
    "residual b0": (1, 5, 7, 1, "res", (0, 0)),
    "residual T1": (1, 6, 1, 1, "res", (1, 1)),
    "head r8": (3, 1, 13, 8, "head", (0, 0)),
    "d2t r4 b3": (2, 6, 5, 4, "plain", (3, 3)),
    "d2t r5 b1": (1, 7, 3, 5, "plain", (1, 1)),
    "d2t r8 b9 T1": (2, 3, 1, 8, "plain", (9, 9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pass_equals_op_chain(case):
    B, C, T, r, kind, pad = CASES[case]
    g = torch.Generator().manual_seed(sorted(CASES).index(case))
    y, bias = torch.randn(B, C * r, T, generator=g), torch.randn(C * r, generator=g)
    x = torch.randn(B, C, T * r, generator=g) if kind == "res" else None
    la = 0.5 * torch.randn(C, generator=g)
    want = chain(y, bias, x, la, r, kind, pad)
    got = K.codec_pointwise(y, bias, x, r=r, tanh=kind == "head", keep=True,
                            alpha=None if kind == "head" else torch.exp(la), pad=pad)
    assert torch.equal(got[0], want[0].contiguous())
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert got[1].shape == (B, C, pad[0] + T * r + pad[1]) and torch.equal(got[1], want[1])
    plain, snake = K.codec_pointwise(y, bias, x, r=r, keep=False, alpha=torch.exp(la), pad=pad) \
        if kind != "head" else (None, None)
    assert plain is None and (kind == "head" or torch.equal(snake, want[1]))


def test_pass_refuses_what_it_cannot_write():
    y, b = torch.zeros(1, 4, 3), torch.zeros(4)
    with pytest.raises(ValueError, match="exclusive"):
        K.codec_pointwise(y, b, torch.zeros(1, 4, 3), tanh=True)
    with pytest.raises(ValueError, match="nothing"):
        K.codec_pointwise(y, b, keep=False)


def _spy(monkeypatch):
    """Route the path choice as on the card (CPU tensors count as the
    card's) and record which decode runs."""
    calls = []
    ncw = M._decode_ncw
    monkeypatch.setattr(M, "_on_card", lambda t: True)
    monkeypatch.setattr(M, "_decode_ncw", lambda *a: calls.append("ncw") or ncw(*a))
    return calls


@pytest.mark.parametrize("case", ["no_grad", "inference_mode", "grad_frozen", "grad_params", "grad_latents",
                                  "bf16", "float64", "jit_trace", "onnx_export", "cpu"])
def test_path_choice(case, monkeypatch):
    p, g = random_codec(SMALL, seed=1)
    lat = torch.randn(2, 3, SMALL.latent_dim, generator=g)
    calls = [] if case == "cpu" else _spy(monkeypatch)
    run = lambda l: M.codec_decode(p, l, SMALL)  # noqa: E731
    want_ncw = case in ("no_grad", "inference_mode", "grad_frozen")
    if case == "no_grad":
        with torch.no_grad():
            out = run(lat)
    elif case == "inference_mode":
        with torch.inference_mode():
            out = run(lat)
    elif case == "grad_frozen":  # grad on, but nothing to differentiate
        out = run(lat)
    elif case == "grad_params":
        p["dec_out"]["w"].requires_grad_(True)
        out = run(lat)
        assert out.requires_grad
    elif case == "grad_latents":
        out = run(lat.requires_grad_(True))
        assert out.requires_grad
    elif case in ("bf16", "float64"):
        with torch.no_grad():
            out = run(lat.to(getattr(torch, {"bf16": "bfloat16", "float64": "float64"}[case])))
    elif case == "jit_trace":
        with torch.no_grad():
            out = torch.jit.trace(run, (lat,), check_trace=False)(lat)
    elif case == "onnx_export":
        monkeypatch.setattr(torch.onnx, "is_in_onnx_export", lambda: True)
        with torch.no_grad():
            out = run(lat)
    else:
        monkeypatch.setattr(M, "_decode_ncw", lambda *a: calls.append("ncw"))
        with torch.no_grad():
            out = run(lat)
    assert calls == (["ncw"] if want_ncw else [])
    assert out.shape == (2, 1, 3 * SMALL.hop)
    if case in ("no_grad", "inference_mode", "grad_frozen", "grad_params", "grad_latents", "onnx_export"):
        with torch.no_grad():
            assert torch.equal(out.detach(), M._decode_ncw(p, lat.detach(), SMALL))

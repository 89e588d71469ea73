"""The port's ops (smalltts_tpu_torch.ops) against the JAX package's ops.

Inputs are made with numpy from a seed and given to both sides; fp32 on the
CPU. Tolerance: 1e-5 relative to the output's largest magnitude (fp32 sums in
another order), unless stated.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from smalltts_tpu.ops import nn as jnn  # noqa: E402
from smalltts_tpu.ops import rope as jrope  # noqa: E402
from smalltts_tpu.ops import schedule as jsched  # noqa: E402
from smalltts_tpu.ops.masking import length_mask as j_length_mask  # noqa: E402
from smalltts_tpu_torch.ops import nn, rope, schedule  # noqa: E402
from smalltts_tpu_torch.ops.masking import length_mask  # noqa: E402

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    denom = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err / denom <= rtol, f"rel err {err / denom:.3e} > {rtol:.0e}"


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


T = torch.from_numpy


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    x, w, b = rnd(2, 5, 16), rnd(16, 24, seed=1), rnd(24, seed=2)
    pj = {"w": jnp.asarray(w), **({"b": jnp.asarray(b)} if bias else {})}
    pt = {"w": T(w), **({"b": T(b)} if bias else {})}
    close(nn.linear(pt, T(x)), jnn.linear(pj, jnp.asarray(x)))


@pytest.mark.parametrize("bias", [True, False])
def test_linear_bf16_rounds_once(bias):
    """bf16, as the card serves: the product accumulates in fp32 and the bias
    adds in fp32 before one rounding, as the JAX linear does. Tolerance: 1
    bf16 ulp (2^-7 relative) plus 1e-4 absolute anywhere, and at most 1% of
    entries differ (fp32 sums in another order may cross a rounding
    boundary, or show where the bias cancels the product). Rounding the
    product to bf16 before the bias changes ~17% of them."""
    x, w, b = rnd(4, 16, 256, seed=20), rnd(256, 96, seed=21, scale=0.0625), rnd(96, seed=22, scale=4.0)
    pj = {"w": jnp.asarray(w, jnp.bfloat16), **({"b": jnp.asarray(b, jnp.bfloat16)} if bias else {})}
    pt = {"w": T(w).bfloat16(), **({"b": T(b).bfloat16()} if bias else {})}
    got = nn.linear(pt, T(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnn.linear(pj, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= np.abs(want) * 2.0 ** -7 + 1e-4).all()
    assert (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("scale_shape", [(32,), (4, 8)])
def test_rmsnorm(scale_shape):
    x = rnd(2, 7, 4, 8, seed=3) if len(scale_shape) == 2 else rnd(2, 7, 32, seed=3)
    s = rnd(*scale_shape, seed=4)
    close(nn.rmsnorm({"scale": T(s)}, T(x), 1e-6), jnn.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6))


def test_layernorm_noaffine_and_mish():
    x = rnd(3, 9, 40, seed=5, scale=3.0)
    close(nn.layernorm_noaffine(T(x)), jnn.layernorm_noaffine(jnp.asarray(x)))
    close(nn.mish(T(x)), jnn.mish(jnp.asarray(x)))


@pytest.mark.parametrize("k,groups,padding", [(31, 16, "SAME"), (7, 1, "SAME"), (1, 1, 0), (3, 4, 1)])
def test_conv1d(k, groups, padding):
    c_in, c_out = 32, 48
    x = rnd(2, 20, c_in, seed=6)
    w_hio = rnd(k, c_in // groups, c_out, seed=7, scale=0.2)
    b = rnd(c_out, seed=8)
    want = jnn.conv1d({"w": jnp.asarray(w_hio), "b": jnp.asarray(b)}, jnp.asarray(x), groups=groups,
                      padding=padding)
    got = nn.conv1d({"w": T(np.ascontiguousarray(w_hio.transpose(2, 1, 0))), "b": T(b)}, T(x),
                    groups=groups, padding=padding)
    close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa(masked):
    q, k, v = (rnd(2, 3, 6, 16, seed=s) for s in (9, 10, 11))
    mask = np.array([[True] * 6, [True] * 2 + [False] * 4]) if masked else None
    want = jnn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_mask=None if mask is None else jnp.asarray(mask))
    got = nn.sdpa(T(q), T(k), T(v), key_mask=None if mask is None else T(mask))
    close(got, want)


def test_rope_interleaved_fp32_and_bf16():
    x = rnd(2, 4, 10, 24, seed=12)
    freqs = rope.rope_table_interleaved(10, 8)
    np.testing.assert_array_equal(freqs, jrope.rope_table_interleaved(10, 8))
    want = jrope.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(freqs))
    close(rope.apply_rope_interleaved(T(x), T(freqs)), want)
    # bf16 input: the rotation runs in fp32 and rounds once (bf16 ulp tolerance)
    want16 = jrope.apply_rope_interleaved(jnp.asarray(x, jnp.bfloat16), jnp.asarray(freqs))
    got16 = rope.apply_rope_interleaved(T(x).bfloat16(), T(freqs))
    close(got16.float(), np.asarray(want16.astype(jnp.float32)), rtol=1e-2)


def test_rope_pairs():
    x = rnd(2, 12, 4, 16, seed=13)
    cos, sin = rope.rope_table_cos_sin(12, 16)
    jc, js = jrope.rope_table_cos_sin(12, 16)
    np.testing.assert_array_equal(cos, jc)
    np.testing.assert_array_equal(sin, js)
    want = jrope.apply_rope_pairs(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    close(rope.apply_rope_pairs(T(x), T(cos), T(sin)), want)


def test_cached_rope_tables_match_the_host_tables():
    """The device-side tables the models read are the host tables, exactly."""
    cos, sin = rope.pair_cos_sin(12, 16, "cpu")
    jc, js = jrope.rope_table_cos_sin(12, 16)
    np.testing.assert_array_equal(cos.numpy(), jc)
    np.testing.assert_array_equal(sin.numpy(), js)
    assert rope.pair_cos_sin(12, 16, "cpu")[0] is cos  # made once, then reused
    icos, isin = rope.interleaved_cos_sin(10, 8, "cpu")
    freqs = torch.from_numpy(jrope.rope_table_interleaved(10, 8))
    assert torch.equal(icos, torch.cos(freqs)) and torch.equal(isin, torch.sin(freqs))


def test_alpha_sigma_and_length_mask():
    t = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    ga, gs = schedule.get_alpha_sigma(T(t))
    wa, ws = jsched.get_alpha_sigma(jnp.asarray(t))
    close(ga, wa)
    close(gs, ws)
    lens = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(length_mask(T(lens), 7).numpy(), np.asarray(j_length_mask(jnp.asarray(lens), 7)))

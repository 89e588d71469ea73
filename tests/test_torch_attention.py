"""The port's attention (smalltts_tpu_torch/ops/kernels/attention.py) on the
CPU, where it runs its plain version, against the JAX package's Pallas
kernel (interpret mode) and its XLA sdpa; and the bf16 kernel's key split
and log-sum-exp merge (attention_split_plain) against both.

fp32; tolerance 1e-5 relative to the largest output (sums in another order).
The kernel itself is held against this plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from smalltts_tpu.ops import nn as jnn  # noqa: E402
from smalltts_tpu.ops.pallas.attention import fused_attention as j_fused_attention  # noqa: E402
from smalltts_tpu_torch.ops.kernels.attention import (  # noqa: E402
    KEY_TILE, attention_plain, attention_split_plain, fused_attention)

RTOL = 1e-5
T = torch.from_numpy


def close(got, want, rtol=RTOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)
    assert err <= rtol, f"rel err {err:.3e}"


def inputs(B, H, Tq, S, D, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, n, D).astype(np.float32) for n in (Tq, S, S))
    lens = rs.randint(1, S + 1, size=B)
    mask = np.arange(S)[None, :] < lens[:, None]
    mask[-1] = False  # one batch row with every key masked: a uniform average
    return q, k, v, mask


@pytest.mark.parametrize("D", [4, 64, 120, 128])
def test_plain_matches_pallas_and_sdpa(D):
    q, k, v, mask = inputs(3, 2, 24, 40, D, seed=D)
    got = fused_attention(T(q), T(k), T(v), T(mask))
    close(got, j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                 interpret=True))
    close(got, jnn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_mask=jnp.asarray(mask)))
    # the fully-masked row is the plain mean of its values
    np.testing.assert_allclose(got[-1].numpy(), np.broadcast_to(v[-1].mean(1, keepdims=True), got[-1].shape),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("D", [4, 64, 120])
def test_two_sources_and_gate_match_concatenated_keys(D):
    q, k, v, mask = inputs(2, 3, 16, 20, D, seed=1)
    _, k2, v2, mask2 = inputs(2, 3, 16, 33, D, seed=2)
    mask2[-1, :5] = True  # the last row now has valid keys only in the second source
    gate = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    kc, vc = np.concatenate([k, k2], 2), np.concatenate([v, v2], 2)
    mc = np.concatenate([mask, mask2], 1)
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(mc),
                             interpret=True)
    want = np.asarray(want) * (1.0 / (1.0 + np.exp(-gate)))
    got = attention_plain(T(q), T(k), T(v), T(mask), T(k2), T(v2), T(mask2), gate=T(gate))
    close(got, want)


def test_out_view_receives_result():
    """`out` may be a strided (B,H,T,D) view of a (B,T,H*D) buffer, as the DiT uses."""
    q, k, v, mask = inputs(2, 4, 8, 12, 64, seed=4)
    buf = torch.zeros(2, 8, 4 * 64)
    view = buf.unflatten(-1, (4, 64)).transpose(1, 2)
    res = fused_attention(T(q), T(k), T(v), T(mask), out=view)
    assert res.data_ptr() == buf.data_ptr()
    close(buf.unflatten(-1, (4, 64)).transpose(1, 2).contiguous(), attention_plain(T(q), T(k), T(v), T(mask)).numpy())


@pytest.mark.parametrize("S1,S2,splits", [(40, 150, 1), (40, 150, 2), (40, 150, 3), (40, 150, 4), (20, 100, 4),
                                          (0, 150, 2)])
def test_split_merge_matches_one_softmax(S1, S2, splits):
    """The key split the bf16 kernel makes where (b, h) pairs are too few:
    1-4 splits of the 64-key tiles [source 1 | source 2], each with its own
    (m, l, O), merged by the log-sum-exp combine. (40, 150): 4 tiles, and
    with 4 splits split 2 holds only keys masked in every row (m = -1e9);
    (20, 100) with 4 splits: 3 tiles, so split 3 holds no key (m = -inf,
    l = 0, weight 0, no NaN); (0, 150): no first source. Batch row 1 has
    keys only in the second source; the last row is fully masked (a uniform
    average over every key). fp32, against the plain one-softmax version and
    the JAX kernel (interpret mode) on the concatenated keys, 1e-5."""
    D = 64
    q, k, v, mask = inputs(3, 2, 24, max(S1, 1), D, seed=5)
    k, v, mask = k[:, :, :S1], v[:, :, :S1], mask[:, :S1]
    _, k2, v2, mask2 = inputs(3, 2, 24, S2, D, seed=6)
    mask[1] = False  # row 1: keys only in the second source
    mask2[1, :7] = True
    mask2[:, KEY_TILE:2 * KEY_TILE] = False  # the second source's second tile: masked in every row
    mask[-1], mask2[-1] = False, False  # a fully masked row
    gate = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    args = [T(q), T(k), T(v), T(mask), T(k2), T(v2), T(mask2)]
    got = attention_split_plain(*args, gate=T(gate), splits=splits)
    close(got, attention_plain(*args, gate=T(gate)).numpy())
    kc, vc, mc = np.concatenate([k, k2], 2), np.concatenate([v, v2], 2), np.concatenate([mask, mask2], 1)
    want = np.asarray(j_fused_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(mc),
                                        interpret=True)) * (1.0 / (1.0 + np.exp(-gate)))
    close(got, want)
    assert bool(torch.isfinite(got).all())
    # the fully masked row: the gated plain mean of every value
    mean = np.concatenate([v[-1], v2[-1]], 1).mean(1, keepdims=True) * (1.0 / (1.0 + np.exp(-gate[-1])))
    np.testing.assert_allclose(got[-1].numpy(), mean, rtol=1e-5, atol=1e-6)

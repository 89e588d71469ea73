"""Fixed-shape length buckets (a copy of smalltts_tpu/data/bucketing.py: the
port serves the same shape contract as the JAX package; the reasons below
are the JAX package's, written for XLA on a TPU).

The TPU answer to the reference's dynamic shapes.

Everything under jit is compiled per static shape; feeding true dynamic
lengths (as the reference's ONNX runtime does) would recompile per request.
Instead each axis (latent frames, reference frames, phoneme ids) snaps to a
small set of bucket sizes with boolean masks carrying the true lengths.
Worst-case padding waste is bounded by the bucket ladder spacing; the bucket
grid is sized so the reference bench grid (2/5/10/30 s) lands near bucket
tops.

Frame math follows the Rust server (`ceil`, src/server/src/pipeline.rs:66),
not the Python client (`int` truncation, src/smalltts/infer/onnx.py:84) —
documented divergence, the server is the benchmark reference.
"""

from __future__ import annotations

import bisect
import math
from typing import Sequence, Tuple

SAMPLE_RATE = 24_000
HOP_SIZE = 3_200
FRAMES_PER_SECOND = SAMPLE_RATE / HOP_SIZE  # 7.5

# 2 s -> 15, 5 s -> 38, 10 s -> 75, 30 s -> 225 frames
LATENT_BUCKETS: Tuple[int, ...] = (16, 40, 80, 120, 176, 240)
# reference audio: 64 frames ~ 8.5 s, 256 frames ~ 34 s (the reference's
# style encoder accepts up to its 4096-frame RoPE cap, style.py:140; round 1
# silently truncated at 64 — VERDICT item 4)
REF_BUCKETS: Tuple[int, ...] = (32, 64, 128, 256)
PHONEME_BUCKETS: Tuple[int, ...] = (64, 128, 256, 384)

# Serving contract: the *fused* synthesize graph compiles one executable per
# (batch, ref, phoneme, latent) shape tuple, so the served cross-product must
# stay small enough to precompile at startup (request-path XLA compiles are
# minutes on TPU). Coarser ladders cost masked FLOPs in the cheap encoders
# (cond-encode is ~2 ms of a ~20 ms budget at 5 s/batch 8) and buy a grid of
# 2*2*6*|batches| executables that warmup() covers exhaustively.
SERVING_REF_BUCKETS: Tuple[int, ...] = (64, 256)
SERVING_PHONEME_BUCKETS: Tuple[int, ...] = (128, 384)


def frames_for_duration(duration_sec: float) -> int:
    """ceil(duration * SR / HOP), >= 1 (server semantics, pipeline.rs:66)."""
    return max(1, math.ceil(duration_sec * SAMPLE_RATE / HOP_SIZE))


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (clamps to the largest bucket)."""
    i = bisect.bisect_left(buckets, n)
    return buckets[min(i, len(buckets) - 1)]


def pad_to(x, target_len: int, axis: int = 0):
    """Pad a numpy array along `axis` to target_len (truncates if longer)."""
    import numpy as np

    cur = x.shape[axis]
    if cur == target_len:
        return x
    if cur > target_len:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, target_len)
        return x[tuple(sl)]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target_len - cur)
    return np.pad(x, widths)

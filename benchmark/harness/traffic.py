"""The one generator of every traffic mix: requests to serve and batches to
train on, from a mix's parameters and the run's seed.

Every seed gets the same multiset of sizes (durations, phoneme counts,
reference lengths, training lengths, CFG drops, inter-arrival gaps), cut
from a fixed grid of quantiles of the mix's distributions. A serving mix is
an unbounded stream of blocks of BLOCK requests, each block holding one
request from each of BLOCK quantile bands and the same BLOCK gaps; the seed
draws the order within each block (and each training step's order), and
every content value (phoneme ids, reference latents, noise). So two seeds
ask for the same work at the same pace, and no run can exhaust the stream."""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

FRAMES_PER_S = 7.5  # codec latent frames a second (24 kHz, hop 3200)
LATENT_BUCKETS = (16, 40, 80, 120, 176, 240)  # the served latent buckets
BLOCK = 64  # requests a block: one from each quantile band


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def torch_seed(seed: int, *tags: int) -> int:
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0] >> 1)


def _grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def durations(spec: dict, n: int = BLOCK) -> np.ndarray:
    """n quantiles of a log-normal of shape `sigma`, clipped to [min, max],
    whose median is set so that the clipped quantiles' mean is `mean`."""
    z = np.array([NormalDist().inv_cdf(u) for u in _grid(n)])

    def at(median):
        return np.clip(np.exp(math.log(median) + spec["sigma"] * z), spec["min"], spec["max"])

    lo, hi = spec["min"], spec["max"]
    for _ in range(60):  # the clipped mean rises with the median
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if at(mid).mean() < spec["mean"] else (lo, mid)
    return at(0.5 * (lo + hi))


def frames_for(duration_s: float) -> int:
    """Latent frames of a duration, as the served model counts them."""
    return max(1, math.ceil(duration_s * 24_000 / 3_200))


def t_bucket(frames: int) -> int:
    return next((b for b in LATENT_BUCKETS if b >= frames), LATENT_BUCKETS[-1])


@dataclass
class Request:
    index: int
    duration_s: float
    seq_len: int
    phonemes: np.ndarray  # int32 ids
    ref: np.ndarray       # (frames, latent_dim) float32: the reference's codec latents
    due: float = 0.0      # seconds after the stream starts (open loop)

    @property
    def t_bucket(self) -> int:
        return t_bucket(self.seq_len)

    @property
    def audio_s(self) -> float:
        return self.seq_len / FRAMES_PER_S


class Stream:
    """A mix's requests, made a block at a time as they are asked for.

    Block b holds the BLOCK duration quantiles, each paired with a phoneme
    count (duration x `phonemes_per_s`, the rate at which the server turns
    a text into a duration) and with one of BLOCK reference lengths spread
    evenly over `reference_frames` (a pairing fixed for every seed and
    block); the seed orders them within the block. With a `rate_per_s`,
    the BLOCK gaps are the quantiles of an exponential scaled to a mean of
    1 / rate, in the seed's order within the block, and a request is due at
    the sum of the gaps before it and its own."""

    def __init__(self, mix: dict, seed: int, vocab: int, latent_dim: int):
        self.mix, self.seed, self.vocab, self.latent_dim = mix, int(seed), vocab, latent_dim
        fixed = rng(0, 2)
        self.durations = durations(mix["duration_s"])
        self.phoneme_counts = np.maximum(np.round(self.durations * mix["phonemes_per_s"]), 1).astype(int)
        rf = mix["reference_frames"]
        self.ref_frames = fixed.permutation(
            np.floor(rf["min"] + (rf["max"] - rf["min"] + 1) * _grid(BLOCK)).astype(int))
        self.gaps = None
        if "rate_per_s" in mix:
            q = -np.log1p(-_grid(BLOCK))
            self.gaps = q / q.mean() / mix["rate_per_s"]
        self._blocks: Dict[int, List[Request]] = {}
        self._seen = set()
        self._lock = threading.Lock()

    @property
    def t_buckets(self) -> List[int]:
        return sorted({t_bucket(frames_for(d)) for d in self.durations})

    @property
    def max_phonemes(self) -> int:
        return int(self.phoneme_counts.max())

    @property
    def max_ref_frames(self) -> int:
        return int(self.ref_frames.max())

    def __getitem__(self, i: int) -> Request:
        b, j = divmod(int(i), BLOCK)
        with self._lock:
            while len(self._blocks) <= b:
                self._blocks[len(self._blocks)] = self._block(len(self._blocks))
            return self._blocks[b][j]

    def __iter__(self):
        i = 0
        while True:
            yield self[i]
            i += 1

    def _block(self, b: int) -> List[Request]:
        r = rng(self.seed, 2, b)
        order = r.permutation(BLOCK)
        if self.gaps is not None:
            due = b * float(self.gaps.sum()) + np.cumsum(self.gaps[r.permutation(BLOCK)])
        out = []
        for j, k in enumerate(order):
            while True:  # distinct sequences: the front knows a request by its phonemes
                ids = r.integers(1, self.vocab, self.phoneme_counts[k]).astype(np.int32)
                if ids.tobytes() not in self._seen:
                    self._seen.add(ids.tobytes())
                    break
            ref = r.standard_normal((self.ref_frames[k], self.latent_dim)).astype(np.float32)
            d = float(self.durations[k])
            out.append(Request(b * BLOCK + j, d, frames_for(d), ids, ref,
                               float(due[j]) if self.gaps is not None else 0.0))
        return out


def train_lengths(mix: dict, seed: int, step: int):
    """One training step's (phoneme, latent, reference) lengths and CFG
    uniforms and t: each an even grid over its range, in the seed's order
    for this step."""
    b = mix["batch"]
    r = rng(seed, 3, step)
    g = _grid(b)

    def ints(spec):
        return r.permutation(np.floor(spec["min"] + (spec["max"] - spec["min"] + 1) * g).astype(np.int32))

    nd = NormalDist()
    z = np.array([nd.inv_cdf(u) for u in g], dtype=np.float32)
    return {"phonemes": ints(mix["phonemes"]), "latents": ints(mix["latents"]), "refs": ints(mix["refs"]),
            "text_u": r.permutation(g).astype(np.float32), "speaker_u": r.permutation(g).astype(np.float32),
            "t": (1.0 / (1.0 + np.exp(-r.permutation(z)))).astype(np.float32)}

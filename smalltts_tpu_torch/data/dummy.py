"""Dummy data: random padded batches, the training fixture (port of
smalltts_tpu/data/dummy.py). Phoneme lengths 5..198, latent lengths
20..256, reference lengths 8..64, padded to the maximal shapes so every
step has one shape. For the same seed it yields the JAX package's numpy
batches."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from smalltts_tpu_torch.text.vocab import phoneme_len


@dataclass(frozen=True)
class DummyDataConfig:
    batch_size: int = 2
    latent_dim: int = 64
    max_phonemes: int = 198
    min_phonemes: int = 5
    max_latents: int = 256
    min_latents: int = 20
    max_ref: int = 64
    min_ref: int = 8
    vocab: int = phoneme_len


def dummy_batch(rng: np.random.Generator, cfg: DummyDataConfig = DummyDataConfig()) -> Dict[str, np.ndarray]:
    b = cfg.batch_size
    ph_lens = rng.integers(cfg.min_phonemes, cfg.max_phonemes + 1, size=b)
    phonemes = np.zeros((b, cfg.max_phonemes), np.int32)
    for i, n in enumerate(ph_lens):
        phonemes[i, :n] = rng.integers(1, cfg.vocab, size=n)

    lat_lens = rng.integers(cfg.min_latents, cfg.max_latents + 1, size=b)
    latents = rng.standard_normal((b, cfg.max_latents, cfg.latent_dim), dtype=np.float32)
    for i, n in enumerate(lat_lens):
        latents[i, n:] = 0.0

    ref_lens = rng.integers(cfg.min_ref, cfg.max_ref + 1, size=b)
    ref = rng.standard_normal((b, cfg.max_ref, cfg.latent_dim), dtype=np.float32)
    for i, n in enumerate(ref_lens):
        ref[i, n:] = 0.0

    return {
        "texts": [f"dummy text {i}" for i in range(b)],
        "phonemes": phonemes,
        "phonemes_lengths": ph_lens.astype(np.int32),
        "latents": latents,
        "latents_lengths": lat_lens.astype(np.int32),
        "ref_latents": ref,
        "ref_latents_lengths": ref_lens.astype(np.int32),
    }


def get_dummy_dataloader(batch_size: int, seed: int = 0,
                         cfg: Optional[DummyDataConfig] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Endless dummy batches: the JAX package's stream of process 0 (a
    data-parallel run, not ported yet, offsets the seed by 100_003 per
    process there)."""
    print("warn: using dummy data, you probably want to use real data")
    cfg = cfg or DummyDataConfig(batch_size=batch_size)
    rng = np.random.default_rng(seed)
    while True:
        yield dummy_batch(rng, cfg)

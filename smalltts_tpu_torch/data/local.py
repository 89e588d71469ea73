"""Local-corpus data pipeline: (wav, text) pairs -> fixed-shape training
batches (port of smalltts_tpu/data/local.py), with data/dummy.py's keys and
shapes, so every trainer step keeps one shape:

  {texts, phonemes(+lengths), latents(+lengths), ref_latents(+lengths)}

Corpus layout, either:
  * metadata.csv with `wav_path|transcript` lines (LJSpeech style), or
  * {name}.wav next to {name}.txt.

The pipeline:
  * host threads decode and resample the wavs and phonemize the texts;
  * the codec encodes the waveforms to 64-dim latents in batches on the
    card, through `encode_fn`, clips grouped by length and padded to
    multiples of 64 latent frames;
  * `ref_latents` are a random crop of the same utterance, disjoint from
    the target crop where the clip is long enough (self-reference);
  * a prefetch thread keeps `prefetch` batches ready; an error in it is
    raised in the training loop.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from smalltts_tpu_torch.data.dummy import DummyDataConfig
from smalltts_tpu_torch.parallel.multihost import process_index


@dataclass(frozen=True)
class LocalDataConfig:
    batch_size: int = 2
    latent_dim: int = 64
    max_phonemes: int = 198
    max_latents: int = 256
    max_ref: int = 64
    min_latents: int = 8
    sample_rate: int = 24_000
    hop: int = 3_200
    prefetch: int = 2


def scan_corpus(root: str) -> List[Tuple[str, str]]:
    """-> [(wav_path, transcript)] from metadata.csv or sidecar .txt files."""
    meta = os.path.join(root, "metadata.csv")
    pairs: List[Tuple[str, str]] = []
    if os.path.isfile(meta):
        for line in open(meta, encoding="utf-8"):
            line = line.strip()
            if not line:
                continue
            # LJSpeech's id|raw_text|normalized_text: the last non-empty field (id|text has just one)
            fields = line.split("|")
            wav = fields[0]
            text = next((f for f in reversed(fields[1:]) if f.strip()), "")
            wav = wav if os.path.isabs(wav) else os.path.join(root, wav)
            if not wav.endswith(".wav"):
                wav += ".wav"
            pairs.append((wav, text))
    else:
        for name in sorted(os.listdir(root)):
            if not name.endswith(".wav"):
                continue
            txt = os.path.join(root, name[:-4] + ".txt")
            if os.path.isfile(txt):
                pairs.append((os.path.join(root, name), open(txt, encoding="utf-8").read().strip()))
    if not pairs:
        raise ValueError(f"no (wav, text) pairs found under {root!r}")
    return pairs


class LocalDataset:
    """The corpus decoded, phonemized and codec-encoded, served as batches.
    `encode_fn` takes audio (B, 1, T) float32 numpy and returns latents (B,
    T // hop, D), a tensor on any device or an array."""

    def __init__(self, root: str, encode_fn, cfg: LocalDataConfig = LocalDataConfig(), tokenizer=None,
                 encode_batch: int = 8) -> None:
        from concurrent.futures import ThreadPoolExecutor

        from smalltts_tpu_torch.serving import audio_io

        if tokenizer is None:
            from smalltts_tpu_torch.text import get_token_ids

            tokenizer = get_token_ids
        self.cfg = cfg
        pairs = scan_corpus(root)

        def prep(pair):
            wav_path, text = pair
            try:
                audio = audio_io.decode_and_resample(open(wav_path, "rb").read(), cfg.sample_rate)
            except Exception as exc:  # noqa: BLE001 -- one unreadable file skips that file, with its reason
                print(f"warn: skipping {wav_path}: {exc}", file=sys.stderr)
                return None
            n = (len(audio) // cfg.hop) * cfg.hop
            if n < cfg.min_latents * cfg.hop:
                return None
            ids = np.asarray(tokenizer(text), np.int32)[: cfg.max_phonemes]
            if len(ids) == 0:
                return None
            return audio[:n].astype(np.float32), ids, text

        tokenizer("a")  # build the (espeak) backend once, serially
        # decoding and resampling release the GIL in the native audio library: threads scale with cores
        with ThreadPoolExecutor(min(len(pairs), max(2, os.cpu_count() or 2))) as pool:
            prepped = [p for p in pool.map(prep, pairs) if p is not None]
        clips = [c for c, _, _ in prepped]
        self.tokens: List[np.ndarray] = [t for _, t, _ in prepped]
        self.texts: List[str] = [x for _, _, x in prepped]
        if not clips:
            raise ValueError(f"all clips under {root!r} shorter than "
                             f"{cfg.min_latents * cfg.hop / cfg.sample_rate:.1f} s or untokenizable")
        # batched encoding, the clips sorted by length and padded up to multiples of 64 latent frames,
        # so the codec runs at a few shapes
        self.latents: List[np.ndarray] = [None] * len(clips)
        order = np.argsort([len(c) for c in clips])
        quantum = cfg.hop * 64
        for i in range(0, len(order), encode_batch):
            idx = order[i: i + encode_batch]
            t_max = -(-max(len(clips[j]) for j in idx) // quantum) * quantum
            batch = np.zeros((len(idx), 1, t_max), np.float32)
            for row, j in enumerate(idx):
                batch[row, 0, : len(clips[j])] = clips[j]
            lat = encode_fn(batch)
            lat = lat.detach().float().cpu().numpy() if torch.is_tensor(lat) else np.asarray(lat)
            for row, j in enumerate(idx):
                self.latents[j] = lat[row, : len(clips[j]) // cfg.hop].astype(np.float32)

    def __len__(self) -> int:
        return len(self.tokens)

    def sample_batch(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.batch_size
        ph = np.zeros((b, cfg.max_phonemes), np.int32)
        ph_lens = np.zeros((b,), np.int32)
        lat = np.zeros((b, cfg.max_latents, cfg.latent_dim), np.float32)
        lat_lens = np.zeros((b,), np.int32)
        ref = np.zeros((b, cfg.max_ref, cfg.latent_dim), np.float32)
        ref_lens = np.zeros((b,), np.int32)
        texts = []
        for i in range(b):
            j = int(rng.integers(len(self.tokens)))
            ids, full = self.tokens[j], self.latents[j]
            texts.append(self.texts[j])
            ph_lens[i] = len(ids)
            ph[i, : len(ids)] = ids
            n = len(full)
            # the target crop (up to max_latents), then the reference from the rest of the utterance
            t_len = min(n, cfg.max_latents)
            t0 = int(rng.integers(0, n - t_len + 1))
            lat_lens[i] = t_len
            lat[i, :t_len] = full[t0: t0 + t_len]
            spans = [(a, z) for a, z in ((0, t0), (t0 + t_len, n)) if z - a >= 2]
            a, z = spans[int(rng.integers(len(spans)))] if spans else (0, n)  # a short clip: overlapping
            r_len = min(z - a, cfg.max_ref)
            r0 = int(rng.integers(a, z - r_len + 1))
            ref_lens[i] = r_len
            ref[i, :r_len] = full[r0: r0 + r_len]
        return {"texts": texts, "phonemes": ph, "phonemes_lengths": ph_lens, "latents": lat,
                "latents_lengths": lat_lens, "ref_latents": ref, "ref_latents_lengths": ref_lens}


def get_local_dataloader(root: str, encode_fn, cfg: Optional[LocalDataConfig] = None,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless prefetched batches of a local corpus, in place of
    data/dummy.get_dummy_dataloader."""
    cfg = cfg or LocalDataConfig()
    ds = LocalDataset(root, encode_fn, cfg)
    # the process's rank folded into the seed: every process of a data-parallel job samples its own slice
    # of the stream (identical seeds would make the global batch dp copies of one)
    rng = np.random.default_rng(seed + 100_003 * process_index())
    q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)

    def producer():
        try:
            while True:
                q.put(ds.sample_batch(rng))
        except BaseException as exc:  # noqa: BLE001 -- raised again in the training loop
            q.put(exc)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        yield item


def default_encode_fn(codec_checkpoint: Optional[str] = None, codec_cfg=None, device=None):
    """The best codec encoder available, on the card unless `device` says
    otherwise: the published codec's ONNX graph where its assets are
    present, else the native codec from `codec_checkpoint` (an npz in the
    JAX package's layout), else a random-init native codec (smoke runs
    only; warns). -> fn(audio (B, 1, T) float32 numpy) -> latents on the
    device."""
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec, assets_present
    from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

    dev = resolve_device(device)
    if codec_checkpoint is None and assets_present():
        codec = OnnxCodec(device=dev)

        @torch.no_grad()
        def onnx_encode(audio):
            return codec.encode_fn(codec.params, to_device(audio, dev))

        return onnx_encode

    from smalltts_tpu_torch.models.codec import CodecConfig, codec_encode, init_codec

    codec_cfg = codec_cfg or CodecConfig()
    if codec_checkpoint:
        from smalltts_tpu_torch.utils.checkpoint import load_pytree, map_pytree
        from smalltts_tpu_torch.utils.convert import params_from_jax

        params = map_pytree(lambda t: t.to(dev), params_from_jax(load_pytree(codec_checkpoint), codec_cfg))
    else:
        import warnings

        warnings.warn("no codec assets/checkpoint: encoding the corpus with a random-init codec (smoke runs only)",
                      stacklevel=2)
        params = init_codec(torch.Generator(device=dev).manual_seed(0), codec_cfg, device=dev)

    @torch.no_grad()
    def encode(audio):
        return codec_encode(params, to_device(audio, dev), codec_cfg)

    return encode


def cli_data_iter(data_dir: Optional[str], codec_checkpoint: Optional[str], batch_size: int, device=None):
    """The trainer CLIs' --data-dir: None when no directory was given (the
    trainers then take the dummy loader)."""
    if not data_dir:
        return None
    return get_local_dataloader(data_dir, default_encode_fn(codec_checkpoint, device=device),
                                LocalDataConfig(batch_size=batch_size))


def dataset_dummy_compat(cfg: LocalDataConfig) -> DummyDataConfig:
    """The DummyDataConfig of the same batch shapes."""
    return DummyDataConfig(batch_size=cfg.batch_size, latent_dim=cfg.latent_dim, max_phonemes=cfg.max_phonemes,
                           max_latents=cfg.max_latents, max_ref=cfg.max_ref)

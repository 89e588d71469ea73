"""SmallTTS: the user-facing inference pipeline (port of smalltts_tpu/infer/pipeline.py).

`synthesize_padded` is the serving batcher's entry point: condition
encoding, the 4-step DMD loop through the hand-written DiT and attention
kernels, and the fp32 codec decode, on one device. Inputs snap to the same
fixed-shape buckets as the JAX package (data.bucketing).

The pipeline runs on the card unless the caller passes `device="cpu"`; with
no card it raises rather than quietly running on the CPU.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from smalltts_tpu_torch.data.bucketing import (
    HOP_SIZE,
    LATENT_BUCKETS,
    SERVING_PHONEME_BUCKETS,
    SERVING_REF_BUCKETS,
    frames_for_duration,
    pad_to,
    pick_bucket,
)
from smalltts_tpu_torch.infer.sampler import NUM_STEPS, _sample_loop, draw_noises, make_synthesize_fn
from smalltts_tpu_torch.models.backbone import BackboneConfig, encode_conditions, init_backbone
from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, codec_encode, init_codec
from smalltts_tpu_torch.models.dit import (
    fuse_serving_projections,
    quantize_modulations,
    quantize_stream_weights,
)
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.utils.transfer import to_device

CHARS_PER_SECOND = 11.5


def estimate_duration(text: str, min_sec: float = 0.5, max_sec: float = 30.0) -> float:
    """Duration heuristic: len(text) / 11.5 s, clamped to [0.5, 30]."""
    return max(min_sec, min(len(text) / CHARS_PER_SECOND, max_sec))


@dataclass
class Timing:
    """Per-stage wall-clock ms."""

    codec_enc_ms: float = 0.0
    cond_enc_ms: float = 0.0
    denoise_ms: float = 0.0
    codec_dec_ms: float = 0.0
    total_ms: float = 0.0


def resolve_device(device=None) -> torch.device:
    """None means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SmallTTS runs on a CUDA card and none is available; "
                           "pass device='cpu' to run on the CPU explicitly")
    return dev


def _cast_tree(tree, dtype, device):
    """Floating leaves -> `dtype` on `device`; others keep their dtype."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype, device) for v in tree]
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


class SmallTTS:
    """DMD 4-step inference (no CFG) on one device.

    Weights: the port's parameter trees (utils.convert.params_from_jax turns
    the JAX package's trees into them), `.npz` checkpoints of the JAX
    package, or nothing for a seeded random init at `cfg`'s size. Floating
    backbone params are cast to bf16 on the card and fp32 on the CPU, and
    the block projections are fused into the serving layout the DiT kernels
    read; the codec runs in fp32.

    int8 serving, both off by default as in the JAX package, applied after
    the cast and the fusion so the scales stay fp32:
    - `w8_modulation`: the stacked adaLN modulation weights are stored int8
      (models.dit.quantize_modulations) and the hoisted modulation product
      runs through the w8 kernel;
    - `w8_stream`: the scan's four weight streams (qkvg, to_out, w13, w2)
      are stored int8 (models.dit.quantize_stream_weights) and the scan's
      GEMM kernel dequantizes them in shared memory."""

    def __init__(
        self,
        backbone_params=None,
        codec_params=None,
        *,
        checkpoint: Optional[str] = None,
        codec_checkpoint: Optional[str] = None,
        cfg: BackboneConfig = None,
        codec_cfg: CodecConfig = None,
        num_steps: Optional[int] = None,
        seed: int = 0,
        sampler: str = "auto",
        pcm16_out: bool = False,
        w8_modulation: bool = False,
        w8_stream: bool = False,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        if sampler not in ("auto", "dmd"):
            raise ValueError(f"sampler {sampler!r} is not ported; use 'dmd' or 'auto'")
        from smalltts_tpu_torch.utils import checkpoint as ckpt
        from smalltts_tpu_torch.utils.config_io import backbone_config_from_meta, codec_config_from_meta
        from smalltts_tpu_torch.utils.convert import params_from_jax

        if cfg is None and checkpoint:
            cfg = backbone_config_from_meta(ckpt.load_meta(checkpoint))
        if codec_cfg is None and codec_checkpoint:
            codec_cfg = codec_config_from_meta(ckpt.load_meta(codec_checkpoint))
        self.cfg = cfg or BackboneConfig()
        self.codec_cfg = codec_cfg or CodecConfig()
        # the card's kernels take bf16 only; the CPU runs fp32, as the tests compare it
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32

        if backbone_params is None and checkpoint:
            backbone_params = params_from_jax(ckpt.load_pytree(checkpoint), self.cfg)
        if codec_params is None and codec_checkpoint:
            codec_params = params_from_jax(ckpt.load_pytree(codec_checkpoint), self.codec_cfg)
        if backbone_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            backbone_params = init_backbone(gen, self.cfg, device=self.device)
        if codec_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            codec_params = init_codec(gen, self.codec_cfg, device=self.device)
        params = _cast_tree(backbone_params, self.dtype, self.device)
        if "r_gate" in params:
            raise ValueError("IMF checkpoints need the imf sampler, which is not ported")
        params = fuse_serving_projections(params)
        if w8_modulation:
            params = quantize_modulations(params)
        if w8_stream:
            params = quantize_stream_weights(params)
        self.params = params
        self.codec_params = _cast_tree(codec_params, torch.float32, self.device)
        self.num_steps = NUM_STEPS if num_steps is None else num_steps
        self.sampler = "dmd"
        self.pcm16_out = pcm16_out
        self._synthesize_fn = make_synthesize_fn(self.cfg, self.codec_cfg, self.num_steps,
                                                 pcm16=pcm16_out)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        self._gen_lock = threading.Lock()

    # ------------------------------------------------------------- helpers

    def _noises(self, batch: int, t_bucket: int) -> torch.Tensor:
        # concurrent callers must each get fresh noise: one locked generator
        with self._gen_lock:
            return draw_noises(self.num_steps, batch, t_bucket, self.cfg.latent_dim, self.dtype,
                               self.device, self._gen)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, x, dtype):
        return to_device(np.asarray(x), self.device).to(dtype)

    # ------------------------------------------------------------- public API

    def encode_reference(self, audio_24k: np.ndarray) -> np.ndarray:
        """Mono 24 kHz waveform (T,) -> reference latents (T', 64). The
        waveform pads to a serving ref bucket's worth of samples and is cut
        beyond the largest bucket."""
        t = len(audio_24k)
        frames = max(-(-t // HOP_SIZE), 1)
        bucket = pick_bucket(frames, SERVING_REF_BUCKETS)
        frames = min(frames, bucket)
        audio = np.zeros((1, 1, bucket * HOP_SIZE), np.float32)
        n = min(t, bucket * HOP_SIZE)
        audio[0, 0, :n] = audio_24k[:n]
        with torch.inference_mode():
            lat = codec_encode(self.codec_params, self._tensor(audio, torch.float32), self.codec_cfg)
            return lat[0, :frames].cpu().numpy()

    def synthesize_padded(self, ref_latents, ref_lengths, phonemes, phoneme_lengths, seq_lengths,
                          t_bucket: int, fetch: bool = True, noises=None):
        """Batched bucket-padded synthesis -> (B, 1, t_bucket * hop) waveform
        (float32; int16 when built with pcm16_out=True). `fetch=False` returns
        the device tensor without waiting for the device. `noises`
        (steps, B, t_bucket, 64) replaces the generator's noise."""
        b = len(seq_lengths)
        with torch.inference_mode():
            noises = (self._noises(b, t_bucket) if noises is None
                      else self._tensor(noises, self.dtype))
            audio = self._synthesize_fn(
                self.params, self.codec_params,
                self._tensor(ref_latents, self.dtype), self._tensor(ref_lengths, torch.int32),
                self._tensor(phonemes, torch.int64), self._tensor(phoneme_lengths, torch.int32),
                self._tensor(seq_lengths, torch.int32), noises, t_bucket=t_bucket)
        if not fetch:
            return audio
        return audio.cpu().numpy()

    def _bucketize(self, ref_latents, phoneme_ids, duration_sec):
        seq_len = frames_for_duration(duration_sec)
        t_bucket = pick_bucket(seq_len, LATENT_BUCKETS)
        seq_len = min(seq_len, t_bucket)
        r_bucket = pick_bucket(len(ref_latents), SERVING_REF_BUCKETS)
        if len(ref_latents) > SERVING_REF_BUCKETS[-1]:
            import warnings

            warnings.warn(f"reference audio is {len(ref_latents)} latent frames; truncating to "
                          f"the largest serving bucket {SERVING_REF_BUCKETS[-1]}", stacklevel=3)
        ref_len = min(len(ref_latents), r_bucket)
        ref = pad_to(np.asarray(ref_latents, np.float32), r_bucket, axis=0)
        p_bucket = pick_bucket(max(len(phoneme_ids), 1), SERVING_PHONEME_BUCKETS)
        ph_len = min(len(phoneme_ids), p_bucket)
        ph = np.zeros((p_bucket,), np.int32)
        ph[:ph_len] = np.asarray(phoneme_ids[:ph_len], np.int32)
        return ref, ref_len, ph, ph_len, seq_len, t_bucket

    def synthesize(self, ref_latents, phoneme_ids: Sequence[int], duration_sec: float,
                   noises=None) -> np.ndarray:
        """Single-utterance synthesis -> (1, samples) waveform at 24 kHz."""
        ref, ref_len, ph, ph_len, seq_len, t_bucket = self._bucketize(
            ref_latents, list(phoneme_ids), duration_sec)
        audio = self.synthesize_padded(ref[None], np.array([ref_len]), ph[None],
                                       np.array([ph_len]), np.array([seq_len]), t_bucket,
                                       noises=noises)
        return audio[0, :, : seq_len * HOP_SIZE]

    def synthesize_timed(self, ref_audio_24k, phoneme_ids, duration_sec):
        """Staged synthesis with per-stage wall-clock timing (each stage ends
        in a device sync). Returns (waveform (1, samples) float32, Timing)."""
        timing = Timing()
        t0 = time.perf_counter()
        ref_latents = self.encode_reference(np.asarray(ref_audio_24k))
        t1 = time.perf_counter()
        timing.codec_enc_ms = (t1 - t0) * 1e3
        ref, ref_len, ph, ph_len, seq_len, t_bucket = self._bucketize(
            ref_latents, list(phoneme_ids), duration_sec)
        with torch.inference_mode():
            ph_t = self._tensor(ph[None], torch.int64)
            ph_mask = length_mask(self._tensor([ph_len], torch.int32), ph_t.shape[1])
            cond = encode_conditions(self.params, self.cfg, self._tensor(ref[None], self.dtype),
                                     self._tensor([ref_len], torch.int32), ph_t, ph_mask)
            self._sync()
            t2 = time.perf_counter()
            timing.cond_enc_ms = (t2 - t1) * 1e3
            latents = _sample_loop(self.params, self.cfg, cond, self._tensor([seq_len], torch.int32),
                                   t_bucket, self.num_steps, self._noises(1, t_bucket))
            self._sync()
            t3 = time.perf_counter()
            timing.denoise_ms = (t3 - t2) * 1e3
            audio = codec_decode(self.codec_params, latents.float(), self.codec_cfg)
            audio = audio.cpu().numpy()[0, :, : seq_len * HOP_SIZE]
        t4 = time.perf_counter()
        timing.codec_dec_ms = (t4 - t3) * 1e3
        timing.total_ms = (t4 - t0) * 1e3
        return audio, timing

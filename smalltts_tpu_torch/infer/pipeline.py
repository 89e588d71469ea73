"""SmallTTS: the user-facing inference pipeline (port of smalltts_tpu/infer/pipeline.py).

`synthesize_padded` is the serving batcher's entry point: condition
encoding, the few-step sampler (DMD-4, or IMF-2 for an IMF checkpoint)
through the hand-written DiT and attention kernels, and the fp32 codec
decode (the native codec, or an imported ONNX one), on one device. Inputs
snap to the same fixed-shape buckets as the JAX package (data.bucketing).

On the card each bucket shape (batch, r, p, t) runs as one captured CUDA
graph, the counterpart of the one XLA executable per bucket of the JAX
package: `warmup` captures the serving contract (`contract_shapes`), a
shape not captured yet is captured the first time it runs, and
`compile_cache_size` counts the graphs. On the CPU nothing is captured;
there `compile_cache_size` counts the bucket shapes that have run.

The pipeline runs on the card unless the caller passes `device="cpu"`; with
no card it raises rather than quietly running on the CPU.

While a torch.profiler runs, each `synthesize_padded` call is the span
pipeline.call (utils/profiling.py) over its host stages: pipeline.inputs
(the inputs' copies to the device), then on the card pipeline.lock (the
wait for the graphs' lock), pipeline.capture (a graph captured in the
request path), pipeline.stage (the static buffers' and the noise's
copies), pipeline.replay and pipeline.clone (the output's copy); without
graphs, pipeline.eager.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

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
from smalltts_tpu_torch.infer.sampler import NUM_STEPS, _latents, draw_noises, make_synthesize_fn, noise_draws
from smalltts_tpu_torch.models.backbone import BackboneConfig, encode_conditions, init_backbone
from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, codec_encode, init_codec
from smalltts_tpu_torch.models.dit import (
    fuse_serving_projections,
    quantize_modulations,
    quantize_stream_weights,
)
from smalltts_tpu_torch.ops import kernels
from smalltts_tpu_torch.ops.masking import length_mask
from smalltts_tpu_torch.parallel import comm
from smalltts_tpu_torch.parallel.mesh import shard_params, use
from smalltts_tpu_torch.utils import profiling
from smalltts_tpu_torch.utils.transfer import resolve_device, to_device

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


@dataclass
class _Graph:
    """One bucket shape captured as a CUDA graph: its static inputs, noise
    and output, the kernel launches each replay makes (counted while it was
    captured) and its replays."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    noises: torch.Tensor
    out: torch.Tensor
    launches: Dict[str, int] = field(default_factory=dict)
    replays: int = 0


def _cast_tree(tree, dtype, device):
    """Floating leaves -> `dtype` on `device`; others keep their dtype."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype, device) for v in tree]
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


def _spmd(fn, mesh):
    """The synthesize fn under `mesh`, SPMD: with the mesh in use, on this
    rank's dp rows of the inputs and noise when the batch divides by dp
    (the audio then all-gathered over dp), else on the whole batch."""

    def synthesize(params, codec_params, *args, t_bucket: int):
        *inputs, noises = args
        with use(mesh):
            split = mesh.dp_group is not None and inputs[0].shape[0] % mesh.dp == 0
            if split:
                inputs, noises = [mesh.rows(x) for x in inputs], mesh.rows(noises, axis=1)
            audio = fn(params, codec_params, *inputs, noises, t_bucket=t_bucket)
            return comm.all_gather(audio, mesh.dp_group, mesh.dp) if split else audio

    return synthesize


class SmallTTS:
    """Few-step inference (no CFG) on one device.

    Weights: the port's parameter trees (utils.convert.params_from_jax turns
    the JAX package's trees into them), `.npz` checkpoints of the JAX
    package, or nothing for a seeded random init at `cfg`'s size. Floating
    backbone params are cast to `dtype` (default bf16 on the card, fp32 on
    the CPU; the card's kernels take bf16 only), and
    the block projections are fused into the serving layout the DiT kernels
    read; the codec runs in fp32.

    int8 serving, both off by default as in the JAX package, applied after
    the cast and the fusion so the scales stay fp32:
    - `w8_modulation`: the stacked adaLN modulation weights are stored int8
      (models.dit.quantize_modulations) and the hoisted modulation product
      runs through the w8 kernel;
    - `w8_stream`: the scan's four weight streams (qkvg, to_out, w13, w2)
      are stored int8 (models.dit.quantize_stream_weights) and the scan's
      GEMM kernel dequantizes them in shared memory.

    `sampler`, as in the JAX package: "dmd" (the 4-step fresh-noise loop;
    on an IMF checkpoint each step evaluates u(x, t, t) with the
    (1 + r_gate) embedding), "imf" (the integral-velocity student,
    train/imf.imf_sample; the checkpoint must carry r_gate) or "auto":
    "imf" when the params carry r_gate, else "dmd". `num_steps` defaults to
    2 for "imf" and 4 for "dmd"; an explicit value is always honoured.

    `codec`, as in the JAX package: "native" (models/codec.py), "onnx" or
    an onnxtorch.codec.OnnxCodec (the imported VibeVoice codec of
    $SMALLTTS_ASSETS/codec/*.onnx, fp32 with TF32 off), or "auto": "onnx"
    when those assets are present and no native codec weights were passed,
    else "native".

    `fused_block` (default True): the block projections are fused into the
    serving layout and the denoiser's block scan runs the hand-written scan
    kernels (ops/kernels/dit_block.py). False keeps the split layout of
    training: the blocks run `_block_core` layer by layer in PyTorch ops,
    their attention still the attention kernel; the int8 stream weights
    need the fused layout. The JAX argument of that name opts into its
    Pallas scan (default off there); here the scan is the default.

    `mesh` (parallel/mesh.py), as in the JAX package, runs the pipeline
    SPMD over a process group: every rank calls with the same inputs. The
    backbone params hold this rank's tensor-parallel shards (on the fused
    and int8 layouts too; the codec stays whole), a batch that divides by
    dp runs this rank's dp rows and the audio is all-gathered over dp, so
    every rank returns the whole batch; a batch that does not divide runs
    whole on every rank. Under NCCL the collectives are captured into each
    bucket's CUDA graph; gloo's cannot be captured, so under gloo the
    pipeline runs eagerly on the card (`graphs` is False, and warmup says
    so)."""

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
        codec="auto",
        dtype=None,
        pcm16_out: bool = False,
        w8_modulation: bool = False,
        w8_stream: bool = False,
        fused_block: bool = True,
        device=None,
        mesh=None,
    ) -> None:
        self.device = resolve_device(device)
        from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec, assets_present
        from smalltts_tpu_torch.utils import checkpoint as ckpt
        from smalltts_tpu_torch.utils.config_io import backbone_config_from_meta, codec_config_from_meta
        from smalltts_tpu_torch.utils.convert import params_from_jax

        if cfg is None and checkpoint and not ckpt.is_torch_checkpoint(checkpoint):
            cfg = backbone_config_from_meta(ckpt.load_meta(checkpoint))
        if codec_cfg is None and codec_checkpoint:
            codec_cfg = codec_config_from_meta(ckpt.load_meta(codec_checkpoint))
        self.cfg = cfg or BackboneConfig()
        self.codec_cfg = codec_cfg or CodecConfig()
        # the card's kernels take bf16 only; the CPU runs fp32 unless `dtype` says otherwise
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype

        if backbone_params is None and checkpoint:  # an npz, or a reference torch checkpoint (.pt/.pth/.bin)
            tree = (ckpt.load_reference_backbone_checkpoint(checkpoint) if ckpt.is_torch_checkpoint(checkpoint)
                    else ckpt.load_pytree(checkpoint))
            backbone_params = params_from_jax(tree, self.cfg)
        # the codec backend, chosen as the JAX package chooses it
        self.onnx_codec = None
        if isinstance(codec, OnnxCodec):
            self.onnx_codec = codec
        elif codec == "onnx":
            self.onnx_codec = OnnxCodec(device=self.device)
        elif codec == "auto":
            if codec_params is None and codec_checkpoint is None and assets_present():
                self.onnx_codec = OnnxCodec(device=self.device)
        elif codec != "native":
            raise ValueError(f"codec must be 'native'/'onnx'/'auto'/OnnxCodec, got {codec!r}")
        if self.onnx_codec is not None:
            codec_params = self.onnx_codec.params
        elif codec_params is None and codec_checkpoint:
            codec_params = params_from_jax(ckpt.load_pytree(codec_checkpoint), self.codec_cfg)
        if backbone_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            backbone_params = init_backbone(gen, self.cfg, device=self.device)
        if codec_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            codec_params = init_codec(gen, self.codec_cfg, device=self.device)
        params = _cast_tree(backbone_params, self.dtype, self.device)
        if sampler == "auto":
            sampler = "imf" if "r_gate" in params else "dmd"
        if sampler == "imf" and "r_gate" not in params:
            raise ValueError("sampler='imf' needs an IMF checkpoint: the params carry no r_gate leaf")
        if fused_block:
            params = fuse_serving_projections(params)
        elif w8_stream:
            raise ValueError("w8_stream needs fused_block: the int8 stream weights are the fused scan's")
        self.fused_block = fused_block
        if w8_modulation:
            params = quantize_modulations(params)
        if w8_stream:
            params = quantize_stream_weights(params)
        self.mesh = mesh
        if mesh is not None:  # after the int8 quantizers: a row shard keeps the whole column's scale
            params = shard_params(params, mesh)
        self.params = params
        self.codec_params = _cast_tree(codec_params, torch.float32, self.device)
        if num_steps is None:
            num_steps = 2 if sampler == "imf" else NUM_STEPS
        self.sampler = sampler
        self.num_steps = num_steps
        self.pcm16_out = pcm16_out
        self._synthesize_fn = make_synthesize_fn(
            self.cfg, self.codec_cfg, self.num_steps, sampler=sampler, pcm16=pcm16_out,
            decode_fn=None if self.onnx_codec is None else self.onnx_codec.decode_fn)
        if mesh is not None:
            self._synthesize_fn = _spmd(self._synthesize_fn, mesh)
        # one CUDA graph per bucket on the card, but not under gloo, whose collectives cannot be captured
        self.graphs = self.device.type == "cuda" and (mesh is None or mesh.backend != "gloo")
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        self._gen_lock = threading.Lock()
        # (batch, r, p, t) -> _Graph on the card; the shapes run on the CPU
        self._graphs: Dict[tuple, _Graph] = {}
        self._shapes_run: set = set()
        # one lock around capture and replay + output copy: a graph's static
        # buffers hold one batch at a time
        self._graph_lock = threading.Lock()
        self._graph_pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

    # ------------------------------------------------------------- helpers

    def _encode(self, audio: torch.Tensor) -> torch.Tensor:
        if self.onnx_codec is not None:
            return self.onnx_codec.encode_fn(self.codec_params, audio)
        return codec_encode(self.codec_params, audio, self.codec_cfg)

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        if self.onnx_codec is not None:
            return self.onnx_codec.decode_fn(self.codec_params, latents)
        return codec_decode(self.codec_params, latents, self.codec_cfg)

    def _noises(self, batch: int, t_bucket: int) -> torch.Tensor:
        # concurrent callers must each get fresh noise: one locked generator
        with self._gen_lock:
            return draw_noises(self.num_steps, batch, t_bucket, self.cfg.latent_dim, self.dtype,
                               self.device, self._gen, self.sampler)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return to_device(np.asarray(x), self.device).to(dtype)

    # ------------------------------------------------------------- public API

    def encode_reference(self, audio_24k: np.ndarray) -> np.ndarray:
        """Mono 24 kHz waveform (T,) -> reference latents (T', 64). The
        waveform pads to a serving ref bucket's worth of samples and is cut
        beyond the largest bucket. The ONNX encoder encodes it when the
        pipeline has one."""
        t = len(audio_24k)
        frames = max(-(-t // HOP_SIZE), 1)
        bucket = pick_bucket(frames, SERVING_REF_BUCKETS)
        frames = min(frames, bucket)
        audio = np.zeros((1, 1, bucket * HOP_SIZE), np.float32)
        n = min(t, bucket * HOP_SIZE)
        audio[0, 0, :n] = audio_24k[:n]
        with torch.inference_mode():
            lat = self._encode(self._tensor(audio, torch.float32))
            return lat[0, :frames].cpu().numpy()

    def synthesize_padded(self, ref_latents, ref_lengths, phonemes, phoneme_lengths, seq_lengths,
                          t_bucket: int, fetch: bool = True, noises=None):
        """Batched bucket-padded synthesis -> (B, 1, t_bucket * hop) waveform
        (float32; int16 when built with pcm16_out=True). On the card the
        bucket shape runs as its CUDA graph, captured on first use.
        `fetch=False` returns the device tensor without waiting for the
        device. `noises` (draws, B, t_bucket, 64), an array or a tensor,
        replaces the generator's noise: one draw a step for "dmd", the start
        noise alone for "imf" (sampler.noise_draws)."""
        b = len(seq_lengths)
        with profiling.annotate("pipeline.call", batch=b, t=t_bucket):
            with torch.inference_mode():
                with profiling.annotate("pipeline.inputs"):
                    inputs = (self._tensor(ref_latents, self.dtype), self._tensor(ref_lengths, torch.int32),
                              self._tensor(phonemes, torch.int64), self._tensor(phoneme_lengths, torch.int32),
                              self._tensor(seq_lengths, torch.int32))
                key = (b, inputs[0].shape[1], inputs[2].shape[1], t_bucket)
                if self.graphs:
                    audio = self._replay(key, inputs, noises)
                else:
                    with profiling.annotate("pipeline.eager"):
                        noises = (self._noises(b, t_bucket) if noises is None
                                  else self._tensor(noises, self.dtype))
                        audio = self._synthesize_fn(self.params, self.codec_params, *inputs, noises,
                                                    t_bucket=t_bucket)
                    with self._graph_lock:
                        self._shapes_run.add(key)
            if not fetch:
                return audio
            return audio.cpu().numpy()

    def _replay(self, key, inputs, noises):
        """Run bucket shape `key` as its CUDA graph, captured first if it has
        not been: the inputs and the noise (drawn by the locked generator, as
        the eager path draws it, or the caller's) go into the graph's static
        buffers, the graph is replayed, and a copy of its static output,
        queued right after the replay, is returned, so that the next batch of
        the same bucket cannot overwrite a result not fetched yet."""
        with profiling.annotate("pipeline.lock"):
            self._graph_lock.acquire()
        try:
            g = self._graphs.get(key)
            if g is None:
                with profiling.annotate("pipeline.capture"):
                    g = self._graphs[key] = self._capture(key, inputs)
            with profiling.annotate("pipeline.stage"):
                for static, x in zip(g.inputs, inputs):
                    static.copy_(x)
                g.noises.copy_(self._noises(key[0], key[3]) if noises is None
                               else self._tensor(noises, self.dtype))
            with profiling.annotate("pipeline.replay"):
                g.graph.replay()
            g.replays += 1
            kernels.add_launches(g.launches)
            with profiling.annotate("pipeline.clone"):
                return g.out.clone()
        finally:
            self._graph_lock.release()

    def _capture(self, key, inputs) -> _Graph:
        """Capture the eager synthesize fn at bucket shape `key` into a CUDA
        graph, in the memory pool that every graph of this pipeline shares
        (replays are serialized on one stream, and each graph keeps its
        static tensors alive). An eager run on a side stream comes first:
        cuDNN chooses its algorithms and the kernels set their attributes
        and tables there, outside the capture. The capture checks only this
        thread's CUDA calls, so the batcher's fetch thread may copy a result
        to the host meanwhile. A failed capture raises."""
        static = tuple(x.clone() for x in inputs)
        noises = torch.zeros((noise_draws(self.sampler, self.num_steps), key[0], key[3], self.cfg.latent_dim),
                             dtype=self.dtype, device=self.device)

        def run():
            return self._synthesize_fn(self.params, self.codec_params, *static, noises, t_bucket=key[3])

        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            run()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with kernels.recording() as launches, torch.cuda.graph(graph, pool=self._graph_pool,
                                                               capture_error_mode="thread_local"):
            out = run()
        return _Graph(graph, static, noises, out, launches)

    def contract_shapes(self, batch_sizes: Sequence[int] = (1, 8),
                        t_buckets: Sequence[int] = LATENT_BUCKETS,
                        r_buckets: Sequence[int] = SERVING_REF_BUCKETS,
                        p_buckets: Sequence[int] = SERVING_PHONEME_BUCKETS):
        """The serving shape contract: every (batch, r, p, t) tuple a request
        can reach after bucketing. warmup() captures exactly this set."""
        return [(bs, rb, pb, tb) for bs in batch_sizes for rb in r_buckets for pb in p_buckets
                for tb in t_buckets]

    def warmup(self, batch_sizes: Sequence[int] = (1, 8), t_buckets: Sequence[int] = LATENT_BUCKETS,
               r_buckets: Sequence[int] = SERVING_REF_BUCKETS, p_buckets: Sequence[int] = SERVING_PHONEME_BUCKETS,
               progress: bool = False, workers: int = 8) -> int:
        """Run every shape of the serving contract once, so that no
        in-contract request captures a CUDA graph in the request path (on
        the CPU, so that each shape has run). The reference encoder runs
        once per ref bucket first, on `workers` threads. Returns the number
        of shape tuples visited. The shapes run one at a time, largest first
        (batch x latent bucket, then phonemes, then refs): the graphs share
        one memory pool, and each smaller graph then reuses blocks that a
        larger one freed instead of growing the pool."""
        shapes = self.contract_shapes(batch_sizes, t_buckets, r_buckets, p_buckets)
        if self.device.type == "cuda" and not self.graphs:
            print(f"warmup: {len(shapes)} shapes run eagerly, no CUDA graph: the {self.mesh.backend} "
                  "backend's collectives cannot be captured", flush=True)
        shapes.sort(key=lambda s: (s[0] * s[3], s[0] * s[2], s[0] * s[1]), reverse=True)

        def warm_encoder(rb):
            self.encode_reference(np.zeros((rb * HOP_SIZE,), np.float32))

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max(1, workers)) as pool:
            list(pool.map(warm_encoder, r_buckets))
        for i, (bs, rb, pb, tb) in enumerate(shapes):
            if progress:
                print(f"warmup {i + 1}/{len(shapes)}: batch={bs} r={rb} p={pb} t={tb}", flush=True)
            self.synthesize_padded(np.zeros((bs, rb, self.cfg.latent_dim), np.float32),
                                   np.full((bs,), rb, np.int32), np.zeros((bs, pb), np.int32),
                                   np.full((bs,), 1, np.int32), np.full((bs,), min(tb, 1), np.int32), tb,
                                   fetch=False)
            # wait per shape, so warmup() returns (and /ready flips) with
            # nothing still queued on the device
            self._sync()
        return len(shapes)

    def compile_cache_size(self) -> int:
        """CUDA graphs captured, one per bucket shape, on the card; the
        bucket shapes that have run, on the CPU or without graphs (tests
        assert this stays flat across in-contract traffic)."""
        with self._graph_lock:
            return len(self._graphs) if self.graphs else len(self._shapes_run)

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
        with torch.inference_mode(), use(self.mesh):
            ph_t = self._tensor(ph[None], torch.int64)
            ph_mask = length_mask(self._tensor([ph_len], torch.int32), ph_t.shape[1])
            cond = encode_conditions(self.params, self.cfg, self._tensor(ref[None], self.dtype),
                                     self._tensor([ref_len], torch.int32), ph_t, ph_mask)
            self._sync()
            t2 = time.perf_counter()
            timing.cond_enc_ms = (t2 - t1) * 1e3
            latents = _latents(self.params, self.cfg, cond, self._tensor([seq_len], torch.int32), t_bucket,
                               self.num_steps, self._noises(1, t_bucket), self.sampler)
            self._sync()
            t3 = time.perf_counter()
            timing.denoise_ms = (t3 - t2) * 1e3
            audio = self._decode(latents.float())
            audio = audio.cpu().numpy()[0, :, : seq_len * HOP_SIZE]
        t4 = time.perf_counter()
        timing.codec_dec_ms = (t4 - t3) * 1e3
        timing.total_ms = (t4 - t0) * 1e3
        return audio, timing

    def forward(self, conditionings: List[np.ndarray], transcriptions: list, texts: list,
                duration_sec: float = 3.0, max_batch: int = 8) -> List[np.ndarray]:
        """Batch API prepending transcription tokens to text tokens. Items
        are packed into `synthesize_padded` calls exactly as the serving
        batcher groups and pads them: everything shares one latent bucket
        (one duration), refs and phonemes pad to the group's serving
        buckets, and each chunk of `max_batch` items is one call on a batch
        class that warmup() captures."""
        from smalltts_tpu_torch.serving.batcher import Request, group_requests, pad_group
        from smalltts_tpu_torch.text import get_token_ids

        def tok(x):
            return get_token_ids(x) if isinstance(x, str) else list(map(int, x))

        requests = [Request(np.asarray(cond, np.float32), tok(trans) + tok(text), duration_sec)
                    for cond, trans, text in zip(conditionings, transcriptions, texts)]
        for r in requests:
            if len(r.ref_latents) > SERVING_REF_BUCKETS[-1]:
                import warnings

                warnings.warn(f"reference audio is {len(r.ref_latents)} latent frames; truncating to the "
                              f"largest serving bucket {SERVING_REF_BUCKETS[-1]} — pass a shorter clip",
                              stacklevel=2)
        index = {id(r): i for i, r in enumerate(requests)}
        results: List[np.ndarray] = [None] * len(requests)
        for group in group_requests(requests, max_batch):
            ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, _ = pad_group(group, max_batch)
            audio = self.synthesize_padded(ref, ref_lens, ph, ph_lens, seq_lens, t_bucket)
            for i, r in enumerate(group):
                results[index[id(r)]] = audio[i, :, : int(seq_lens[i]) * HOP_SIZE]
        return results

    __call__ = forward

"""Serving cells: the program's SmallTTS behind its Batcher, driven by the
benchmark's own requests, and the check of what it served.

The front is the `tts` the Batcher is given. It hands each padded batch to
SmallTTS.synthesize_padded with noise from the benchmark's bank (drawn on
the device from the seed; a request's slot is its index modulo the bank),
and records each call: its bucket shape, the rows' true lengths, the host
time inside the call and the program's launch counters."""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import flops as F
from harness import traffic as T
from harness.core import Run, to_device
from harness.stats import percentile
from harness.window import Gate
from reference import model as ref


@dataclass
class Batch:
    b: int
    r: int
    p: int
    t: int
    ref_lens: np.ndarray
    ph_lens: np.ndarray
    seq_lens: np.ndarray
    real: int
    host_s: float        # inside the program's synthesize_padded
    start: float         # perf_counter at the call
    wall: tuple          # (start, end) ns, wall clock, around the program's call
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def requested_frames(self) -> int:
        return int(self.seq_lens[: self.real].sum())

    @property
    def padded_frames(self) -> int:
        return self.b * self.t


@dataclass
class Served:
    req: T.Request
    due: float
    done: Optional[float] = None
    error: Optional[str] = None


def program_configs(config: dict):
    """The program's BackboneConfig and CodecConfig of a configuration file."""
    from smalltts_tpu_torch.models.backbone import BackboneConfig
    from smalltts_tpu_torch.models.codec import CodecConfig
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig

    d = config["dit"]
    dit = DiTConfig(latent_dim=config["latent_dim"], phoneme_dim=config["phoneme_dim"],
                    hidden_dim=config["hidden_dim"], n_blocks=d["n_blocks"], heads=d["heads"],
                    mlp_ratio=d["mlp_ratio"], rot_dim=d["rot_dim"], conv_kernel=d["conv_kernel"],
                    conv_groups=d["conv_groups"], remat=config.get("training", {}).get("remat", False))
    c = config["codec"]
    return (BackboneConfig(latent_dim=config["latent_dim"], hidden_dim=config["hidden_dim"],
                           phoneme_dim=config["phoneme_dim"], vocab_size=config["vocab_size"],
                           time_embed_dim=config["time_embed_dim"], dit=dit, text=EncoderConfig(**config["text"]),
                           style=EncoderConfig(**config["style"])),
            CodecConfig(latent_dim=c["latent_dim"], strides=tuple(c["strides"]), channels=tuple(c["channels"]),
                        res_dilations=tuple(c["res_dilations"]), kernel=c["kernel"], head_kernel=c["head_kernel"]))


class Front:
    """The Batcher's `tts`: forwards each batch to the program."""

    def __init__(self, tts, bank: torch.Tensor, index_of: Dict[bytes, int]):
        self.tts, self.bank, self.index_of = tts, bank, index_of
        self.recording = False
        self.gate = None  # with --trace 1, the window's Gate
        self.batches: List[Batch] = []
        self.spans: List[tuple] = []  # (name, wall start ns, wall end ns)

    def synthesize_padded(self, ref_latents, ref_lengths, phonemes, phoneme_lengths, seq_lengths, t_bucket,
                          fetch=True):
        if self.gate is None:
            return self._call(ref_latents, ref_lengths, phonemes, phoneme_lengths, seq_lengths, t_bucket, fetch)
        with self.gate.call():
            out = self._call(ref_latents, ref_lengths, phonemes, phoneme_lengths, seq_lengths, t_bucket, fetch)
        return Gated(out, self.gate) if hasattr(out, "cpu") else out

    def _call(self, ref_latents, ref_lengths, phonemes, phoneme_lengths, seq_lengths, t_bucket, fetch):
        from smalltts_tpu_torch.ops import kernels

        w0 = time.time_ns()
        b = len(seq_lengths)
        rows = [self.index_of.get(phonemes[i, : phoneme_lengths[i]].tobytes(), -1) for i in range(b)]
        real = sum(r >= 0 for r in rows)
        slots = to_device(torch.tensor([max(r, 0) % self.bank.shape[1] for r in rows]), self.bank.device)
        noises = self.bank.index_select(1, slots)[:, :, :t_bucket]
        before = dict(kernels.LAUNCHES)
        t0, w1 = time.perf_counter(), time.time_ns()
        out = self.tts.synthesize_padded(ref_latents, ref_lengths, phonemes, phoneme_lengths, seq_lengths, t_bucket,
                                         fetch=fetch, noises=noises)
        t1, w2 = time.perf_counter(), time.time_ns()
        if self.recording:
            launches = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items() if v != before.get(k, 0)}
            self.batches.append(Batch(b, ref_latents.shape[1], phonemes.shape[1], t_bucket,
                                      np.array(ref_lengths), np.array(phoneme_lengths), np.array(seq_lengths),
                                      real, t1 - t0, t0, (w1, w2), launches))
            self.spans += [("front: noise rows", w0, w1), ("program: synthesize_padded", w1, w2)]
        return out


class Gated:
    """A batch's device answer whose copy to the host (the Batcher's fetch
    thread calls .cpu()) passes the front's gate."""

    def __init__(self, out, gate):
        self.out, self.gate = out, gate

    def cpu(self):
        with self.gate.call():
            return self.out.cpu()


KEEP_SHARE = 0.02  # answers of the window kept for the check, drawn from the seed
NOISE_BANK = 1024  # noise slots; a request's slot is its index modulo this


@dataclass
class RefOut:
    """The plain reference's answer to one request: its int16 waveform and
    its float waveform over its own samples, and its latents (the bucket's
    frames) on the device."""

    wave: np.ndarray
    audio: np.ndarray
    latents: torch.Tensor


def rel_gap(got, want) -> float:
    """Relative L2 gap of `got` to `want`, over `want`'s samples."""
    w = np.asarray(want, np.float64).reshape(-1)
    g = np.asarray(got, np.float64).reshape(-1)[: len(w)]
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))


class Inputs:
    """What the benchmark makes from the seed for a serving cell: the
    weights (on the device, in the served dtype; the codec in float32), the
    noise bank and the stream of requests."""

    def __init__(self, run: Run):
        cfg, mix, dev = run.cell.config, run.cell.traffic, run.device
        self.run, self.m = run, run.model
        self.dtype = getattr(torch, cfg["serving"]["dtype"])
        self.steps = cfg["serving"]["num_steps"]
        self.stream = T.Stream(mix, run.seed, self.m.vocab_size, self.m.latent_dim)
        gen = torch.Generator(device=dev).manual_seed(T.torch_seed(run.seed, 10))
        self.weights = ref.make_params(ref.backbone_shapes(self.m), gen, self.dtype, dev)
        self.codec = ref.make_params(ref.codec_decoder_shapes(self.m), gen, torch.float32, dev)
        self.bank = torch.randn((self.steps, NOISE_BANK, max(self.stream.t_buckets), self.m.latent_dim),
                                generator=gen, device=dev, dtype=torch.float32).to(self.dtype)

    def buckets(self):
        """The (reference, phoneme) buckets of every request of the stream."""
        from smalltts_tpu_torch.data.bucketing import SERVING_PHONEME_BUCKETS, SERVING_REF_BUCKETS, pick_bucket

        return (pick_bucket(self.stream.max_ref_frames, SERVING_REF_BUCKETS),
                pick_bucket(self.stream.max_phonemes, SERVING_PHONEME_BUCKETS))

    def noise(self, indices, t: int) -> torch.Tensor:
        slots = to_device(torch.tensor([i % NOISE_BANK for i in indices]), self.bank.device)
        return self.bank.index_select(1, slots)[:, :, :t]

    def make_program(self, **serving):
        """The program's SmallTTS on these weights, as the configuration
        states it (`serving` overrides its options)."""
        from smalltts_tpu_torch.infer.pipeline import SmallTTS

        s = {**self.run.cell.config["serving"], **serving}
        bcfg, ccfg = program_configs(self.run.cell.config)
        return SmallTTS(ref.nest(self.weights), ref.nest(self.codec), cfg=bcfg, codec_cfg=ccfg, codec="native",
                        dtype=self.dtype, pcm16_out=s["pcm16_out"], fused_block=s["fused_block"],
                        w8_stream=s["w8_stream"], w8_modulation=s["w8_modulation"], num_steps=s["num_steps"],
                        sampler=s["sampler"], device=self.run.device)

    def sample(self, kept: List[int], longest: Optional[int], n: int) -> List[int]:
        """The longest answer and n - 1 more drawn from the seed among `kept`."""
        others = sorted(k for k in kept if k != longest)
        pick = T.rng(self.run.seed, 5).permutation(others)[: max(n - 1, 0)].tolist()
        return ([longest] if longest is not None else []) + pick

    @staticmethod
    def by_t(reqs: List[T.Request]) -> Dict[int, List[T.Request]]:
        out: Dict[int, List[T.Request]] = {}
        for r in reqs:
            out.setdefault(r.t_bucket, []).append(r)
        return out

    def reference_outputs(self, reqs: List[T.Request], prec: "ref.Prec") -> Dict[int, RefOut]:
        """{index: RefOut} from the plain reference at `prec` on the same
        inputs and noise; its codec in float32, TF32 off."""
        dev, m = self.run.device, self.m
        p = ref.cast_floats(ref.nest(self.weights), prec.dtype)
        cp = ref.nest(self.codec)
        rb, pb = self.buckets()
        out = {}
        with torch.no_grad(), ref.tf32_off():
            for tb, group in self.by_t(reqs).items():
                refs = np.zeros((len(group), rb, m.latent_dim), np.float32)
                ph = np.zeros((len(group), pb), np.int64)
                for j, r in enumerate(group):
                    refs[j, : len(r.ref)] = r.ref
                    ph[j, : len(r.phonemes)] = r.phonemes
                tt = lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)  # noqa: E731
                lat = ref.sample_latents(p, m, tt(refs, prec.dtype), tt([len(r.ref) for r in group], torch.int64),
                                         tt(ph, torch.int64), tt([len(r.phonemes) for r in group], torch.int64),
                                         tt([r.seq_len for r in group], torch.int64), tb,
                                         self.noise([r.index for r in group], tb), prec, self.steps).float()
                audio = ref.codec_decode(cp, m, lat)
                wave, audio = ref.pcm16(audio).cpu().numpy(), audio.cpu().numpy()
                for j, r in enumerate(group):
                    n = r.seq_len * m.hop
                    out[r.index] = RefOut(wave[j, :n], audio[j, :n], lat[j])
        return out

    def reference_codec(self, reqs: List[T.Request], outs: Dict[int, RefOut], operand) -> Dict[int, np.ndarray]:
        """{index: float waveform} of the reference codec over the latents
        of `outs`, each operand of its convolutions passed through
        `operand` (a lower precision), TF32 off."""
        cp, out = ref.nest(self.codec), {}
        with torch.no_grad(), ref.tf32_off():
            for tb, group in self.by_t(reqs).items():
                audio = ref.codec_decode(cp, self.m, torch.stack([outs[r.index].latents for r in group]),
                                         operand).cpu().numpy()
                for j, r in enumerate(group):
                    out[r.index] = audio[j, : r.seq_len * self.m.hop]
        return out

    def program_codec(self, tts, reqs: List[T.Request], outs: Dict[int, RefOut],
                      batch_of: Dict[int, int]) -> Dict[int, np.ndarray]:
        """{index: float waveform} of the program's own codec (the served
        SmallTTS's decode) over the reference's latents of `outs`, run at
        the served bucket shapes: batch_of[t] rows of t frames, the rows
        left over zero."""
        out = {}
        with torch.inference_mode():
            for tb, group in self.by_t(reqs).items():
                b = batch_of[tb]
                for c in range(0, len(group), b):
                    chunk = group[c: c + b]
                    lat = torch.zeros((b, tb, self.m.latent_dim), dtype=torch.float32, device=self.run.device)
                    lat[: len(chunk)] = torch.stack([outs[r.index].latents for r in chunk])
                    audio = tts._decode(lat).float().reshape(b, -1).cpu().numpy()
                    for j, r in enumerate(chunk):
                        out[r.index] = audio[j, : r.seq_len * self.m.hop]
        return out


class Server(Inputs):
    """Set-up of a serving cell: its inputs, the program, the batcher and
    its warm shapes."""

    def __init__(self, run: Run):
        from smalltts_tpu_torch.ops import kernels
        from smalltts_tpu_torch.serving.batcher import Batcher, batch_ladder

        mix, dev = run.cell.traffic, run.device
        if dev.type == "cuda":
            kernels.build_all()
        super().__init__(run)
        self.tts = self.make_program()
        self.index_of: Dict[bytes, int] = {}
        self.front = Front(self.tts, self.bank, self.index_of)
        if run.trace:
            self.front.gate = Gate()
        b = mix["batcher"]
        self.batcher = Batcher(self.front, max_batch=b["max_batch"], growth_limit=b.get("growth_limit"))
        self.classes = sorted(set(batch_ladder(b["max_batch"], b.get("growth_limit"))) | {1})
        self.served: Dict[int, Served] = {}
        run.served = self.served
        self.kept: Dict[int, np.ndarray] = {}
        self.longest: Optional[int] = None
        self.lock = threading.Lock()
        self.window = None
        self.count_by_due = "rate_per_s" in mix
        self._warm()
        if run.trace and dev.type == "cuda":
            from harness.trace import warm_profiler

            warm_profiler()

    def _warm(self) -> None:
        """Run every bucket shape this mix can reach once: the batch classes
        and 1, the latent buckets its durations reach, its reference bucket
        and its phoneme bucket. On the card each is captured as its graph."""
        rb, pb = self.buckets()
        for bs in sorted(self.classes, reverse=True):
            for tb in reversed(self.stream.t_buckets):
                self.front.synthesize_padded(np.zeros((bs, rb, self.m.latent_dim), np.float32),
                                             np.full((bs,), rb, np.int32), np.zeros((bs, pb), np.int32),
                                             np.ones((bs,), np.int32), np.ones((bs,), np.int32), tb, fetch=False)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------- requests

    def submit(self, req: T.Request, due: float) -> None:
        s = Served(req, due)
        with self.lock:
            self.served[req.index] = s
            self.index_of[req.phonemes.tobytes()] = req.index
        try:
            fut = self.batcher.submit(req.ref, req.phonemes, req.duration_s)
        except Exception as exc:  # refused: counts as failed
            s.error = repr(exc)
            s.done = time.perf_counter()
            self.on_done(s)
            return
        fut.add_done_callback(lambda f: self._resolved(s, f))

    def _resolved(self, s: Served, fut) -> None:
        s.done = time.perf_counter()
        exc = fut.exception()
        if exc is not None:
            s.error = repr(exc)
        else:
            wave = fut.result()
            w = self.window
            if w is not None and self._counts(s, w):
                i = s.req.index
                with self.lock:
                    if T.rng(self.run.seed, 4, i).random() < KEEP_SHARE:
                        self.kept[i] = np.array(wave[0])
                    if self.longest is None or s.req.seq_len > self.served[self.longest].req.seq_len:
                        self.kept[i] = np.array(wave[0])
                        self.longest = i
        self.on_done(s)

    def _counts(self, s: Served, w) -> bool:
        """Whether a request is the window's: the closed loop counts what
        completes in it, the open loop what is due in it."""
        t = s.due if self.count_by_due else s.done
        return w[0] <= t < w[1]

    def on_done(self, s: Served) -> None:  # the loop's hook
        pass

    def finish(self) -> None:
        """After the window: wait for every answer due in it (a minute past the
        close at most; one that never comes has failed), read the memory peak,
        stop the batcher and check the sample against the reference."""
        run = self.run
        deadline = run.window[1] + 60.0
        while time.perf_counter() < deadline and any(s.done is None for s in run.requests):
            time.sleep(0.01)
        run.attempted = len(run.requests)
        run.failed = sum(1 for s in run.requests if s.error is not None or s.done is None)
        for s in run.requests:
            if s.error is not None:
                run.note(f"request {s.req.index} failed: {s.error}")
                break
        if run.device.type == "cuda":
            torch.cuda.synchronize()
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
        if run.profile is not None:
            run.traced = traced_batches(run)
        self.batcher.close()
        self.batcher = None
        self.check(run.cell.config["check"]["requests"])

    # --------------------------------------------------------------- check

    def free_program(self) -> None:
        self.tts = self.front.tts = None
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, n: int) -> None:
        """Hold a sample of the window's answers to the plain reference: the
        longest answer and n - 1 more drawn from the seed among the kept
        ones. Two numbers are compared, each the widest relative L2 gap over
        the sample:
        - wave_gap_bf16: the served int16 waveform against the reference's
          from the same inputs and noise, the reference in bf16 at the
          served model's rounding points (its products and norms in
          float32, TF32 off) and its codec in float32;
        - codec_gap: the served SmallTTS's own codec, run at the window's
          bucket shapes over the reference's latents, against the
          reference's float32 codec over the same latents. The served graph
          does not give out its latents, so this is the codec alone: bf16's
          rounding in the denoiser hides a codec one precision down in the
          first number.
        The gap to the float32 reference is printed beside them."""
        run = self.run
        limits = run.cell.config["check"]
        sample = self.sample(list(self.kept), self.longest, n)
        if not sample:
            run.note("check: no answer of the window to compare")
            for k in ("wave_gap_bf16", "codec_gap"):
                run.checks[k] = (math.inf, limits[k])
            self.free_program()
            return
        reqs = [self.stream[i] for i in sample]
        bf = self.reference_outputs(reqs, ref.Prec(torch.bfloat16))
        batch_of = {tb: max((b.b for b in run.batches if b.t == tb), default=max(self.classes))
                    for tb in self.stream.t_buckets}
        codec = self.program_codec(self.tts, reqs, bf, batch_of)
        self.free_program()
        run.checks["wave_gap_bf16"] = (max(rel_gap(self.kept[i], bf[i].wave) for i in sample),
                                       limits["wave_gap_bf16"])
        run.checks["codec_gap"] = (max(rel_gap(codec[i], bf[i].audio) for i in sample), limits["codec_gap"])
        fp32 = self.reference_outputs(reqs, ref.Prec(torch.float32))
        run.note(f"check: {len(sample)} answers held to the reference, the longest {reqs[0].seq_len} frames; "
                 f"the codec at batch {batch_of}; beside the compared bf16 reference, the float32 reference's "
                 f"widest gap is {max(rel_gap(self.kept[i], fp32[i].wave) for i in sample)!r} "
                 "(not compared: an fp8 control reads only 3x that)")


def completed_in_window(run: Run) -> List[Served]:
    """Every answer that reached the host inside the window."""
    if not run.window:
        return []
    w0, w1 = run.window
    return [s for s in run.served.values() if s.error is None and s.done is not None and w0 <= s.done < w1]


def latencies(run: Run) -> List[float]:
    """Each request due in the window: from its due time to its waveform on
    the host; a failed or missing one as inf."""
    return [math.inf if (s.error or s.done is None) else s.done - s.due for s in run.requests]


def latency_percentile(run: Run, p: float) -> Optional[float]:
    lat = latencies(run)
    if not lat:
        return None
    v = percentile(lat, p)
    return v * 1e3 if math.isfinite(v) else run.seconds * 1e3 + 60e3


def padding_share(run: Run) -> Optional[float]:
    req = sum(b.requested_frames for b in run.batches)
    pad = sum(b.padded_frames for b in run.batches)
    return 100.0 * (1.0 - req / pad) if pad else None



def traced_batches(run: Run):
    """[(batch, {class: records})] of the traced slice's batches whose every
    hand-written and codec-convolution launch the trace kept. Each graph
    replay is matched to the front's call that launched it by the wall
    clock; the records kept are checked against the program's launch
    counters of that call, and the codec's against its 27 convolutions."""
    import bisect
    import statistics

    from harness.trace import COUNTERS, kernel_class

    prof = run.profile
    if prof is None or not prof.graph_launches:
        return []
    launches = sorted(prof.graph_launches, key=lambda x: x[1])
    batches = sorted(run.batches, key=lambda b: b.wall[0])
    starts = [b.wall[0] for b in batches]

    def contained(off):
        out = {}
        for corr, ns in launches:
            i = bisect.bisect_right(starts, ns - off) - 1
            if i >= 0 and ns - off <= batches[i].wall[1] + 200_000:
                out[corr] = batches[i]
        return out

    off, matched = 0, contained(0)
    if len(matched) < 0.9 * min(len(launches), len(batches)):
        best = None
        for shift in range(-8, 9):
            d = [launches[i][1] - batches[i + shift].wall[0] for i in range(len(launches))
                 if 0 <= i + shift < len(batches)]
            if len(d) >= 3:
                med = statistics.median(d)
                mad = statistics.median(abs(x - med) for x in d)
                if best is None or mad < best[0]:
                    best = (mad, med)
        if best is not None:
            off = int(best[1])
            matched = contained(off)
    prof.offset = off
    by_corr = prof.records_by_launch()
    n_conv = len(F.codec_convs(run.model, 1))
    out, kept, want = [], {}, {}
    for corr, b in matched.items():
        cls = {}
        for r in by_corr.get(corr, []):
            c = kernel_class(r.name)
            if c:
                cls.setdefault(c, []).append(r)
        expect = {c: sum(b.launches.get(k, 0) for k in keys) for c, keys in COUNTERS.items()}
        expect["codec_conv"] = n_conv
        for c, n in expect.items():
            kept[c] = kept.get(c, 0) + len(cls.get(c, []))
            want[c] = want.get(c, 0) + n
        if all(len(cls.get(c, [])) == n for c, n in expect.items()):
            out.append((b, cls))
    run.note(f"trace: {len(launches)} graph replays, {len(matched)} matched to the front's calls "
             f"(clock offset {off} ns), {len(out)} with every launch kept; records kept of launched: "
             + ", ".join(f"{c} {kept[c]} of {want[c]}" for c in sorted(want)))
    return out


def class_seconds(batches, cls: str) -> float:
    return sum(r.end - r.start for _, c in batches for r in c.get(cls, [])) / 1e9


def class_bound_seconds(run: Run, batches, cls: str) -> float:
    total = 0.0
    for b, _ in batches:
        launches = F.batch_launches(run.model, b.b, b.r, b.p, b.t, b.ref_lens, b.ph_lens, b.seq_lens,
                                    run.cell.config["serving"]["num_steps"])
        total += sum(F.bound_s(f, n) for f, n in launches[cls])
    return total


def roofline(run: Run, cls: str) -> Optional[float]:
    batches = run.traced
    t = class_seconds(batches, cls)
    return 100.0 * class_bound_seconds(run, batches, cls) / t if t > 0 else None


def ms_per_padded_audio_s(run: Run, cls: str) -> Optional[float]:
    batches = run.traced
    audio = sum(b.b * b.t for b, _ in batches) / T.FRAMES_PER_S
    return class_seconds(batches, cls) * 1e3 / audio if audio else None


def idle_share(run: Run) -> Optional[float]:
    prof = run.profile
    if prof is None:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)

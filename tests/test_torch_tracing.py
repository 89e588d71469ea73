"""The program's spans (smalltts_tpu_torch/utils/profiling.py) on the CPU:

- with no profiler running nothing is kept, and a site costs one flag read;
- under a CPU torch.profiler, a thread started before it records (the flag
  read is torch's process-wide one, not the per-thread check), and no
  record_function range is opened outside `trace()`;
- parent ids nest within a thread;
- the bounded store drops its oldest spans and counts them;
- a Batcher over a fake tts: every request's batcher.queue, dispatch,
  inflight, fetch and resolve meet end to end, under one request id and one
  group id, with the group's padded and requested frames counted;
- SmallTTS.synthesize_padded on the CPU: pipeline.call over pipeline.inputs
  and pipeline.eager;
- a tiny teacher step: teacher.step over forward, backward and update, the
  update over guard, optimizer and ema;
- `trace()`'s Chrome trace holds each span as a named range.
"""

import contextlib
import json
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smalltts_tpu_torch.utils import profiling


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def since(t0, prefix=""):
    return [s for s in profiling.spans() if s.start >= t0 and s.name.startswith(prefix)]


def by_id(spans):
    return {s.id: s for s in spans}


def test_nothing_is_kept_without_a_profiler():
    t0 = time.time_ns()
    with profiling.annotate("test.off", k=1) as sp:
        sp.set(more=2)
        profiling.record("test.off_record", t0, time.time_ns())
    assert not sp.recording and sp.start is None and sp.end is None
    assert since(t0, "test.") == []


def test_a_thread_started_before_the_profiler_records():
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(10)
        with profiling.annotate("test.thread", who="worker"):
            pass
        done.set()

    th = threading.Thread(target=work)
    th.start()
    t0 = time.time_ns()
    with cpu_profile() as prof:
        go.set()
        assert done.wait(10)
    th.join(10)
    assert not th.is_alive()
    got = since(t0, "test.thread")
    assert len(got) == 1 and got[0].attrs == {"who": "worker"} and got[0].thread == th.native_id
    assert t0 <= got[0].start <= got[0].end <= time.time_ns()
    # outside trace() a span opens no record_function range
    assert "test.thread" not in {e.key for e in prof.key_averages()}


def test_parent_ids_nest_and_stamps_are_ordered():
    t0 = time.time_ns()
    with cpu_profile():
        with profiling.annotate("test.outer") as outer:
            with profiling.annotate("test.mid"):
                with profiling.annotate("test.inner"):
                    pass
            with profiling.annotate("test.after", start=outer.start):
                pass
    got = {s.name: s for s in since(t0, "test.")}
    assert got["test.outer"].parent is None
    assert got["test.mid"].parent == got["test.outer"].id
    assert got["test.inner"].parent == got["test.mid"].id
    assert got["test.after"].parent == got["test.outer"].id
    assert got["test.after"].start == got["test.outer"].start  # a given start stamp is kept
    o, m, i = got["test.outer"], got["test.mid"], got["test.inner"]
    assert o.start <= m.start <= i.start <= i.end <= m.end <= o.end


def test_the_bound_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", deque(maxlen=4))
    monkeypatch.setattr(profiling, "_dropped", 0)
    with cpu_profile():
        for i in range(6):
            profiling.record("test.bound", i + 1, i + 2, i=i)
    assert [s.attrs["i"] for s in profiling.spans()] == [2, 3, 4, 5]
    assert profiling.dropped() == 2


class FakeTTS:
    """synthesize_padded as the pipeline's fetch=False gives it: a tensor."""

    def synthesize_padded(self, ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, fetch=True):
        from smalltts_tpu_torch.data.bucketing import HOP_SIZE

        time.sleep(0.002)
        return torch.zeros((len(seq_lens), 1, t_bucket * HOP_SIZE))


def test_batcher_requests_chain_five_spans_with_no_gap():
    from smalltts_tpu_torch.serving.batcher import Batcher

    batcher = Batcher(FakeTTS(), max_batch=4)  # its threads start before the profiler
    durations = [1.0, 1.5, 2.0, 6.0, 1.2, 7.5, 2.2]
    try:
        t0 = time.time_ns()
        with cpu_profile():
            futs = [batcher.submit(np.zeros((10, 64), np.float32), [1, 2, 3], d) for d in durations]
            for f in futs:
                f.result(timeout=30)
            deadline = time.time() + 10  # the resolve span ends just after the last future is set
            while len(since(t0, "batcher.resolve")) < len(since(t0, "batcher.dispatch")) and time.time() < deadline:
                time.sleep(0.01)
    finally:
        batcher.close()
    spans = since(t0, "batcher.")
    ids = by_id(spans)
    groups = {}
    for s in spans:
        if s.name != "batcher.queue":
            groups.setdefault(s.attrs["group"], {})[s.name] = s
    queues = [s for s in spans if s.name == "batcher.queue"]
    assert len(queues) == len(durations) and len({q.attrs["request"] for q in queues}) == len(durations)
    requested = padded = 0
    for q in queues:
        g = groups[q.attrs["group"]]
        assert set(g) == {"batcher.dispatch", "batcher.pad", "batcher.synthesize", "batcher.inflight",
                          "batcher.fetch", "batcher.resolve"}
        assert q.attrs["request"] in g["batcher.dispatch"].attrs["requests"]
        chain = [q] + [g[n] for n in ("batcher.dispatch", "batcher.inflight", "batcher.fetch", "batcher.resolve")]
        for a, b in zip(chain, chain[1:]):
            assert a.end == b.start, (a.name, b.name)
        assert all(s.start <= s.end for s in chain)
        for child in ("batcher.pad", "batcher.synthesize"):
            assert ids[g[child].parent] is g["batcher.dispatch"]
    for g in groups.values():
        requested += g["batcher.pad"].attrs["requested_frames"]
        padded += g["batcher.pad"].attrs["padded_frames"]
    assert 0 < requested < padded


def test_pipeline_call_spans_its_host_stages_on_the_cpu():
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.models.backbone import BackboneConfig
    from smalltts_tpu_torch.models.codec import CodecConfig
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig

    enc = EncoderConfig(model_size=32, num_layers=1, num_heads=2, intermediate_size=64, norm_eps=1e-6)
    cfg = BackboneConfig(latent_dim=64, hidden_dim=64, phoneme_dim=32, text=enc, style=enc,
                         dit=DiTConfig(latent_dim=64, phoneme_dim=32, hidden_dim=64, n_blocks=1, heads=4,
                                       rot_dim=8, conv_groups=16))
    tts = SmallTTS(cfg=cfg, codec_cfg=CodecConfig(latent_dim=64, channels=(16, 16, 16, 8, 8, 4)), device="cpu",
                   num_steps=1)
    args = (np.zeros((2, 8, 64), np.float32), np.array([8, 4], np.int32), np.ones((2, 16), np.int32),
            np.array([16, 9], np.int32), np.array([16, 10], np.int32), 16)
    t0 = time.time_ns()
    with cpu_profile():
        audio = tts.synthesize_padded(*args, fetch=False)
    assert audio.shape[0] == 2
    spans = since(t0, "pipeline.")
    call = [s for s in spans if s.name == "pipeline.call"]
    assert len(call) == 1 and call[0].attrs == {"batch": 2, "t": 16}
    children = sorted((s.start, s.name) for s in spans if s.parent == call[0].id)
    assert [n for _, n in children] == ["pipeline.inputs", "pipeline.eager"]


def test_teacher_step_spans_its_phases():
    from smalltts_tpu_torch.models.backbone import BackboneConfig, init_backbone
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig
    from smalltts_tpu_torch.train.ema import ema_init
    from smalltts_tpu_torch.train.optim import teacher_optimizer
    from smalltts_tpu_torch.train.teacher import make_teacher_step, teacher_draws

    enc = EncoderConfig(model_size=32, num_layers=1, num_heads=2, intermediate_size=64, norm_eps=1e-6)
    cfg = BackboneConfig(latent_dim=64, hidden_dim=64, phoneme_dim=32, text=enc, style=enc,
                         dit=DiTConfig(latent_dim=64, phoneme_dim=32, hidden_dim=64, n_blocks=1, heads=4,
                                       rot_dim=8, conv_groups=16))
    g = torch.Generator().manual_seed(0)
    params = init_backbone(g, cfg)
    tx, _ = teacher_optimizer(params, 10, 2)
    batch = {"phonemes": torch.randint(1, 50, (2, 12), generator=g), "phonemes_lengths": torch.tensor([12, 7]),
             "latents": torch.randn((2, 16, 64), generator=g), "latents_lengths": torch.tensor([16, 11]),
             "ref_latents": torch.randn((2, 8, 64), generator=g), "ref_latents_lengths": torch.tensor([8, 5])}
    step = make_teacher_step(cfg, tx)
    t0 = time.time_ns()
    with cpu_profile():
        out = step(params, tx.init(params), ema_init(params), batch, teacher_draws(g, batch))
    assert torch.isfinite(out[3])
    spans = since(t0, "teacher.")
    named = {s.name: s for s in spans}
    assert len(named) == len(spans) == 7
    kids = lambda s: sorted((c.start, c.name) for c in spans if c.parent == s.id)  # noqa: E731
    assert [n for _, n in kids(named["teacher.step"])] == ["teacher.forward", "teacher.backward", "teacher.update"]
    assert [n for _, n in kids(named["teacher.update"])] == ["teacher.guard", "teacher.optimizer", "teacher.ema"]
    assert named["teacher.step"].parent is None


def test_trace_writes_each_span_as_a_named_range(tmp_path):
    t0 = time.time_ns()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("test.chrome_range"):
            torch.randn(16, 8) @ torch.randn(8, 4)
    with open(prof.trace_file) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test.chrome_range" in names
    assert [s.name for s in since(t0, "test.chrome")] == ["test.chrome_range"]
    assert not profiling._ranges


@pytest.mark.parametrize("on", [False, True])
def test_a_span_leaves_no_state_behind(on):
    """The thread's stack of open spans is empty after a block that raised."""
    ctx = cpu_profile() if on else contextlib.nullcontext()
    with ctx:
        with pytest.raises(ValueError):
            with profiling.annotate("test.raises"):
                raise ValueError("inside")
    assert profiling._stack() == []

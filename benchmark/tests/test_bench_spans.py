"""The readers of the metrics that read the program's own spans
(harness/spans.py, benchmark/metrics/*), on synthetic spans and device
records: each of the four against numbers worked by hand, and none of
them reading anything where the program dropped spans, keeps none (a
program older than its spans) or the run was not traced."""

from types import SimpleNamespace

import pytest

from harness import core
from harness.trace import Profile, Record
from smalltts_tpu_torch.utils import profiling
from smalltts_tpu_torch.utils.profiling import Span

SLICE = (1_000, 2_000)  # ns, the traced slice on the wall clock


def span(name, start, end, id=0, parent=None):
    return Span(name, SLICE[0] + start, SLICE[0] + end, 1, id, parent, {})


# serving: the device busy at [100, 300) and [500, 700) of the slice, so idle
# at [0, 100), [300, 500) and [700, 1000): 600 ns
SERVE = [
    span("pipeline.call", -100, 150, id=1),  # began before the slice, ends in it: kept, clipped to the slice
    span("pipeline.replay", 100, 140, id=2, parent=1),  # the device busy through it
    span("pipeline.call", 250, 600, id=3),
    span("pipeline.replay", 320, 380, id=4, parent=3),
    span("pipeline.call", 680, 1200, id=5),  # ends after the slice: left out, and its replay with it
    span("pipeline.replay", 700, 990, id=6, parent=5),
]
TRAIN = [
    span("teacher.step", 0, 500), span("teacher.forward", 10, 200), span("teacher.backward", 200, 400),
    span("teacher.update", 400, 490),
    span("teacher.step", 500, 990), span("teacher.forward", 510, 700), span("teacher.backward", 700, 880),
    span("teacher.update", 880, 980),
]
EXPECT = {
    "idle_in_pipeline_share.offline": 100.0 * (100 + 200 - 60) / 600,  # [0, 100), [300, 500) less [320, 380)
    "forward_host_ms.train": (190 + 190) / 2 / 1e6,
    "backward_host_ms.train": (200 + 180) / 2 / 1e6,
    "update_host_ms.train": (90 + 100) / 2 / 1e6,
}


def fake_run():
    prof = Profile(records=[Record("k", SLICE[0] + 100, SLICE[0] + 300, 1),
                            Record("k", SLICE[0] + 500, SLICE[0] + 700, 2)], wall=SLICE)
    prof.offset = 123_456  # a fitted offset is not applied to the program's spans
    return SimpleNamespace(profile=prof)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SERVE + TRAIN))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    return monkeypatch


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_each_reader_against_worked_numbers(program, name):
    assert core.metric_reader(name)(fake_run()) == pytest.approx(EXPECT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_no_reading_where_spans_were_dropped(program, name):
    program.setattr(profiling, "dropped", lambda: 1)
    assert core.metric_reader(name)(fake_run()) is None


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_no_reading_from_a_program_without_spans_or_an_untraced_run(monkeypatch, name):
    assert core.metric_reader(name)(SimpleNamespace(profile=None)) is None
    monkeypatch.delattr(profiling, "spans")
    assert core.metric_reader(name)(fake_run()) is None


def test_the_four_are_declared_for_their_cells():
    bench = core.load_benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    cells = {"offline": "serve-offline-mixed", "train": "train-teacher-b96"}
    for name in EXPECT:
        assert declared[name]["workloads"] == [cells[name.rsplit(".", 1)[1]]]
        assert declared[name]["source"] in ("program_span", "device_trace")


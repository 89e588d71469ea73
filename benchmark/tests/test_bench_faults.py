"""Whole runs of tiny cells on the CPU, past the look for a card: a sound
run comes out correct, and each fault a cell can have, planted in the
program's timed path, makes `correct` come out false."""

import time

import pytest
import torch

import run as R
from tiny import tiny_cell

CPU = torch.device("cpu")


def _execute(cell, seed=2**31 + 5, seconds=3.0):
    return R.execute(cell, seed, seconds, False, CPU, time.perf_counter())


def _serving(name):
    return tiny_cell(name)


@pytest.fixture
def serving_cell(monkeypatch):
    from harness import serve

    monkeypatch.setattr(serve, "KEEP_SHARE", 1.0)
    cell = _serving("serve-offline-mixed")
    cell.config["check"]["requests"] = 12
    return cell


def _patch_synthesize(monkeypatch, fault):
    from smalltts_tpu_torch.infer.pipeline import SmallTTS

    orig = SmallTTS.synthesize_padded

    def broken(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        return fault(out, len(args[4]))

    monkeypatch.setattr(SmallTTS, "synthesize_padded", broken)


@pytest.mark.parametrize("name", ["serve-offline-mixed", "serve-poisson-short"])
def test_sound_serving_runs_are_correct(name):
    res = _execute(_serving(name))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"wave_gap_bf16", "codec_gap"}


def test_half_of_each_batch_left_out_is_not_correct(serving_cell, monkeypatch):
    def fault(out, b):
        out = out.clone()
        out[b // 2:] = 0
        return out

    _patch_synthesize(monkeypatch, fault)
    res = _execute(serving_cell)
    assert not res["correct"]
    assert res["checks"]["wave_gap_bf16"]["value"] > res["checks"]["wave_gap_bf16"]["limit"]


def test_answers_altered_where_they_are_produced_are_not_correct(serving_cell, monkeypatch):
    def fault(out, b):  # each row gets its neighbour's answer; a lone row its own, reversed in time
        return torch.roll(out, 1, dims=0) if b > 1 else torch.flip(out, dims=[-1])

    _patch_synthesize(monkeypatch, fault)
    res = _execute(serving_cell)
    assert not res["correct"]


def test_a_codec_one_precision_down_is_not_correct(serving_cell, monkeypatch):
    """The codec's weights rounded to TF32 where the served model decodes:
    the denoiser's bf16 rounding hides it from the waveform's gap, the
    codec's own gap catches it."""
    import smalltts_tpu_torch.infer.pipeline as pipeline
    import smalltts_tpu_torch.infer.sampler as sampler
    from reference.model import tf32_round

    orig = sampler.codec_decode

    def rounded(tree):
        return {k: rounded(v) for k, v in tree.items()} if isinstance(tree, dict) else \
            [rounded(v) for v in tree] if isinstance(tree, list) else tf32_round(tree)

    def decode(p, latents, cfg):
        return orig(rounded(p), latents, cfg)

    monkeypatch.setattr(sampler, "codec_decode", decode)
    monkeypatch.setattr(pipeline, "codec_decode", decode)
    res = _execute(serving_cell)
    assert not res["correct"]
    assert res["checks"]["codec_gap"]["value"] > res["checks"]["codec_gap"]["limit"]


def _patch_step(monkeypatch, wrap):
    import smalltts_tpu_torch.train.teacher as teacher

    orig = teacher.make_teacher_step

    def make(*args, **kwargs):
        return wrap(orig(*args, **kwargs))

    monkeypatch.setattr(teacher, "make_teacher_step", make)


def test_sound_training_run_is_correct():
    res = _execute(tiny_cell("train-teacher-b96"))
    assert res["correct"] and res["attempted"] > 0
    assert set(res["checks"]) == {"grad_gap", "change_gap", "ema_change_gap"}


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    def wrap(step):
        def unchanged(params, opt, ema, batch, draws, decay=None):
            _, _, _, loss = step(params, opt, ema, batch, draws, decay)
            return params, opt, ema, loss

        return unchanged

    _patch_step(monkeypatch, wrap)
    res = _execute(tiny_cell("train-teacher-b96"))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    def wrap(step):
        def half(params, opt, ema, batch, draws, decay=None):
            h = batch["latents"].shape[0] // 2
            return step(params, opt, ema, {k: v[:h] for k, v in batch.items()}, {k: v[:h] for k, v in draws.items()},
                        decay)

        return half

    _patch_step(monkeypatch, wrap)
    res = _execute(tiny_cell("train-teacher-b96"))
    assert not res["correct"]


def test_an_ema_that_copies_the_params_is_not_correct(monkeypatch):
    def wrap(step):
        def copies(params, opt, ema, batch, draws, decay=None):
            params, opt, _, loss = step(params, opt, ema, batch, draws, decay)
            return params, opt, params, loss

        return copies

    _patch_step(monkeypatch, wrap)
    res = _execute(tiny_cell("train-teacher-b96"))
    assert not res["correct"]
    assert res["checks"]["ema_change_gap"]["value"] > res["checks"]["ema_change_gap"]["limit"]


def test_the_control_is_not_correct():
    """The plain reference in the program's place, its products in fp8:
    it fails one of each cell's compared numbers, which sound runs pass."""
    import controls
    from tiny import TINY_SERVE_LIMITS, TINY_TRAIN_LIMITS

    for name, n in (("serve-offline-mixed", 4), ("serve-poisson-short", 12)):  # more rows of a bucket than a batch
        serve = controls.serve_readings(_serving(name), 11, CPU, n)
        assert serve["control_fp8"]["wave_gap_bf16"] > TINY_SERVE_LIMITS["wave_gap_bf16"]
        assert serve["control_tf32"]["codec_gap"] > TINY_SERVE_LIMITS["codec_gap"]
        assert all(serve["program"][k] <= lim for k, lim in TINY_SERVE_LIMITS.items())
    train = controls.train_readings(tiny_cell("train-teacher-b96"), 11, CPU)
    for label in ("control_fp8", "fault_half_batch", "fault_ema_copies"):
        assert any(train[label][k] > lim for k, lim in TINY_TRAIN_LIMITS.items()), label

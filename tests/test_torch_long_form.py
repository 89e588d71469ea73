"""The port's long-form synthesis (smalltts_tpu_torch/infer/long_form.py)
against the JAX package's: sentence splitting, the streaming head split,
the crossfades, and whole chunked runs through one deterministic stub
pipeline. Host code only: results must be equal (the crossfades are the
same numpy float32 arithmetic)."""

import numpy as np
import pytest

from smalltts_tpu.infer import long_form as J
from smalltts_tpu.text import phonemize as j_phonemize
from smalltts_tpu_torch.infer import long_form as P
from smalltts_tpu_torch.text import phonemize

TEXTS = [
    "One. Two! Three? " + "word " * 200 + ". Done.",
    "Short lead-in. " + "gigantic " * 40 + ". Tail.",
    "Hello [laughter]. Bye [sigh].",
    "x" * 700 + " and then a normal sentence. Finally, the end…",
    "Well, I suppose so; but then again: maybe not, who knows what tomorrow holds for us all?",
    "[cough] [laughter] Right. ",
    "",
]


@pytest.fixture(autouse=True)
def chars():
    phonemize.set_backend("chars")
    j_phonemize.set_backend("chars")


@pytest.mark.parametrize("max_chars", [50, 80, 330])
@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_split_sentences_equal_jax(i, max_chars):
    assert P.split_sentences(TEXTS[i], max_chars) == J.split_sentences(TEXTS[i], max_chars)


@pytest.mark.parametrize("head_chars", [8, 24])
@pytest.mark.parametrize("sentence", ["Hello there, this is a longer first sentence of the text.",
                                      "Tiny.", "[laughter] and then someone said something, quietly",
                                      "unbrokenwordthatislongerthanthehead and more"])
def test_head_split_equal_jax(sentence, head_chars):
    assert P.head_split(sentence, head_chars) == J.head_split(sentence, head_chars)


def test_crossfades_equal_jax():
    rs = np.random.RandomState(0)
    parts = [rs.randn(1, n).astype(np.float32) for n in (2400, 100, 7000, 0, 480, 3)]
    parts.append((32767 * np.clip(rs.randn(1, 900), -1, 1)).astype(np.int16))
    for fade_ms in (0.0, 5.0, 20.0):
        assert np.array_equal(P.crossfade_concat(parts, fade_ms), J.crossfade_concat(parts, fade_ms))
        fade = int(24_000 * fade_ms / 1e3)
        pend_p = pend_j = None
        for part in parts:
            cur = P.as_float_waveform(part)
            assert np.array_equal(cur, J.as_float_waveform(part))
            (ep, pend_p), (ej, pend_j) = (P.crossfade_stream_step(pend_p, cur, fade),
                                          J.crossfade_stream_step(pend_j, cur, fade))
            assert (ep is None) == (ej is None) and (ep is None or np.array_equal(ep, ej))
            assert np.array_equal(pend_p, pend_j)


class StubTTS:
    """synthesize(ref, ids, duration) -> a (1, T) waveform that depends on
    the ids and the duration only, T = duration x 24 kHz."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def synthesize(self, ref_latents, ids, duration):
        n = int(duration * 24_000)
        wave = np.sin(np.arange(n, dtype=np.float32) * (1 + sum(ids) % 97) * 1e-3)[None] * 0.5
        return (wave * 32767).astype(np.int16) if self.dtype == np.int16 else wave.astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("i", [0, 1, 2, 4])
def test_stream_and_long_through_a_stub_equal_jax(i, dtype):
    tts, ref = StubTTS(dtype), np.zeros((16, 64), np.float32)
    got = list(P.stream_synthesize_long(tts, ref, TEXTS[i]))
    want = list(J.stream_synthesize_long(tts, ref, TEXTS[i]))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(P.synthesize_long(tts, ref, TEXTS[i]), J.synthesize_long(tts, ref, TEXTS[i]))

"""The port's text frontend (smalltts_tpu_torch/text) against the JAX
package's on the same text: number spelling, normalization, token ids with
the `chars` backend and with the espeak ctypes backend (driven through
tests/fake_espeak.c, built with cc as tests/test_espeak_ffi.py builds it),
and merge_transcript. Host code only: the ids must be equal."""

import json
import os
import subprocess

import pytest

from smalltts_tpu.text import merge_transcript as j_merge_transcript
from smalltts_tpu.text import normalizer as j_normalizer
from smalltts_tpu.text import numbers as j_numbers
from smalltts_tpu.text import phonemize as j_phonemize
from smalltts_tpu_torch.text import merge_transcript
from smalltts_tpu_torch.text import normalizer, numbers, phonemize

HERE = os.path.dirname(__file__)
SENTENCES = json.load(open(os.path.join(HERE, "fixtures", "golden_sentences.json"), encoding="utf-8"))
EXTRA = ["It costs $3.50 on 12/25, not 1,000,000 yen.", "Dr. Smith lives at 221B Baker St.",
         "Go [laughter] now, [cough] okay?", "naïve café — 3rd of 4", ""]


@pytest.fixture
def chars():
    phonemize.set_backend("chars")
    j_phonemize.set_backend("chars")
    yield
    phonemize.set_backend("chars")
    j_phonemize.set_backend("chars")


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fake_espeak") / "libespeak-ng.so")
    try:
        subprocess.run([os.environ.get("CC", "cc"), "-shared", "-fPIC", "-O1", "-o", path,
                        os.path.join(HERE, "fake_espeak.c")], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as exc:
        pytest.skip(f"no C compiler for the fake espeak stub: {exc}")
    return path


@pytest.mark.parametrize("i", range(len(SENTENCES)))
def test_token_ids_chars_backend_equal_jax(chars, i):
    text = SENTENCES[i]
    assert phonemize.backend_name() == j_phonemize.backend_name() == "chars"
    assert normalizer.EnglishTextNormalizer().normalize(text) == j_normalizer.EnglishTextNormalizer().normalize(text)
    assert phonemize.get_token_ids(text) == j_phonemize.get_token_ids(text)


@pytest.mark.parametrize("text", EXTRA)
def test_normalize_and_token_ids_of_numbers_and_events(chars, text):
    assert normalizer.EnglishTextNormalizer().normalize(text) == j_normalizer.EnglishTextNormalizer().normalize(text)
    assert phonemize.get_token_ids(text) == j_phonemize.get_token_ids(text)


def test_numbers_spell_as_jax():
    for n in [0, 7, 13, 21, 100, 101, 999, 1000, 1001, 123456, 10 ** 9 + 7, 10 ** 18, -42]:
        assert numbers.number_to_words(n) == j_numbers.number_to_words(n), n


def test_token_ids_espeak_backend_equal_jax(fake_lib, monkeypatch):
    monkeypatch.setenv("PHONEMIZER_ESPEAK_LIBRARY", fake_lib)
    phonemize.set_backend("espeak")
    j_phonemize.set_backend("espeak")
    try:
        assert phonemize.backend_name() == j_phonemize.backend_name() == "espeak"
        for text in SENTENCES + EXTRA:
            got, want = phonemize.get_token_ids(text), j_phonemize.get_token_ids(text)
            assert got == want, text
        assert phonemize.get_token_ids("Go [laughter] now")  # the stub's "P" prefix tokens and the event
    finally:
        phonemize.set_backend("chars")
        j_phonemize.set_backend("chars")


def test_merge_transcript_equal_jax():
    words = [{"start": 0.5, "word": "hello"}, {"start": 1.5, "word": "there"}, {"start": None, "word": "x"},
             {"start": 2.0, "word": ""}]
    events = [{"start": 1.0, "label": "Laughter", "prob": 0.9}, {"start": 0.1, "label": "cough", "prob": 0.05},
              {"start": 3.0, "label": "not-an-event", "prob": 1.0}, {"start": 2.5, "label": "Cough", "prob": 0.5}]
    assert merge_transcript(words, events) == j_merge_transcript(words, events)

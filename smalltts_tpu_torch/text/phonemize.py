"""Text -> phoneme token ids.

Capability parity with the reference tokenizer (reference:
src/smalltts/data/phonemization/phonemes.py:57-117): bracketed `[event]`
tokens are split out and repeated NV_REPEAT=4 times; plain spans are
normalized then phonemized (espeak en-us, IPA with stress, punctuation
preserved); resulting characters map through the fixed vocab.

Serving improvement: espeak-ng is bound IN-PROCESS via ctypes
(no per-request `uv run python` subprocess like the reference Rust server,
src/server/src/phonemize.rs:8-14). When libespeak-ng is not installed, a
deterministic character backend keeps the whole pipeline hermetic (the vocab
deliberately contains all ASCII letters, so raw text remains tokenizable);
select backends explicitly with `set_backend("espeak"|"chars")`.

The PyTorch port's own copy of smalltts_tpu/text/phonemize.py, with its imports
pointing at smalltts_tpu_torch; it behaves as that module does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import re
import threading
from typing import List, Optional

from smalltts_tpu_torch.text.normalizer import EnglishTextNormalizer
from smalltts_tpu_torch.text.vocab import NV_REPEAT, SED_LABELS, get_sed_event_id, p2idx

_tok = re.compile(r"\w+|[^\w\s]")
_bracket_re = re.compile(r"\[(\w+)\]")
_punct_split_re = re.compile(r"([;:,.!?¡¿—…\"«»“”])")

normalizer = EnglishTextNormalizer()


class EspeakBackend:
    """In-process espeak-ng via ctypes (espeak_TextToPhonemes, IPA + stress)."""

    _AUDIO_OUTPUT_SYNCHRONOUS = 0x02
    _espeakCHARS_UTF8 = 1
    _espeakPHONEMES_IPA = 0x02

    def __init__(self, language: str = "en-us") -> None:
        path = (
            os.environ.get("PHONEMIZER_ESPEAK_LIBRARY")
            or ctypes.util.find_library("espeak-ng")
            or ctypes.util.find_library("espeak")
        )
        if not path:
            raise RuntimeError("libespeak-ng not found")
        if "/" in path and not os.path.exists(path):
            raise RuntimeError(f"espeak library path {path!r} does not exist")
        self._lib = ctypes.cdll.LoadLibrary(path)
        # NB: espeak keeps GLOBAL C state, so calls are serialized on the
        # MODULE-level _backend_lock (shared across instances): an instance
        # lock let set_backend("espeak") re-run espeak_Initialize under a
        # different lock while an older instance was mid-TextToPhonemes —
        # garbage phonemes or a segfault. Construction itself
        # runs under _backend_lock (set_backend/_get_backend hold it).
        rate = self._lib.espeak_Initialize(self._AUDIO_OUTPUT_SYNCHRONOUS, 0, None, 0)
        if rate <= 0:
            raise RuntimeError("espeak_Initialize failed")
        if self._lib.espeak_SetVoiceByName(language.encode()) != 0:
            raise RuntimeError(f"espeak voice {language!r} unavailable")
        self._lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        self._lib.espeak_TextToPhonemes.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int,
            ctypes.c_int,
        ]

    def _phonemize_span(self, text: str) -> str:
        out: List[str] = []
        data = ctypes.c_char_p(text.encode("utf-8"))
        ptr = ctypes.c_void_p(ctypes.cast(data, ctypes.c_void_p).value)
        # IPA with NO phoneme separator (high byte 0): phones concatenate
        # within a word, words stay space-separated — the phonemizer
        # library's output shape the reference trained on (a separator here
        # would double the token stream with inter-phone spaces).
        mode = self._espeakPHONEMES_IPA
        while ptr.value:
            res = self._lib.espeak_TextToPhonemes(
                ctypes.byref(ptr), self._espeakCHARS_UTF8, mode
            )
            if res:
                out.append(res.decode("utf-8"))
        return " ".join(out)

    def phonemize(self, text: str) -> str:
        """Phonemize preserving punctuation (espeak drops it natively)."""
        with _backend_lock:  # module lock: see __init__ on espeak C state
            pieces = []
            for part in _punct_split_re.split(text):
                if not part:
                    continue
                if _punct_split_re.fullmatch(part):
                    pieces.append(part)
                elif part.strip():
                    pieces.append(self._phonemize_span(part.strip()))
            return " ".join(pieces)


class CharBackend:
    """Deterministic fallback: normalized lowercase characters (all in-vocab)."""

    def phonemize(self, text: str) -> str:
        return text


_backend = None
_backend_name: Optional[str] = None
# espeak-ng keeps global C state (espeak_Initialize / SetVoiceByName are not
# thread-safe); construction must be serialized — threaded callers (corpus
# prep pool, server executor) otherwise race the lazy init
_backend_lock = threading.Lock()


def set_backend(name: str) -> None:
    global _backend, _backend_name
    with _backend_lock:
        if name == "espeak":
            _backend = EspeakBackend()
        elif name == "chars":
            _backend = CharBackend()
        else:
            raise ValueError(f"unknown phonemize backend {name!r}")
        _backend_name = name


def _get_backend():
    global _backend, _backend_name
    if _backend is None:
        with _backend_lock:
            if _backend is None:  # double-checked: losers reuse the winner's
                try:
                    _backend = EspeakBackend()
                    _backend_name = "espeak"
                except Exception:
                    _backend = CharBackend()
                    _backend_name = "chars"
    return _backend


def backend_name() -> str:
    _get_backend()
    return _backend_name or "chars"


def phonemize_text(text: str) -> str:
    """Normalize + phonemize a plain-text span, whitespace-canonicalized."""
    text = normalizer.normalize(text)
    phonemized = _get_backend().phonemize(text)
    return " ".join(_tok.findall(phonemized))


def get_token_ids(text: str) -> List[int]:
    """Full tokenizer: bracket events x NV_REPEAT interleaved with phonemized spans."""
    parts = _bracket_re.split(text)
    out: List[int] = []
    for i, part in enumerate(parts):
        if i % 2 == 0:
            if part.strip():
                s = phonemize_text(part)
                out.extend(p2idx[c] for c in s if c in p2idx)
        else:
            eid = get_sed_event_id(part)
            if eid is not None:
                out.extend([eid] * NV_REPEAT)
    return out


def merge_transcript(asr_words: list, sed_events: list) -> str:
    """Interleave ASR words and sound events by start time (data prep;
    reference: phonemes.py:100-117)."""
    items = []
    for w in asr_words:
        start = w.get("start")
        word = w.get("word", "")
        if start is not None and word:
            items.append((float(start), word))
    for e in sed_events:
        label = e.get("label")
        if label is None or label.lower() not in SED_LABELS:
            continue
        if e.get("prob", 0.0) < 0.1:
            continue
        start = e.get("start")
        if start is not None:
            items.append((float(start), f"[{label.lower()}]"))
    items.sort(key=lambda x: x[0])
    return " ".join(t for _, t in items)

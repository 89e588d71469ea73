"""Long-form synthesis: sentence chunking for texts beyond the 30 s cap.

The reference clamps duration to 30 s and notes long text "would be handled
by chunking at the application layer (not implemented)" (SURVEY.md section 5;
reference: src/smalltts/infer/onnx.py:17-18). Implemented here: split text on
sentence boundaries (keeping bracketed events attached), synthesize each
chunk with the same reference latents (voice consistency), concatenate with a
short crossfade.

The PyTorch port's own copy of smalltts_tpu/infer/long_form.py, with its imports
pointing at smalltts_tpu_torch; it behaves as that module does.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

from smalltts_tpu_torch.data.bucketing import SAMPLE_RATE

_SENTENCE_RE = re.compile(r"[^.!?…]*(?:\[[^\]]*\][^.!?…]*)*[.!?…]+|[^.!?…]+$")


def split_sentences(text: str, max_chars: int = 330) -> List[str]:
    """Sentence-ish chunks, each under max_chars (~30 s at 11.5 chars/s)."""
    sentences = [m.group(0).strip() for m in _SENTENCE_RE.finditer(text)]
    sentences = [s for s in sentences if s]
    chunks: List[str] = []
    cur = ""
    for s in sentences:
        if len(s) > max_chars:  # pathological sentence: hard-split on words
            if cur:  # flush pending text first to preserve order
                chunks.append(cur)
                cur = ""
            piece = ""
            for w in s.split():
                while len(w) > max_chars:
                    # a single unbroken token (URL, base64 blob) longer than
                    # max_chars would otherwise become one chunk whose
                    # duration clamps at 30 s and truncates mid-utterance
                    # — slice it at the character level
                    if piece:
                        chunks.append(piece)
                        piece = ""
                    chunks.append(w[:max_chars])
                    w = w[max_chars:]
                if not w:
                    continue
                if piece and len(piece) + len(w) + 1 > max_chars:
                    chunks.append(piece)
                    piece = w
                else:
                    piece = f"{piece} {w}".strip()
            s = piece
            if not s:
                continue
        if cur and len(cur) + len(s) + 1 > max_chars:
            chunks.append(cur)
            cur = s
        else:
            cur = f"{cur} {s}".strip()
    if cur:
        chunks.append(cur)
    return chunks


def head_split(sentence: str, head_chars: int = 24) -> tuple:
    """Clip a short head off `sentence` for streaming TTFB: -> (head, rest).

    The first audio chunk of /synthesize/stream should synthesize in the
    SMALLEST latent bucket (16 frames = ~2.1 s = ~24 chars at 11.5 chars/s)
    instead of waiting for the whole first sentence's bucket — the
    first-chunk fast path (stream TTFB measured WORSE
    than non-streaming because chunk 1 waited behind full-bucket synthesis).

    Cuts at the last word boundary within `head_chars`, preferring a
    clause boundary (`, ; :` + space) when one lands in the window, and
    never inside a bracketed [event] token. Returns (sentence, "") when the
    sentence already fits or no safe cut exists (single unbroken word)."""
    if len(sentence) <= head_chars:
        return sentence, ""
    depth = 0
    last_space = -1
    last_clause = -1
    for i, c in enumerate(sentence[: head_chars + 1]):
        if c == "[":
            depth += 1
        elif c == "]":
            depth = max(0, depth - 1)
        elif c == " " and depth == 0 and i > 0:
            last_space = i
            if sentence[i - 1] in ",;:":
                last_clause = i
    cut = last_clause if last_clause > 0 else last_space
    if cut <= 0:
        return sentence, ""
    head, rest = sentence[:cut].strip(), sentence[cut:].strip()
    if not head or not rest:
        return sentence, ""
    return head, rest


def as_float_waveform(x) -> np.ndarray:
    """(1, T) waveform -> flat float32 in [-1, 1]. int16 input (a
    pcm16_out pipeline, infer/pipeline.py) is rescaled so crossfades blend
    amplitudes, not 32767-scaled integers. Public: the serving stream path
    consumes it too."""
    arr = np.asarray(x)
    if arr.dtype == np.int16:
        return arr.astype(np.float32).reshape(-1) / 32767.0
    return arr.astype(np.float32).reshape(-1)


_as_float = as_float_waveform  # legacy alias (pre-r4 imports)


def crossfade_concat(parts: Sequence[np.ndarray], fade_ms: float = 20.0,
                     sr: int = SAMPLE_RATE) -> np.ndarray:
    """Concatenate (1, T) waveforms with linear crossfades."""
    fade = int(sr * fade_ms / 1e3)
    out = _as_float(parts[0])
    for part in parts[1:]:
        nxt = _as_float(part)
        f = min(fade, len(out), len(nxt))
        if f > 0:
            ramp = np.linspace(0.0, 1.0, f, dtype=np.float32)
            overlap = out[-f:] * (1 - ramp) + nxt[:f] * ramp
            out = np.concatenate([out[:-f], overlap, nxt[f:]])
        else:
            out = np.concatenate([out, nxt])
    return out[None, :]


def synthesize_long(tts, ref_latents: np.ndarray, text: str,
                    chars_per_second: float = 11.5) -> np.ndarray:
    """Chunked synthesis of arbitrarily long text -> (1, samples) @24 kHz.

    `chars_per_second` scales both the per-chunk duration estimate and the
    chunk size cap (otherwise a slow-speech voice at 8 chars/s would get ~30%
    too little latent budget)."""
    from smalltts_tpu_torch.text import get_token_ids

    parts = []
    for chunk in split_sentences(text, max_chars=int(30 * chars_per_second)):
        tokens = get_token_ids(chunk)
        if not tokens:
            continue
        duration = max(0.5, min(len(chunk) / chars_per_second, 30.0))
        parts.append(tts.synthesize(ref_latents, tokens, duration))
    if not parts:
        return np.zeros((1, 0), np.float32)
    return crossfade_concat(parts)


def stream_synthesize_long(tts, ref_latents: np.ndarray, text: str,
                           fade_ms: float = 20.0, synth=None,
                           max_chars: int = 330):
    """Generator of (samples,) float32 pieces whose concatenation equals
    synthesize_long's output (crossfades applied at chunk boundaries; each
    chunk emits as soon as ITS synthesis completes — everything except the
    fade tail, which waits to blend with the next chunk — so playback
    starts after the first sentence instead of after the whole text).

    `synth(chunk_text) -> (1, T)` overrides the per-chunk synthesis call
    (the server routes chunks through its batcher)."""
    from smalltts_tpu_torch.infer.pipeline import estimate_duration
    from smalltts_tpu_torch.text import get_token_ids

    if synth is None:
        def synth(chunk):
            return tts.synthesize(
                ref_latents, get_token_ids(chunk), estimate_duration(chunk)
            )

    fade = int(SAMPLE_RATE * fade_ms / 1e3)
    pending = None
    for chunk in split_sentences(text, max_chars):
        if not chunk.strip():
            continue
        cur = _as_float(synth(chunk))
        if cur.size == 0:
            continue
        emit, pending = crossfade_stream_step(pending, cur, fade)
        if emit is not None:
            yield emit
    if pending is not None and len(pending):
        # the zero-fade tail is an empty array, and consumers map emits to
        # chunked-transfer frames where an empty chunk is the terminator
        yield pending


def crossfade_stream_step(pending, cur, fade: int):
    """One boundary of incremental crossfading: -> (emit|None, new_pending).
    Concatenating all emits (+ final pending) equals crossfade_concat.

    EVERY chunk emits its body the moment it arrives, holding back only the
    last min(fade, stream_length) samples for the next blend (holding the
    WHOLE remainder of each chunk would deliver every chunk after the first
    one synthesis-interval late, and a live player would underrun for a
    full sentence per boundary). Holding exactly
    the stream tail also reproduces crossfade_concat's f =
    min(fade, len(out), len(next)) semantics for chunks shorter than the
    fade, which pending-per-chunk did not. Zero-length emits collapse to
    None: consumers map emits to chunked-transfer frames, where an empty
    chunk is the stream terminator."""
    if pending is None:
        combined = cur
    else:
        n = min(fade, len(pending), len(cur))
        if n > 0:
            ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
            blended = pending[-n:] * (1.0 - ramp) + cur[:n] * ramp
            combined = np.concatenate([pending[:-n], blended, cur[n:]])
        else:
            combined = np.concatenate([pending, cur])
    hold = min(max(fade, 0), len(combined))
    emit = combined[: len(combined) - hold]
    return (emit if len(emit) else None), combined[len(combined) - hold:]

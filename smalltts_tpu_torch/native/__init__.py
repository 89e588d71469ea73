"""ctypes bindings for the native C++ audio library (the PyTorch port's own
copy of the JAX package's native/ library: the same audio.cc and Makefile).

Builds `build/libsmalltts_audio.so` with make and g++ on the first call of
`lib()` (cached); callers fall back to serving.audio_io (numpy) when
`lib() is None`. Processes that call `lib()` at once (test workers on a
fresh tree) build one at a time: make and the load run under an exclusive
`flock` on `build/.build.lock`, and the Makefile writes the library to a
temporary name and renames it, so no process can open a half-written file.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "build", "libsmalltts_audio.so")
_LOCK = os.path.join(_DIR, "build", ".build.lock")
_lib = None
_tried = False
_build_lock = threading.Lock()  # the threads of this process; _process_lock() the other processes


@contextlib.contextmanager
def _process_lock():
    """An exclusive flock on build/.build.lock, held until the block ends;
    no lock where build/ cannot be written (a prebuilt, read-only tree)."""
    try:
        os.makedirs(os.path.dirname(_LOCK), exist_ok=True)
        f = open(_LOCK, "a")
    except OSError:
        yield
        return
    with f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _DIR, "-s"], check=True, capture_output=True, timeout=120
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _build_lock:
        if _lib is not None or _tried:  # double-checked under the lock
            return _lib
        with _process_lock():
            # a failed build or load is tried once more before it is cached
            for _ in range(2):
                if _load() is not None:
                    break
            _tried = True
        return _lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    # always run make: it's incremental (~ms when fresh) and rebuilds a
    # stale .so after audio.cc edits — an existing .so alone proved nothing
    # about freshness. A failed build (no g++) still uses a prebuilt .so.
    if not _build() and not os.path.exists(_SO):
        return None
    try:
        l = ctypes.CDLL(_SO)
    except OSError:
        return None
    l.stt_decode_wav.restype = ctypes.c_int
    l.stt_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
    ]
    l.stt_resample.restype = ctypes.c_int
    l.stt_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_long),
    ]
    l.stt_encode_wav16.restype = ctypes.c_int
    l.stt_encode_wav16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_long),
    ]
    l.stt_to_mono.restype = None
    l.stt_to_mono.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    l.stt_free.argtypes = [ctypes.c_void_p]
    _lib = l
    return _lib


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    l = lib()
    assert l is not None
    out = ctypes.POINTER(ctypes.c_float)()
    ch = ctypes.c_int()
    frames = ctypes.c_long()
    sr = ctypes.c_int()
    rc = l.stt_decode_wav(data, len(data), ctypes.byref(out), ctypes.byref(ch),
                          ctypes.byref(frames), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"wav decode failed (code {rc})")
    n = frames.value * ch.value
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    l.stt_free(out)
    # interleaved (frames, ch) -> (ch, frames)
    return arr.reshape(frames.value, ch.value).T.copy(), sr.value


def to_mono(samples: np.ndarray) -> np.ndarray:
    return samples.mean(axis=0).astype(np.float32) if samples.ndim == 2 else samples


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    # same attacker-bytes bounds as the numpy backend: sr=1 would make the
    # C side malloc n_in*24000 floats (multi-GB, unchecked)
    from smalltts_tpu_torch.serving.audio_io import check_resample_input

    if sr_in != sr_out:
        check_resample_input(int(np.asarray(x).shape[-1]), sr_in)
    l = lib()
    assert l is not None
    x = np.ascontiguousarray(x, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n_out = ctypes.c_long()
    rc = l.stt_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr_in, sr_out,
        ctypes.byref(out), ctypes.byref(n_out),
    )
    if rc != 0:
        raise ValueError("resample failed")
    arr = np.ctypeslib.as_array(out, shape=(n_out.value,)).copy()
    l.stt_free(out)
    return arr


def encode_wav(samples: np.ndarray, sample_rate: int = 24_000) -> bytes:
    if np.asarray(samples).dtype == np.int16:
        # already quantized in the fused graph (SmallTTS(pcm16_out=True)) —
        # the C path would cast the 32767-scaled ints to float and clamp
        # them all to +-1; header + passthrough is pure byte assembly
        from smalltts_tpu_torch.serving.audio_io import encode_wav as _encode_py

        return _encode_py(samples, sample_rate)
    l = lib()
    assert l is not None
    x = np.ascontiguousarray(np.asarray(samples, np.float32).reshape(-1))
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_long()
    rc = l.stt_encode_wav16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sample_rate,
        ctypes.byref(out), ctypes.byref(n),
    )
    if rc != 0:
        raise ValueError("wav encode failed")
    data = bytes(np.ctypeslib.as_array(out, shape=(n.value,)))
    l.stt_free(out)
    return data


def decode_and_resample(data: bytes, target_sr: int = 24_000) -> np.ndarray:
    samples, sr = decode_wav(data)
    return resample(to_mono(samples), sr, target_sr)

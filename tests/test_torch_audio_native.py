"""The port's native C++ audio library (smalltts_tpu_torch/native, built here
with g++) against the port's numpy module (serving/audio_io.py) and against
the JAX package's native library (smalltts_tpu/native), on the same bytes.

Tolerances: against the JAX package's library, equal (the same C++ source);
decode against numpy 1e-6 (float32 division in C against numpy's); resample
against numpy 5e-4 away from the edges (a direct windowed sinc against
scipy's polyphase filter, the JAX test's bound); WAV bytes equal.
"""

import ctypes
import struct
import time

import numpy as np
import pytest

from smalltts_tpu import native as jnative
from smalltts_tpu_torch import native
from smalltts_tpu_torch.serving import audio_io


def jax_library(seconds=60.0):
    """The JAX package's library. Its build has no lock across processes, so
    a test worker may load its .so while another is still writing it and
    cache the failure; that module's cache (_lib, _tried) is reset and the
    load tried again, for up to `seconds`."""
    deadline = time.monotonic() + seconds
    while jnative.lib() is None and time.monotonic() < deadline:
        time.sleep(0.5)
        jnative._lib, jnative._tried = None, False
    return jnative.lib()


@pytest.fixture(scope="module", autouse=True)
def built():
    if native.lib() is None or jax_library() is None:
        pytest.fail("the native audio library did not build (g++ and make are installed here)")


def sine(sr, seconds=0.4, freq=440.0, amp=0.5):
    t = np.arange(int(sr * seconds)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def wav_bytes(samples, sr, fmt, bits):
    """(channels, T) float samples in [-1, 1] -> a WAV of format 1 (PCM) or
    3 (float) at `bits` per sample."""
    ch = samples.shape[0]
    x = samples.T.reshape(-1)
    if fmt == 3:
        data = x.astype("<f4").tobytes()
    elif bits == 16:
        data = np.clip(np.rint(x * 32767), -32768, 32767).astype("<i2").tobytes()
    elif bits == 32:
        data = np.clip(np.rint(x.astype(np.float64) * 2147483647), -2 ** 31, 2 ** 31 - 1).astype("<i4").tobytes()
    else:  # 24
        v = np.clip(np.rint(x.astype(np.float64) * 8388607), -2 ** 23, 2 ** 23 - 1).astype(np.int32)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
    block = ch * bits // 8
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16, fmt, ch, sr, sr * block,
                      block, bits, b"data", len(data))
    return hdr + data


FORMATS = [(1, 16), (1, 24), (1, 32), (3, 32)]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt,bits", FORMATS)
def test_decode_wav(fmt, bits, channels):
    x = np.stack([sine(22_050, freq=220.0 * (c + 1)) for c in range(channels)])
    data = wav_bytes(x, 22_050, fmt, bits)
    got, sr = native.decode_wav(data)
    want, sr_np = audio_io.decode_wav(data)
    jgot, jsr = jnative.decode_wav(data)
    assert sr == sr_np == jsr == 22_050 and got.shape == want.shape == (channels, x.shape[1])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("sr_in", [8_000, 16_000, 22_050, 24_000, 44_100, 48_000])
def test_resample(sr_in):
    x = sine(sr_in)
    got = native.resample(x, sr_in, 24_000)
    want = audio_io.resample(x, sr_in, 24_000)
    np.testing.assert_array_equal(got, jnative.resample(x, sr_in, 24_000))
    n = min(len(got), len(want))
    assert abs(len(got) - len(want)) <= 1
    if sr_in == 24_000:
        np.testing.assert_array_equal(got, x)
    assert np.abs(got[2000:n - 2000] - want[2000:n - 2000]).max() < 5e-4


@pytest.mark.parametrize("samples", ["float", "clipped", "int16"])
def test_encode_wav16(samples):
    rs = np.random.RandomState(0)
    x = {"float": sine(24_000), "clipped": (1.5 * rs.randn(3000)).astype(np.float32),
         "int16": rs.randint(-32768, 32767, 3000).astype(np.int16)}[samples]
    got = native.encode_wav(x, 24_000)
    assert got == audio_io.encode_wav(x, 24_000) == jnative.encode_wav(x, 24_000)
    back, sr = native.decode_wav(got)
    assert sr == 24_000 and back.shape == (1, len(x))


def test_to_mono():
    x = np.stack([sine(24_000, freq=440.0), sine(24_000, freq=880.0)])
    np.testing.assert_array_equal(native.to_mono(x), jnative.to_mono(x))
    np.testing.assert_allclose(native.to_mono(x), audio_io.to_mono(x), atol=1e-7)
    # the C entry, interleaved (frames, channels) in
    inter = np.ascontiguousarray(x.T, np.float32)
    out = np.zeros(x.shape[1], np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    native.lib().stt_to_mono(inter.ctypes.data_as(fp), x.shape[1], 2, out.ctypes.data_as(fp))
    np.testing.assert_allclose(out, x.mean(0), atol=1e-7)


def test_decode_and_resample_and_bounds():
    data = wav_bytes(sine(44_100)[None], 44_100, 1, 16)
    got = native.decode_and_resample(data, 24_000)
    np.testing.assert_array_equal(got, jnative.decode_and_resample(data, 24_000))
    for sr in (1, 999, 768_001):
        bad = wav_bytes(np.zeros((1, 2000), np.float32), sr, 1, 16)
        for be in (native, audio_io):
            with pytest.raises(ValueError):
                be.decode_and_resample(bad, 24_000)
    with pytest.raises(ValueError):
        native.decode_wav(b"RIFF....not a wav")


def test_backend_is_native_when_built():
    from smalltts_tpu.serving import audio_io as j_audio_io

    assert audio_io.backend() is native
    assert j_audio_io.backend() is jnative

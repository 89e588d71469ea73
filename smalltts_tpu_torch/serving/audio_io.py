"""Host-side audio I/O: WAV decode, mono mix, HQ sinc resample, WAV encode.

Capability parity with the reference's native audio path
(reference: src/server/src/audio.rs:13-97 — symphonia decode -> mono mix ->
rubato SincFixedIn resample -> 24 kHz; hound 16-bit PCM writer with clamp)
and the Python HQ resampler (src/smalltts/infer/utils.py:7-23 — sinc-kaiser,
width 1024, rolloff 0.94, beta 14.7697).

A native C++ implementation (smalltts_tpu_torch/native) is used when built;
this module is the pure numpy/scipy reference implementation and fallback.
WAV covers PCM 16/24/32-bit + float32, the formats the serving contract
accepts.

The PyTorch port's own copy of smalltts_tpu/serving/audio_io.py, with its
imports pointing at smalltts_tpu_torch.
"""

from __future__ import annotations

import io
import math
import struct
from typing import Tuple

import numpy as np

KAISER_BETA = 14.769656459379492  # matches torchaudio's default beta (ref utils.py)
ROLLOFF = 0.94
LOWPASS_WIDTH = 64

# Resample-input bounds shared by BOTH backends (this module and the C++
# lib's Python wrapper). The WAV header's sample_rate is attacker bytes on
# the serving path: sr=1 turns a 1 MB upload into a ~24000x output blowup
# (and a multi-GB unchecked malloc in the native path — a segfault, not an
# exception), while a prime sr near 2^31 makes the polyphase filter's tap
# count 2*width*max(up,down) — hundreds of GB. Bound the rate to the real
# audio range and the decoded length to an hour BEFORE any allocation.
MIN_SAMPLE_RATE = 1_000
MAX_SAMPLE_RATE = 768_000
MAX_DECODED_SECONDS = 3_600.0


def check_resample_input(n_samples: int, sr_in: int) -> None:
    """Raise ValueError on rates/lengths outside the serving contract."""
    if not (MIN_SAMPLE_RATE <= sr_in <= MAX_SAMPLE_RATE):
        raise ValueError(f"unsupported sample rate {sr_in}")
    if n_samples > MAX_DECODED_SECONDS * sr_in:
        raise ValueError(
            f"audio exceeds the {MAX_DECODED_SECONDS:.0f}s decode cap")


def backend():
    """The one chooser between the native C++ audio library and this
    module: every consumer (the server among them) routes through here, so
    the same wav always decodes via the same code path."""
    from smalltts_tpu_torch import native

    if native.lib() is not None:
        return native
    import smalltts_tpu_torch.serving.audio_io as audio_io

    return audio_io


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (float32 samples (channels, T) in [-1,1], sample_rate)."""
    f = io.BytesIO(data)
    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        chunk_id, chunk_size = struct.unpack("<4sI", hdr)
        if chunk_id == b"fmt ":
            fmt = f.read(chunk_size)
            if chunk_size % 2:
                f.read(1)
        elif chunk_id == b"data":
            raw = f.read(chunk_size)
            break
        else:
            f.seek(chunk_size + (chunk_size % 2), 1)
    if fmt is None:
        raise ValueError("no fmt chunk found")
    audio_format, channels, sample_rate, _br, _ba, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 24:
        b3 = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            b3[:, 0].astype(np.int32)
            | (b3[:, 1].astype(np.int32) << 8)
            | (b3[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x >> 23) & 1) * (1 << 24)).astype(np.float32) / 8388608.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported wav format {audio_format}/{bits}bit")
    x = x.reshape(-1, channels).T
    return np.ascontiguousarray(x), sample_rate


def to_mono(samples: np.ndarray) -> np.ndarray:
    """(channels, T) -> (T,) mean mix (reference: audio.rs:76-84)."""
    return samples.mean(axis=0) if samples.ndim == 2 else samples


def resample(x: np.ndarray, sr_in: int, sr_out: int,
             width: int = LOWPASS_WIDTH) -> np.ndarray:
    """Polyphase windowed-sinc resampler (kaiser beta 14.77, rolloff 0.94)."""
    if sr_in == sr_out:
        return x.astype(np.float32)
    check_resample_input(x.shape[-1], sr_in)
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    if max(up, down) > 512:
        # an awkward rate (prime 44101-style) reduces to a huge up/down
        # pair whose filter would have 2*width*max(up,down) taps; a
        # bounded rational approximation keeps taps sane at a relative
        # rate error <= ~6e-5 (inaudible). Every standard rate (8k/11025/
        # 16k/22.05k/44.1k/48k/96k <-> 24k) reduces exactly below the
        # threshold and never takes this path.
        from fractions import Fraction

        fr = Fraction(sr_out, sr_in).limit_denominator(128)
        up, down = fr.numerator, fr.denominator
    max_rate = max(up, down)
    half_len = width * max_rate
    # cutoff at rolloff * nyquist of the lower rate, normalized to the
    # upsampled rate: f_c = rolloff / max(up, down)
    f_c = ROLLOFF / max_rate
    n = 2 * half_len + 1
    t = np.arange(n) - half_len
    h = np.sinc(f_c * t) * f_c
    h *= np.kaiser(n, KAISER_BETA)
    # NB: resample_poly applies the `up` gain to user-provided filters itself
    y = resample_poly(x.astype(np.float64), up, down, window=h)
    return y.astype(np.float32)


def decode_and_resample(data: bytes, target_sr: int = 24_000) -> np.ndarray:
    """Any supported WAV -> mono float32 at target rate (audio.rs:13-20)."""
    samples, sr = decode_wav(data)
    return resample(to_mono(samples), sr, target_sr)


def pcm16(samples: np.ndarray) -> bytes:
    """Mono float32 -> raw 16-bit little-endian PCM with clamp — the ONE
    clamp/rint/scale convention; encode_wav and the streaming body both use
    it (the stream had its own inline copy that could drift).

    int16 input passes through untouched: SmallTTS(pcm16_out=True) applies
    this exact convention in the fused graph (infer/sampler.py), so the
    samples are already quantized — re-clamping 32767-scaled ints to [-1, 1]
    would destroy them."""
    arr = np.asarray(samples)
    if arr.dtype == np.int16:
        return np.ascontiguousarray(arr.reshape(-1), dtype="<i2").tobytes()
    x = np.clip(arr.astype(np.float32).reshape(-1), -1.0, 1.0)
    return np.rint(x * 32767.0).astype("<i2").tobytes()


def encode_wav(samples: np.ndarray, sample_rate: int = 24_000) -> bytes:
    """Mono float32 -> 16-bit PCM WAV bytes with clamp (audio.rs:22-36)."""
    pcm = pcm16(samples)
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm), b"WAVE",
        b"fmt ", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16,
        b"data", len(pcm),
    )
    return hdr + pcm


def resample_hq(audio: np.ndarray, sr_in: int, sr_out: int = 24_000) -> np.ndarray:
    """HQ resample for reference audio — lowpass width 1024 like the
    reference's torchaudio settings (reference: infer/utils.py:7-23)."""
    return resample(audio, sr_in, sr_out, width=1024)

"""Waveform quality metrics: log-mel distance, SNR and speaker similarity
(port of smalltts_tpu/utils/metrics.py). Everything but `sv_similarity` is
numpy on the host; `sv_similarity` embeds with the port's SV models on the
device their weights are on.
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def probe_sine(seconds: float = 2.0, sr: int = 24_000, freq: float = 220.0):
    """The shared probe waveform: a fundamental plus a 3.1x partial."""
    t = np.arange(int(seconds * sr))
    return (0.4 * np.sin(2 * np.pi * freq * t / sr) + 0.1 * np.sin(2 * np.pi * 3.1 * freq * t / sr)).astype(np.float32)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular filters on the HTK mel scale
    (2595 log10(1 + f / 700)), unnormalized."""
    fmax = fmax or sr / 2.0
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, c, r = bins[i], bins[i + 1], bins[i + 2]
        if c > lo:
            fb[i, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        if r > c:
            fb[i, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb


def log_mel_spectrogram(audio: np.ndarray, sr: int = 24_000, n_fft: int = 1024, hop: int = 256,
                        n_mels: int = 80) -> np.ndarray:
    """(T,) waveform -> (frames, n_mels) log-mel: Hann window, frames that
    fit (the tail is cut; a clip shorter than n_fft is zero-padded to one)."""
    audio = np.asarray(audio, np.float64).reshape(-1)
    n_frames = max(1 + (len(audio) - n_fft) // hop, 0)
    if n_frames == 0:
        audio = np.pad(audio, (0, n_fft - len(audio)))
        n_frames = 1
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = audio[idx] * np.hanning(n_fft)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ mel_filterbank(sr, n_fft, n_mels).T
    return np.log(np.maximum(mel, 1e-10))


def mel_distance(a: np.ndarray, b: np.ndarray, sr: int = 24_000) -> float:
    """Mean |log-mel| distance between two waveforms (cut to the shorter)."""
    ma = log_mel_spectrogram(a, sr)
    mb = log_mel_spectrogram(b, sr)
    n = min(len(ma), len(mb))
    return float(np.abs(ma[:n] - mb[:n]).mean())


def sv_similarity(a: np.ndarray, b: np.ndarray, tts=None, sv_params=None, teacher_params=None) -> float:
    """Cosine similarity of the speaker embeddings of two 24 kHz waveforms.

    - `teacher_params` (the voxceleb waveform ECAPA, models/sv_teacher.py,
      the port's tree): the waveforms resampled to 16 kHz and embedded;
    - else `sv_params` (the latent-domain SV, models/sv.py, the port's tree)
      over `tts.encode_reference`'s latents (`tts` a SmallTTS; a default
      one is built when None). With no trained SV weights it warns and
      uses a random-init SV (seed 0), kept on `tts`: the value is then a
      smoke signal, not a similarity measurement."""
    import torch

    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree

    if teacher_params is not None:
        from smalltts_tpu_torch.models.sv_teacher import resample_24k_to_16k, sv_teacher_embed

        dev = next(iter(flatten_pytree(teacher_params).values())).device

        def embed(wav):
            x = torch.from_numpy(np.asarray(wav, np.float32).reshape(1, 1, -1)).to(dev)
            with torch.no_grad():
                return sv_teacher_embed(teacher_params, resample_24k_to_16k(x))[0].cpu().numpy()

    else:
        from smalltts_tpu_torch.models.sv import SVConfig, init_sv, sv_forward

        if tts is None:
            from smalltts_tpu_torch.infer.pipeline import SmallTTS

            tts = SmallTTS()
        cfg = SVConfig()
        if sv_params is None:
            sv_params = getattr(tts, "_sv_params", None)
        if sv_params is None:
            import warnings

            warnings.warn("sv_similarity: no trained SV weights passed — using a random-init model; the value is "
                          "NOT a similarity measurement", stacklevel=2)
            sv_params = init_sv(torch.Generator(device=tts.device).manual_seed(0), cfg, device=tts.device)
            tts._sv_params = sv_params
        dev = next(iter(flatten_pytree(sv_params).values())).device

        def embed(wav):
            lat = tts.encode_reference(np.asarray(wav, np.float32))
            with torch.no_grad():
                emb, _ = sv_forward(sv_params, cfg, torch.from_numpy(lat)[None].to(dev),
                                    torch.tensor([lat.shape[0]], device=dev))
            return emb[0].cpu().numpy()

    ea, eb = embed(a), embed(b)
    denom = np.linalg.norm(ea) * np.linalg.norm(eb)
    return float(ea @ eb / max(denom, 1e-12))


def snr_db(reference: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-noise ratio of `test` against `reference` (cut to the shorter)."""
    n = min(len(reference), len(test))
    ref, t = np.asarray(reference[:n], np.float64), np.asarray(test[:n], np.float64)
    noise = ref - t
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean(noise ** 2), 1e-12)))

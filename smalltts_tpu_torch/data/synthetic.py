"""A deterministic synthetic-speech corpus: (wav, text) pairs with learnable
acoustic structure, made in-process (port of smalltts_tpu/data/synthetic.py;
the same files for the same seed).

There is no audio data in the repository, so this is what a trainer's
`--data-dir` path runs on when nothing is downloaded. Pseudo-speech with the
structure the models need to learn something measurable:

* per-character "phones": vowel-like characters are harmonic stacks with
  two formant resonances, consonant-like ones filtered noise bursts, spaces
  silences, all determined by the character, so text and acoustics map onto
  each other (CTC alignment, mel reconstruction);
* per-speaker voices: f0, formant scale and vibrato derived from the
  speaker id, so speaker embeddings have structure to separate;
* fully deterministic given (text, speaker, seed).

Not a speech synthesizer: a fixture with speech-like structure (pitch,
formants, voicing, timing), the audio analogue of the dummy loader.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

SR = 24_000
VOWELS = set("aeiouy")

# small word bank -> texts tokenize well under both espeak and char backends
WORDS = (
    "one two three red blue moon star open hear say light voice deep call "
    "echo name wave time glow free run dark soft high low"
).split()


def _speaker_profile(speaker: int):
    r = np.random.RandomState(1000 + speaker)
    return {
        "f0": 95.0 + 130.0 * r.rand(),          # 95..225 Hz fundamental
        "formant_scale": 0.85 + 0.4 * r.rand(),  # vocal-tract length proxy
        "vibrato_hz": 4.0 + 3.0 * r.rand(),
        "vibrato_depth": 0.005 + 0.02 * r.rand(),
    }


def _char_phone(c: str):
    """Character -> deterministic acoustic parameters."""
    o = ord(c.lower())
    r = np.random.RandomState(o)
    return {
        "voiced": c.lower() in VOWELS,
        "dur": 0.07 + 0.05 * r.rand(),                 # 70..120 ms
        "f1": 350.0 + 500.0 * r.rand(),                # formant 1
        "f2": 900.0 + 1600.0 * r.rand(),               # formant 2
        "f0_mult": 0.9 + 0.2 * r.rand(),
        "amp": 0.25 + 0.15 * r.rand(),
    }


def synth_speech(text: str, speaker: int = 0, sr: int = SR,
                 seed: int = 0) -> np.ndarray:
    """(T,) float32 pseudo-speech in [-1, 1], deterministic."""
    spk = _speaker_profile(speaker)
    rng = np.random.RandomState(seed * 7919 + speaker)
    pieces: List[np.ndarray] = []
    for c in text:
        if not c.isalnum():
            pieces.append(np.zeros(int(0.04 * sr), np.float32))
            continue
        p = _char_phone(c)
        n = int(p["dur"] * sr)
        t = np.arange(n) / sr
        env = np.sin(np.pi * np.clip(t / p["dur"], 0, 1)) ** 0.5  # attack/decay
        if p["voiced"]:
            f0 = spk["f0"] * p["f0_mult"] * (
                1.0 + spk["vibrato_depth"] * np.sin(2 * np.pi * spk["vibrato_hz"] * t)
            )
            phase = 2 * np.pi * np.cumsum(f0) / sr
            sig = np.zeros(n)
            for k in range(1, 13):  # harmonic stack weighted by formants
                fk = k * spk["f0"] * p["f0_mult"]
                w = (np.exp(-0.5 * ((fk - p["f1"] * spk["formant_scale"]) / 250.0) ** 2)
                     + 0.7 * np.exp(-0.5 * ((fk - p["f2"] * spk["formant_scale"]) / 350.0) ** 2)
                     + 0.05)
                sig += w * np.sin(k * phase)
            sig /= np.max(np.abs(sig)) + 1e-9
        else:
            # consonant: noise burst shaped by a crude band emphasis
            noise = rng.randn(n)
            kernel_t = np.arange(-32, 33) / sr
            band = np.cos(2 * np.pi * p["f2"] * spk["formant_scale"] * kernel_t)
            band *= np.hanning(len(kernel_t))
            sig = np.convolve(noise, band, mode="same")
            sig /= np.max(np.abs(sig)) + 1e-9
            sig *= 0.5
        pieces.append((p["amp"] * env * sig).astype(np.float32))
    if not pieces:
        pieces = [np.zeros(int(0.1 * sr), np.float32)]
    audio = np.concatenate(pieces)
    peak = np.max(np.abs(audio))
    return (0.8 * audio / peak).astype(np.float32) if peak > 0 else audio


def make_text(rng: np.random.RandomState, n_words: Tuple[int, int] = (2, 6)) -> str:
    k = rng.randint(n_words[0], n_words[1] + 1)
    return " ".join(WORDS[rng.randint(len(WORDS))] for _ in range(k))


def write_corpus(root: str, n_utts: int = 32, n_speakers: int = 4,
                 seed: int = 0, sr: int = SR) -> List[Tuple[str, str, int]]:
    """Write {i:04d}.wav/.txt pairs under `root` (data.local.scan_corpus
    layout). Returns [(wav_path, text, speaker)]."""
    from smalltts_tpu_torch.serving.audio_io import encode_wav

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_utts):
        speaker = i % n_speakers
        text = make_text(rng)
        audio = synth_speech(text, speaker=speaker, sr=sr, seed=seed)
        wav_path = os.path.join(root, f"{i:04d}.wav")
        with open(wav_path, "wb") as f:
            f.write(encode_wav(audio, sr))
        with open(os.path.join(root, f"{i:04d}.txt"), "w") as f:
            f.write(text + "\n")
        out.append((wav_path, text, speaker))
    return out


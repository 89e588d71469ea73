"""Interactive synthesis: one line of stdin at a time, with its wall time
and real-time factor (port of scripts/interactive.py).

    python -m smalltts_tpu_torch.scripts.interactive [--wav REF.wav] [--checkpoint C]
        [--out-dir out] [--device cuda]

The reference is `--wav` (decoded, resampled to 24 kHz and encoded by the
codec), else assets/tryme/latents.npy where present, else RandomState(0)
latents. Each line is written to <out-dir>/interactive_<n>.wav (no sound
device is assumed).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def default_latents() -> np.ndarray:
    """The built-in reference: assets/tryme/latents.npy, else RandomState(0)."""
    path = "assets/tryme/latents.npy"
    return np.load(path) if os.path.exists(path) else np.random.RandomState(0).randn(16, 64).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Synthesize each line of stdin.")
    ap.add_argument("--wav", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    from smalltts_tpu_torch.infer.pipeline import SmallTTS, estimate_duration
    from smalltts_tpu_torch.scripts.clone import load_audio
    from smalltts_tpu_torch.serving.audio_io import encode_wav
    from smalltts_tpu_torch.text import get_token_ids

    tts = SmallTTS(checkpoint=args.checkpoint, device=args.device)
    ref_latents = tts.encode_reference(load_audio(args.wav)) if args.wav else default_latents()

    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    print("enter text (ctrl-d to exit):")
    for line in sys.stdin:
        text = line.strip()
        if not text:
            continue
        tokens = get_token_ids(text)
        duration = estimate_duration(text)
        t0 = time.perf_counter()
        audio = tts.synthesize(ref_latents, tokens, duration)
        dt = time.perf_counter() - t0
        rtf = dt / duration
        path = os.path.join(args.out_dir, f"interactive_{n}.wav")
        with open(path, "wb") as f:
            f.write(encode_wav(audio.reshape(-1), 24_000))
        print(f"{path}: {dt*1e3:.0f} ms for {duration:.1f}s audio (rtf {rtf:.3f})")
        n += 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

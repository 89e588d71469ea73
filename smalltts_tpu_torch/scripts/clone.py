"""Voice cloning: --wav --text [--transcription] [--duration] [--out]
(port of scripts/clone.py).

    python -m smalltts_tpu_torch.scripts.clone --wav REF.wav --text TEXT
        [--transcription T] [--duration S] [--out out/clone.wav] [--checkpoint C] [--device cuda]

Decodes and resamples the reference to 24 kHz, encodes it with the codec
(`SmallTTS.encode_reference`), prepends the transcription's tokens to the
text's, synthesizes `--duration` seconds (default: estimate_duration of the
text) and writes a 16-bit wav.
"""

from __future__ import annotations

import argparse
import os


def load_audio(path: str):
    """A wav file -> mono float32 at 24 kHz."""
    from smalltts_tpu_torch.serving.audio_io import backend

    with open(path, "rb") as f:
        return backend().decode_and_resample(f.read(), 24_000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Clone a voice from a reference wav.")
    ap.add_argument("--wav", required=True, help="reference audio (wav)")
    ap.add_argument("--text", required=True, help="text to speak")
    ap.add_argument("--transcription", default=None,
                    help="transcript of the reference audio (prepended tokens)")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--out", default="out/clone.wav")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    from smalltts_tpu_torch.infer.pipeline import SmallTTS, estimate_duration
    from smalltts_tpu_torch.serving.audio_io import encode_wav
    from smalltts_tpu_torch.text import get_token_ids

    tts = SmallTTS(checkpoint=args.checkpoint, device=args.device)
    ref_latents = tts.encode_reference(load_audio(args.wav))

    tokens = get_token_ids(args.text)
    if args.transcription:
        tokens = get_token_ids(args.transcription) + tokens
    duration = args.duration or estimate_duration(args.text)
    audio = tts.synthesize(ref_latents, tokens, duration)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(encode_wav(audio.reshape(-1), 24_000))
    print(f"wrote {args.out} ({duration:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

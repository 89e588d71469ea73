"""Batch synthesis over a transcriptions manifest, through the serving
batcher (port of scripts/batch.py).

    python -m smalltts_tpu_torch.scripts.batch [--manifest assets/test_audio/transcriptions.json]
        [--out out] [--checkpoint C] [--device cuda]

The manifest is {wav_name: transcript}, wav names relative to its
directory. Each reference is encoded once, and each of the four TEXTS is
submitted with the reference's transcript prepended; the Batcher groups the
requests into padded batches (one CUDA graph per bucket on the card). Writes
<out>/<wav>_<i>_gen.wav.
"""

from __future__ import annotations

import argparse
import json
import os

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Hello! This voice was cloned on a TPU.",
    "Speech synthesis with four diffusion steps is fast.",
    "How does this sound to you?",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Synthesize a manifest's texts through the batcher.")
    ap.add_argument("--manifest", default="assets/test_audio/transcriptions.json")
    ap.add_argument("--out", default="out")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    from smalltts_tpu_torch.infer.pipeline import SmallTTS, estimate_duration
    from smalltts_tpu_torch.scripts.clone import load_audio
    from smalltts_tpu_torch.serving.audio_io import encode_wav
    from smalltts_tpu_torch.serving.batcher import Batcher
    from smalltts_tpu_torch.text import get_token_ids

    with open(args.manifest) as f:
        manifest = json.load(f)

    tts = SmallTTS(checkpoint=args.checkpoint, device=args.device)
    batcher = Batcher(tts)
    os.makedirs(args.out, exist_ok=True)

    futures = []
    base = os.path.dirname(args.manifest)
    try:
        for wav_name, transcript in manifest.items():
            ref_latents = tts.encode_reference(load_audio(os.path.join(base, wav_name)))
            for i, text in enumerate(TEXTS):
                tokens = get_token_ids(transcript) + get_token_ids(text)
                fut = batcher.submit(ref_latents, tokens, estimate_duration(text))
                futures.append((f"{os.path.splitext(wav_name)[0]}_{i}_gen.wav", fut))

        for name, fut in futures:
            audio = fut.result()
            with open(os.path.join(args.out, name), "wb") as f:
                f.write(encode_wav(audio.reshape(-1), 24_000))
            print(f"wrote {args.out}/{name}")
    finally:
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""One-shot demo: text -> out/tryme.wav in the built-in voice (port of
scripts/tryme.py).

    python -m smalltts_tpu_torch.scripts.tryme [--device cuda] [TEXT]

Reads $SMALLTTS_ASSETS (default assets/) where its folders are present, in
the root script's order: the reference latents tryme/latents.npy (else
RandomState(0) latents), then the native checkpoint dmd/student_latest.npz,
else the reference's published ONNX graphs (dmd/condition_encoder.onnx,
dmd/denoiser.onnx, codec/decoder.onnx) through onnxtorch.ImportedSmallTTS,
else random-init weights with a warning (a hermetic demo). Unlike the root
script it downloads nothing: the JAX package's ensure_assets fetches the
folders from a model hub, and the port reads only what is on disk. Writes a
16-bit wav at 24 kHz.
"""

from __future__ import annotations

import os
import sys

import numpy as np

FOLDERS = ("tryme", "codec", "dmd")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    usage = "usage: python -m smalltts_tpu_torch.scripts.tryme [--device D] [TEXT]   (-> out/tryme.wav)"
    if argv[:1] in (["-h"], ["--help"]):
        # bare-argv CLI, as the root script: help touches no asset and no device
        print(__doc__.strip())
        print("\n" + usage)
        return 0
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 == len(argv):
            print(f"{usage}\ntryme: --device needs a value", file=sys.stderr)
            return 2
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    text = argv[0] if argv else "Hello from smalltts on TPU!"

    from smalltts_tpu_torch.infer.pipeline import SmallTTS, estimate_duration
    from smalltts_tpu_torch.onnxtorch.pipeline import assets_present as onnx_assets
    from smalltts_tpu_torch.serving.audio_io import encode_wav
    from smalltts_tpu_torch.text import get_token_ids

    root = os.environ.get("SMALLTTS_ASSETS", "assets")
    missing = [f for f in FOLDERS if not os.path.isdir(os.path.join(root, f))]
    if missing:
        print(f"warn: assets {missing} not present under {root!r}; continuing with random weights",
              file=sys.stderr)

    latents_path = os.path.join(root, "tryme", "latents.npy")
    ckpt_path = os.path.join(root, "dmd", "student_latest.npz")
    ref_latents = (np.load(latents_path) if os.path.exists(latents_path)
                   else np.random.RandomState(0).randn(16, 64).astype(np.float32))

    tokens = get_token_ids(text)
    duration = estimate_duration(text)
    if os.path.exists(ckpt_path):
        # a converted native checkpoint: the bucketed pipeline
        tts = SmallTTS(checkpoint=ckpt_path, device=device)
    elif onnx_assets(root):
        # the reference's published graphs, imported as they are
        from smalltts_tpu_torch.onnxtorch.pipeline import ImportedSmallTTS

        print("using imported reference ONNX graphs (assets/dmd)", file=sys.stderr)
        tts = ImportedSmallTTS(os.path.join(root, "dmd", "condition_encoder.onnx"),
                               os.path.join(root, "dmd", "denoiser.onnx"),
                               os.path.join(root, "codec", "decoder.onnx"), device=device)
    else:
        tts = SmallTTS(device=device)  # hermetic demo: random weights
    audio = tts.synthesize(ref_latents, tokens, duration)

    os.makedirs("out", exist_ok=True)
    with open("out/tryme.wav", "wb") as f:
        f.write(encode_wav(audio.reshape(-1), 24_000))
    print(f"wrote out/tryme.wav ({duration:.1f}s, {len(tokens)} tokens)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Import and inspect the reference VibeVoice codec's ONNX graphs (port of
scripts/import_codec.py).

    python -m smalltts_tpu_torch.scripts.import_codec [--assets assets/codec] [--save out/codec_import]
        [--roundtrip-seconds 1.0] [--device cuda]

Parses <assets>/{encoder,decoder}.onnx with the port's ONNX interpreter
(onnxtorch; no `onnx` or `onnxruntime` package), prints each graph's
summary, optionally saves the initializers as <save>_{enc,dec}.npz, and runs
an encode -> decode round trip of a 220 Hz sine with noise on the device,
printing its SNR (the codec is lossy: a sanity check only).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Import and inspect the codec's ONNX graphs.")
    ap.add_argument("--assets", default="assets/codec")
    ap.add_argument("--save", default=None, help="save initializers to <save>_{enc,dec}.npz")
    ap.add_argument("--roundtrip-seconds", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    enc_path = os.path.join(args.assets, "encoder.onnx")
    dec_path = os.path.join(args.assets, "decoder.onnx")
    for p in (enc_path, dec_path):
        if not os.path.isfile(p):
            print(f"missing {p}", file=sys.stderr)
            return 1

    import torch

    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec

    codec = OnnxCodec(enc_path, dec_path, device=args.device)
    print(codec.describe())

    if args.save:
        for side in ("encoder", "decoder"):
            out = f"{args.save}_{side[:3]}.npz"
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            np.savez(out, **{k: v.cpu().numpy() for k, v in codec.params[side].items()})
            print(f"saved {side} initializers -> {out}")

    sr = 24_000
    t = int(args.roundtrip_seconds * sr)
    rng = np.random.RandomState(0)
    audio = (0.5 * np.sin(2 * np.pi * 220 * np.arange(t) / sr)
             + 0.05 * rng.randn(t)).astype(np.float32)[None, None, :]
    with torch.inference_mode():
        latents = codec.encode_fn(codec.params, torch.from_numpy(audio).to(codec.device))
        print(f"encode: {audio.shape} -> {tuple(latents.shape)}")
        recon = codec.decode_fn(codec.params, latents)
        print(f"decode: {tuple(latents.shape)} -> {tuple(recon.shape)}")
        a = recon.cpu().numpy()[0, 0, : audio.shape[-1]]
    b = audio[0, 0, : a.shape[0]]
    snr = 10 * np.log10(np.mean(b**2) / (np.mean((a - b) ** 2) + 1e-12))
    print(f"round-trip SNR vs input: {snr:.1f} dB (codec is lossy; sanity only)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

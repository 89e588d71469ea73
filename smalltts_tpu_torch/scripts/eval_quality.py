"""Quality evaluation: codec fidelity, agreement with golden waveforms, and
speaker stability, through utils/metrics.py.

    python -m smalltts_tpu_torch.scripts.eval_quality [--roundtrip] [--against DIR]
        [--self-consistency] [--synthetic N] [--checkpoint C] [--codec auto|native|onnx]
        [--codec-checkpoint C] [--ref WAV] [--texts FILE] [--sv-teacher T] [--sv-checkpoint S]
        [--out out/quality.json] [--device cuda]

- `--roundtrip`: encode -> decode against the input waveform (mel distance,
  SNR), over the references;
- `--against DIR`: synthesize each line of `--texts` and compare it with
  DIR/<i>.wav (mel distance, SV similarity);
- `--self-consistency`: the first text synthesized twice on fresh noise
  from the pipeline's seeded generator, the SV similarity of the two takes.

References: `--ref`, else the probe sine, or `--synthetic N` utterances of
the synthetic-speech corpus (data/synthetic.py). SV similarity uses
`--sv-teacher` (the voxceleb waveform ECAPA) or `--sv-checkpoint` (the
latent SV, an npz in the JAX package's layout); with neither it warns and
uses a random-init SV. Prints one JSON line a measurement and writes the
summary to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_wav(path: str):
    from smalltts_tpu_torch.serving.audio_io import backend

    with open(path, "rb") as f:
        return backend().decode_and_resample(f.read(), 24_000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Quality evaluation of the pipeline.")
    ap.add_argument("--checkpoint", default=None, help="backbone weights")
    ap.add_argument("--codec", default="auto", choices=["auto", "native", "onnx"])
    ap.add_argument("--codec-checkpoint", default=None)
    ap.add_argument("--ref", default=None, help="reference wav (default: synthetic tone)")
    ap.add_argument("--texts", default=None, help="file with one text per line")
    ap.add_argument("--roundtrip", action="store_true")
    ap.add_argument("--against", default=None, help="dir of golden wavs to compare to")
    ap.add_argument("--self-consistency", action="store_true")
    ap.add_argument("--sv-teacher", default=None, help="voxceleb waveform ECAPA weights (.ckpt/.npz)")
    ap.add_argument("--sv-checkpoint", default=None, help="latent SV weights (.npz)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="use N utterances of the synthetic-speech corpus (data/synthetic.py) as --ref material")
    ap.add_argument("--out", default="out/quality.json")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from smalltts_tpu_torch.infer.pipeline import SmallTTS, estimate_duration
    from smalltts_tpu_torch.text import get_token_ids
    from smalltts_tpu_torch.utils import metrics

    tts = SmallTTS(checkpoint=args.checkpoint, codec=args.codec, codec_checkpoint=args.codec_checkpoint,
                   device=args.device)
    teacher_params = None
    if args.sv_teacher:
        from smalltts_tpu_torch.models.sv_teacher import load_teacher

        teacher_params = load_teacher(args.sv_teacher, device=tts.device)
    sv_params = None
    if args.sv_checkpoint:
        from smalltts_tpu_torch.models.sv import SVConfig
        from smalltts_tpu_torch.utils.checkpoint import load_pytree, map_pytree
        from smalltts_tpu_torch.utils.convert import params_from_jax

        sv_params = map_pytree(lambda t: t.to(tts.device),
                               params_from_jax(load_pytree(args.sv_checkpoint), SVConfig()))

    if args.synthetic:
        from smalltts_tpu_torch.data.synthetic import make_text, synth_speech

        rng = np.random.RandomState(0)
        synth_refs = [synth_speech(make_text(rng), speaker=i % 4, seed=0) for i in range(args.synthetic)]
        ref_wav = synth_refs[0]
    else:
        synth_refs = None
        ref_wav = _load_wav(args.ref) if args.ref else metrics.probe_sine()
    texts = ([ln.strip() for ln in open(args.texts) if ln.strip()] if args.texts
             else ["The quick brown fox jumps over the lazy dog."])
    results = {}

    def sv_sim(a, b):
        return metrics.sv_similarity(a, b, tts=tts, sv_params=sv_params, teacher_params=teacher_params)

    if args.roundtrip:
        rows = []
        for wav in (synth_refs or [ref_wav]):
            lat = tts.encode_reference(wav)
            with torch.inference_mode():
                recon = tts._decode(torch.from_numpy(lat[None]).to(tts.device).float())
            recon = recon.cpu().numpy()[0, 0, :len(wav)]
            rows.append({"mel_distance": round(metrics.mel_distance(wav, recon), 4),
                         "snr_db": round(metrics.snr_db(wav, recon), 2)})
        results["roundtrip"] = {"mel_distance": round(float(np.mean([r["mel_distance"] for r in rows])), 4),
                                "snr_db": round(float(np.mean([r["snr_db"] for r in rows])), 2), "n": len(rows)}
        print(json.dumps({"mode": "roundtrip", **results["roundtrip"]}))

    if args.against:
        ref_lat = tts.encode_reference(ref_wav)
        rows = []
        for i, text in enumerate(texts):
            golden_path = os.path.join(args.against, f"{i}.wav")
            if not os.path.isfile(golden_path):
                print(f"skip {i}: no golden {golden_path}", file=sys.stderr)
                continue
            golden = _load_wav(golden_path)
            audio = tts.synthesize(ref_lat, get_token_ids(text), estimate_duration(text))[0]
            row = {"i": i, "mel_distance": round(metrics.mel_distance(golden, audio), 4),
                   "sv_similarity": round(sv_sim(golden, audio), 4)}
            rows.append(row)
            print(json.dumps({"mode": "against", **row}))
        if rows:
            results["against"] = {
                "mel_distance_mean": round(float(np.mean([r["mel_distance"] for r in rows])), 4),
                "sv_similarity_mean": round(float(np.mean([r["sv_similarity"] for r in rows])), 4),
                "n": len(rows)}

    if args.self_consistency:
        ref_lat = tts.encode_reference(ref_wav)
        tok = get_token_ids(texts[0])
        dur = estimate_duration(texts[0])
        a = tts.synthesize(ref_lat, tok, dur)[0]
        b = tts.synthesize(ref_lat, tok, dur)[0]
        results["self_consistency"] = {"sv_similarity": round(sv_sim(a, b), 4)}
        print(json.dumps({"mode": "self_consistency", **results["self_consistency"]}))

    if not results:
        print("nothing to do: pass --roundtrip / --against / --self-consistency", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

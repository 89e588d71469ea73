"""Real-asset certification: one command, a status a stage (port of
scripts/certify.py).

    python -m smalltts_tpu_torch.scripts.certify [--assets-root DIR] [--out CERTIFY.json]
        [--stages a,b,...] [--device cuda]

Stages, each independent, each recorded in CERTIFY.json:
  assets              fetch or verify assets/{tryme,codec,dmd} (assets/ensure.py)
  espeak_goldens      record or regress the espeak token goldens
                      (tests/goldens/espeak_tokens.json)
  codec_parity        the VibeVoice ONNX codec through onnxtorch.OnnxCodec:
                      encode/decode round trip, mel distance and SNR, an
                      onnxruntime cross-check where onnxruntime is installed
  imported_pipeline   onnxtorch.ImportedSmallTTS on the published dmd
                      graphs: finite audio of the right length, and the
                      onnxruntime recurrence on the same noise where
                      onnxruntime is installed
  checkpoint_parity   a reference torch checkpoint -> utils/torch_convert ->
                      the port's backbone_forward, against the reference's
                      DiTModel where $SMALLTTS_REFERENCE_SRC names its
                      source tree (unset, the oracle skips)
  tryme               `python -m smalltts_tpu_torch.scripts.tryme` writes a
                      non-silent wav
  quality             mel distance and SV similarity between SmallTTS on the
                      converted checkpoint and the imported graphs, on the
                      same text and reference

Statuses: pass / fail / skip (a prerequisite is absent; the reason is
recorded). The exit code is 0 unless a stage failed. Stages gate on their
own files, never on an earlier stage's status, so a partial asset set
certifies what exists and a re-run after more assets land flips the
skipped stages to pass or fail. `SMALLTTS_ASSETS` is set to the assets
root once, for every consumer (OnnxCodec's and ImportedSmallTTS's
defaults, the tryme subprocess, ensure_assets).

The models run on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np

SR = 24_000
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the environment variable that names the reference's source tree (smallbraineng/smalltts's src/), which
# checkpoint_parity's oracle reads; unset, the oracle skips
REFERENCE_SRC_VAR = "SMALLTTS_REFERENCE_SRC"


def _sine(seconds=2.0, freq=220.0):
    from smalltts_tpu_torch.utils.metrics import probe_sine

    return probe_sine(seconds, SR, freq)


class Skip(Exception):
    """Raised by a stage when a prerequisite is absent (recorded, not failed)."""


def _device(ctx):
    from smalltts_tpu_torch.utils.transfer import resolve_device

    return resolve_device(ctx.get("device"))


# ------------------------------------------------------------------ stages


def stage_assets(ctx) -> dict:
    from smalltts_tpu_torch.assets.ensure import ensure_assets

    folders = ["tryme", "codec", "dmd"]
    try:
        ensure_assets(folders, root=ctx["assets_root"])
    except RuntimeError as exc:
        ctx["fetch_error"] = str(exc)
    present = {f: os.path.isdir(os.path.join(ctx["assets_root"], f)) for f in folders}
    files = {}
    for f, ok in present.items():
        if ok:
            root = os.path.join(ctx["assets_root"], f)
            files[f] = sorted(os.path.relpath(os.path.join(dp, fn), root) for dp, _, fns in os.walk(root) for fn in fns)
    if not any(present.values()):
        raise Skip(f"no assets present after fetch attempt ({ctx.get('fetch_error', 'no fetch error')})")
    out = {"present": present, "files": files}
    missing = [f for f, ok in present.items() if not ok]
    if missing:
        # a partial asset set is not a skip: every later stage gates on its own files
        out["partial"] = missing
        out["note"] = "partial asset set: later stages certify what exists; re-run once the rest is fetched"
    return out


def stage_espeak_goldens(ctx) -> dict:
    from smalltts_tpu_torch.text.phonemize import set_backend

    try:
        set_backend("espeak")
    except Exception as exc:
        set_backend("chars")
        raise Skip(f"espeak backend unavailable: {exc}")
    try:
        from smalltts_tpu_torch.text import get_token_ids

        fixtures = os.path.join(ctx["repo_root"], "tests", "fixtures", "golden_sentences.json")
        sentences = json.load(open(fixtures))
        tokens = {s: get_token_ids(s) for s in sentences}
    finally:
        set_backend("chars")
    golden_path = os.path.join(ctx["repo_root"], "tests", "goldens", "espeak_tokens.json")
    if not os.path.exists(golden_path):
        with open(golden_path, "w") as f:
            json.dump(tokens, f, indent=0)
        return {"recorded": len(tokens), "path": golden_path, "note": "first espeak-equipped run: goldens recorded"}
    golden = json.load(open(golden_path))
    # only sentences present in the goldens can drift; new fixture sentences extend them
    drifted = [s for s, got in tokens.items() if s in golden and golden[s] != got]
    if drifted:
        raise AssertionError(f"espeak token streams drifted for {len(drifted)} sentence(s): {drifted[:3]}")
    new_keys = [s for s in tokens if s not in golden]
    if new_keys:
        golden.update({s: tokens[s] for s in new_keys})
        with open(golden_path, "w") as f:
            json.dump(golden, f, indent=0)
    return {"regressed": len(tokens) - len(new_keys), "recorded_new": len(new_keys), "path": golden_path}


def stage_codec_parity(ctx) -> dict:
    import torch

    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec

    enc = os.path.join(ctx["assets_root"], "codec", "encoder.onnx")
    dec = os.path.join(ctx["assets_root"], "codec", "decoder.onnx")
    if not os.path.isfile(dec):
        raise Skip(f"no codec decoder at {dec}")
    dev = _device(ctx)
    codec = OnnxCodec(enc if os.path.isfile(enc) else None, dec, device=dev)
    out: dict = {}
    wav = _sine(2.0)[None, None, :]
    with torch.inference_mode():
        if codec.encoder is not None:
            lat = codec.encode_fn(codec.params, torch.from_numpy(wav).to(dev)).cpu().numpy()
            assert lat.ndim == 3 and lat.shape[0] == 1, lat.shape
            out["latent_shape"] = list(lat.shape)
            out["hop"] = wav.shape[-1] // lat.shape[1]
        else:
            lat = np.random.RandomState(0).randn(1, 15, 64).astype(np.float32)
            out["note"] = "encoder absent: decode-only checks"
        recon = codec.decode_fn(codec.params, torch.from_numpy(lat).to(dev)).cpu().numpy()
    assert np.isfinite(recon).all(), "non-finite decode output"
    out["decode_shape"] = list(recon.shape)
    if codec.encoder is not None:
        from smalltts_tpu_torch.utils import metrics

        ref = wav[0, 0, : recon.shape[-1]]
        got = recon[0, 0, : len(ref)]
        out["roundtrip_mel_distance"] = round(metrics.mel_distance(ref, got), 4)
        out["roundtrip_snr_db"] = round(metrics.snr_db(ref, got), 2)
    try:
        import onnxruntime as ort
    except ImportError:
        out["ort_cross_check"] = "skipped: onnxruntime not installed"
        return out
    sess = ort.InferenceSession(dec)
    want = sess.run(None, {sess.get_inputs()[0].name: np.asarray(lat)})[0]
    np.testing.assert_allclose(recon, want, atol=1e-3, rtol=1e-3)
    out["ort_cross_check"] = "pass"
    return out


def stage_imported_pipeline(ctx) -> dict:
    from smalltts_tpu_torch.onnxtorch.pipeline import ImportedSmallTTS

    root = ctx["assets_root"]
    paths = [os.path.join(root, "dmd", "condition_encoder.onnx"), os.path.join(root, "dmd", "denoiser.onnx"),
             os.path.join(root, "codec", "decoder.onnx")]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        raise Skip(f"published graphs missing: {missing}")
    tts = ImportedSmallTTS(*paths, device=_device(ctx))
    ctx["imported_tts"] = tts

    lat_path = os.path.join(root, "tryme", "latents.npy")
    ref = np.load(lat_path) if os.path.isfile(lat_path) else np.random.RandomState(0).randn(16, 64).astype(np.float32)
    tokens = ctx["tokens"]
    duration = ctx["duration"]
    seq_len = max(1, int(duration * SR / 3200))
    rng = np.random.RandomState(7)
    noises = rng.randn(4, 1, seq_len, 64).astype(np.float32)
    audio = tts.synthesize(ref, tokens, duration, noises=noises)
    assert np.isfinite(audio).all(), "non-finite synthesis output"
    rms = float(np.sqrt(np.mean(audio ** 2)))
    assert rms > 1e-4, f"silent output (rms {rms:.2e})"
    out = {"samples": int(audio.shape[-1]), "rms": round(rms, 4)}
    ctx["imported_audio"] = audio
    ctx["imported_ref"] = ref
    ctx["imported_noises"] = noises

    wav_path = os.path.join(ctx["out_dir"], "certify_imported.wav")
    from smalltts_tpu_torch.serving.audio_io import encode_wav

    with open(wav_path, "wb") as f:
        f.write(encode_wav(audio.reshape(-1), SR))
    out["wav"] = wav_path

    try:
        import onnxruntime as ort
    except ImportError:
        out["ort_cross_check"] = "skipped: onnxruntime not installed"
        return out
    # the reference client's recurrence through onnxruntime, with the same noise
    import torch

    from smalltts_tpu_torch.onnxtorch.pipeline import _rope_freqs
    from smalltts_tpu_torch.ops.schedule import get_alpha_sigma

    cond = ort.InferenceSession(paths[0])
    den = ort.InferenceSession(paths[1])
    dec = ort.InferenceSession(paths[2])
    feed = [ref[None].astype(np.float32), np.array([ref.shape[0]], np.int64), np.array([tokens], np.int64),
            np.ones((1, len(tokens)), bool)]
    names = [i.name for i in cond.get_inputs()]
    kv = cond.run(None, dict(zip(names, feed)))
    rope = _rope_freqs(seq_len)
    mask = np.ones((1, seq_len), bool)
    x_pred = np.zeros((1, seq_len, 64), np.float32)
    dnames = [i.name for i in den.get_inputs()]
    for i, t_val in enumerate(np.linspace(1, 0, 4, dtype=np.float32)):
        a, s = (float(v) for v in get_alpha_sigma(torch.tensor(float(t_val))))
        x_t = (a * x_pred + s * noises[i]).astype(np.float32)
        vel = den.run(None, dict(zip(dnames, [x_t, mask, np.array([t_val], np.float32), kv[0], kv[1], kv[2], kv[3],
                                              kv[4], feed[3], rope])))[0]
        x_pred = (a * x_t - s * vel).astype(np.float32)
    want = dec.run(None, {dec.get_inputs()[0].name: x_pred})[0][0]
    np.testing.assert_allclose(audio, want, atol=2e-3, rtol=2e-3)
    out["ort_cross_check"] = "pass"
    return out


def _import_reference(module: str):
    """A module of the reference's source tree ($SMALLTTS_REFERENCE_SRC), its
    optional dependencies (beartype, phonemizer, inflect) stubbed: the
    lookup the repository's parity tests make, in a copy of its own. Only
    the tree the variable names is read."""
    import importlib
    import types

    src = os.environ.get(REFERENCE_SRC_VAR)
    if not src:
        raise ImportError(f"${REFERENCE_SRC_VAR} is not set")
    if not os.path.isdir(src):
        raise ImportError(f"no reference source tree at ${REFERENCE_SRC_VAR}={src}")
    if "beartype" not in sys.modules:
        beartype = types.ModuleType("beartype")
        beartype.beartype = lambda fn=None, **kw: (fn if fn is not None else (lambda f: f))
        sys.modules["beartype"] = beartype
    if "phonemizer" not in sys.modules:
        phonemizer = types.ModuleType("phonemizer")
        backend = types.ModuleType("phonemizer.backend")
        logger = types.ModuleType("phonemizer.logger")

        class _FakeEspeak:
            def __init__(self, *a, **k):
                pass

            def phonemize(self, texts):
                return ["" for _ in texts]

        backend.EspeakBackend = _FakeEspeak
        logger.get_logger = lambda **k: None
        phonemizer.backend, phonemizer.logger = backend, logger
        sys.modules.update({"phonemizer": phonemizer, "phonemizer.backend": backend, "phonemizer.logger": logger})
    if "inflect" not in sys.modules:
        inflect = types.ModuleType("inflect")

        class _FakeEngine:
            def __getattr__(self, name):
                raise RuntimeError("inflect stub: not usable in oracle mode")

        inflect.engine = lambda: _FakeEngine()
        sys.modules["inflect"] = inflect
    if src not in sys.path:
        sys.path.insert(0, src)
    return importlib.import_module(module)


def stage_checkpoint_parity(ctx) -> dict:
    root = ctx["assets_root"]
    candidates = []
    for sub in ("teacher_checkpoints", "dmd_checkpoints", "dmd"):
        d = os.path.join(root, sub)
        if os.path.isdir(d):
            candidates += sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith((".pt", ".pth", ".bin")))
    ckpt_path = ctx.get("torch_checkpoint") or (candidates[-1] if candidates else None)
    if ckpt_path is None:
        raise Skip("no torch checkpoint under assets/{teacher,dmd}_checkpoints")
    import torch

    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]

    from smalltts_tpu_torch.models.backbone import BackboneConfig, backbone_forward
    from smalltts_tpu_torch.ops import nn
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree
    from smalltts_tpu_torch.utils.convert import params_from_jax
    from smalltts_tpu_torch.utils.torch_convert import (
        clean_state_dict_keys,
        convert_backbone_state_dict,
        state_dict_to_numpy,
    )

    sd_np = clean_state_dict_keys(state_dict_to_numpy(sd))
    n_blocks = ctx.get("n_dit_blocks", 12)
    tree = convert_backbone_state_dict(sd_np, n_dit_blocks=n_blocks)
    out = {"checkpoint": ckpt_path, "params": int(sum(np.size(v) for v in flatten_pytree(tree).values()))}

    # the conversion and a finite fp32 forward are the deployment-side check; the reference's own
    # forward, where its source tree is present, is the oracle
    cfg = ctx.get("backbone_cfg") or BackboneConfig()
    dev = _device(ctx)
    params = map_pytree(lambda x: x.to(dev), params_from_jax(tree, cfg))
    rng = np.random.RandomState(0)
    b, t_len, r, p = 1, 12, 8, 10
    args_np = dict(
        noised=rng.randn(b, t_len, 64).astype(np.float32),
        ref_latents=rng.randn(b, r, 64).astype(np.float32),
        ref_lengths=np.array([r], np.int64),
        mask=np.ones((b, t_len), bool),
        phonemes=rng.randint(1, 190, size=(b, p)).astype(np.int64),
        ph_mask=np.ones((b, p), bool),
        t=np.array([0.4], np.float32),
    )
    with torch.inference_mode(), nn.no_tf32():
        ours = backbone_forward(params, cfg, *(torch.from_numpy(v).to(dev) for v in args_np.values())).cpu().numpy()
    assert np.isfinite(ours).all(), "non-finite converted-backbone output"
    out["forward_rms"] = round(float(np.sqrt(np.mean(ours.astype(np.float64) ** 2))), 6)

    try:
        ref_model_mod = _import_reference("smalltts.models.backbone.model")
    except Exception as exc:
        out["oracle_cross_check"] = f"skipped: reference source unavailable ({exc})"
        return out
    oracle = ctx.get("oracle_model")
    if oracle is None:
        oracle = ref_model_mod.DiTModel(64)
        missing, unexpected = oracle.load_state_dict({k: torch.from_numpy(v) for k, v in sd_np.items()}, strict=False)
        out["oracle_missing_keys"] = len(missing)
        out["oracle_unexpected_keys"] = len(unexpected)
    oracle = oracle.eval()
    with torch.no_grad():
        want = oracle(*(torch.from_numpy(v) for v in args_np.values())).numpy()
    np.testing.assert_allclose(ours, want, rtol=5e-4, atol=5e-4)
    out["oracle_cross_check"] = "pass (rtol 5e-4)"
    return out


def stage_tryme(ctx) -> dict:
    import subprocess

    latents = os.path.join(ctx["assets_root"], "tryme", "latents.npy")
    if not os.path.exists(latents):
        # tryme falls back to random weights without assets and still writes a non-silent wav: a pass
        # there would certify nothing about the assets under test
        raise Skip(f"tryme assets absent ({latents}); the hermetic fallback would false-pass")
    out_wav = os.path.join(ctx["repo_root"], "out", "tryme.wav")
    if os.path.exists(out_wav):
        os.remove(out_wav)
    cmd = [sys.executable, "-m", "smalltts_tpu_torch.scripts.tryme"]
    if ctx.get("device") is not None:
        cmd += ["--device", str(ctx["device"])]
    proc = subprocess.run(cmd + ["Certification test sentence."], capture_output=True, text=True, timeout=1800,
                          cwd=ctx["repo_root"])
    if proc.returncode != 0:
        raise AssertionError(f"tryme failed rc={proc.returncode}: {proc.stderr[-500:]}")
    assert os.path.isfile(out_wav), "out/tryme.wav not written"
    from smalltts_tpu_torch.serving.audio_io import backend

    wav = backend().decode_and_resample(open(out_wav, "rb").read(), SR)
    rms = float(np.sqrt(np.mean(np.square(wav))))
    assert np.isfinite(wav).all() and rms > 1e-4, f"silent tryme output ({rms:.2e})"
    return {"wav": out_wav, "seconds": round(len(wav) / SR, 2), "rms": round(rms, 4)}


def stage_quality(ctx) -> dict:
    if "imported_audio" not in ctx:
        raise Skip("imported_pipeline did not run")
    ckpt = ctx.get("native_checkpoint")
    if ckpt is None:
        d = os.path.join(ctx["assets_root"], "dmd")
        cand = [os.path.join(d, f) for f in (os.listdir(d) if os.path.isdir(d) else []) if f.endswith(".npz")]
        ckpt = cand[-1] if cand else None
    if ckpt is None:
        raise Skip("no converted native checkpoint (assets/dmd/*.npz); run "
                   "python -m smalltts_tpu_torch.scripts.test_checkpoint --convert first")
    from smalltts_tpu_torch.infer.pipeline import SmallTTS
    from smalltts_tpu_torch.utils import metrics

    tts = SmallTTS(checkpoint=ckpt, codec="auto", device=_device(ctx))
    audio_native = tts.synthesize(ctx["imported_ref"], ctx["tokens"], ctx["duration"])[0]
    audio_imported = np.asarray(ctx["imported_audio"]).reshape(-1)
    n = min(len(audio_native.reshape(-1)), len(audio_imported))
    mel = metrics.mel_distance(audio_native.reshape(-1)[:n], audio_imported[:n])
    out = {"mel_distance_native_vs_imported": round(mel, 4), "native_checkpoint": ckpt}
    try:
        sv = metrics.sv_similarity(audio_native.reshape(-1)[:n], audio_imported[:n], tts=tts)
        out["sv_similarity"] = round(float(sv), 4)
    except Exception as exc:
        out["sv_similarity"] = f"unavailable: {exc}"
    threshold = ctx.get("mel_threshold", 2.0)
    assert mel < threshold, f"native pipeline diverges from imported reference graphs (mel {mel:.3f} >= {threshold})"
    return out


STAGES = [
    ("assets", stage_assets),
    ("espeak_goldens", stage_espeak_goldens),
    ("codec_parity", stage_codec_parity),
    ("imported_pipeline", stage_imported_pipeline),
    ("checkpoint_parity", stage_checkpoint_parity),
    ("tryme", stage_tryme),
    ("quality", stage_quality),
]


def run_certification(assets_root="assets", out_path="CERTIFY.json", stages=None, ctx_extra=None,
                      device=None) -> dict:
    """Run the selected stages (all by default) -> the report, also written
    to `out_path`. `ctx_extra` overrides the context's entries (tokens,
    duration, torch_checkpoint, backbone_cfg, ...); `device` is where the
    models run (None: the card)."""
    out_dir = os.path.join(REPO_ROOT, "out")
    os.makedirs(out_dir, exist_ok=True)
    text = "The quick brown fox jumps over the lazy dog."
    from smalltts_tpu_torch.infer.pipeline import estimate_duration
    from smalltts_tpu_torch.text import get_token_ids

    # resolved once and exported: every consumer reads SMALLTTS_ASSETS
    assets_root = os.path.abspath(assets_root)
    os.environ["SMALLTTS_ASSETS"] = assets_root
    ctx = {
        "assets_root": assets_root,
        "repo_root": REPO_ROOT,
        "out_dir": out_dir,
        "tokens": get_token_ids(text),
        "duration": estimate_duration(text),
        "device": device,
    }
    ctx.update(ctx_extra or {})
    selected = {s.strip() for s in (stages or [name for name, _ in STAGES])}
    known = {name for name, _ in STAGES}
    unknown = selected - known
    if unknown:
        # a mistyped --stages must not run nothing and exit 0
        raise SystemExit(f"unknown stage(s) {sorted(unknown)}; available: {sorted(known)}")
    report = {"ts": time.time(), "assets_root": assets_root, "stages": {}}
    for name, fn in STAGES:
        if name not in selected:
            continue
        t0 = time.time()
        entry: dict = {}
        try:
            detail = fn(ctx)
            entry = {"status": "pass", **(detail or {})}
        except Skip as exc:
            entry = {"status": "skip", "reason": str(exc)}
        except Exception as exc:
            entry = {"status": "fail", "error": f"{type(exc).__name__}: {exc}",
                     "traceback": traceback.format_exc()[-2000:]}
        entry["elapsed_s"] = round(time.time() - t0, 2)
        report["stages"][name] = entry
        print(f"[certify] {name}: {entry['status']}"
              + (f" ({entry.get('reason', entry.get('error', ''))})" if entry["status"] != "pass" else ""))
    statuses = [e["status"] for e in report["stages"].values()]
    report["ok"] = "fail" not in statuses
    report["summary"] = (f"{statuses.count('pass')} pass / {statuses.count('skip')} skip / "
                         f"{statuses.count('fail')} fail")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"[certify] {report['summary']} -> {out_path}")
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="real-asset certification")
    ap.add_argument("--assets-root", default=os.environ.get("SMALLTTS_ASSETS", "assets"))
    ap.add_argument("--out", default="CERTIFY.json")
    ap.add_argument("--stages", default=None, help="comma-separated subset (default: all)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    report = run_certification(args.assets_root, args.out, stages=args.stages.split(",") if args.stages else None,
                               device=args.device)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

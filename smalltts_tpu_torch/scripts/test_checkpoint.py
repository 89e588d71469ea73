"""Checkpoint validator: key and shape report, full forward and the cached
split (port of scripts/test_checkpoint.py).

    python -m smalltts_tpu_torch.scripts.test_checkpoint CHECKPOINT [--kind backbone|asr|sv|disc]
        [--convert OUT_NPZ] [--device cuda]

Loads a reference torch checkpoint (.pt/.pth/.bin, converted by
utils.torch_convert) or an npz in the JAX package's layout, and reports the
keys missing, unexpected and of another shape than a fresh model's at the
default configuration (exit code 1 if any key is missing or mismatched).
Then, on the device, a backbone checkpoint runs the full forward with
return_features and the cached split (encode_conditions + denoise_step),
which must agree with it to 1e-4; a sidecar (the distiller's asr/sv/disc)
runs its forward. `--convert` writes a backbone checkpoint as an npz with
its architecture (config_io.backbone_meta), which SmallTTS(checkpoint=...)
configures itself from.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load_sidecar(path: str, convert):
    from smalltts_tpu_torch.utils import checkpoint as ckpt

    if ckpt.is_torch_checkpoint(path):
        import torch

        from smalltts_tpu_torch.utils.torch_convert import state_dict_to_numpy

        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return convert(state_dict_to_numpy(sd))
    return ckpt.load_pytree(path)


def default_config(kind: str):
    """The configuration a checkpoint of `kind` is held against: the model's default."""
    if kind == "backbone":
        from smalltts_tpu_torch.models.backbone import BackboneConfig as cls
    elif kind == "asr":
        from smalltts_tpu_torch.models.asr import ASRConfig as cls
    elif kind == "sv":
        from smalltts_tpu_torch.models.sv import SVConfig as cls
    elif kind == "disc":
        from smalltts_tpu_torch.models.discriminator import DiscriminatorConfig as cls
    else:
        raise ValueError(kind)
    return cls()


def reference_shapes(init, cfg, device) -> dict:
    """{flat key: shape} of a fresh model at `cfg`, in the JAX package's
    layout (utils.convert.params_to_jax), the layout checkpoints hold."""
    import torch

    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree
    from smalltts_tpu_torch.utils.convert import params_to_jax

    gen = torch.Generator(device=device).manual_seed(0)
    tree = params_to_jax(init(gen, cfg, device=device), cfg)
    return {k: tuple(v.shape) for k, v in flatten_pytree(tree).items()}


def diff(ref_shapes: dict, got_flat: dict, ignore: str = None):
    """(missing, unexpected, mismatched) keys, each sorted; unexpected keys
    holding `ignore` are left out."""
    missing = sorted(set(ref_shapes) - set(got_flat))
    unexpected = sorted(k for k in set(got_flat) - set(ref_shapes) if not (ignore and ignore in k))
    mismatched = sorted(k for k in set(ref_shapes) & set(got_flat)
                        if tuple(ref_shapes[k]) != tuple(np.shape(got_flat[k])))
    return missing, unexpected, mismatched


def _validate_sidecar(kind: str, path: str, device) -> int:
    """Key/shape diff and a forward of a distiller sidecar (the ASR, SV and
    discriminator checkpoints saved beside the student)."""
    import torch

    from smalltts_tpu_torch.utils import torch_convert as tc
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree
    from smalltts_tpu_torch.utils.convert import params_from_jax

    rng = np.random.RandomState(0)
    cfg = default_config(kind)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    if kind == "asr":
        from smalltts_tpu_torch.models.asr import asr_forward, init_asr

        convert, init = tc.convert_asr_state_dict, init_asr
        fwd = lambda p: asr_forward(p, cfg, t(rng.randn(2, 12, 64)), t([12, 8], torch.int32))[0]  # noqa: E731
    elif kind == "sv":
        from smalltts_tpu_torch.models.sv import init_sv, sv_forward

        convert, init = tc.convert_sv_state_dict, init_sv
        fwd = lambda p: sv_forward(p, cfg, t(rng.randn(2, 20, 64)), t([20, 11], torch.int32))[0]  # noqa: E731
    elif kind == "disc":
        from smalltts_tpu_torch.models.discriminator import discriminator_forward, init_discriminator

        convert, init = tc.convert_discriminator_state_dict, init_discriminator
        fwd = lambda p: discriminator_forward(  # noqa: E731
            p, cfg, t(rng.randn(2, 3, 10, cfg.transformer_dim)), t(rng.randn(2, 10, cfg.latent_dim)),
            t(rng.randn(2, 6, cfg.ref_dim)), t(np.ones((2, 6)), torch.bool), t(np.ones((2, 10)), torch.bool),
            t(rng.randint(1, cfg.vocab, (2, 5)), torch.int64), t([0.3, 0.8]))[0]
    else:
        raise ValueError(kind)

    ref = reference_shapes(init, cfg, device)
    params = _load_sidecar(path, convert)
    # a converted speechbrain SV carries the ASP TDNN's batchnorm as an extra
    missing, unexpected, mismatched = diff(ref, flatten_pytree(params), ignore="attn_tdnn_bn")
    print(f"{kind}: missing {len(missing)}, unexpected {len(unexpected)}, "
          f"shape mismatches {len(mismatched)}")
    for k in (missing + unexpected + mismatched)[:20]:
        print(f"  ! {k}")
    if missing or mismatched:
        return 1
    with torch.no_grad():
        out = fwd(map_pytree(lambda x: x.to(device), params_from_jax(params, cfg)))
    assert bool(torch.isfinite(out).all()), f"{kind} forward produced non-finite"
    print(f"{kind} forward OK: {tuple(out.shape)}")
    print("checkpoint valid")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Validate a checkpoint against the default configuration.")
    ap.add_argument("checkpoint", help=".pt torch state_dict or .npz pytree")
    ap.add_argument("--kind", default="backbone",
                    choices=["backbone", "asr", "sv", "disc"],
                    help="which model family the checkpoint belongs to "
                         "(dmd_checkpoints sidecars: asr/sv/disc)")
    ap.add_argument("--convert", metavar="OUT_NPZ", default=None,
                    help="after validation, write the converted params as a "
                         "native .npz WITH embedded architecture metadata "
                         "(utils/config_io.backbone_meta), the file "
                         "SmallTTS(checkpoint=...) configures itself from "
                         "(backbone checkpoints only)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    from smalltts_tpu_torch.utils.transfer import resolve_device

    device = resolve_device(args.device)
    if args.kind != "backbone":
        if args.convert:
            print("--convert supports backbone checkpoints only (sidecars carry no config metadata)",
                  file=sys.stderr)
            return 1
        return _validate_sidecar(args.kind, args.checkpoint, device)

    import torch

    from smalltts_tpu_torch.models.backbone import backbone_forward, denoise_step, encode_conditions, init_backbone
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.checkpoint import flatten_pytree, map_pytree
    from smalltts_tpu_torch.utils.convert import params_from_jax

    cfg = default_config("backbone")
    ref = reference_shapes(init_backbone, cfg, device)
    if ckpt.is_torch_checkpoint(args.checkpoint):
        params = ckpt.load_reference_backbone_checkpoint(args.checkpoint)
    else:
        params = ckpt.load_pytree(args.checkpoint)
    got_flat = flatten_pytree(params)

    missing, unexpected, mismatched = diff(ref, got_flat)
    print(f"missing keys: {len(missing)}")
    for k in missing[:20]:
        print(f"  - {k}")
    print(f"unexpected keys: {len(unexpected)}")
    for k in unexpected[:20]:
        print(f"  + {k}")
    print(f"shape mismatches: {len(mismatched)}")
    for k in mismatched[:20]:
        print(f"  ! {k}: expected {ref[k]}, got {np.shape(got_flat[k])}")
    if missing or mismatched:
        return 1

    p = map_pytree(lambda x: x.to(device=device, dtype=torch.float32) if x.is_floating_point() else x.to(device),
                   params_from_jax(params, cfg))
    rng = np.random.RandomState(0)
    b, t_len, r, n_ph = 2, 24, 12, 16

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    noised = t(rng.randn(b, t_len, 64))
    ref_lat = t(rng.randn(b, r, 64))
    ref_lens = t([r, r // 2], torch.int32)
    mask = torch.ones((b, t_len), dtype=torch.bool, device=device)
    phonemes = t(rng.randint(1, cfg.vocab_size, (b, n_ph)), torch.int64)
    ph_mask = torch.ones((b, n_ph), dtype=torch.bool, device=device)
    tt = t([0.4, 0.9])

    with torch.no_grad():
        vel, feats = backbone_forward(p, cfg, noised, ref_lat, ref_lens, mask, phonemes, ph_mask, tt,
                                      return_features=True)
        assert tuple(vel.shape) == (b, t_len, 64), vel.shape
        assert tuple(feats.shape) == (b, cfg.dit.n_blocks, t_len, cfg.hidden_dim), feats.shape
        print(f"full forward OK: velocity {tuple(vel.shape)}, features {tuple(feats.shape)}")

        cond = encode_conditions(p, cfg, ref_lat, ref_lens, phonemes, ph_mask)
        vel_cached = denoise_step(p, cfg, noised, mask, tt, cond)
    err = float((vel_cached - vel).abs().max())
    assert err < 1e-4, f"cached path diverges from full forward: {err}"
    print(f"cached-inference path OK (max |diff| = {err:.2e})")
    print("checkpoint valid")

    if args.convert:
        from smalltts_tpu_torch.utils.config_io import backbone_meta

        ckpt.save_pytree(args.convert, params, meta=backbone_meta(cfg))
        print(f"converted -> {args.convert} (with embedded config metadata)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

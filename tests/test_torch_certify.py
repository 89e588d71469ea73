"""The port's certification harness (smalltts_tpu_torch/scripts/certify.py)
against the root script's run_certification, on the same tiny fixture tree,
on the CPU.

The tree is the port's own export (onnxtorch.export) of a tiny seeded
backbone and codec with the published I/O contracts: assets/codec/
{encoder,decoder}.onnx, assets/dmd/{condition_encoder,denoiser}.onnx, the
same backbone as assets/dmd/student_latest.npz (JAX layout, backbone_meta)
and as a reference-layout .pt (utils/torch_convert.backbone_state_dict),
and assets/tryme/latents.npy. huggingface_hub is blocked in every run
(nothing is fetched).

Held equal between the packages, stage by stage: the status; latent_shape,
hop, decode_shape and samples exactly; the codec round trip's mel distance
and SNR within 1e-3 relative (plus the report's rounding); the imported
pipeline's audio within 2e-5 absolute / 1e-4 relative
(test_imported_smalltts_equals_jax's bound); checkpoint_parity's
forward_rms within 1e-5 relative (plus the report's rounding to 6
decimals); the quality stage's speaker cosine within 1e-3 on the same
random-init SV weights; checkpoint_parity's oracle skipped with its reason
(the port's with $SMALLTTS_REFERENCE_SRC unset, and the port's lookup reads
no other tree). The no-asset, unknown stage, corrupt decoder and
partial-then-complete runs, and tryme's skip.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu_torch.scripts import certify  # noqa: E402

# the root script, loaded from its file (the scripts directory on sys.path would shadow modules such as profile)
_spec = importlib.util.spec_from_file_location(
    "root_certify", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "certify.py"))
jcertify = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jcertify)
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402

PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))
SEQ, REF_T, PH_P = 16, 11, 13
FIX = {"tokens": [5] * PH_P, "duration": SEQ * 3200 / 24000}  # int(d * 24000 / 3200) == SEQ
STAGES = ["assets", "espeak_goldens", "codec_parity", "imported_pipeline", "checkpoint_parity", "quality"]


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No download in any run: ensure_assets sees no huggingface_hub; one
    intra-op thread for the tiny models."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _export_codec(root, cp):
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export

    os.makedirs(os.path.join(root, "codec"), exist_ok=True)
    hop = PCODEC.hop
    for name, module, example, axes in (
            ("encoder", CodecEncoder(cp, PCODEC), torch.zeros((1, 1, 4 * hop)), {0: "b", 2: "t"}),
            ("decoder", CodecDecoder(cp, PCODEC), torch.zeros((1, 4, 64)), {0: "b", 1: "t"})):
        with open(os.path.join(root, "codec", f"{name}.onnx"), "wb") as f:
            f.write(export(module, (example,), dynamic_axes={"x": axes}, input_names=["x"]))


def _export_dmd_and_rest(root, bp):
    from smalltts_tpu_torch.onnxtorch.export import ConditionEncoder, Denoiser, export
    from smalltts_tpu_torch.onnxtorch.pipeline import _rope_freqs
    from smalltts_tpu_torch.utils import checkpoint as ckpt
    from smalltts_tpu_torch.utils.config_io import backbone_meta
    from smalltts_tpu_torch.utils.convert import params_to_jax

    os.makedirs(os.path.join(root, "dmd"), exist_ok=True)
    os.makedirs(os.path.join(root, "tryme"), exist_ok=True)
    cond, den = ConditionEncoder(bp, PCFG), Denoiser(bp, PCFG)
    mask_p = torch.ones((1, PH_P), dtype=torch.bool)
    cargs = (torch.zeros((1, REF_T, 64)), torch.tensor([REF_T]), torch.tensor([FIX["tokens"]]), mask_p)
    with torch.no_grad():
        kv = cond(*cargs)
    dargs = (torch.zeros((1, SEQ, 64)), torch.ones((1, SEQ), dtype=torch.bool), torch.tensor([0.5]), *kv, mask_p,
             torch.from_numpy(_rope_freqs(SEQ)))
    for name, module, example in (("condition_encoder", cond, cargs), ("denoiser", den, dargs)):
        with open(os.path.join(root, "dmd", f"{name}.onnx"), "wb") as f:
            f.write(export(module, example))
    ckpt.save_pytree(os.path.join(root, "dmd", "student_latest.npz"), params_to_jax(bp), meta=backbone_meta(PCFG))
    np.save(os.path.join(root, "tryme", "latents.npy"), np.random.RandomState(0).randn(REF_T, 64).astype(np.float32))


@pytest.fixture(scope="module")
def weights():
    from smalltts_tpu_torch.models.backbone import init_backbone, redraw_zero_init
    from smalltts_tpu_torch.models.codec import init_codec

    g = torch.Generator().manual_seed(0)
    return redraw_zero_init(init_backbone(g, PCFG), g), init_codec(g, PCODEC)


@pytest.fixture(scope="module")
def tree(weights, tmp_path_factory):
    """The full fixture tree, and the reference-layout .pt beside it."""
    from smalltts_tpu_torch.utils.convert import params_to_jax
    from smalltts_tpu_torch.utils.torch_convert import backbone_state_dict

    bp, cp = weights
    root = str(tmp_path_factory.mktemp("certify") / "assets")
    _export_codec(root, cp)
    _export_dmd_and_rest(root, bp)
    pt = os.path.join(os.path.dirname(root), "teacher.pt")
    torch.save(backbone_state_dict(params_to_jax(bp)), pt)
    return root, pt


def _recording(mod, mp, ctxs):
    """Wrap `mod`'s imported_pipeline stage to keep its context (the audio it made)."""
    def wrap(name, fn):
        def stage(ctx):
            ctxs.append(ctx)
            return fn(ctx)

        return (name, stage if name == "imported_pipeline" else fn)

    mp.setattr(mod, "STAGES", [wrap(n, f) for n, f in mod.STAGES])


@pytest.fixture(scope="module")
def both_reports(tree, tmp_path_factory):
    """One run of each package on the full tree (every stage but tryme),
    and the imported pipeline's audio from each."""
    root, pt = tree
    out = tmp_path_factory.mktemp("reports")
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "huggingface_hub", None)
    mp.delenv(certify.REFERENCE_SRC_VAR, raising=False)  # the port's oracle skips, wherever the checkout lies
    jctx, pctx = [], []
    from smalltts_tpu.models import backbone
    from smalltts_tpu.models import sv as jsv

    from smalltts_tpu_torch.models import sv as psv
    from smalltts_tpu_torch.utils.convert import params_to_jax

    # checkpoint_parity's eager JAX forward, jitted: the same function, one compile instead of one an op
    mp.setattr(backbone, "backbone_forward", jax.jit(backbone.backbone_forward, static_argnums=1))
    # the quality stage's random-init SV model: the port's seed-0 init (as the port's stage draws it) in the JAX
    # layout, in place of JAX's eager init (a compile a layer), so that both stages embed with the same weights;
    # its forward jitted
    sv_cfg = psv.SVConfig()
    sv_tree = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                           params_to_jax(psv.init_sv(torch.Generator().manual_seed(0), sv_cfg), sv_cfg))
    mp.setattr(jsv, "init_sv", lambda key, cfg=None, dtype=None: sv_tree)
    mp.setattr(jsv, "sv_forward", jax.jit(jsv.sv_forward, static_argnums=(1, 4)))
    _recording(jcertify, mp, jctx)
    _recording(certify, mp, pctx)
    try:
        want = jcertify.run_certification(root, str(out / "jax.json"), stages=STAGES,
                                          ctx_extra={**FIX, "torch_checkpoint": pt, "backbone_cfg": TINY_BACKBONE,
                                                     "n_dit_blocks": TINY_BACKBONE.dit.n_blocks})
        got = certify.run_certification(root, str(out / "port.json"), stages=STAGES, device="cpu",
                                        ctx_extra={**FIX, "torch_checkpoint": pt, "backbone_cfg": PCFG,
                                                   "n_dit_blocks": PCFG.dit.n_blocks})
    finally:
        mp.undo()
    return want, got, jctx[0]["imported_audio"], pctx[0]["imported_audio"]


def test_stages_and_report_layout_equal_jax():
    assert [n for n, _ in certify.STAGES] == [n for n, _ in jcertify.STAGES]
    assert issubclass(certify.Skip, Exception)


def test_full_tree_statuses_and_values_equal_jax(both_reports):
    want, got, _, _ = both_reports
    ws, gs = want["stages"], got["stages"]
    assert list(gs) == list(ws) == STAGES
    assert {k: v["status"] for k, v in gs.items()} == {k: v["status"] for k, v in ws.items()}, (ws, gs)
    assert gs["assets"]["status"] == "pass" and "partial" not in gs["assets"]
    assert gs["assets"]["files"] == ws["assets"]["files"]
    assert gs["espeak_goldens"]["status"] == "skip" and gs["quality"]["status"] == "pass"
    for key in ("latent_shape", "hop", "decode_shape"):
        assert gs["codec_parity"][key] == ws["codec_parity"][key], key
    for key, rounding in (("roundtrip_mel_distance", 1e-4), ("roundtrip_snr_db", 1e-2)):  # the report's rounding
        assert abs(gs["codec_parity"][key] - ws["codec_parity"][key]) <= 1e-3 * abs(ws["codec_parity"][key]) + rounding
    assert gs["imported_pipeline"]["status"] == "pass", gs["imported_pipeline"]
    assert gs["imported_pipeline"]["samples"] == ws["imported_pipeline"]["samples"] == SEQ * PCODEC.hop
    assert gs["imported_pipeline"]["ort_cross_check"] == ws["imported_pipeline"]["ort_cross_check"]
    cp, cw = gs["checkpoint_parity"], ws["checkpoint_parity"]
    assert cp["status"] == "pass" and cp["params"] == cw["params"]
    assert abs(cp["forward_rms"] - cw["forward_rms"]) <= 1e-5 * cw["forward_rms"] + 1e-6
    assert cp["oracle_cross_check"].startswith("skipped: reference source unavailable")
    assert cw["oracle_cross_check"].startswith("skipped: reference source unavailable")
    assert got["ok"] == want["ok"] and got["summary"] == want["summary"]
    # the same random-init SV weights in both (the fixture's): the speaker cosines of the two native-vs-imported
    # pairs agree within 1e-3 (the report's rounding is 1e-4); the mel readings are not compared: each quality
    # stage draws its own noise
    assert abs(gs["quality"]["sv_similarity"] - ws["quality"]["sv_similarity"]) <= 1e-3
    assert os.path.isfile(gs["imported_pipeline"]["wav"])


def test_imported_audio_equals_jax(both_reports):
    """The imported pipeline stage's audio (RandomState(7) noises) against
    the JAX stage's: 2e-5 absolute, 1e-4 relative."""
    _, _, want, got = both_reports
    assert got.shape == want.shape == (1, SEQ * PCODEC.hop) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


def test_no_assets_all_skip_and_exit_zero(tmp_path, monkeypatch):
    stages = [n for n, _ in certify.STAGES]
    got = certify.run_certification(str(tmp_path / "assets"), str(tmp_path / "port.json"), device="cpu")
    want = jcertify.run_certification(str(tmp_path / "assets"), str(tmp_path / "jax.json"))
    assert {k: v["status"] for k, v in got["stages"].items()} == {k: v["status"] for k, v in want["stages"].items()}
    assert set(got["stages"]) == set(stages) and {v["status"] for v in got["stages"].values()} == {"skip"}
    assert got["ok"] is True and json.load(open(tmp_path / "port.json"))["summary"] == "0 pass / 7 skip / 0 fail"
    assert "huggingface_hub is unavailable" in got["stages"]["assets"]["reason"]
    assert certify.main(["--assets-root", str(tmp_path / "assets"), "--out", str(tmp_path / "main.json"),
                         "--device", "cpu"]) == 0


def test_unknown_stage_exits(tmp_path):
    with pytest.raises(SystemExit, match="unknown stage"):
        jcertify.run_certification(str(tmp_path), str(tmp_path / "j.json"), stages=["codec_parity", "nope"])
    with pytest.raises(SystemExit, match="unknown stage"):
        certify.run_certification(str(tmp_path), str(tmp_path / "p.json"), stages=["codec_parity", "nope"],
                                  device="cpu")


def test_corrupt_decoder_fails_and_exits_one(tmp_path):
    assets = tmp_path / "assets"
    (assets / "codec").mkdir(parents=True)
    (assets / "codec" / "decoder.onnx").write_bytes(b"not a model")
    want = jcertify.run_certification(str(assets), str(tmp_path / "j.json"), stages=["codec_parity"])
    got = certify.run_certification(str(assets), str(tmp_path / "p.json"), stages=["codec_parity"], device="cpu")
    for r in (want, got):
        assert r["stages"]["codec_parity"]["status"] == "fail" and "error" in r["stages"]["codec_parity"]
        assert r["ok"] is False
    assert certify.main(["--assets-root", str(assets), "--out", str(tmp_path / "m.json"), "--stages", "codec_parity",
                         "--device", "cpu"]) == 1


def test_partial_assets_then_reentrant(tree, tmp_path):
    """With only the codec present the codec stage certifies and the rest
    skip; once the dmd graphs and tryme latents land, a re-run flips
    imported_pipeline to pass and codec_parity passes again."""
    root, _ = tree
    assets = tmp_path / "assets"
    shutil.copytree(os.path.join(root, "codec"), assets / "codec")
    stages = ["assets", "codec_parity", "imported_pipeline", "quality"]
    r1 = certify.run_certification(str(assets), str(tmp_path / "c1.json"), stages=stages, ctx_extra=FIX,
                                   device="cpu")
    st = r1["stages"]
    assert st["assets"]["status"] == "pass" and sorted(st["assets"]["partial"]) == ["dmd", "tryme"]
    assert st["codec_parity"]["status"] == "pass"
    assert st["imported_pipeline"]["status"] == "skip" and st["quality"]["status"] == "skip"
    assert r1["ok"] is True
    for sub in ("dmd", "tryme"):
        shutil.copytree(os.path.join(root, sub), assets / sub)
    r2 = certify.run_certification(str(assets), str(tmp_path / "c2.json"), stages=stages[:3], ctx_extra=FIX,
                                   device="cpu")
    st2 = r2["stages"]
    assert st2["assets"]["status"] == "pass" and "partial" not in st2["assets"]
    assert st2["codec_parity"]["status"] == "pass"
    assert st2["imported_pipeline"]["status"] == "pass", st2["imported_pipeline"]


def test_tryme_skips_without_latents(tmp_path):
    for run in (lambda o: jcertify.run_certification(str(tmp_path), o, stages=["tryme"]),
                lambda o: certify.run_certification(str(tmp_path), o, stages=["tryme"], device="cpu")):
        st = run(str(tmp_path / "t.json"))["stages"]["tryme"]
        assert st["status"] == "skip" and "hermetic fallback would false-pass" in st["reason"]


def test_oracle_reads_only_the_tree_its_variable_names(tmp_path, monkeypatch):
    """checkpoint_parity's oracle lookup reads $SMALLTTS_REFERENCE_SRC and
    nothing else: unset, it raises before touching sys.path; set, the module
    comes from that tree."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    path0, before = list(sys.path), set(sys.modules)
    monkeypatch.delenv(certify.REFERENCE_SRC_VAR, raising=False)
    try:
        with pytest.raises(ImportError, match="is not set"):
            certify._import_reference("smalltts.models.backbone.model")
        assert sys.path == path0
        monkeypatch.setenv(certify.REFERENCE_SRC_VAR, str(tmp_path / "absent"))
        with pytest.raises(ImportError, match="no reference source tree"):
            certify._import_reference("smalltts.models.backbone.model")
        src = tmp_path / "src"
        src.mkdir()
        (src / "oracle_probe_tree.py").write_text("WHERE = 'the named tree'\n")
        monkeypatch.setenv(certify.REFERENCE_SRC_VAR, str(src))
        assert certify._import_reference("oracle_probe_tree").WHERE == "the named tree"
        assert sys.path[0] == str(src)
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]

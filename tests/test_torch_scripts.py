"""The port's script entry points (smalltts_tpu_torch/scripts) against the
root scripts/ that drive the JAX package, on the CPU at tiny sizes.

- Flags: each module has every add_argument flag of its root script, plus
  --device where it runs a model (phonemize and test_x402 run none).
- phonemize: the same JSON line as the JAX package's get_token_ids.
- clone, interactive, batch, tryme: on a tiny checkpoint carrying
  backbone_meta, with the pipeline's codec config patched to the tiny
  codec. The JAX scripts run against a recording stub of their SmallTTS
  (and Batcher): the tokens (transcription prepended) and durations each
  script passes, and batch's file names, equal theirs; every wav the port
  wrote equals, bit for bit, what a fresh port pipeline on the same seed
  makes of the same inputs.
- test_checkpoint: for each --kind at a tiny configuration (the default
  config patched in both packages), on a complete npz, one with a key
  dropped and one with a leaf's shape changed: the missing, unexpected and
  mismatched lists and the exit code equal the JAX script's; --convert
  round-trips through SmallTTS(checkpoint=..., device="cpu").
- import_codec: on a mini codec exported by onnxtorch.export, the saved
  initializers equal the JAX OnnxCodec's, the round trip's latents agree
  within 1e-5, and a missing graph exits 1.
- test_x402: the client against the port's TTSServer around a stub, in
  trust mode without a key and in local mode with a fixed key; the port's
  signed payment is accepted by the JAX package's server in local mode.
- demo_quality_loop: 2 steps a stage give the JAX script's summary keys,
  all finite; from weights carried across from JAX, the script's ASR greedy
  decode and SV teacher cosine equal the JAX script's computation (1e-5).
"""

import ast
import asyncio
import base64
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, "tests")
from tiny import TINY_BACKBONE, TINY_CODEC  # noqa: E402

from smalltts_tpu.utils import checkpoint as jckpt  # noqa: E402
from smalltts_tpu.utils import config_io as jcio  # noqa: E402
from smalltts_tpu_torch.infer import pipeline  # noqa: E402
from smalltts_tpu_torch.models import backbone as PB  # noqa: E402
from smalltts_tpu_torch.scripts import demo_quality_loop as demo  # noqa: E402
from smalltts_tpu_torch.serving.audio_io import decode_wav, encode_wav  # noqa: E402
from smalltts_tpu_torch.utils.config_io import backbone_config_from_dict, codec_config_from_dict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["phonemize", "clone", "interactive", "batch", "tryme", "test_checkpoint", "import_codec", "test_x402",
           "bench_serving", "demo_quality_loop"]
NO_DEVICE = {"phonemize", "test_x402"}  # host only: they run no model
PCFG = backbone_config_from_dict(dataclasses.asdict(TINY_BACKBONE))
PCODEC = codec_config_from_dict(dataclasses.asdict(TINY_CODEC))


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny models' many small ops, one intra-op thread each: beside
    other test workers a pool of threads a process costs far more than it
    saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def flags(path):
    """The option strings (and positional names) of every add_argument call in a file."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return out


def load_root(name):
    """A root script as a module (its imports run when main() is called)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_root(monkeypatch, name, argv):
    """main() of a root script under `argv`; its exit code."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(argv))
    try:
        rc = load_root(name).main()
    except SystemExit as e:
        rc = e.code
    return 0 if rc is None else rc


@pytest.mark.parametrize("name", SCRIPTS)
def test_flags_are_the_root_scripts_plus_device(name):
    import importlib

    mod = importlib.import_module(f"smalltts_tpu_torch.scripts.{name}")
    assert callable(mod.main)
    want = flags(os.path.join(ROOT, "scripts", f"{name}.py"))
    if name not in NO_DEVICE and name != "tryme":  # tryme's bare argv takes --device by hand, below
        want |= {"--device"}
    assert flags(mod.__file__) == want


@pytest.mark.parametrize("name", ["phonemize", "tryme", "test_x402"])
def test_bare_argv_help_touches_nothing(name, tmp_path, monkeypatch, capsys):
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SERVER_URL", "http://127.0.0.1:9")  # nothing listens: a dial would fail
    assert importlib.import_module(f"smalltts_tpu_torch.scripts.{name}").main(["--help"]) == 0
    usage = [line for line in capsys.readouterr().out.splitlines() if line.startswith("usage:")]
    assert len(usage) == 1 and ("--device" in usage[0]) == (name == "tryme")
    assert os.listdir(tmp_path) == []


def test_tryme_device_without_a_value_is_a_usage_error(tmp_path, monkeypatch, capsys):
    from smalltts_tpu_torch.scripts import tryme

    monkeypatch.chdir(tmp_path)
    assert tryme.main(["hello", "--device"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("usage:") and "--device needs a value" in err
    assert os.listdir(tmp_path) == []


def test_phonemize_prints_the_jax_token_ids():
    from smalltts_tpu.text import get_token_ids

    text = ["Hello", "world,", "it's", "2024!"]
    res = subprocess.run([sys.executable, "-m", "smalltts_tpu_torch.scripts.phonemize", *text], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == json.dumps(get_token_ids(" ".join(text))) + "\n"


# --------------------------------------------------------------- served scripts


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from smalltts_tpu_torch.utils.convert import params_to_jax

    d = tmp_path_factory.mktemp("tiny_backbone")
    params = PB.redraw_zero_init(PB.init_backbone(torch.Generator().manual_seed(0), PCFG),
                                 torch.Generator().manual_seed(1))
    jckpt.save_pytree(str(d / "backbone.npz"), jax.tree.map(np.asarray, params_to_jax(params)),
                      meta=jcio.backbone_meta(TINY_BACKBONE))
    return str(d / "backbone.npz")


def sine_wav(path, seconds, freq):
    t = np.arange(int(seconds * 24_000)) / 24_000
    with open(path, "wb") as f:
        f.write(encode_wav((0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32), 24_000))


@pytest.fixture
def port_tts(monkeypatch):
    """The port's SmallTTS with the tiny codec, recording each synthesize
    call's (ref latents, tokens, duration) and each synthesize_padded call's
    inputs and output; returns (calls, padded calls, the unpatched class)."""
    monkeypatch.setattr(pipeline, "CodecConfig", lambda: PCODEC)
    monkeypatch.setattr(pipeline, "BackboneConfig", lambda: PCFG)  # tryme's random-weights pipeline
    calls, padded = [], []
    base = pipeline.SmallTTS

    class Recording(base):
        def synthesize(self, ref_latents, phoneme_ids, duration_sec, noises=None):
            calls.append((np.array(ref_latents), list(phoneme_ids), duration_sec))
            return super().synthesize(ref_latents, phoneme_ids, duration_sec, noises)

        def synthesize_padded(self, *args, **kw):
            out = super().synthesize_padded(*args, **kw)
            padded.append(([np.array(a) for a in args[:5]] + [args[5]], np.array(out)))
            return out

    monkeypatch.setattr(pipeline, "SmallTTS", Recording)
    return calls, padded, base


@pytest.fixture
def jax_tts(monkeypatch):
    """A recording stub in place of the JAX package's SmallTTS and Batcher:
    the JAX scripts run their host logic with no model."""
    from concurrent.futures import Future

    from smalltts_tpu.infer import pipeline as jpipe
    from smalltts_tpu.serving import batcher as jbatcher

    calls = []  # (None, tokens, duration) of each synthesize call

    class Stub:
        def __init__(self, *a, **k):
            pass

        def encode_reference(self, audio):
            return np.zeros((max(1, len(audio) // 3200), 64), np.float32)

        def synthesize(self, ref_latents, phoneme_ids, duration_sec):
            calls.append((None, list(phoneme_ids), duration_sec))
            return np.zeros((1, int(duration_sec * 24_000)), np.float32)

    class StubBatcher:
        def __init__(self, tts, **k):
            self.tts = tts

        def submit(self, ref, tokens, duration):
            fut = Future()
            fut.set_result(self.tts.synthesize(ref, tokens, duration))
            return fut

        def close(self):
            pass

    monkeypatch.setattr(jpipe, "SmallTTS", Stub)
    monkeypatch.setattr(jbatcher, "Batcher", StubBatcher)
    return calls


def replay(base, ckpt, calls, out_files):
    """A fresh port pipeline on the same seed synthesizes the recorded
    inputs in order; each result's wav equals the file written."""
    fresh = base(checkpoint=ckpt, device="cpu")
    assert len(calls) == len(out_files)
    for (ref, tokens, duration), path in zip(calls, out_files):
        audio = fresh.synthesize(ref, tokens, duration)
        assert open(path, "rb").read() == encode_wav(audio.reshape(-1), 24_000)


def test_clone_matches_the_jax_script(tiny_ckpt, port_tts, jax_tts, tmp_path, monkeypatch):
    from smalltts_tpu_torch.scripts import clone

    calls, _, base = port_tts
    sine_wav(tmp_path / "ref.wav", 1.3, 220.0)
    common = ["--wav", str(tmp_path / "ref.wav"), "--text", "Hello there, friend.", "--transcription",
              "A short reference.", "--checkpoint", tiny_ckpt]
    assert clone.main(common + ["--out", str(tmp_path / "port.wav"), "--device", "cpu"]) == 0
    assert run_root(monkeypatch, "clone", common + ["--out", str(tmp_path / "jax.wav")]) == 0
    assert [c[1:] for c in calls] == [c[1:] for c in jax_tts]
    fresh = base(checkpoint=tiny_ckpt, device="cpu")
    np.testing.assert_array_equal(calls[0][0], fresh.encode_reference(clone.load_audio(str(tmp_path / "ref.wav"))))
    replay(base, tiny_ckpt, calls, [tmp_path / "port.wav"])


def test_interactive_matches_the_jax_script(tiny_ckpt, port_tts, jax_tts, tmp_path, monkeypatch, capsys):
    from smalltts_tpu_torch.scripts import interactive

    calls, _, base = port_tts
    monkeypatch.chdir(tmp_path)  # no assets/tryme: RandomState(0) latents
    lines = "Good morning.\n\nHow are you today?\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    assert interactive.main(["--checkpoint", tiny_ckpt, "--out-dir", "port", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("rtf") == 2 and "port/interactive_1.wav" in out
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    assert run_root(monkeypatch, "interactive", ["--checkpoint", tiny_ckpt, "--out-dir", "jax"]) == 0
    assert [c[1:] for c in calls] == [c[1:] for c in jax_tts]
    np.testing.assert_array_equal(calls[0][0], np.random.RandomState(0).randn(16, 64).astype(np.float32))
    replay(base, tiny_ckpt, calls, [tmp_path / "port" / f"interactive_{i}.wav" for i in range(2)])


def test_batch_matches_the_jax_script(tiny_ckpt, port_tts, jax_tts, tmp_path, monkeypatch):
    from smalltts_tpu_torch.scripts import batch
    from smalltts_tpu_torch.serving import batcher as pbatcher

    calls, padded, base = port_tts
    submits = []

    class Recording(pbatcher.Batcher):
        def submit(self, ref_latents, token_ids, duration_sec):
            submits.append((list(token_ids), duration_sec))
            return super().submit(ref_latents, token_ids, duration_sec)

    monkeypatch.setattr(pbatcher, "Batcher", Recording)
    sine_wav(tmp_path / "a.wav", 1.0, 200.0)
    sine_wav(tmp_path / "b.wav", 2.2, 310.0)
    (tmp_path / "transcriptions.json").write_text(json.dumps({"a.wav": "first voice", "b.wav": "second one"}))
    manifest = str(tmp_path / "transcriptions.json")
    assert batch.main(["--manifest", manifest, "--out", str(tmp_path / "port"), "--checkpoint", tiny_ckpt,
                       "--device", "cpu"]) == 0
    assert run_root(monkeypatch, "batch", ["--manifest", manifest, "--out", str(tmp_path / "jax"),
                                           "--checkpoint", tiny_ckpt]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 8 and names == sorted(os.listdir(tmp_path / "jax"))
    assert submits == [c[1:] for c in jax_tts]
    # every wav written is a row of a padded batch, and a fresh pipeline makes those batches bit for bit
    fresh = base(checkpoint=tiny_ckpt, device="cpu")
    rows = set()
    for args, out in padded:
        np.testing.assert_array_equal(fresh.synthesize_padded(*args), out)
        for i in np.flatnonzero(args[1] > 0):
            rows.add(encode_wav(out[i, :, : int(args[4][i]) * 3200].reshape(-1), 24_000))
    assert {open(tmp_path / "port" / n, "rb").read() for n in names} <= rows
    assert not calls  # the batcher calls synthesize_padded only


def test_tryme_without_assets_matches_the_jax_script(port_tts, jax_tts, tmp_path, monkeypatch, capsys):
    from smalltts_tpu.assets import ensure
    from smalltts_tpu_torch.scripts import tryme

    calls, _, base = port_tts

    def no_download(folders, root=None):
        raise RuntimeError(f"assets {list(folders)} not present under {root!r}")

    monkeypatch.setattr(ensure, "ensure_assets", no_download)  # the JAX script's fetch, kept offline
    monkeypatch.setenv("SMALLTTS_ASSETS", str(tmp_path / "assets"))
    monkeypatch.chdir(tmp_path)
    assert tryme.main(["--device", "cpu", "Testing one two three."]) == 0
    port = capsys.readouterr()
    assert "continuing with random weights" in port.err and "wrote out/tryme.wav" in port.out
    os.rename("out/tryme.wav", "port.wav")
    assert run_root(monkeypatch, "tryme", ["Testing one two three."]) == 0
    assert "continuing with random weights" in capsys.readouterr().err
    assert [c[1:] for c in calls] == [c[1:] for c in jax_tts]
    fresh = base(device="cpu")
    audio = fresh.synthesize(np.random.RandomState(0).randn(16, 64).astype(np.float32), *calls[0][1:])
    assert open("port.wav", "rb").read() == encode_wav(audio.reshape(-1), 24_000)


# --------------------------------------------------------------- test_checkpoint


def tiny_kinds():
    """kind -> (the JAX model's module, its config's class name, the JAX tiny
    config, the port's init, the JAX forward's name)."""
    from test_distill import TINY_ASR64, TINY_DISC, TINY_SV64

    from smalltts_tpu.models import asr as JA
    from smalltts_tpu.models import backbone as JB
    from smalltts_tpu.models import discriminator as JD
    from smalltts_tpu.models import sv as JS
    from smalltts_tpu_torch.models import asr as PA
    from smalltts_tpu_torch.models import discriminator as PD
    from smalltts_tpu_torch.models import sv as PS

    return {"backbone": (JB, "BackboneConfig", TINY_BACKBONE, PB.init_backbone, "backbone_forward"),
            "asr": (JA, "ASRConfig", TINY_ASR64, PA.init_asr, "asr_forward"),
            "sv": (JS, "SVConfig", TINY_SV64, PS.init_sv, "sv_forward"),
            "disc": (JD, "DiscriminatorConfig", TINY_DISC, PD.init_discriminator, "discriminator_forward")}


def port_config(jcfg):
    """The port's counterpart of a JAX config dataclass, field for field."""
    from smalltts_tpu_torch.models import asr, discriminator, sv
    from smalltts_tpu_torch.models.conformer import ConformerConfig
    from smalltts_tpu_torch.utils.config_io import _filtered_kwargs

    name = type(jcfg).__name__
    if name == "BackboneConfig":
        return backbone_config_from_dict(dataclasses.asdict(jcfg))
    cls = {"ASRConfig": asr.ASRConfig, "SVConfig": sv.SVConfig,
           "DiscriminatorConfig": discriminator.DiscriminatorConfig}[name]
    kw = _filtered_kwargs(cls, dataclasses.asdict(jcfg))
    if "conformer" in kw:
        kw["conformer"] = ConformerConfig(**_filtered_kwargs(ConformerConfig, kw["conformer"]))
    return cls(**kw)


def listed(out):
    """The key lines a validator printed, in order."""
    return [line.strip() for line in out.splitlines() if line.startswith("  ")]


@pytest.mark.parametrize("kind", ["backbone", "asr", "sv", "disc"])
def test_test_checkpoint_reports_and_exit_codes_match_jax(kind, tmp_path, monkeypatch, capsys):
    from smalltts_tpu_torch.scripts import test_checkpoint

    from smalltts_tpu_torch.utils.convert import params_to_jax

    jmod, cname, jcfg, pinit, fwd = tiny_kinds()[kind]
    pcfg = port_config(jcfg)
    monkeypatch.setattr(jmod, cname, lambda: jcfg)
    # the JAX script's forward, compiled once (op-by-op it takes seconds on the CPU)
    for name in (fwd, "encode_conditions", "denoise_step") if kind == "backbone" else (fwd,):
        monkeypatch.setattr(jmod, name, jax.jit(getattr(jmod, name), static_argnums=(1,),
                                                static_argnames=("return_features",) if name == "backbone_forward" else ()))
    monkeypatch.setattr(test_checkpoint, "default_config", lambda k: pcfg)
    # seeded weights in the JAX package's layout
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_pytree(
        params_to_jax(pinit(torch.Generator().manual_seed(0), pcfg), pcfg)).items()}
    keys = sorted(flat)
    dropped = {**flat, "not/a/param": np.zeros((3,), np.float32)}  # a key missing, one unexpected
    del dropped[keys[len(keys) // 2]]
    reshaped = dict(flat)
    reshaped[keys[1]] = np.zeros(np.shape(flat[keys[1]]) + (2,), np.float32)
    for label, tree in (("complete", flat), ("dropped", dropped), ("reshaped", reshaped)):
        path = str(tmp_path / f"{label}.npz")
        jckpt.save_pytree(path, jckpt.unflatten_pytree(tree))
        argv = [path, "--kind", kind]
        rc = test_checkpoint.main(argv + ["--device", "cpu"])
        got = capsys.readouterr().out
        want_rc = run_root(monkeypatch, "test_checkpoint", argv)
        want = capsys.readouterr().out
        assert rc == want_rc == (0 if label == "complete" else 1), (label, got)
        assert listed(got) == listed(want), label
        heads = [[line for line in out.splitlines() if not line.startswith(" ")][:3] for out in (got, want)]
        assert heads[0] == heads[1], label
        if rc == 0:
            assert "forward OK" in got and got.rstrip().endswith("checkpoint valid")
    if kind == "backbone":
        out = str(tmp_path / "converted.npz")
        assert test_checkpoint.main([str(tmp_path / "complete.npz"), "--convert", out, "--device", "cpu"]) == 0
        assert "cached-inference path OK" in capsys.readouterr().out
        tts = pipeline.SmallTTS(checkpoint=out, device="cpu", codec_cfg=PCODEC)
        assert tts.cfg == pcfg
        want_tts = pipeline.SmallTTS(checkpoint=str(tmp_path / "complete.npz"), cfg=pcfg, codec_cfg=PCODEC,
                                     device="cpu")
        from smalltts_tpu_torch.utils.checkpoint import flatten_pytree

        want_flat = flatten_pytree(want_tts.params)
        for k, v in flatten_pytree(tts.params).items():
            assert torch.equal(v, want_flat[k]), k
    else:
        assert test_checkpoint.main([str(tmp_path / "complete.npz"), "--kind", kind, "--convert", "x.npz",
                                     "--device", "cpu"]) == 1
        assert "backbone checkpoints only" in capsys.readouterr().err


# --------------------------------------------------------------- import_codec


@pytest.fixture(scope="module")
def mini_codec(tmp_path_factory):
    from smalltts_tpu_torch.models import codec as PC
    from smalltts_tpu_torch.onnxtorch.export import CodecDecoder, CodecEncoder, export

    cfg = PC.CodecConfig(strides=(4, 5), channels=(32, 24, 8), res_dilations=(1,))
    d = tmp_path_factory.mktemp("mini_codec")
    cp = PC.init_codec(torch.Generator().manual_seed(5), cfg)
    (d / "encoder.onnx").write_bytes(export(CodecEncoder(cp, cfg), (0.1 * torch.randn(1, 1, 4 * cfg.hop),),
                                            dynamic_axes={"audio": {0: "b", 2: "t"}}, input_names=["audio"]))
    (d / "decoder.onnx").write_bytes(export(CodecDecoder(cp, cfg), (torch.randn(1, 4, 64),),
                                            dynamic_axes={"latents": {0: "b", 1: "t"}}, input_names=["latents"]))
    return d


def test_import_codec_matches_the_jax_script(mini_codec, tmp_path, monkeypatch, capsys):
    from smalltts_tpu.onnxjax.codec import OnnxCodec as JOnnxCodec
    from smalltts_tpu_torch.onnxtorch.codec import OnnxCodec
    from smalltts_tpu_torch.scripts import import_codec

    common = ["--assets", str(mini_codec), "--roundtrip-seconds", "0.05"]
    assert import_codec.main(common + ["--save", str(tmp_path / "port" / "c"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert run_root(monkeypatch, "import_codec", common + ["--save", str(tmp_path / "jax" / "c")]) == 0
    want = capsys.readouterr().out
    for side in ("enc", "dec"):
        a, b = (np.load(tmp_path / d / f"c_{side}.npz") for d in ("port", "jax"))
        assert sorted(a.files) == sorted(b.files) and a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # the same lines, the SNR's rounding aside
    strip = lambda s, d: [line.split(":")[0].replace(str(tmp_path / d), "D")  # noqa: E731
                          for line in s.splitlines()]
    assert strip(got, "port") == strip(want, "jax")
    snr = lambda s: float(s.split("round-trip SNR vs input: ")[1].split(" dB")[0])  # noqa: E731
    assert abs(snr(got) - snr(want)) <= 0.1 and math.isfinite(snr(got))
    # the round trip's latents, as the script computes them
    t = int(0.05 * 24_000)
    rng = np.random.RandomState(0)
    audio = (0.5 * np.sin(2 * np.pi * 220 * np.arange(t) / 24_000) + 0.05 * rng.randn(t)).astype(np.float32)
    p = OnnxCodec(str(mini_codec / "encoder.onnx"), str(mini_codec / "decoder.onnx"), device="cpu")
    j = JOnnxCodec(str(mini_codec / "encoder.onnx"), str(mini_codec / "decoder.onnx"))
    lp = p.encode_fn(p.params, torch.from_numpy(audio[None, None])).numpy()
    lj = np.asarray(jax.jit(j.encode_fn)(j.params, audio[None, None]))
    assert float(np.abs(lp - lj).max() / np.abs(lj).max()) <= 1e-5
    # a missing graph: the JAX script's message without its download hint, exit 1
    assert import_codec.main(["--assets", str(tmp_path / "none"), "--device", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == f"missing {tmp_path / 'none' / 'encoder.onnx'}"


# --------------------------------------------------------------- test_x402


class _StubTTS:
    def synthesize_padded(self, ref, ref_lens, ph, ph_lens, seq_lens, t_bucket, key=None, fetch=True):
        return np.zeros((ref.shape[0], 1, int(t_bucket) * 3200), np.float32)

    def encode_reference(self, samples):
        return np.zeros((4, 64), np.float32)


def start_server(server):
    """`server` on a local socket in a thread of its own; (port, stop)."""
    loop = asyncio.new_event_loop()
    ready, holder = threading.Event(), {}

    def run():
        asyncio.set_event_loop(loop)

        async def main():
            srv = await asyncio.start_server(server._serve_conn, "127.0.0.1", 0)
            holder["port"] = srv.sockets[0].getsockname()[1]
            ready.set()
            async with srv:
                await srv.serve_forever()

        try:
            loop.run_until_complete(main())
        except RuntimeError:  # stopped from the test's thread
            pass

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)

    return holder["port"], stop


PRIV = "d15c0"


@pytest.mark.parametrize("server_pkg,mode,key", [("port", "trust", None), ("port", "local", PRIV),
                                                 ("jax", "local", PRIV)])
def test_x402_client_pays_the_server(server_pkg, mode, key, tmp_path, monkeypatch, capsys):
    from smalltts_tpu_torch.scripts import test_x402

    if server_pkg == "port":
        from smalltts_tpu_torch.serving.server import TTSServer
        from smalltts_tpu_torch.serving.x402 import X402Config
    else:
        from smalltts_tpu.serving.server import TTSServer
        from smalltts_tpu.serving.x402 import X402Config
    server = TTSServer(tts=_StubTTS(), x402_cfg=X402Config(mode=mode), tokenizer=lambda t: [1, 2, 3])
    port, stop = start_server(server)
    try:
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("SERVER_URL", f"http://127.0.0.1:{port}")
        monkeypatch.setenv("DURATION", "1.0")
        if key:
            monkeypatch.setenv("PRIVATE_KEY", key)
        else:
            monkeypatch.delenv("PRIVATE_KEY", raising=False)
        assert test_x402.main([]) == 0
        out = capsys.readouterr().out
        assert out.startswith("402: ") and ("signed EIP-3009 payment" in out) == bool(key)
        body = open("output.wav", "rb").read()
        assert body[:4] == b"RIFF" and decode_wav(body)[1] == 24_000
        assert f"wrote output.wav ({len(body)} bytes)" in out
    finally:
        if server._batcher is not None:
            server._batcher.close()
        stop()


def test_signed_payment_verifies_in_both_gates():
    """The port's signature, from the same key and nonce, is the JAX gate's."""
    from smalltts_tpu.serving.x402 import X402Config as JConfig
    from smalltts_tpu.serving.x402 import X402Gate as JGate
    from smalltts_tpu_torch.serving.x402 import X402Config, X402Gate

    jg, pg = JGate(JConfig(mode="local")), X402Gate(X402Config(mode="local"))
    accept = json.loads(base64.b64decode(jg.payment_required_header(2.0, "/synthesize")))["accepts"][0]
    nonce, now = bytes(range(32)), 1.7e9
    assert pg.sign_payment(int(PRIV, 16), accept, nonce=nonce, now=now) == \
           jg.sign_payment(int(PRIV, 16), accept, nonce=nonce, now=now)


# --------------------------------------------------------------- demo_quality_loop


def test_demo_configs_are_the_test_suites():
    from test_distill import TINY_ASR64, TINY_SV64

    assert demo.TINY_BACKBONE == PCFG and demo.TINY_CODEC == PCODEC
    assert dataclasses.asdict(demo.TINY_ASR64) == dataclasses.asdict(TINY_ASR64)
    assert dataclasses.asdict(demo.TINY_SV64) == dataclasses.asdict(TINY_SV64)


def summary_keys(path):
    """{stage: [keys]} of the `summary[stage] = {...}` dicts in a script."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", None) == "summary"):
            stage = node.targets[0].slice.value
            out[stage] = [k.value for k in node.value.keys] if isinstance(node.value, ast.Dict) else None
    return out


def test_demo_quality_loop_summary_on_the_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--codec-steps", "2", "--teacher-steps", "2", "--asr-steps", "2", "--sv-steps", "2",
            "--sample-steps", "2", "--samples-out", str(tmp_path / "samples")]
    assert demo.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    want = summary_keys(os.path.join(ROOT, "scripts", "demo_quality_loop.py"))
    assert summary_keys(demo.__file__) == want
    assert list(summary) == list(want) and all(list(summary[k]) == v for k, v in want.items() if v is not None)

    def finite(x):
        return all(finite(v) for v in x.values()) if isinstance(x, dict) else (
            isinstance(x, bool) or math.isfinite(x))

    assert finite(summary)
    assert sorted(os.listdir(tmp_path / "samples")) == ["demo_gen.wav", "demo_ref.wav", "index.json"]
    assert [line.split("] ")[1].split(":")[0] for line in out[:-1]] == [
        "synthetic utterance 1.20s", "codec", "teacher", "TTS", f"samples written to {tmp_path / 'samples'}",
        "ASR", "SV"]


def test_demo_asr_decode_and_sv_cosine_match_jax():
    """The script's greedy decode and teacher cosine, against the JAX
    script's own computation (main's ASR and SV blocks) on the same seeded
    weights carried across to the JAX layout, with no training step."""
    import itertools

    from test_distill import TINY_ASR64, TINY_SV64

    from smalltts_tpu.data.synthetic import synth_speech
    from smalltts_tpu.models.asr import asr_forward
    from smalltts_tpu.models.codec import codec_decode, codec_encode
    from smalltts_tpu.models.sv import SVConfig, sv_forward
    from smalltts_tpu.models.sv_teacher import make_teacher_fn
    from smalltts_tpu_torch.models.asr import init_asr
    from smalltts_tpu_torch.models.codec import init_codec
    from smalltts_tpu_torch.models.sv import init_sv
    from smalltts_tpu_torch.models.sv_teacher import init_sv_teacher
    from smalltts_tpu_torch.models.sv_teacher import make_teacher_fn as p_make_teacher_fn
    from smalltts_tpu_torch.utils.convert import params_to_jax

    tcfg = SVConfig(input_dim=80, channels=(16, 16, 16, 16, 48), emb_dim=8, attention_channels=8,
                    res2net_scale=2, se_channels=8)
    assert dataclasses.asdict(demo.TINY_SV_TEACHER) == dataclasses.asdict(tcfg)
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    p_cp, p_asr = init_codec(gen(0), PCODEC), init_asr(gen(3), demo.TINY_ASR64)
    p_tp0, p_sv = init_sv_teacher(gen(5), demo.TINY_SV_TEACHER), init_sv(gen(6), demo.TINY_SV64)
    to_jax = lambda t, cfg=None: jax.tree.map(lambda x: jnp.asarray(x.numpy()), params_to_jax(t, cfg))  # noqa: E731
    cp, asr, tp0, sv = (to_jax(p_cp), to_jax(p_asr, demo.TINY_ASR64), to_jax(p_tp0, demo.TINY_SV_TEACHER),
                        to_jax(p_sv, demo.TINY_SV64))

    gt = synth_speech("blue moon light", speaker=0, seed=0)
    gt = gt[: (len(gt) // TINY_CODEC.hop) * TINY_CODEC.hop]
    # the script's calls, each jitted (op-by-op dispatch of these graphs takes tens of seconds on the CPU)
    lat_gt = np.asarray(jax.jit(lambda a: codec_encode(cp, a, TINY_CODEC))(jnp.asarray(gt[None, None, :])))[0]
    T = lat_gt.shape[0]
    lat, lens = jnp.asarray(lat_gt[None]), jnp.asarray([T], jnp.int32)
    logp, out_lens, _ = jax.jit(lambda x, n: asr_forward(asr, TINY_ASR64, x, n))(lat, lens)
    pred = np.asarray(jnp.argmax(logp, -1))[0, : int(out_lens[0])]
    want_decode = [int(k) for k, _ in itertools.groupby(pred) if k != 0]
    teacher_fn, tp = make_teacher_fn(tp0, tcfg)
    emb, _ = jax.jit(lambda x, n: sv_forward(sv, TINY_SV64, x, n))(lat, lens)
    temb = jax.jit(lambda x: teacher_fn(tp, codec_decode(cp, x, TINY_CODEC)))(lat)
    e, te = np.asarray(emb)[0], np.asarray(temb)[0]
    want_cos = float(e @ te / (np.linalg.norm(e) * np.linalg.norm(te) + 1e-9))

    assert demo.greedy_decode(p_asr, lat_gt, "cpu") == want_decode
    p_fn, p_tp = p_make_teacher_fn(p_tp0, demo.TINY_SV_TEACHER)
    got_cos = demo.teacher_cosine(p_sv, p_cp, p_tp, p_fn, lat_gt, "cpu")
    assert abs(got_cos - want_cos) <= 1e-5, (got_cos, want_cos)


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    import importlib

    monkeypatch.chdir(tmp_path)
    sine_wav(tmp_path / "r.wav", 0.5, 200.0)
    (tmp_path / "m.json").write_text(json.dumps({"r.wav": "hi"}))
    argv = {"clone": ["--wav", "r.wav", "--text", "hi"], "interactive": [], "batch": ["--manifest", "m.json"],
            "tryme": ["hi"],
            "test_checkpoint": ["x.npz"], "bench_serving": [], "demo_quality_loop": []}
    for name, args in argv.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            importlib.import_module(f"smalltts_tpu_torch.scripts.{name}").main(args)

"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "smalltts_tpu_torch")

BLOCKED = ("import sys; sys.modules['jax'] = None; sys.modules['smalltts_tpu'] = None; "
           "sys.modules['jaxlib'] = None; ")


def _modules():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                yield rel.replace(os.sep, ".").removesuffix(".__init__")


def test_every_module_imports_without_jax():
    code = BLOCKED + "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in sorted(_modules()))
    code += "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v is not None}\n"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"\bsmalltts_tpu\."])
def test_no_source_names_jax_or_the_jax_package(pattern):
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith((".py", ".cu", ".cuh", ".cc"))]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    hits = [f"{os.path.relpath(f, ROOT)}:{i}" for f in files
            for i, line in enumerate(open(f, encoding="utf-8"), 1) if re.search(pattern, line)]
    assert not hits, hits


def test_smalltts_without_a_card_raises():
    from smalltts_tpu_torch.infer.pipeline import SmallTTS, resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SmallTTS()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_never_build_on_the_cpu():
    """CPU tensors take the plain versions; nothing is compiled or loaded."""
    from smalltts_tpu_torch.ops import kernels
    from smalltts_tpu_torch.ops.kernels import dit_block as K
    from smalltts_tpu_torch.ops.kernels import w8 as W

    a = torch.randn(2, 8, 64)
    before = dict(kernels.LAUNCHES)
    mod = torch.zeros(2, 64)
    cos = torch.ones(8, 8)
    h = K.adaln_modulate(a, mod, mod)
    qkvg = K.gemm_bias(h, torch.randn(64, 64), torch.randn(64))
    K.qk_norm_rope(qkvg, torch.ones(2, 8), torch.ones(2, 8), cos, cos)
    K.gemm_swiglu(h, torch.randn(64, 32), torch.randn(32))
    K.gemm_residual(a, torch.randn(64, 64), None, h, mod)
    w_q, scale = W.quantize_w8(torch.randn(3, 64, 64))
    K.gemm_bias(h, w_q[0], torch.randn(64), w_scale=scale[0])
    W.w8_matmul(a[0], w_q[0], scale[0])
    W.w8_matmul_stacked(a[0], w_q, scale, torch.tensor(1, dtype=torch.int32))
    W.w8_matmul_all_layers(a[0], w_q, scale)
    assert kernels.LAUNCHES == before
    assert not kernels._libs


NEW_HOST_MODULES = ["smalltts_tpu_torch.text", "smalltts_tpu_torch.text.numbers", "smalltts_tpu_torch.text.normalizer",
                    "smalltts_tpu_torch.text.phonemize", "smalltts_tpu_torch.serving.multipart",
                    "smalltts_tpu_torch.serving.audio_io", "smalltts_tpu_torch.serving.eth",
                    "smalltts_tpu_torch.serving.x402", "smalltts_tpu_torch.infer.long_form",
                    "smalltts_tpu_torch.serving.server", "smalltts_tpu_torch.infer.pipeline",
                    "smalltts_tpu_torch.native", "smalltts_tpu_torch.onnxtorch", "smalltts_tpu_torch.onnxtorch.proto",
                    "smalltts_tpu_torch.onnxtorch.interp", "smalltts_tpu_torch.onnxtorch.codec",
                    "smalltts_tpu_torch.onnxtorch.pipeline", "smalltts_tpu_torch.utils.onnx_import",
                    "smalltts_tpu_torch.train.imf", "smalltts_tpu_torch.assets", "smalltts_tpu_torch.assets.ensure"]

# a CPU TTSServer answering one /synthesize through a tiny pipeline, the
# text frontend and the Batcher, with neither JAX nor the JAX package blocked
SERVE = """
import asyncio, sys
import numpy as np
from smalltts_tpu_torch.infer.pipeline import SmallTTS
from smalltts_tpu_torch.models.backbone import BackboneConfig
from smalltts_tpu_torch.models.codec import CodecConfig
from smalltts_tpu_torch.models.dit import DiTConfig
from smalltts_tpu_torch.models.encoder import EncoderConfig
from smalltts_tpu_torch.serving.audio_io import encode_wav
from smalltts_tpu_torch.serving.server import TTSServer
enc = EncoderConfig(model_size=32, num_layers=1, num_heads=2, intermediate_size=64, norm_eps=1e-6)
cfg = BackboneConfig(latent_dim=64, hidden_dim=64, phoneme_dim=32, text=enc, style=enc,
                     dit=DiTConfig(latent_dim=64, phoneme_dim=32, hidden_dim=64, n_blocks=1, heads=4, rot_dim=8,
                                   conv_groups=16))
tts = SmallTTS(cfg=cfg, codec_cfg=CodecConfig(latent_dim=64, channels=(16, 16, 16, 8, 8, 4)), device="cpu",
               pcm16_out=True)
srv = TTSServer(tts=tts)
wav = encode_wav(0.1 * np.sin(np.arange(12000) / 9.0), 24000)
body = (b'--B\\r\\nContent-Disposition: form-data; name="audio"\\r\\n\\r\\n' + wav
        + b'\\r\\n--B\\r\\nContent-Disposition: form-data; name="text"\\r\\n\\r\\nHello there.\\r\\n--B--\\r\\n')
status, headers, out = asyncio.run(srv.handle("POST", "/synthesize", {"duration": "1"},
                                              {"content-type": "multipart/form-data; boundary=B"}, body))
srv._batcher.close()
assert status == 200 and dict(headers)["content-type"] == "audio/wav", (status, out[:200])
"""


def _loaded(names):
    return "assert not {k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'smalltts_tpu'}, " + repr(names) + "\n"


def test_new_host_modules_and_a_cpu_server_request_load_no_jax():
    """Importing each module of the text frontend, the HTTP server, long
    form, the native audio library, the ONNX import path and the IMF
    sampler, building the native library, and then serving one CPU request,
    loads neither JAX nor the JAX package (nothing is blocked here: a
    fallback import would show)."""
    code = "import importlib, sys\n" + "".join(f"importlib.import_module({m!r})\n" + _loaded(m)
                                              for m in NEW_HOST_MODULES)
    code += ("from smalltts_tpu_torch import native\nfrom smalltts_tpu_torch.serving import audio_io\n"
             "assert native.lib() is not None and audio_io.backend() is native\n" + _loaded("after the native build"))
    code += SERVE + _loaded("after a CPU TTSServer request")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


TRAIN_MODULES = ["smalltts_tpu_torch.train.teacher", "smalltts_tpu_torch.train.optim", "smalltts_tpu_torch.train.ema",
                 "smalltts_tpu_torch.data.dummy", "smalltts_tpu_torch.infer.teacher_sampler",
                 "smalltts_tpu_torch.ops.precision", "smalltts_tpu_torch.utils.profiling"]

TRAIN = """
import tempfile
from smalltts_tpu_torch.models.backbone import BackboneConfig
from smalltts_tpu_torch.models.dit import DiTConfig
from smalltts_tpu_torch.models.encoder import EncoderConfig
from smalltts_tpu_torch.train.teacher import TeacherTrainConfig, train_teacher
enc = EncoderConfig(model_size=32, num_layers=1, num_heads=2, intermediate_size=64, norm_eps=1e-6)
cfg = BackboneConfig(latent_dim=64, hidden_dim=64, phoneme_dim=32, text=enc, style=enc,
                     dit=DiTConfig(latent_dim=64, phoneme_dim=32, hidden_dim=64, n_blocks=1, heads=4, rot_dim=8,
                                   conv_groups=16))
with tempfile.TemporaryDirectory() as d:
    train_teacher(TeacherTrainConfig(num_steps=3, save_every=2), cfg, checkpoint_dir=d, device="cpu")
"""


def test_training_modules_and_a_cpu_teacher_run_load_no_jax():
    """Importing each training module, then three CPU teacher steps with a
    save, loads neither JAX nor the JAX package (nothing blocked)."""
    code = "import importlib, sys\n" + "".join(f"importlib.import_module({m!r})\n" + _loaded(m)
                                              for m in TRAIN_MODULES)
    code += TRAIN + _loaded("after three CPU teacher steps and a save")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


SCRIPTS = ["phonemize", "clone", "interactive", "batch", "tryme", "test_checkpoint", "import_codec", "test_x402",
           "bench_serving", "demo_quality_loop", "eval_quality", "profile", "dryrun_multihost", "certify",
           "ab_fused_block", "ab_fused_block_e2e", "imf_corpus", "exp_imf_boundary", "exp_imf_source"]

RUN_SCRIPTS = """
import contextlib, importlib, io, os, tempfile
for name in SCRIPTS:
    main = importlib.import_module("smalltts_tpu_torch.scripts." + name).main
    with contextlib.redirect_stdout(io.StringIO()) as out:
        try:
            rc = main(["--help"])
        except SystemExit as e:
            rc = e.code
    assert rc in (0, None) and "usage" in out.getvalue(), (name, rc)
from smalltts_tpu_torch.scripts import demo_quality_loop, phonemize
assert phonemize.main(["hello", "world"]) == 0
with tempfile.TemporaryDirectory() as d:
    assert demo_quality_loop.main(["--device", "cpu", "--codec-steps", "1", "--teacher-steps", "1", "--asr-steps", "1",
                                   "--sv-steps", "1", "--sample-steps", "1", "--samples-out", d]) == 0
"""


def test_script_entry_points_run_without_jax():
    """Every module of smalltts_tpu_torch/scripts answers --help, phonemize
    prints ids and the demo loop runs one step a stage on the CPU, with JAX
    and the JAX package blocked."""
    code = BLOCKED + f"SCRIPTS = {SCRIPTS!r}\n" + RUN_SCRIPTS
    code += ("assert not {k.split('.')[0] for k, v in sys.modules.items() if v is not None} "
             "& {'jax', 'jaxlib', 'smalltts_tpu'}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})  # tiny ops: one intra-op thread
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(SCRIPTS) == sorted(f[:-3] for f in os.listdir(os.path.join(PKG, "scripts"))
                                     if f.endswith(".py") and f != "__init__.py")

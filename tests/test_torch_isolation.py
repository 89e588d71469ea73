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
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith((".py", ".cu"))]
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

"""The port's package-level API is the JAX package's: the same five names,
loaded on first use, so that importing the package loads neither JAX nor
torch's CUDA extensions nor any kernel of the port."""

import os
import subprocess
import sys

import pytest

import smalltts_tpu
import smalltts_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["SmallTTS", "ImportedSmallTTS", "OnnxCodec", "estimate_duration", "__version__"]


def test_all_and_version_equal_the_jax_package():
    assert smalltts_tpu_torch.__all__ == smalltts_tpu.__all__ == NAMES
    assert smalltts_tpu_torch.__version__ == smalltts_tpu.__version__


@pytest.mark.parametrize("name", NAMES[:-1])
def test_each_name_resolves_to_the_port(name):
    obj = getattr(smalltts_tpu_torch, name)
    assert obj.__module__.startswith("smalltts_tpu_torch.")
    assert obj.__name__ == getattr(smalltts_tpu, name).__name__ == name


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        smalltts_tpu_torch.nope  # noqa: B018


def test_import_loads_nothing_heavy():
    code = ("import sys\nimport smalltts_tpu_torch\n"
            "assert not {k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'smalltts_tpu', 'torch'}\n"
            "from smalltts_tpu_torch import SmallTTS, ImportedSmallTTS, OnnxCodec, estimate_duration, __version__\n"
            "assert not {k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'smalltts_tpu'}\n"
            "from smalltts_tpu_torch.ops import kernels\n"
            "assert not kernels._libs\n"
            "assert estimate_duration('a' * 23) == 2.0\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]

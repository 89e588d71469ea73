"""The port's native audio library builds safely from processes that load it
at once (test workers on a fresh tree): a copy of smalltts_tpu_torch/native
with an empty build/ is loaded by 6 processes started together, and every
one of them must get the library; three rounds, build/ emptied before each
(a racing build fails some process in most rounds, not in every one)."""

import os
import shutil
import subprocess
import sys

from smalltts_tpu_torch import native

LOAD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
l = mod.lib()
assert l is not None, "lib() returned None"
wav = mod.encode_wav(mod.np.zeros(8, mod.np.float32), 24000)
assert wav[:4] == b"RIFF" and len(wav) == 44 + 16, wav[:16]
print("loaded")
"""


def test_six_processes_load_a_fresh_build(tmp_path):
    src = os.path.dirname(native.__file__)
    copy = tmp_path / "native"
    shutil.copytree(src, copy, ignore=shutil.ignore_patterns("build", "__pycache__"))
    assert not (copy / "build").exists()
    init = str(copy / "__init__.py")
    for round_ in range(3):
        shutil.rmtree(copy / "build", ignore_errors=True)
        procs = [subprocess.Popen([sys.executable, "-c", LOAD, init], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for _ in range(6)]
        results = [(*p.communicate(timeout=300), p.returncode) for p in procs]
        failed = [(rc, err[-500:]) for out, err, rc in results if rc != 0 or out.strip() != "loaded"]
        assert not failed, (round_, failed)
        assert (copy / "build" / "libsmalltts_audio.so").exists()
        assert not (copy / "build" / "libsmalltts_audio.so.tmp").exists()

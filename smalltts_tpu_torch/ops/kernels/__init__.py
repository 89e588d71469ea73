"""Hand-written Hopper kernels, their build, launch counts and plain versions.

Each kernel lives in `smalltts_tpu_torch/csrc/<name>.cu` with a plain C
interface; helpers that several sources share are in `csrc/*.cuh`. It is compiled with nvcc for sm_90a at first use (never at import)
into `ops/kernels/build/`, under a file lock, and loaded with ctypes.

Every wrapper takes its plain PyTorch version only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises. `LAUNCHES` counts the
launches per wrapper name: a wrapper adds one where it launches, nowhere
else. Under a CUDA graph capture (`recording()`) a wrapper's count goes to
the graph instead, and each replay adds the graph's counts
(`add_launches`). `SHAPE_LAUNCHES` counts the eager launches of a wrapper
that names its shape (attention), by (name, shape); a graph's replays do
not add to it. `force_plain()` is a test-only switch that routes CUDA
tensors through the plain versions, so a run can be held against the same
run without the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = ("attention", "dit_block", "w8", "ctc", "codec")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {}
SHAPE_LAUNCHES: Dict[tuple, int] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_plain = threading.local()


def count_launch(name: str, shape: Optional[tuple] = None) -> None:
    counts = getattr(_plain, "recording", None)  # a CUDA graph capture in this thread
    with _lock:
        if counts is None:
            counts = LAUNCHES
            if shape is not None:
                SHAPE_LAUNCHES[(name, shape)] = SHAPE_LAUNCHES.get((name, shape), 0) + 1
        counts[name] = counts.get(name, 0) + 1


def reset_launches() -> None:
    with _lock:
        for k in list(LAUNCHES):
            LAUNCHES[k] = 0
        SHAPE_LAUNCHES.clear()


def add_launches(counts: Dict[str, int]) -> None:
    """Add `counts` to LAUNCHES: the launches a CUDA graph makes each time
    it is replayed, which no wrapper sees."""
    with _lock:
        for k, v in counts.items():
            LAUNCHES[k] = LAUNCHES.get(k, 0) + v


@contextlib.contextmanager
def recording():
    """Count this thread's wrapper calls into a dict of their own, not into
    LAUNCHES: while a CUDA graph is captured a wrapper records its kernel
    into the graph and launches nothing. Yields that dict, the launches
    each replay of the graph makes."""
    counts: Dict[str, int] = {}
    prev = getattr(_plain, "recording", None)
    _plain.recording = counts
    try:
        yield counts
    finally:
        _plain.recording = prev


@contextlib.contextmanager
def force_plain():
    """Test-only: run the plain versions on CUDA tensors in this thread."""
    prev = getattr(_plain, "on", False)
    _plain.on = True
    try:
        yield
    finally:
        _plain.on = prev


def checkpoint_contexts():
    """torch.utils.checkpoint's context_fn: the forward as it is, and the
    recompute in the backward, which autograd runs in a thread of its own
    on the card, under this thread's force_plain() where it is on and with
    this thread's parallel mesh in use (a tensor-parallel block's
    collectives run again in the recompute)."""
    from smalltts_tpu_torch.parallel import mesh

    plain, m = getattr(_plain, "on", False), mesh.current()

    @contextlib.contextmanager
    def recompute():
        with (force_plain() if plain else contextlib.nullcontext()), mesh.use(m):
            yield

    return contextlib.nullcontext(), recompute()


def use_plain(t) -> bool:
    """True where a wrapper must take its plain version: a CPU tensor, or the
    test-only switch. Any other device launches the kernel."""
    return t.device.type == "cpu" or getattr(_plain, "on", False)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _build(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(path, "rb") as f:  # the source and every header it may include
            h.update(f.read())
    digest = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                tmp = out + f".tmp{os.getpid()}"
                res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                     capture_output=True, text=True)
                with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as log:
                    log.write(res.stdout + res.stderr)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr[-4000:]}")
                os.replace(tmp, out)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return out


# C entry points of each source: name -> (argtypes, restype). Every entry
# returns a cudaError_t (0 = success); <source>_error maps it to a message.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "attention": {
        "st_attention": ([_I, _I, ctypes.POINTER(_P), ctypes.POINTER(_L),
                          ctypes.POINTER(_I), _F, _P], _I),
    },
    "dit_block": {
        "st_adaln_modulate": ([_P, _P, _P, _P, _L, _I, _I, _I, _P], _I),
        "st_qk_norm_rope": ([_P, _L, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P], _I),
        "st_gemm": ([_I, _P, _L, _P, _L, _P, _P, _P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _P], _I),
    },
    "w8": {
        "st_w8_matmul": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    },
    "ctc": {
        "st_ctc_forward": ([_P] * 7 + [_I, _I, _I, _P], _I),
        "st_ctc_factor_floats": ([_I, _I, _I], _L),
        "st_ctc_backward": ([_P] * 11 + [_I] * 4 + [_P], _I),
    },
    "codec": {
        "st_codec_pointwise": ([_P] * 6 + [_I] * 7 + [_P], _I),
    },
}


def load(name: str) -> ctypes.CDLL:
    """The compiled library for csrc/<name>.cu, built on first use, with
    its entry points typed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _build(name)
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            err = getattr(lib, f"st_{name}_error")
            err.argtypes, err.restype = [_I], ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def build_all() -> Dict[str, float]:
    """Build every source at once (one nvcc per source, started together);
    returns the seconds each source took to build and load (a fraction of a
    second where the build was cached)."""
    errors, seconds = [], {}

    def run(n):
        t0 = time.perf_counter()
        try:
            load(n)
        except Exception as exc:  # reported after every build has ended
            errors.append(exc)
        seconds[n] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(n,)) for n in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {n: seconds[n] for n in SOURCES}


def check(lib: ctypes.CDLL, name: str, status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point of `name`."""
    if status != 0:
        msg = getattr(lib, f"st_{name}_error")(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")

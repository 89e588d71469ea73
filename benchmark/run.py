"""One run of one benchmark cell of smalltts_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (kernel builds, cached in the checkout; weights made on the card
from the seed; the cell's shapes warmed), then a window of --seconds, then
the check of what the window produced against the plain reference in
benchmark/reference/. Prints, as its last stdout line, one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device (and with --trace 1 breakdown),
and checks, each compared number beside its limit; the same numbers are
the last lines of stderr. Exits nonzero with no result where there is no
card, or where JAX or the JAX package was loaded, and, with every thread's
stack on stderr, where the run hangs."""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
# caches of the program's builds at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(cell, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """Run `cell` once on `device`; returns the result line."""
    import torch

    from harness import core
    from reference.model import model_cfg

    run = core.Run(cell, seed, seconds, trace, device, started=started, model=model_cfg(cell.config))
    core.loop_module(cell.traffic["loop"]).run(run)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.entry.get("chips", 1), "memory_peak_bytes": int(run.memory_peak_bytes)}
    breakdown = None
    prof = run.profile
    if prof is not None:
        clip = bool(prof.graph_launches)  # serving slices are clipped to the window; training slices drain
        info["busy_s"] = prof.busy_s(clip=clip)
        info["window_s"] = prof.window_s
        t0 = time.perf_counter()
        breakdown = {"device_ops": prof.top_ops(10), "idle_gaps": prof.idle_gaps(getattr(prof, "spans", []), 10)}
        run.note(f"trace: breakdown read in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    line = core.result_line(run, info, breakdown)
    run.note(f"metrics read in {time.perf_counter() - t0:.3f} s")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from harness import window

    window.arm()  # a hang writes every thread's stack to stderr and exits 1

    import torch

    from harness import core

    cell = core.find_cell(args.workload)
    chips = cell.entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), STARTED)
    bad = core.forbidden_modules()
    if bad:
        print(f"no result: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    window.disarm()
    print(f"correct: {result['correct']} (failed {result['failed']} of {result['attempted']})", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The sweep that fixes an open-loop cell's arrival rate: the cell's mix at
each given rate, one run each, and whether the program kept up.

    python3 benchmark/sweep.py --workload serve-poisson-short --seed 7 --seconds 20 --rates 140 170 200

A rate is kept up with where every request due in the window was answered
within it and the latency of the window's last quarter of requests is no
higher than that of its first quarter by more than half. Prints one JSON
line per rate. The benchmark's own runs do not run this."""

import argparse
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from harness import core
    from harness.serve import latency_percentile
    from harness.stats import percentile
    from reference.model import model_cfg

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    for rate in args.rates:
        cell = copy.deepcopy(core.find_cell(args.workload))
        cell.traffic["rate_per_s"] = rate
        run = core.Run(cell, args.seed, args.seconds, False, torch.device("cuda", 0), started=time.perf_counter(),
                       model=model_cfg(cell.config))
        core.loop_module(cell.traffic["loop"]).run(run)
        reqs = sorted(run.requests, key=lambda s: s.due)
        q = max(len(reqs) // 4, 1)
        lat = lambda part: percentile([s.done - s.due if s.done else float("inf") for s in part], 50) * 1e3  # noqa
        in_time = sum(1 for s in reqs if s.done is not None and s.done < run.window[1])
        print(json.dumps({"rate_per_s": rate, "due": len(reqs), "answered_in_window": in_time,
                          "p50_ms": latency_percentile(run, 50), "p95_ms": latency_percentile(run, 95),
                          "p50_first_quarter_ms": lat(reqs[:q]), "p50_last_quarter_ms": lat(reqs[-q:]),
                          "correct": core.correct(run), "checks": run.checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

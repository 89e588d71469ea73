"""Readings that set a cell's limits: the control and the faults, beside
the program's own, on the card at the cell's own sizes.

    python3 benchmark/controls.py --workload <cell> --seeds 1 2 3 [--requests 16]

Serving cells, each reading the widest gap over a sample of requests drawn
as a run draws it: the control of the denoiser, the plain reference put in
the program's place one precision below the configuration's bf16 (every
product's operands in fp8 e4m3 under a per-tensor scale), on
wave_gap_bf16; the control of the codec, the reference's codec one
precision below its float32 with TF32 off (each convolution's operands in
TF32), and beside it the same in bf16, on codec_gap; and the program as
configured on both. Training cells: the control (the reference in fp8 in
the program's place), and the faults of half the batch left out (the mean
taken over the rest) and of an EMA that copies the params; each the cell's
compared numbers. A state left unchanged reads 1 on the changes and needs
no run.

Prints one JSON line per seed. The benchmark's own runs do not run this."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def serve_readings(cell, seed: int, device, n: int) -> dict:
    import numpy as np
    import torch

    from harness import core
    from harness.serve import Inputs, rel_gap
    from reference import model as ref
    from reference.model import model_cfg
    from smalltts_tpu_torch.serving.batcher import Request, batch_ladder, pad_group

    run = core.Run(cell, seed, 0.0, False, device, model=model_cfg(cell.config))
    inp = Inputs(run)
    pool = [inp.stream[i] for i in range(32 * n)]
    longest = max(pool, key=lambda r: (r.seq_len, -r.index)).index
    reqs = [inp.stream[i] for i in inp.sample([r.index for r in pool], longest, n)]
    b = cell.traffic["batcher"]
    classes = batch_ladder(b["max_batch"], b.get("growth_limit"))
    batch_of = {tb: max(classes) for tb in inp.stream.t_buckets}
    out = {"seed": seed, "requests": len(reqs)}

    def widest(got, want):
        return max(rel_gap(got[r.index], want[r.index]) for r in reqs)

    bf = inp.reference_outputs(reqs, ref.Prec(torch.bfloat16))
    want_wave = {i: o.wave for i, o in bf.items()}
    want_audio = {i: o.audio for i, o in bf.items()}
    fp8 = inp.reference_outputs(reqs, ref.Prec(torch.bfloat16, fp8=True))
    out["control_fp8"] = {"wave_gap_bf16": widest({i: o.wave for i, o in fp8.items()}, want_wave)}
    for label, operand in (("control_tf32", ref.tf32_round), ("codec_bf16", ref.bf16_round)):
        out[label] = {"codec_gap": widest(inp.reference_codec(reqs, bf, operand), want_audio)}

    tts = inp.make_program()
    served = {}
    for group in inp.by_t(reqs).values():
        for c in range(0, len(group), max(classes)):
            chunk = group[c: c + max(classes)]
            refs, rl, ph, pl, sl, t_bucket, bsz = pad_group(
                [Request(r.ref, r.phonemes, r.duration_s) for r in chunk], b["max_batch"], classes=classes)
            idx = [r.index for r in chunk] + [0] * (bsz - len(chunk))
            wave = tts.synthesize_padded(refs, rl, ph, pl, sl, t_bucket, noises=inp.noise(idx, t_bucket))
            for j, r in enumerate(chunk):
                served[r.index] = np.asarray(wave[j, 0])
    out["program"] = {"wave_gap_bf16": widest(served, want_wave),
                      "codec_gap": widest(inp.program_codec(tts, reqs, bf, batch_of), want_audio)}
    del tts
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_readings(cell, seed: int, device) -> dict:
    import torch

    from harness import core
    from harness.train import TrainInputs, Trainer, gaps, reference_readings
    from reference import model as ref
    from reference.model import model_cfg

    rows = cell.config["check"]["rows_per_block"]
    run = core.Run(cell, seed, 0.0, False, device, model=model_cfg(cell.config))
    inp = TrainInputs(run)
    want = reference_readings(inp, ref.Prec(torch.float32), rows)
    out = {"seed": seed, "control_fp8": gaps(reference_readings(inp, ref.Prec(torch.bfloat16, fp8=True), rows), want)}
    del inp

    tr = Trainer(core.Run(cell, seed, 0.0, False, device, model=model_cfg(cell.config)))
    step = tr.step_fn
    half = cell.traffic["batch"] // 2
    clone = lambda tree: tree.clone() if torch.is_tensor(tree) else (  # noqa: E731
        {k: clone(v) for k, v in tree.items()} if isinstance(tree, dict) else
        type(tree)(clone(v) for v in tree) if isinstance(tree, (list, tuple)) else tree)
    start = clone(tr.state)

    def half_batch(params, opt, ema, batch, draws, decay):
        return step(params, opt, ema, {k: v[:half] for k, v in batch.items()},
                    {k: v[:half] for k, v in draws.items()}, decay)

    def ema_copies(params, opt, ema, batch, draws, decay):
        params, opt, _, loss = step(params, opt, ema, batch, draws, decay)
        return params, opt, params, loss

    for label, fault in (("fault_half_batch", half_batch), ("fault_ema_copies", ema_copies)):
        tr.k, tr.readings, tr.kept_inputs = 0, {}, []
        tr.state = clone(start)
        tr.step_fn = fault
        tr.warm()
        out[label] = gaps(tr.readings, want)
    tr.free_program()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from harness import core

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    cell = core.find_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["loop"] == "steps":
            res = train_readings(cell, seed, dev)
        else:
            res = serve_readings(cell, seed, dev, args.requests or cell.config["check"]["requests"])
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tiny cells for the CPU tests: the published layouts at widths a CPU runs
in seconds, with each cell's traffic cut down to match."""

import copy
import json
import os

from harness import serve
from harness.core import ROOT, Cell, find_cell

# the tiny cells keep half of their answers for the check, from a small bank
serve.KEEP_SHARE = 0.5
serve.NOISE_BANK = 64

TINY_MODEL = {
    "latent_dim": 64, "hidden_dim": 64, "phoneme_dim": 32, "vocab_size": 198, "time_embed_dim": 32,
    "dit": {"n_blocks": 2, "heads": 4, "mlp_ratio": 2.5, "rot_dim": 8, "conv_kernel": 31, "conv_groups": 16},
    "text": {"model_size": 32, "num_layers": 2, "num_heads": 2, "intermediate_size": 64, "norm_eps": 1e-6},
    "style": {"model_size": 32, "num_layers": 2, "num_heads": 2, "intermediate_size": 64, "norm_eps": 1e-5},
    "codec": {"latent_dim": 64, "strides": [4, 4, 5, 5, 8], "channels": [16, 16, 16, 8, 8, 4],
              "res_dilations": [1, 3], "kernel": 7, "head_kernel": 7},
}


# The tiny model's own limits, set as the full size's are, from its own
# readings on the CPU (bf16 program against the float32 reference; the fp8
# control): sound runs read grad 6.3-7.7e-3, change 1.5-1.8e-3, EMA change
# 1.4-2.0e-3, waveform 0.6e-3; the control 4.2e-2, 2.3e-2, 2.6e-2 and
# 5.4e-3. The codec: the program's float32 codec reads 0 to 5e-7, the
# reference's with TF32 operands 5.7e-4.
TINY_TRAIN_LIMITS = {"grad_gap": 0.015, "change_gap": 0.009, "ema_change_gap": 0.009}
TINY_SERVE_LIMITS = {"wave_gap_bf16": 0.0025, "codec_gap": 1e-4}


def tiny_cell(name: str, **traffic) -> Cell:
    """The committed cell `name` with the tiny model's widths and smaller
    traffic."""
    cell = copy.deepcopy(find_cell(name))
    cell.config.update(copy.deepcopy(TINY_MODEL))
    if cell.traffic["loop"] == "steps":
        cell.traffic.update({"batch": 4, "phonemes": {"min": 5, "max": 24, "pad": 24},
                             "latents": {"min": 4, "max": 20, "pad": 20}, "refs": {"min": 2, "max": 8, "pad": 8}})
        cell.config["check"].update(TINY_TRAIN_LIMITS, rows_per_block=3)
    else:
        cell.traffic["ramp_s"] = 0.2
        cell.config["check"].update(TINY_SERVE_LIMITS, requests=3)
        if "outstanding" in cell.traffic:
            cell.traffic["outstanding"] = 12
        if "rate_per_s" in cell.traffic:
            cell.traffic["rate_per_s"] = 8.0
    cell.traffic.update(traffic)
    return cell


def committed(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)

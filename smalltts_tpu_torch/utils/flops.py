"""Model-FLOPs accounting (port of smalltts_tpu/utils/flops.py): the FLOPs of
one call counted by PyTorch's FlopCounterMode, the card's peaks from a table
of published figures, and achieved rates against them.
"""

from __future__ import annotations

import os
from typing import Optional

# (substring of torch.cuda.get_device_name, dense bf16 TFLOP/s, HBM GB/s): NVIDIA's published datasheet
# figures for the H100 SXM5, 989 TFLOP/s bf16 dense and 3.35 TB/s of HBM3 ("NVIDIA H100 80GB HBM3").
# SMALLTTS_PEAK_TFLOPS / SMALLTTS_PEAK_GBPS override these and name the peaks of any other card.
_PEAKS = (
    ("H100 80GB HBM3", 989.0, 3350.0),
    ("H100 SXM", 989.0, 3350.0),
)


def device_peaks(device=None) -> tuple[float, float]:
    """-> (peak dense bf16 TFLOP/s, peak HBM GB/s) of `device`: a card name
    (str), a CUDA device or its index (default: card 0). The environment's
    SMALLTTS_PEAK_TFLOPS / SMALLTTS_PEAK_GBPS win; a card the table does not
    hold raises unless both are set."""
    tf = os.environ.get("SMALLTTS_PEAK_TFLOPS")
    bw = os.environ.get("SMALLTTS_PEAK_GBPS")
    if tf and bw:
        return float(tf), float(bw)
    if isinstance(device, str) and not device.startswith("cuda"):
        name = device
    else:
        import torch

        name = torch.cuda.get_device_name(0 if device is None else device)
    for sub, peak_tf, peak_bw in _PEAKS:
        if sub in name:
            return (float(tf) if tf else peak_tf, float(bw) if bw else peak_bw)
    raise ValueError(f"no published peaks for {name!r}: set SMALLTTS_PEAK_TFLOPS and SMALLTTS_PEAK_GBPS")


def _tensor_bytes(tree) -> int:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _mm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """aten.mm, and its out_dtype overload (whose dtype arg comes third)."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """aten.bmm, and its out_dtype overload."""
    return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]


def compiled_cost(fn, *args, **kwargs) -> Optional[dict]:
    """FLOPs and bytes of one call fn(*args, **kwargs), which this runs once:
    -> {"flops": float, "bytes": float}, or None when no FLOP is counted.
    FLOPs are FlopCounterMode's (matmuls, convolutions, attention: 2 a
    multiply-add; elementwise ops are not counted). Bytes are those of the
    tensors in the arguments and the results, each read or written once: a
    floor on the memory traffic, not a count of the bytes every kernel moves."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    # FlopCounterMode's own mm / bmm formulas take the out_dtype overload's dtype (nn.matmul_f32 on the
    # card: torch.mm / torch.bmm with out_dtype=float32) for the output shape, and raise
    mapping = {torch.ops.aten.mm: _mm_flop, torch.ops.aten.bmm: _bmm_flop}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        out = fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    if flops <= 0:
        return None
    return {"flops": flops, "bytes": float(_tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out))}


def utilization(flops: float, nbytes: float, wall_s: float, device=None) -> dict:
    """-> {"achieved_tflops", "mfu", "hbm_gbps", "hbm_frac", "peak_tflops",
    "peak_gbps"} for one call of `flops` FLOPs and `nbytes` bytes taking
    `wall_s` seconds on `device` (device_peaks' argument)."""
    peak_tf, peak_bw = device_peaks(device)
    tflops = flops / wall_s / 1e12
    gbps = nbytes / wall_s / 1e9
    return {
        "achieved_tflops": round(tflops, 2),
        "mfu": round(tflops / peak_tf, 4),
        "hbm_gbps": round(gbps, 1),
        "hbm_frac": round(gbps / peak_bw, 4),
        "peak_tflops": peak_tf,
        "peak_gbps": peak_bw,
    }

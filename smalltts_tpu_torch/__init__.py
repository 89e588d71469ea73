"""smalltts_tpu_torch: the PyTorch/CUDA port of smalltts_tpu for NVIDIA Hopper.

The serving path (codec encode -> style/text encoders -> DMD 4-step DiT ->
fp32 codec decode -> batcher) runs on the card through hand-written kernels
in `csrc/` (built with nvcc at first use, see ops/kernels). The package
imports neither JAX nor the JAX package; it keeps its own copies of the host
modules it needs.

Public API, the JAX package's, loaded on first use (importing the package
loads neither torch's CUDA extensions nor any kernel):

    from smalltts_tpu_torch import SmallTTS
"""

__version__ = "0.1.0"

_LAZY = {
    "SmallTTS": ("smalltts_tpu_torch.infer.pipeline", "SmallTTS"),
    # the reference's published ONNX graphs, interpreted on the card
    "ImportedSmallTTS": ("smalltts_tpu_torch.onnxtorch.pipeline", "ImportedSmallTTS"),
    "OnnxCodec": ("smalltts_tpu_torch.onnxtorch.codec", "OnnxCodec"),
    "estimate_duration": ("smalltts_tpu_torch.infer.pipeline", "estimate_duration"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'smalltts_tpu_torch' has no attribute {name!r}")


__all__ = ["SmallTTS", "ImportedSmallTTS", "OnnxCodec", "estimate_duration", "__version__"]

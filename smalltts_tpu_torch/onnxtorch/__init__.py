"""ONNX -> PyTorch import path (no `onnx` / `onnxruntime` dependency): the
port of smalltts_tpu/onnxjax.

* `proto`: a pure-Python protobuf wire-format reader/writer for the ONNX
  schema subset (the port's own copy);
* `interp`: a graph-walking interpreter: host folding of shape math and a
  registry of ONNX ops in PyTorch (`OnnxFunction`);
* `codec`: `OnnxCodec`, the imported VibeVoice codec;
* `pipeline`: `ImportedSmallTTS`, the reference's published graphs.

This is the parity path; the native codec (models/codec.py) stays the
serving default.
"""

from smalltts_tpu_torch.onnxtorch.interp import OnnxFunction
from smalltts_tpu_torch.onnxtorch.proto import load_model, parse_model

__all__ = ["load_model", "parse_model", "OnnxFunction", "ImportedSmallTTS"]


def __getattr__(name):
    if name == "ImportedSmallTTS":  # lazy: pulls in the sampler stack
        from smalltts_tpu_torch.onnxtorch.pipeline import ImportedSmallTTS

        return ImportedSmallTTS
    raise AttributeError(name)

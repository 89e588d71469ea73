"""ONNX weight and topology inspection helpers over the port's own parser
(port of smalltts_tpu/utils/onnx_import.py). To run the graphs, use
smalltts_tpu_torch.onnxtorch.codec.OnnxCodec."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from smalltts_tpu_torch.onnxtorch.proto import load_model, tensor_to_numpy


def load_initializers(path: str) -> Dict[str, np.ndarray]:
    """ONNX graph -> {initializer name: numpy array}."""
    model = load_model(path)
    base = os.path.dirname(path) or "."
    return {init.name: tensor_to_numpy(init, base) for init in model.graph.initializers}


def describe_graph(path: str) -> str:
    """Human-readable op summary (to reconstruct architectures)."""
    model = load_model(path)
    return "\n".join(f"{node.op_type}: {list(node.inputs)} -> {list(node.outputs)}" for node in model.graph.nodes)

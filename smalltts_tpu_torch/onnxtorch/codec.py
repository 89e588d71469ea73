"""The reference VibeVoice codec, imported from its ONNX assets (port of
smalltts_tpu/onnxjax/codec.py).

The published `assets/codec/{encoder,decoder}.onnx` graphs run through the
interpreter with the same I/O contract: `encode(audio[B,1,T]) ->
latents[B,T',64]`, `decode(latents) -> audio[B,1,T]`. All compute is fp32
with TF32 off (the interpreter's `highest_precision`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from smalltts_tpu_torch.onnxtorch.interp import OnnxFunction
from smalltts_tpu_torch.onnxtorch.proto import load_model
from smalltts_tpu_torch.utils.transfer import resolve_device

# resolved against $SMALLTTS_ASSETS when used, not when this module is imported
DEFAULT_ENCODER = "<assets>/codec/encoder.onnx"
DEFAULT_DECODER = "<assets>/codec/decoder.onnx"


def _resolve(p: Optional[str]) -> Optional[str]:
    if p is None:
        return None
    root = os.environ.get("SMALLTTS_ASSETS", "assets")
    return p.replace("<assets>", root, 1) if p.startswith("<assets>") else p


def assets_present(encoder_path: str = DEFAULT_ENCODER, decoder_path: str = DEFAULT_DECODER) -> bool:
    return os.path.isfile(_resolve(encoder_path)) and os.path.isfile(_resolve(decoder_path))


class OnnxCodec:
    """VibeVoice codec as two functions of (params, x) and a parameter tree.

    `params` is `{"encoder": {...}, "decoder": {...}}` of tensors on
    `device` (None means the card; `device="cpu"` runs on the CPU). Either
    side may be omitted (decode-only serving needs no encoder)."""

    def __init__(self, encoder_path: Optional[str] = DEFAULT_ENCODER,
                 decoder_path: Optional[str] = DEFAULT_DECODER, device=None) -> None:
        self.device = resolve_device(device)
        encoder_path = _resolve(encoder_path)
        decoder_path = _resolve(decoder_path)
        self._enc = self._dec = None
        params = {}
        for side, path in (("encoder", encoder_path), ("decoder", decoder_path)):
            if path is None:
                continue
            fn = OnnxFunction(load_model(path), base_dir=os.path.dirname(path) or ".")
            params[side] = {k: v.to(self.device) for k, v in fn.params.items()}
            if side == "encoder":
                self._enc = fn
            else:
                self._dec = fn
        if not params:
            raise ValueError("OnnxCodec needs at least one of encoder/decoder")
        self.params = params

    @property
    def encoder(self):
        """Imported encoder OnnxFunction, or None (decode-only build)."""
        return self._enc

    @property
    def decoder(self):
        return self._dec

    def encode_fn(self, params, audio: torch.Tensor) -> torch.Tensor:
        """(B, 1, T) fp32 24 kHz -> (B, T', 64)."""
        if self._enc is None:
            raise ValueError("OnnxCodec was built without an encoder")
        return self._enc(params["encoder"], audio.float())

    def decode_fn(self, params, latents: torch.Tensor) -> torch.Tensor:
        """(B, T', 64) -> (B, 1, T) fp32 waveform."""
        if self._dec is None:
            raise ValueError("OnnxCodec was built without a decoder")
        return self._dec(params["decoder"], latents.float())

    def describe(self) -> str:
        lines = []
        for name, fn in (("encoder", self._enc), ("decoder", self._dec)):
            if fn is None:
                continue
            n_params = sum(int(v.numel()) for v in fn.params.values())
            lines.append(f"{name}: {len(fn.model.graph.nodes)} nodes, {n_params / 1e6:.1f}M params, "
                         f"ops={','.join(fn.ops_used())}")
        return "\n".join(lines)

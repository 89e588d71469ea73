"""The port's own models as ONNX graphs with the published I/O contracts
(onnxtorch.pipeline, onnxtorch.codec), through `torch.onnx.export`'s
TorchScript exporter, which needs no `onnx` package.

The wrappers hold a parameter tree as buffers (they become the graph's
initializers) and call the port's model functions; export them with the
plain versions of the kernels (CPU tensors, or kernels.force_plain() on the
card) and in fp32, the published graphs' dtype:

- `CodecEncoder`: audio (B, 1, T) -> latents (B, T / hop, 64);
- `CodecDecoder`: latents (B, T', 64) -> audio (B, 1, T' * hop);
- `ConditionEncoder`: (ref (1, R, 64) f32, ref_len (1,) i64, phonemes
  (1, P) i64, phonemes_mask (1, P) bool) -> (k_ref, v_ref, ref_mask,
  k_text, v_text), the K/V stacks (L, 1, heads, R or P, head_dim);
- `Denoiser`: (x_t, mask, t (1,), k_ref, v_ref, ref_mask, k_text, v_text,
  phonemes_mask, rope (1, S, 64)) -> velocity (1, S, 64). Every input is
  used; the DiT's RoPE tables are cos and sin of `rope`.
"""

from __future__ import annotations

import io

import torch

from smalltts_tpu_torch.models.backbone import BackboneConfig, time_embedding
from smalltts_tpu_torch.models.codec import CodecConfig, codec_decode, codec_encode
from smalltts_tpu_torch.models.dit import dit_encode_cross_kv, dit_forward_cached, fuse_serving_projections
from smalltts_tpu_torch.models.style_encoder import style_encoder
from smalltts_tpu_torch.models.text_encoder import text_encoder
from smalltts_tpu_torch.ops import nn


def export(module: torch.nn.Module, args: tuple, opset: int = 17, dynamic_axes=None, input_names=None,
           output_names=None) -> bytes:
    """torch.onnx.export (TorchScript exporter) to bytes. Its last step, an
    onnxscript pass that needs the `onnx` package and changes nothing for
    standard ops, is skipped."""
    try:
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    except ImportError:  # older torch
        from torch.onnx._internal import onnx_proto_utils
    if hasattr(onnx_proto_utils, "_add_onnxscript_fn"):
        onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    module.eval()
    buf = io.BytesIO()
    with torch.no_grad():
        torch.onnx.export(module, args, buf, opset_version=opset, dynamic_axes=dynamic_axes,
                          input_names=input_names, output_names=output_names, dynamo=False)
    return buf.getvalue()


class _Leaf(int):
    """An index into the wrapper's buffers, marking a leaf of the tree."""


class _Params(torch.nn.Module):
    """A parameter tree's leaves as buffers p0, p1, ...; `tree()` rebuilds it."""

    def __init__(self, tree):
        super().__init__()
        leaves = []

        def index(node):
            if isinstance(node, dict):
                return {k: index(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [index(v) for v in node]
            leaves.append(node)
            return _Leaf(len(leaves) - 1)

        self._def = index(tree)
        for i, t in enumerate(leaves):
            self.register_buffer(f"p{i}", t)

    def tree(self):
        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if isinstance(node, list):
                return [build(v) for v in node]
            return getattr(self, f"p{node}")

        return build(self._def)


class CodecEncoder(_Params):
    def __init__(self, params, cfg: CodecConfig = CodecConfig()):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, audio):
        return codec_encode(self.tree(), audio, self.cfg)


class CodecDecoder(_Params):
    def __init__(self, params, cfg: CodecConfig = CodecConfig()):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, latents):
        return codec_decode(self.tree(), latents, self.cfg)


class ConditionEncoder(_Params):
    def __init__(self, params, cfg: BackboneConfig = BackboneConfig()):
        super().__init__({k: params[k] for k in ("style_encoder", "phoneme_embedding", "dit")})
        self.cfg = cfg

    def forward(self, ref, ref_len, phonemes, phonemes_mask):
        p, cfg = self.tree(), self.cfg
        ref_seq, ref_mask = style_encoder(p["style_encoder"], ref, ref_len, cfg.style)
        emb = text_encoder(p["phoneme_embedding"], phonemes, phonemes_mask, cfg.text)
        kv = dit_encode_cross_kv(p["dit"], cfg.dit, ref_seq, emb, phonemes_mask)
        return kv.k_ref, kv.v_ref, ref_mask, kv.k_text, kv.v_text


class Denoiser(_Params):
    def __init__(self, params, cfg: BackboneConfig = BackboneConfig()):
        params = fuse_serving_projections(params)
        super().__init__({k: params[k] for k in ("time_embedding", "dit", "velocity")})
        self.cfg = cfg

    def forward(self, x_t, mask, t, k_ref, v_ref, ref_mask, k_text, v_text, phonemes_mask, rope):
        p, cfg = self.tree(), self.cfg
        t_emb = time_embedding(p["time_embedding"], t.expand(x_t.shape[0]), cfg.time_embed_dim)
        freqs = rope[0, :, :cfg.dit.rot_dim]
        decoded = dit_forward_cached(p["dit"], cfg.dit, x_t, t_emb, mask, torch.cat([k_ref, k_text], dim=3),
                                     torch.cat([v_ref, v_text], dim=3), torch.cat([ref_mask, phonemes_mask], dim=1),
                                     rope=(torch.cos(freqs), torch.sin(freqs)))
        return nn.linear(p["velocity"], decoded)

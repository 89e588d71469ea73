"""Model configs to and from checkpoint metadata (port of
smalltts_tpu/utils/config_io.py). Lists come back as tuples where the field
wants one, and keys unknown to this build are dropped."""

from __future__ import annotations

import dataclasses
from typing import Optional


def config_to_dict(cfg) -> dict:
    """Nested frozen dataclass -> plain JSON-safe dict."""
    return dataclasses.asdict(cfg)


def backbone_meta(cfg) -> dict:
    """The metadata backbone trainers write into their checkpoints."""
    return {"backbone_config": config_to_dict(cfg)}


def codec_meta(cfg) -> dict:
    """The metadata the codec trainers write into their checkpoints."""
    return {"codec_config": config_to_dict(cfg)}


def _filtered_kwargs(cls, d: dict) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            if isinstance(f.default, tuple) and isinstance(v, list):
                v = tuple(v)
            out[f.name] = v
    return out


def backbone_config_from_dict(d: dict):
    from smalltts_tpu_torch.models.backbone import BackboneConfig
    from smalltts_tpu_torch.models.dit import DiTConfig
    from smalltts_tpu_torch.models.encoder import EncoderConfig

    d = dict(d)
    for key, sub in (("dit", DiTConfig), ("text", EncoderConfig), ("style", EncoderConfig)):
        if isinstance(d.get(key), dict):
            d[key] = sub(**_filtered_kwargs(sub, d[key]))
    return BackboneConfig(**_filtered_kwargs(BackboneConfig, d))


def codec_config_from_dict(d: dict):
    from smalltts_tpu_torch.models.codec import CodecConfig

    return CodecConfig(**_filtered_kwargs(CodecConfig, d))


def backbone_config_from_meta(meta: Optional[dict]):
    """-> BackboneConfig, or None for metadata without one."""
    if meta and isinstance(meta.get("backbone_config"), dict):
        return backbone_config_from_dict(meta["backbone_config"])
    return None


def codec_config_from_meta(meta: Optional[dict]):
    if meta and isinstance(meta.get("codec_config"), dict):
        return codec_config_from_dict(meta["codec_config"])
    return None

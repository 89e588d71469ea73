"""Reader of the JAX package's flat-key `.npz` checkpoints (read side of
smalltts_tpu/utils/checkpoint.py), in numpy alone.

Format: keys `a/b/c` with `#i` marking list items (`enc_stages#3/conv/w`);
bfloat16 leaves stored as uint16 views and named in `__bfloat16_keys__`;
JSON metadata (the architecture config) under `__meta_json__`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

_SEP = "/"
_LIST = "#"
_BF16_KEY = "__bfloat16_keys__"
_META_KEY = "__meta_json__"


def bf16_bits_to_float32(u16: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the same values in float32 (exact)."""
    return (np.asarray(u16, np.uint16).astype(np.uint32) << 16).view(np.float32)


def unflatten_pytree(flat: Dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            if _LIST in part:
                name, idx = part.split(_LIST)
                lst = node.setdefault(name, [])
                while len(lst) <= int(idx):
                    lst.append({})
                if last:
                    lst[int(idx)] = val
                else:
                    node = lst[int(idx)]
            elif last:
                node[part] = val
            else:
                node = node.setdefault(part, {})
    return root


def load_meta(path: str) -> Optional[dict]:
    """The metadata dict saved with the checkpoint, or None."""
    with np.load(path, allow_pickle=False) as data:
        if _META_KEY not in data.files:
            return None
        return json.loads(str(data[_META_KEY]))


def load_pytree(path: str):
    """Nested dict/list of numpy arrays; bfloat16 leaves come back as float32."""
    with np.load(path, allow_pickle=False) as data:
        bf16 = {str(x) for x in data[_BF16_KEY]} if _BF16_KEY in data.files else set()
        flat = {k: (bf16_bits_to_float32(data[k]) if k in bf16 else data[k])
                for k in data.files if k not in (_BF16_KEY, _META_KEY)}
    return unflatten_pytree(flat)

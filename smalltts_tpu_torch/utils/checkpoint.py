"""The JAX package's flat-key `.npz` checkpoints, read and written (port of
smalltts_tpu/utils/checkpoint.py), and the port's own trainer state.

Format: keys `a/b/c` with `#i` marking list items (`enc_stages#3/conv/w`);
bfloat16 leaves stored as uint16 views and named in `__bfloat16_keys__`;
JSON metadata (the architecture config) under `__meta_json__`. A file that
save_pytree writes from a tree in the JAX package's layout
(utils/convert.params_to_jax) loads in both packages.

The trainer state (save_train_state) is the port's own: named keys
`params/...`, `opt_state/mu/...`, `opt_state/nu/...`, `opt_state/count`,
`ema/...`, `step`, in the port's layout. The JAX package stores its optax
state's leaves in tree order, which only optax can rebuild, so the two
trainer-state files do not load across packages (utils/convert.
train_state_from_jax carries a JAX run's state over instead).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

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
    return unflatten_pytree(_read_flat(path))


TORCH_SUFFIXES = (".pt", ".pth", ".bin")  # a reference torch checkpoint; anything else is an npz


def is_torch_checkpoint(path: str) -> bool:
    return str(path).endswith(TORCH_SUFFIXES)


def load_reference_backbone_checkpoint(path: str):
    """A reference torch teacher/DMD checkpoint -> the JAX-layout tree
    (numpy leaves) that `utils.convert.params_from_jax` takes.

    Accepts raw state_dicts, `{"model": ...}` wrappers and the DMD bundle
    (`student_model` key preferred, distill.py:468-479)."""
    from smalltts_tpu_torch.utils.torch_convert import convert_backbone_state_dict, state_dict_to_numpy

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict):
        for key in ("student_model", "model"):
            if key in sd:
                sd = sd[key]
                break
    return convert_backbone_state_dict(state_dict_to_numpy(sd))


def flatten_pytree(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> {"a/b#0/c": leaf}, leaves as they are, in order."""
    out: Dict[str, Any] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}{_SEP}{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}{_LIST}{i}")
        else:
            out[path] = node

    rec(tree, prefix)
    return out


def _to_numpy(leaf):
    """(array, is_bf16): a tensor comes to the host; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), True
        return leaf.numpy(), False
    return np.asarray(leaf), False


def _atomic_savez(path: str, flat: Dict[str, Any], meta: Optional[dict] = None) -> None:
    """Write to a temporary name, then rename: a crash mid-save never
    corrupts the last good file."""
    out, bf16 = {}, []
    for k, v in flat.items():
        out[k], is_bf16 = _to_numpy(v)
        if is_bf16:
            bf16.append(k)
    if bf16:
        out[_BF16_KEY] = np.array(bf16)
    if meta is not None:
        if _META_KEY in out:
            raise ValueError(f"the tree already holds the reserved key {_META_KEY!r}")
        out[_META_KEY] = np.array(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)


def save_pytree(path: str, tree, meta: Optional[dict] = None) -> None:
    """A tree of tensors or arrays as a flat-key npz, `meta` (JSON-safe, e.g.
    config_io.backbone_meta(cfg)) under the reserved key."""
    _atomic_savez(path, flatten_pytree(tree), meta)


def save_train_state(path: str, state) -> None:
    """The trainer's state, {"params", "opt_state", "ema", "step"}, under named keys."""
    _atomic_savez(path, flatten_pytree(state))


def load_train_state(path: str, device="cpu"):
    """save_train_state's tree, its leaves as tensors on `device`."""
    return map_pytree(lambda a: torch.from_numpy(np.array(a)).to(device), unflatten_pytree(_read_flat(path)))


def _read_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        bf16 = {str(x) for x in data[_BF16_KEY]} if _BF16_KEY in data.files else set()
        return {k: (bf16_bits_to_float32(data[k]) if k in bf16 else data[k])
                for k in data.files if k not in (_BF16_KEY, _META_KEY)}


def cast_floating(tree, dtype):
    """Floating leaves cast to `dtype` (bf16 for serving on the card); other
    leaves kept as they are."""
    return map_pytree(lambda x: x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point() else x, tree)


def map_pytree(fn, tree):
    """The same nesting of dicts and lists with fn applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_pytree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_pytree(fn, v) for v in tree]
    return fn(tree)


class AsyncCheckpointer:
    """Checkpoint writes off the training thread. The caller's thread only
    copies the tensors on their device (the step loop goes on changing the
    originals) and records an event; one worker thread waits for the event,
    brings the copies to the host and writes the npz. `wait()` joins the
    queued saves and raises the first error since the last wait."""

    def __init__(self, max_pending: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._errors: list = []
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, event = item
            try:
                if event is not None:
                    event.synchronize()
                fn(*args)
            except Exception as exc:  # raised by wait()
                self._errors.append(exc)
            finally:
                self._q.task_done()

    def _enqueue(self, fn, path, tree, *rest) -> None:
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        snap = map_pytree(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)
        event = None
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in flatten_pytree(snap).values()):
            event = torch.cuda.Event()
            event.record()
        self._q.put((fn, (path, snap, *rest), event))

    def save_pytree(self, path: str, tree, meta: Optional[dict] = None) -> None:
        self._enqueue(save_pytree, path, tree, meta)

    def save_train_state(self, path: str, state) -> None:
        self._enqueue(save_train_state, path, state)

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            errors, self._errors = self._errors, []
            raise errors[0]

    def close(self) -> None:
        """Flush, then stop the worker, also when the flush raises."""
        self._closed = True
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=60)

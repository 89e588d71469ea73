"""The device an entry point runs on, and host-to-device copies that do not
wait for the device."""

from __future__ import annotations

import numpy as np
import torch


def to_device(a, device) -> torch.Tensor:
    """A host array as a tensor on `device`. To a CUDA device the copy goes
    from pinned memory, asynchronously on the current stream, so it queues
    behind the work already there instead of waiting for it (a copy from
    pageable memory synchronizes the stream). PyTorch's pinned-memory
    allocator keeps the host buffer until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def resolve_device(device=None) -> torch.device:
    """None means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SmallTTS runs on a CUDA card and none is available; "
                           "pass device='cpu' to run on the CPU explicitly")
    return dev

"""Device selection and host-to-device transfer.

`resolve_device` plays the role of ``JAX_PLATFORMS``: the caller names the
device, and asking for CUDA on a machine without a usable GPU raises.
`to_device` takes the place of keyhunt_tpu's `runtime.fast_put`.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """'cuda' / 'cpu' (or a torch.device) -> torch.device; 'cuda' without
    a GPU raises instead of falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(use --device cpu for the plain path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _as_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:          # limb/slab words: int32 bit patterns
        arr = arr.view(np.int32)
    if not arr.flags.writeable:         # memmapped tables: torch wants a copy
        arr = arr.copy()
    return torch.from_numpy(arr)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on `device`. uint32 arrays arrive as int32 bit
    patterns (the package's limb storage type). CUDA uploads go through
    pinned memory and are asynchronous on the current stream."""
    t = _as_torch(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t

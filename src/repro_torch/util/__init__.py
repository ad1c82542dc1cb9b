"""Device helpers shared by the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA on a host
    without a card raises (nothing quietly continues on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but CUDA is not "
            f"available here; pass device='cpu' to run the plain path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Host array -> tensor on ``device``. To a card it copies from
    pinned memory without blocking, so the host does not wait on the
    stream (the caller's decode step keeps its single sync)."""
    t = torch.from_numpy(np.array(a, dtype=dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t

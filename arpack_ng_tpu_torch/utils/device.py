"""The device the package's entry points run on.

Every public constructor and entry point runs on the CUDA card unless the
caller names another device (``device="cpu"``).  A default call on a
machine without CUDA raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

#: device of every entry point that is not given one
DEFAULT = "cuda"


def normalized(device) -> tuple:
    """``(type, index)`` of ``device`` with the index filled in: the
    current CUDA device for ``"cuda"`` (0 where this process has no CUDA),
    0 for any other device given without one.  ``torch.device("cuda")``
    and ``torch.device("cuda:0")`` compare unequal; their normal forms do
    not."""
    dev = torch.device(device)
    if dev.index is not None:
        return dev.type, dev.index
    if dev.type == "cuda" and torch.cuda.is_available():
        return dev.type, torch.cuda.current_device()
    return dev.type, 0


def same(a, b) -> bool:
    """Whether two device specifications name the same device."""
    return normalized(a) == normalized(b)


def require(device) -> torch.device:
    """``device`` as a ``torch.device``; raise a clear error when it is a
    CUDA device and this process has no CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested, but CUDA is not available: the package "
            "runs on the card by default; pass device='cpu' to run on the "
            "CPU")
    return dev

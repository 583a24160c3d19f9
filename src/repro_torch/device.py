"""Device resolution shared by the port's entry points.

Entry points default to ``"cuda"``.  A CUDA request on a machine without
a usable GPU raises instead of silently running on the CPU: the CPU path
exists for tests and must be asked for explicitly (``device="cpu"``).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "expected 'cuda' or 'cpu'")
    return dev

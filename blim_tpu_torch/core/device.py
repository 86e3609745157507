"""Device resolution for the port's entry points.

Every entry point takes `device` (default "cuda"). A CUDA device without a
GPU raises instead of drifting to the CPU: the CPU runs only when the caller
asks for it, as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev

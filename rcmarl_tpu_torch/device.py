"""The port's device policy.

Every entry point runs on the GPU unless its caller asks for the CPU
(``device="cpu"``, as the tests do). Asking for nothing on a host with
no CUDA device is an error, never a quiet run on the CPU: a number
measured on the host must not pass for one measured on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given.
    Raises ``RuntimeError`` when a CUDA device is wanted and there is
    none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host explicitly"
        )
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """The card's name for a CUDA device, ``'cpu'`` for the host."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"

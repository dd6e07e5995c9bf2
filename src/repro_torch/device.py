"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when CUDA is asked for (or implied by ``None``) and no
    card is present, so a run never drops to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work before a host clock is read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

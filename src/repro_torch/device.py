"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and a CUDA device on a host without one raises instead of
quietly running elsewhere.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

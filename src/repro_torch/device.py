"""Device policy of the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` argument they take ``cuda``, and without a CUDA device they raise
instead of carrying on quietly on the CPU.  The tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["NoCudaDeviceError", "resolve_device"]


class NoCudaDeviceError(RuntimeError):
    """An entry point was called without a device and no CUDA device exists."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

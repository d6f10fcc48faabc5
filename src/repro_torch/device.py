"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceSpec = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceSpec = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks.

    ``None`` means the CUDA device; when no card is present that raises
    instead of quietly running on the CPU.  Pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev

"""What every kernel wrapper shares: the checks of its int32 tensors and
the launch of a ``ctypes``-bound entry point on the current stream.

Each CUDA source under ``kernels/*/csrc/`` exports entry points that take
the current stream last and return ``cudaGetLastError()``, and an
``*_error_string`` function that names such a code.
"""
from __future__ import annotations

import torch


def check_int32(name: str, **tensors: torch.Tensor) -> torch.device:
    """All tensors int32, 1-D, contiguous, non-empty, on one CPU or CUDA
    device; returns that device."""
    devices = set()
    for arg, t in tensors.items():
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous 1-D int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.numel() == 0:
            raise ValueError(f"{name}: {arg} is empty")
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def launch(name: str, fn, error_string, *args) -> None:
    """Call entry point ``fn`` with ``args`` and the current stream; raise
    if the launch was refused."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")

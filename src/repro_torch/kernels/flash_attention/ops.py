"""Wrapper of the flash-attention kernel: check, dispatch, count.

``flash_attention`` checks its tensors (f32 or bf16, one dtype, 4-D,
contiguous, one device, head dim 32, 64 or 128, ``Lq <= Lk``) and
dispatches on their device: a CPU tensor runs the plain version in
``ref.py``; a CUDA tensor launches the kernel of ``csrc/flash.cu`` on the
current stream, or raises.  ``LAUNCHES`` counts its kernel launches and
nothing else.  The library is built and loaded at the first launch, never
at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int

LAUNCHES = {"flash_attention": 0}
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.flash_attention.argtypes = ([_P] * 4 + [_I] * 8 + [ctypes.c_float]
                                    + [_P])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [_I]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; q, k and "
                             f"v must all be float32 or all bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-D tensor, got {tuple(t.shape)}")
        if t.device != q.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    b, hq, lq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hkv, lk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if min(b, hq, hkv, lq) < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} "
                         f"key/value heads, batch {b}, {lq} queries")
    if lq > lk:
        raise ValueError(f"flash_attention: {lq} queries over {lk} keys; the "
                         "queries sit at the end of the keys, so Lq <= Lk")


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """Attention with GQA and the queries at the end of the keys.  q [B, Hq,
    Lq, D]; k, v [B, Hkv, Lk, D]; returns [B, Hq, Lq, D] in q's dtype.  See
    :func:`ref.attention_ref`."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[3] ** -0.5
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    b, hq, lq, d = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    launch("flash_attention", lib.flash_attention, lib.flash_error_string,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           _DTYPES[q.dtype], b, hq, k.shape[1], lq, k.shape[2], d,
           int(causal), float(sm_scale))
    LAUNCHES["flash_attention"] += 1
    return out


def reset_counts() -> None:
    """Zero ``LAUNCHES`` and the plain version's ``calls``."""
    LAUNCHES["flash_attention"] = 0
    ref.attention_ref.calls = 0

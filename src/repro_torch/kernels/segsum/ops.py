"""Wrapper of the segment-sum kernel: check, dispatch, count.

``sorted_segment_sum`` checks its tensors (data f32 or bf16 ``[N, D]``,
ids int32 ``[N]``, both contiguous, on one device) and dispatches on that
device: a CPU tensor runs the plain version in ``ref.py``; a CUDA tensor
launches the kernel of ``csrc/segsum.cu`` on the current stream, or raises.
``LAUNCHES`` counts its kernel launches and nothing else.  The library is
built and loaded at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch
from repro_torch.kernels.segsum import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "segsum.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int

LAUNCHES = {"sorted_segment_sum": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.sorted_segment_sum.argtypes = [_P, _P, ctypes.c_longlong, _I, _I, _I,
                                       _P, _P, _P]
    lib.sorted_segment_sum.restype = ctypes.c_int
    lib.segsum_error_string.argtypes = [_I]
    lib.segsum_error_string.restype = ctypes.c_char_p
    return lib


def sorted_segment_sum(data, seg_ids, n_segments: int):
    """Sum the rows of ``data`` [N, D] by segment id into [n_segments, D],
    in data's dtype; ids outside ``[0, n_segments)`` add nothing, and the
    ids need not be sorted.  See :func:`ref.sorted_segment_sum_ref`."""
    if data.dtype not in _DTYPES or data.dim() != 2 or \
            not data.is_contiguous():
        raise ValueError(f"sorted_segment_sum: data must be a contiguous 2-D "
                         f"float32 or bfloat16 tensor, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if seg_ids.dtype != torch.int32 or seg_ids.dim() != 1 or \
            not seg_ids.is_contiguous():
        raise ValueError(f"sorted_segment_sum: seg_ids must be a contiguous "
                         f"1-D int32 tensor, got {seg_ids.dtype} "
                         f"{tuple(seg_ids.shape)}")
    if seg_ids.shape[0] != data.shape[0]:
        raise ValueError(f"sorted_segment_sum: {seg_ids.shape[0]} ids for "
                         f"{data.shape[0]} rows")
    if data.device != seg_ids.device or \
            data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sorted_segment_sum: data on {data.device}, ids on "
                         f"{seg_ids.device}")
    if not 0 <= n_segments < 2 ** 31:
        raise ValueError(f"sorted_segment_sum: n_segments={n_segments}")
    if data.device.type == "cpu":
        return ref.sorted_segment_sum_ref(data, seg_ids, n_segments)
    n, d = data.shape
    acc = torch.empty(n_segments, d, dtype=torch.float32, device=data.device)
    out = acc if data.dtype == torch.float32 else torch.empty(
        n_segments, d, dtype=data.dtype, device=data.device)
    lib = _lib()
    launch("sorted_segment_sum", lib.sorted_segment_sum,
           lib.segsum_error_string, data.data_ptr(), seg_ids.data_ptr(), n, d,
           n_segments, _DTYPES[data.dtype], acc.data_ptr(), out.data_ptr())
    LAUNCHES["sorted_segment_sum"] += 1
    return out


def reset_counts() -> None:
    """Zero ``LAUNCHES`` and the plain version's ``calls``."""
    LAUNCHES["sorted_segment_sum"] = 0
    ref.sorted_segment_sum_ref.calls = 0

"""Wrapper of the intersection-count kernel: check, dispatch, count.

``intersect_count`` checks its tensors (int32, 1-D, contiguous, one device)
and dispatches on that device: a CPU tensor runs the plain version in
``ref.py``; a CUDA tensor launches the kernel of ``csrc/intersect.cu`` on
the current stream, or raises.  ``LAUNCHES`` counts its kernel launches and
nothing else.  The library is built and loaded at the first launch, never
at import.  ``kernel_paths`` says which of the kernel's paths each pair
takes, from the arguments alone.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_int32, launch
from repro_torch.kernels.intersect import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "intersect.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int

LAUNCHES = {"intersect_count": 0}

# the kernel's staged forms of segment A (csrc/intersect.cu: kBits, kWords;
# tests/test_torch_intersect.py holds the two equal)
BITMAP_BITS = 1 << 16
LIST_WORDS = 2048
# the paths of kernel_paths, by their code
PATHS = ("empty", "bitmap", "list", "search")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.intersect_count.argtypes = [_P] * 5 + [_I] * 4 + [_P] * 2
    lib.intersect_count.restype = ctypes.c_int
    lib.intersect_error_string.argtypes = [_I]
    lib.intersect_error_string.restype = ctypes.c_char_p
    return lib


def intersect_count(col_idx, lo_a, hi_a, lo_b, hi_b, *, max_deg: int,
                    n_steps: int):
    """|col_idx[lo_a:hi_a] ∩ col_idx[lo_b:hi_b]| per pair, int32[n_pairs]:
    the first ``max_deg`` elements of each segment A are searched for in
    segment B by ``n_steps`` branchless halvings.  See
    :func:`ref.intersect_count_ref`."""
    dev = check_int32("intersect_count", col_idx=col_idx, lo_a=lo_a,
                      hi_a=hi_a, lo_b=lo_b, hi_b=hi_b)
    n = lo_a.shape[0]
    if any(t.shape[0] != n for t in (hi_a, lo_b, hi_b)):
        raise ValueError("intersect_count: segment bounds differ in length")
    if max_deg < 0 or n_steps < 1:
        raise ValueError(f"intersect_count: max_deg={max_deg}, "
                         f"n_steps={n_steps}")
    if dev.type == "cpu":
        return ref.intersect_count_ref(col_idx, lo_a, hi_a, lo_b, hi_b,
                                       max_deg=max_deg, n_steps=n_steps)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _lib()
    launch("intersect_count", lib.intersect_count, lib.intersect_error_string,
           *(t.data_ptr() for t in (col_idx, lo_a, hi_a, lo_b, hi_b)),
           col_idx.shape[0], n, max_deg, n_steps, out.data_ptr())
    LAUNCHES["intersect_count"] += 1
    return out


def kernel_paths(col_idx, lo_a, hi_a, lo_b, hi_b, *, max_deg: int,
                 n_steps: int) -> torch.Tensor:
    """The path each pair takes in the kernel, int8[n_pairs], a code into
    ``PATHS``: ``empty`` counts 0 without a search (A' = the first
    ``max_deg`` elements of A, or B, is empty); ``bitmap`` and ``list``
    probe B in A' staged as a bitmap over its span or as its sorted list;
    ``search`` is a pair that fails a gate of those two (A' or B out of
    strict order or reaching outside ``col_idx``, |B| over 2^n_steps - 1,
    or A' wider than ``BITMAP_BITS`` ids and longer than ``LIST_WORDS``)
    and runs the TPU kernel's search."""
    m = col_idx.shape[0]
    col = col_idx.long()
    la, ha, lb, hb = (t.long() for t in (lo_a, hi_a, lo_b, hi_b))
    # breaks[i]: the positions j in 1..i with col[j] <= col[j - 1]
    breaks = torch.zeros(m, dtype=torch.long, device=col.device)
    breaks[1:] = col[1:] <= col[:-1]
    breaks = breaks.cumsum(0)

    def ascending(lo, hi):          # col[lo:hi) strictly, for lo < hi
        return (breaks[(hi - 1).clamp(0, m - 1)]
                == breaks[lo.clamp(0, m - 1)])

    n_a = (ha - la).clamp(0, max_deg)
    a_ok = (la >= 0) & (la + n_a <= m) & ascending(la, la + n_a)
    span = (col[(la + n_a - 1).clamp(0, m - 1)] - col[la.clamp(0, m - 1)]
            + 1)
    bitmap = a_ok & (span <= BITMAP_BITS)
    listed = a_ok & ~bitmap & (n_a <= LIST_WORDS)
    b_ok = ((lb >= 0) & (hb <= m) & (hb - lb < 1 << min(n_steps, 62))
            & ascending(lb, hb))
    path = torch.full_like(la, PATHS.index("search"), dtype=torch.int8)
    path[listed & b_ok] = PATHS.index("list")
    path[bitmap & b_ok] = PATHS.index("bitmap")
    path[(n_a == 0) | (lb >= hb)] = PATHS.index("empty")
    return path


def reset_counts() -> None:
    """Zero ``LAUNCHES`` and the plain version's ``calls``."""
    LAUNCHES["intersect_count"] = 0
    ref.intersect_count_ref.calls = 0

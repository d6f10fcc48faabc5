"""Wrapper of the segment-sum kernel: check, dispatch, count.

``sorted_segment_sum`` checks its tensors (data f32 or bf16 ``[N, D]``,
ids int32 ``[N]``, both contiguous, on one device) and dispatches on that
device: a CPU tensor runs the plain version in ``ref.py``; a CUDA tensor
launches the kernel of ``csrc/segsum.cu`` on the current stream, or raises.
``LAUNCHES`` counts its wrapper's launches (one a call, however many CUDA
kernels the C function starts) and nothing else.  ``tile_plan`` cuts the
rows into the kernel's grid on the host.  The library is built and loaded
at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch
from repro_torch.kernels.segsum import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "segsum.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int

LAUNCHES = {"sorted_segment_sum": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SMS = 132                 # an H100's SMs
CTAS_PER_SM = 4           # resident 256-thread CTAs at up to 64 registers
WAVES = 4                 # CTAs the grid should give, in waves of SMS x 4
THREADS = 256             # a CTA
MIN_CTA_BYTES = 64 << 10  # a CTA reads at least this much where n allows
MAX_GROUP_ROWS = 256


class TilePlan(NamedTuple):
    """The kernel's grid: ``row_tiles`` x ``col_tiles`` CTAs of ``THREADS``
    threads in groups of ``lanes`` lanes; a group sums ``group_rows``
    consecutive rows of a column tile ``lanes * per_lane`` wide, with
    16-byte loads if ``vector``."""
    vector: bool
    per_lane: int
    lanes: int
    group_rows: int
    row_tiles: int
    col_tiles: int

    @property
    def tile_rows(self) -> int:
        return THREADS // self.lanes * self.group_rows

    @property
    def tile_cols(self) -> int:
        return self.lanes * self.per_lane


def tile_plan(n: int, d: int, elem_size: int, address: int) -> TilePlan:
    """The grid of ``csrc/segsum.cu`` for ``n`` rows of ``d`` elements of
    ``elem_size`` bytes at ``address``: a lane holds 16 bytes of a row
    (``per_lane`` columns), on the 16-byte path if a row is a whole number
    of 16-byte vectors and ``address`` is 16-byte aligned; a row group has
    the fewest lanes (a power of two up to 32) that reach across the row,
    and a wider row is cut into column tiles of 32 lanes; ``group_rows`` is
    the largest power of two up to ``MAX_GROUP_ROWS`` (or the least that
    reads ``MIN_CTA_BYTES`` a CTA, if more) that still gives ``WAVES``
    waves of CTAs, and at least that least."""
    per_lane = 16 // elem_size
    vector = (d * elem_size) % 16 == 0 and address % 16 == 0
    lanes = 1
    while lanes < 32 and lanes * per_lane < d:
        lanes *= 2
    width = lanes * per_lane
    col_tiles = -(-d // width)
    groups = THREADS // lanes
    row_bytes = max(1, min(d, width) * elem_size * groups)
    least = 1
    while least * row_bytes < MIN_CTA_BYTES:
        least *= 2
    want = WAVES * SMS * CTAS_PER_SM
    rows = max(least, MAX_GROUP_ROWS)

    def tiles(g: int) -> int:
        return -(-n // (groups * g))
    while rows > least and tiles(rows) * col_tiles < want:
        rows //= 2
    return TilePlan(vector, per_lane, lanes, rows, tiles(rows), col_tiles)


@functools.lru_cache(maxsize=None)
def _lib(source: Path = SOURCE) -> ctypes.CDLL:
    """The built library of ``source`` (by default the repository's
    ``csrc/segsum.cu``; ``bench.py`` passes other builds), bound."""
    lib = build.load(source)
    lib.sorted_segment_sum.argtypes = [_P, _P, ctypes.c_longlong, _I, _I, _I,
                                       _I, _I, _I, ctypes.c_longlong, _I,
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
    plan = tile_plan(n, d, data.element_size(), data.data_ptr())
    lib = _lib()
    launch("sorted_segment_sum", lib.sorted_segment_sum,
           lib.segsum_error_string, data.data_ptr(), seg_ids.data_ptr(), n, d,
           n_segments, _DTYPES[data.dtype], int(plan.vector), plan.lanes,
           plan.group_rows, plan.row_tiles, plan.col_tiles, acc.data_ptr(),
           out.data_ptr())
    LAUNCHES["sorted_segment_sum"] += 1
    return out


def reset_counts() -> None:
    """Zero ``LAUNCHES`` and the plain version's ``calls``."""
    LAUNCHES["sorted_segment_sum"] = 0
    ref.sorted_segment_sum_ref.calls = 0

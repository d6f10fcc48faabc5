"""Wrapper of the flash-attention kernel: check, dispatch, count.

``flash_attention`` checks its tensors (f32 or bf16, one dtype, 4-D,
contiguous, one device, head dim 32, 64 or 128, ``Lq <= Lk``) and
dispatches on their device: a CPU tensor runs the plain version in
``ref.py``; a CUDA tensor launches the kernel of ``csrc/flash.cu`` on the
current stream, or raises.  The kernel has two variants, chosen by dtype
alone: bf16 runs on the tensor cores (wgmma fed by TMA); f32 runs its
products as 3xTF32 on the tensor cores (mma.sync) and its softmax and
sums on the FMA pipes.  The f32 variant follows ``fma_plan``'s work list:
a call whose plan splits query tiles runs two CUDA kernels, ``flash_fma``
and then ``flash_fma_merge``, in the one C call.  ``LAUNCHES`` counts the
wrapper's launches (one a call, however many CUDA kernels it starts) and
nothing else, and ``VARIANT_LAUNCHES`` counts them again by variant.  The
library is built and loaded at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int

LAUNCHES = {"flash_attention": 0}
VARIANT_LAUNCHES = {"tensor_core": 0, "fma": 0}
_VARIANTS = {torch.bfloat16: "tensor_core", torch.float32: "fma"}
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# flash_fma's tiles and work list (csrc/flash.cu kBQ, kBK)
FMA_ROWS = 64             # query rows a tile (a CTA)
FMA_KEYS = 64             # keys a key tile
SMS = 132                 # an H100's SMs
FMA_SLOTS = 2 * SMS       # resident flash_fma CTAs: two an SM


class FmaPlan(NamedTuple):
    """How ``flash_fma`` cuts one call.  Each of ``heads`` (batch x query
    head) has query tiles of ``FMA_ROWS`` rows; tile t sees
    ``key_tiles[t]`` key tiles of ``FMA_KEYS`` keys (to its last row's
    diagonal if causal) and is cut into ``chunks(t)`` chunks of nearly
    equal numbers of them, at most ``chunk_tiles``.  ``items`` lists one
    head's chunks as (t, c, first key tile, end key tile), longest first;
    the grid runs the list for every head."""
    heads: int
    key_tiles: tuple[int, ...]
    chunk_tiles: int
    items: tuple[tuple[int, int, int, int], ...]

    def chunks(self, t: int) -> int:
        return -(-self.key_tiles[t] // self.chunk_tiles)

    @property
    def max_chunks(self) -> int:
        return self.chunks(len(self.key_tiles) - 1)

    @property
    def split(self) -> bool:
        """Whether some tile has more than one chunk (and the merge
        runs)."""
        return len(self.items) > len(self.key_tiles)


def _key_tiles(lq: int, lk: int, causal: bool) -> tuple[int, ...]:
    n_qt = -(-lq // FMA_ROWS)
    return tuple(-(-((min(lq, (t + 1) * FMA_ROWS) + lk - lq) if causal
                     else lk) // FMA_KEYS) for t in range(n_qt))


def _items(key_tiles, chunk_tiles: int) -> tuple:
    items = []
    for t, n in enumerate(key_tiles):
        n_c = -(-n // chunk_tiles)
        items += [(t, c, c * n // n_c, (c + 1) * n // n_c)
                  for c in range(n_c)]
    return tuple(sorted(items, key=lambda it: (it[2] - it[3], -it[0],
                                               it[1])))


def _n_items(key_tiles, chunk_tiles: int) -> int:
    return sum(-(-n // chunk_tiles) for n in key_tiles)


def _makespan(items, heads: int) -> int:
    """Key tiles on the busiest of ``FMA_SLOTS`` CTA slots (two an SM, so a
    CTA alone on an SM counts as slow as one that shares it) when every
    head's items go, longest first, each to the slot with the least work
    so far, at one key tile of cost an item besides its own (Q's copy,
    the partial sums' write and merge)."""
    loads = [0] * FMA_SLOTS
    for _, _, lo, hi in items:
        for _ in range(heads):
            heapq.heapreplace(loads, loads[0] + hi - lo + 1)
    return max(loads)


@functools.lru_cache(maxsize=4096)
def fma_plan(b: int, hq: int, hkv: int, lq: int, lk: int, d: int,
             causal: bool, *, chunk_tiles: int | None = None) -> FmaPlan:
    """``flash_fma``'s work list for q [b, hq, lq, d] over k, v [b, hkv,
    lk, d] (the cut depends on b x hq, lq, lk and causal alone).  Where the
    (batch, head, query tile)s fill ``FMA_SLOTS`` CTAs, one chunk a tile.
    Else, of the chunk lengths from the largest that gives at least
    ``4 * FMA_SLOTS`` items to the largest that gives at least
    ``FMA_SLOTS`` (one key tile where the work is smaller), the one that
    leaves the least on the busiest slot (``_makespan``), the longer on a
    tie.  ``chunk_tiles`` forces a chunk length (tests, the bench).  Pure
    Python: no device, no copy."""
    del hkv, d
    heads = b * hq
    key_tiles = _key_tiles(lq, lk, causal)
    longest = key_tiles[-1]

    def largest(want: int) -> int:     # the longest chunk giving `want`
        lo, hi = 1, longest
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if heads * _n_items(key_tiles, mid) >= want:
                lo = mid
            else:
                hi = mid - 1
        return lo

    if chunk_tiles is None:
        chunk_tiles = longest
        if heads * len(key_tiles) < FMA_SLOTS:
            top, low = largest(FMA_SLOTS), largest(4 * FMA_SLOTS)
            lengths = {top, *range(low, top, max(1, (top - low) // 24))}
            chunk_tiles = min(lengths, key=lambda n: (
                _makespan(_items(key_tiles, n), heads), -n))
    chunk_tiles = max(1, min(chunk_tiles, longest))
    return FmaPlan(heads, key_tiles, chunk_tiles,
                   _items(key_tiles, chunk_tiles))


def fma_launch_args(plan: FmaPlan, d: int):
    """The f32 launch's plan arguments: chunk length, items a head, the
    packed item table (t | c << 16 an item, in the plan's order), or None
    for one chunk a tile, and the workspace's floats (chunks' 64 x d
    accumulators, then their (m, l) pairs; 0 for one chunk a tile)."""
    if not plan.split:
        return plan.chunk_tiles, len(plan.items), None, 0
    slots = plan.heads * len(plan.key_tiles) * plan.max_chunks
    return (plan.chunk_tiles, len(plan.items),
            tuple(t | c << 16 for t, c, _, _ in plan.items),
            slots * FMA_ROWS * (d + 2))


def device_table(packed, device) -> torch.Tensor:
    """A packed item table as int32 on ``device``, copied from pinned
    memory on the current stream: no sync."""
    return torch.tensor(packed, dtype=torch.int32).pin_memory().to(
        device, non_blocking=True)


@functools.lru_cache(maxsize=4096)
def _fma_args(b, hq, hkv, lq, lk, d, causal, device):
    """``fma_launch_args`` of the shape's plan with its table on ``device``
    (made at a shape's first call, then kept here) and the table's
    address."""
    chunk_tiles, n_items, packed, ws_floats = fma_launch_args(
        fma_plan(b, hq, hkv, lq, lk, d, causal), d)
    table = None if packed is None else device_table(packed, device)
    return (chunk_tiles, n_items, table,
            None if table is None else table.data_ptr(), ws_floats)


@functools.lru_cache(maxsize=None)
def _lib(source: Path = SOURCE) -> ctypes.CDLL:
    """The built library of ``source`` (by default the repository's
    ``csrc/flash.cu``; ``bench.py`` passes other builds), bound."""
    lib = build.load(source)
    lib.flash_attention.argtypes = ([_P] * 5 + [_I] * 8 + [ctypes.c_float]
                                    + [_I, _I, _P, _P])
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
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    chunk_tiles = n_items = ws_floats = 0
    table = ws = None
    if q.dtype == torch.float32:
        chunk_tiles, n_items, _, table, ws_floats = _fma_args(
            b, hq, hkv, lq, lk, d, bool(causal), q.device)
    if ws_floats:       # a split call's chunks' partial sums
        ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    lib = _lib()
    launch("flash_attention", lib.flash_attention, lib.flash_error_string,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           None if ws is None else ws.data_ptr(),
           _DTYPES[q.dtype], b, hq, hkv, lq, lk, d, int(causal),
           float(sm_scale), chunk_tiles, n_items, table)
    LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[_VARIANTS[q.dtype]] += 1
    return out


def reset_counts() -> None:
    """Zero ``LAUNCHES``, ``VARIANT_LAUNCHES`` and the plain version's
    ``calls``."""
    LAUNCHES["flash_attention"] = 0
    for variant in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[variant] = 0
    ref.attention_ref.calls = 0

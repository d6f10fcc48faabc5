"""Streaming edge blocks (paper §5.2, out-of-core; counterpart of
``repro.core.blocks``).

Edge blocking bounds peak device memory by mining the level-0 worklist in
contiguous chunks:

* **Block construction** — contiguous worklist ranges (:func:`make_blocks`).
  After degree relabeling (:func:`repro_torch.graph.csr.relabel`) the hot
  high-degree core sits in the id prefix, so contiguity is locality.  The
  block size comes from the caller or from a byte budget through the
  analytic live-bytes model (:func:`auto_block_size`).
* **Live-bytes model** — :func:`estimate_live_bytes` prices one block's
  device residency from its capacity plan.  It is deterministic and
  monotone in every capacity, so a blocked run prices below the unblocked
  one; it is also ``Miner.peak_live_bytes``.
* **Streaming queue** — :class:`BlockQueue` keeps the worklist columns once
  in pinned host memory and copies one block at a time to the device on a
  side CUDA stream, block i+1's copy issued before block i is handed to
  the consumer, so the copy overlaps the mining of the block before it.

The arithmetic of every function here is the JAX package's, so both give
the same blocks, prices and scaled plans.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.plan import bucket_pow2
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.obs import metrics as _M
from repro_torch.obs import trace as _T

# Bytes per i32 column element; every embedding-list column is i32.
_W = 4


@dataclasses.dataclass(frozen=True)
class EdgeBlock:
    """One contiguous level-0 worklist range ``[lo, lo + n)``."""

    index: int
    lo: int
    n: int


def make_blocks(m: int, block_size: int,
                count: Optional[int] = None) -> list[EdgeBlock]:
    """Split an ``m``-entry worklist into contiguous blocks.

    ``count`` forces exactly that many blocks (trailing ones possibly
    empty), one per device on the sharded path.
    """
    block_size = max(int(block_size), 1)
    blocks = [EdgeBlock(index=i, lo=lo, n=min(block_size, m - lo))
              for i, lo in enumerate(range(0, max(m, 0), block_size))]
    if not blocks:
        blocks = [EdgeBlock(index=0, lo=0, n=0)]
    if count is not None:
        if len(blocks) > count:
            raise ValueError(f"{len(blocks)} blocks of {block_size} "
                             f"exceed requested count {count}")
        blocks += [EdgeBlock(index=i, lo=m, n=0)
                   for i in range(len(blocks), count)]
    return blocks


def estimate_live_bytes(kind: str,
                        caps: Sequence[tuple[int, int]],
                        filter_caps: Sequence[int] = (),
                        cap0: int = 0) -> int:
    """Analytic peak of device-resident mining bytes for one (blocked) run.

    Prices what the pipelines keep live at the deepest level: every
    level's SoA columns (level 0 two columns and the memo state for vertex
    apps, four for edge apps; each extension level its ``out_cap``-sized
    columns), the widest materialised frontier, and the candidate buffers
    of the largest extend.  Deterministic and monotone in ``cap0`` and in
    every capacity, so a blocked run (every cap scaled down by the block
    ratio) always prices below the unblocked run.
    """
    cap0 = int(cap0)
    caps = [(int(c), int(o)) for c, o in caps]
    if kind == "vertex":
        total = 3 * _W * cap0                      # vid + idx + state
        width = 2
        frontier = _W * cap0 * width               # materialised emb matrix
        cand_peak = 0
        for cand_cap, out_cap in caps:
            width += 1
            total += 3 * _W * out_cap              # vid + idx + state
            frontier = max(frontier, _W * out_cap * width)
            cand_peak = max(cand_peak, 4 * _W * cand_cap)
        return total + frontier + cand_peak
    # edge-induced: all levels stay live (the domain reduce walks them),
    # each level 4 columns; the frontier expands every level to E+1 slots
    total = 4 * _W * cap0
    level_caps = [cap0] + [o for _, o in caps]
    for fc in filter_caps:                         # post-filter compactions
        level_caps.append(int(fc))
    for c in level_caps[1:]:
        total += 4 * _W * c
    n_slots = len(caps) + 2
    deepest = max(level_caps) if level_caps else 0
    frontier = _W * deepest * (2 * n_slots + 2)    # v0, vid/his[E], eid[E]
    cand_peak = max((5 * _W * c for c, _ in caps), default=0)
    return total + frontier + cand_peak


def scale_caps(caps: Sequence[tuple[int, int]],
               filter_caps: Sequence[int], ratio: float
               ) -> tuple[tuple[tuple[int, int], ...], tuple[int, ...]]:
    """Scale a capacity schedule by a worklist ratio (floor 128, pow2/raw).

    Blocked runs reuse the full-worklist plan with every capacity scaled
    by ``block / worklist``; the executor's grow-on-overflow backstop
    covers skewed blocks (the hub block extends far more than a tail
    block).  No ceiling is applied here: the executor clips what it adopts
    (:meth:`repro_torch.core.plan.MiningExecutor.adopt_plan`).
    """
    ratio = float(ratio)
    sc = tuple((bucket_pow2(int(np.ceil(c * ratio))),
                max(-(-int(np.ceil(o * ratio)) // 128) * 128, 128))
               for c, o in caps)
    fc = tuple(max(-(-int(np.ceil(f * ratio)) // 128) * 128, 128)
               for f in filter_caps)
    return sc, fc


def auto_block_size(m: int, caps: Sequence[tuple[int, int]],
                    filter_caps: Sequence[int], budget_bytes: int,
                    kind: str = "vertex", min_block: int = 128) -> int:
    """The largest block size whose estimated live bytes fit a budget.

    ``caps``/``filter_caps`` describe the full-worklist plan; candidate
    block sizes walk down the power-of-two grid, each priced with the plan
    scaled by ``block / m``.  Returns ``m`` when the unblocked run fits,
    and ``min_block`` when not even the smallest block fits (the budget is
    then advisory: mining still needs one block's buffers).
    """
    m = max(int(m), 1)
    if estimate_live_bytes(kind, caps, filter_caps, bucket_pow2(m)) \
            <= budget_bytes:
        return m
    b = bucket_pow2(m) // 2
    while b > min_block:
        sc, fc = scale_caps(caps, filter_caps, b / m)
        if estimate_live_bytes(kind, sc, fc, b) <= budget_bytes:
            return b
        b //= 2
    return min_block


class BlockQueue:
    """Double-buffered host-to-device staging of level-0 worklist blocks.

    ``arrays`` are the full worklist columns (host numpy); iteration yields
    ``(block, device_columns)``, each column ``cap0`` long and zero past
    ``block.n``.  On a CUDA device the columns sit once in pinned host
    memory; each block is copied on a side stream into buffers allocated
    there, an event is recorded after the copy, and the consumer's stream
    waits on that event when the block is handed over.  Block i+1's copy
    is issued before block i is yielded, so it overlaps block i's mining;
    at most two blocks' columns are staged at once.  Each handed-over
    buffer is marked as used by the consumer's stream
    (``Tensor.record_stream``), so the allocator does not give its memory
    to a later block's copy while work queued on that stream may still
    read it.  On a CPU device the blocks are copied plainly.

    ``stage_s`` is the host time spent issuing the copies, ``mine_s`` the
    host time the consumer held the blocks.  Each staging runs in a
    ``block.stage`` span; the times also go to the metrics, as the JAX
    package's queue records them: the ``blocks.stage_ms`` and
    ``blocks.mine_ms`` histograms, the ``blocks.stage_s`` and
    ``blocks.mine_s`` counters, and the ``blocks.stage_overlap`` gauge,
    ``mine_s / (stage_s + mine_s)`` (1.0 when staging cost no wall time
    beside the mining).
    """

    def __init__(self, arrays: Iterable[np.ndarray],
                 blocks: Sequence[EdgeBlock], cap0: int,
                 device: DeviceSpec = None):
        self.device = resolve_device(device)
        self.blocks = list(blocks)
        self.cap0 = int(cap0)
        cols = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        self._stream = None
        if self.device.type == "cuda":
            cols = [c.pin_memory() for c in cols]
            self._stream = torch.cuda.Stream(self.device)
        self.columns = cols
        self.stage_s = 0.0
        self.mine_s = 0.0

    def __len__(self) -> int:
        return len(self.blocks)

    def _stage(self, blk: EdgeBlock):
        """Issue block ``blk``'s copies: ``(columns, event)``, the event
        None on a CPU device."""
        with _T.span("block.stage", cat="blocks", index=blk.index, n=blk.n):
            return self._copy(blk)

    def _copy(self, blk: EdgeBlock):
        if self._stream is None:
            out = []
            for c in self.columns:
                buf = torch.zeros(self.cap0, dtype=c.dtype)
                buf[:blk.n] = c[blk.lo:blk.lo + blk.n]
                out.append(buf.to(self.device))
            return tuple(out), None
        with torch.cuda.stream(self._stream):
            out = []
            for c in self.columns:
                buf = torch.empty(self.cap0, dtype=c.dtype,
                                  device=self.device)
                if blk.n:
                    buf[:blk.n].copy_(c[blk.lo:blk.lo + blk.n],
                                      non_blocking=True)
                buf[blk.n:].zero_()
                out.append(buf)
            event = torch.cuda.Event()
            event.record(self._stream)
        return tuple(out), event

    def _hand_over(self, staged):
        """The staged columns, made safe to read on the current stream."""
        cols, event = staged
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for c in cols:
                c.record_stream(consumer)
        return cols

    def __iter__(self):
        """Yield ``(block, staged_columns)``, adding to ``stage_s`` and
        ``mine_s`` and recording the metrics (also when the consumer stops
        early)."""
        stage_s = mine_s = 0.0
        try:
            t0 = time.perf_counter()
            nxt = self._stage(self.blocks[0]) if self.blocks else None
            stage_s += time.perf_counter() - t0
            for i, blk in enumerate(self.blocks):
                t0 = time.perf_counter()
                cur, nxt = nxt, (self._stage(self.blocks[i + 1])
                                 if i + 1 < len(self.blocks) else None)
                cols = self._hand_over(cur)
                del cur
                dt = time.perf_counter() - t0
                stage_s += dt
                _M.observe("blocks.stage_ms", dt * 1e3)
                t0 = time.perf_counter()
                try:
                    yield blk, cols
                finally:
                    dt = time.perf_counter() - t0
                    mine_s += dt
                    _M.observe("blocks.mine_ms", dt * 1e3)
                del cols
        finally:
            self.stage_s += stage_s
            self.mine_s += mine_s
            _M.inc("blocks.stage_s", stage_s)
            _M.inc("blocks.mine_s", mine_s)
            if stage_s + mine_s > 0:
                _M.set_gauge("blocks.stage_overlap",
                             mine_s / (stage_s + mine_s))


def stack_blocks(arrays: Iterable[np.ndarray], blocks: Sequence[EdgeBlock],
                 cap0: int, device: DeviceSpec = None
                 ) -> tuple[torch.Tensor, ...]:
    """Stage every block at once into stacked ``[n_blocks, cap0]`` tensors
    (one block per device on the sharded path), with :class:`BlockQueue`'s
    padding contract: zero past ``block.n``."""
    dev = resolve_device(device)
    out = []
    for a in arrays:
        a = np.asarray(a)
        buf = np.zeros((len(blocks), int(cap0)), dtype=a.dtype)
        for i, blk in enumerate(blocks):
            if blk.n:
                buf[i, : blk.n] = a[blk.lo: blk.lo + blk.n]
        out.append(torch.from_numpy(buf).to(dev))
    return tuple(out)

"""Plain PyTorch phase backend, vertex half (counterpart of
``repro.core.phases.reference``), registered as ``torch-ref``.

EXTEND is the inspection-execution candidate generation of paper §5.3:
count candidates per (parent, slot) masked by ``toExtend``, expand each
output slot to its (parent, rank), gather the candidate from the CSR,
evaluate ``toAdd`` before writing, and compact the survivors by a prefix
sum.  The module-level functions are the single source of truth;
:class:`ReferenceBackend` packages them, and the CUDA backend overrides
only the enumeration (:meth:`ReferenceBackend._vertex_candidates`) and
``extend_pruned``.

Unlike XLA, torch raises on an out-of-range gather (and trips a
device-side assert on the card), so every gather the JAX code leaves to
XLA's clamping is clipped here explicitly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.api import (GraphCtx, MiningApp,
                                  is_auto_canonical_vertex,
                                  resolve_kernel_predicate)
from repro_torch.core.embedding_list import EmbeddingLevel
from repro_torch.core.phases.base import PhaseBackend
from repro_torch.sparse.ops import compact_mask, expand_ragged

# Candidate slots are int32 and capacities are powers of two, so one level
# can plan at most 2^30 candidate slots.
MAX_CAND_CAP = 1 << 30


def check_supported(app: MiningApp) -> None:
    """Raise for what this slice of the port does not cover."""
    if app.kind != "vertex":
        raise NotImplementedError(
            f"app {app.name!r}: edge-induced mining is not ported yet")
    if app.update_state_kernel is not None:
        raise NotImplementedError(
            f"app {app.name!r}: the state column (update_state_kernel) is "
            "not ported yet")


def check_cand_cap(cand_cap: int) -> None:
    if cand_cap > MAX_CAND_CAP:
        raise OverflowError(
            f"cand_cap={cand_cap} > 2^30: candidate slots are int32; more "
            "candidates per level need edge blocks, which are not ported "
            "yet")


# ---------------------------------------------------------------------------
# EXTEND: vertex-induced


def vertex_ext_degrees(ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                       n_valid: torch.Tensor,
                       state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step 1: per-(parent, slot) candidate counts, masked by ``toExtend``
    (int32 [cap, k])."""
    cap, k = emb.shape
    valid = torch.arange(cap, dtype=torch.int32, device=emb.device) < n_valid
    if app.to_extend is not None:
        ext = app.to_extend(ctx, emb)
    else:
        ext = torch.ones((cap, k), dtype=torch.bool, device=emb.device)
    ext = ext & valid[:, None]
    return torch.where(ext, ctx.degree(emb), 0).to(torch.int32)


def vertex_add_mask(ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                    row_c: torch.Tensor, u: torch.Tensor,
                    src_slot: torch.Tensor, state: Optional[torch.Tensor],
                    live: torch.Tensor) -> torch.Tensor:
    """Step 3's filter for apps without a kernel predicate: ``app.to_add``,
    else the default automorphism-canonical test."""
    rows = row_c.long()
    parent_emb = emb[rows]
    parent_state = None if state is None else state[rows]
    if app.to_add is not None:
        add = app.to_add(ctx, parent_emb, u, src_slot, parent_state)
    else:
        add = is_auto_canonical_vertex(ctx, parent_emb, u, src_slot)
    return add & live


def apply_kernel_predicate(ctx: GraphCtx, pred, emb: torch.Tensor,
                           row_c: torch.Tensor, u: torch.Tensor,
                           src_slot: torch.Tensor,
                           state: Optional[torch.Tensor],
                           live: torch.Tensor) -> torch.Tensor:
    """Evaluate the kernel predicate on flat batches, probing connectivity
    here (one bit test against the full pack, else a CSR search)."""
    k = emb.shape[1]
    rows = row_c.long()
    parent = emb[rows]
    emb_cols = tuple(parent[:, j] for j in range(k))
    conn = tuple(ctx.is_connected(parent[:, j], u) for j in range(k))
    st = (torch.zeros(u.shape, dtype=torch.int32, device=u.device)
          if state is None else state[rows])
    return pred(emb_cols, u, src_slot, st, conn) & live


def _pad_empty_frontier(emb: torch.Tensor, state: Optional[torch.Tensor]):
    """Zero-row frontier (zero-edge graph): pad to one dead row, so gathers
    have something to read; ``n_valid`` is 0, so every live mask drops it."""
    if emb.shape[0]:
        return emb, state
    emb = torch.full((1, emb.shape[1]), -1, dtype=emb.dtype,
                     device=emb.device)
    state = None if state is None else torch.zeros((1,), dtype=state.dtype,
                                                   device=state.device)
    return emb, state


def _col_idx(ctx: GraphCtx) -> torch.Tensor:
    """The CSR column array, padded to one entry on a zero-edge graph so a
    (masked) gather from it stays valid."""
    if ctx.n_edges:
        return ctx.col_idx
    return torch.zeros(1, dtype=ctx.col_idx.dtype, device=ctx.device)


def _vertex_candidates(ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                       n_valid: torch.Tensor, state: Optional[torch.Tensor],
                       cand_cap: int):
    """Steps 1+2+filter: enumerate candidate (parent, u) pairs.

    Returns (parent_row int32[cand_cap], u int32[cand_cap],
             src_slot int32[cand_cap], add_mask bool[cand_cap],
             n_candidates int64[]).  ``n_candidates`` is the exact total
    (an int64 sum, so a total past 2^31 flags overflow instead of
    wrapping).
    """
    check_cand_cap(cand_cap)
    emb, state = _pad_empty_frontier(emb, state)
    cap, k = emb.shape
    deg = vertex_ext_degrees(ctx, app, emb, n_valid, state)
    slot_parent, rank, _ = expand_ragged(deg.reshape(-1), cand_cap)
    total = deg.sum(dtype=torch.int64)
    row = torch.div(slot_parent, k, rounding_mode="floor")
    col = slot_parent - row * k          # floor mod, as jnp's %
    live = slot_parent >= 0
    row_c = row.clamp(0, cap - 1)
    col_c = col.clamp(0, k - 1)
    v = emb[row_c.long(), col_c.long()]
    ptr = ctx.row_ptr[v.clamp(0, ctx.n_vertices - 1).long()] + rank
    u = _col_idx(ctx)[ptr.clamp(0, max(ctx.n_edges - 1, 0)).long()]
    u = torch.where(live, u, -1)
    src_slot = col_c.to(torch.int32)
    pred = resolve_kernel_predicate(app, k)
    if pred is not None:
        add = apply_kernel_predicate(ctx, pred, emb, row_c, u, src_slot,
                                     state, live)
    else:
        add = vertex_add_mask(ctx, app, emb, row_c, u, src_slot, state,
                              live)
    return row_c.to(torch.int32), u, src_slot, add, total


def candidate_bound_vertex(ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                           n_valid: torch.Tensor,
                           state: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Cheap upper bound on the candidate count (degree sum, int64)."""
    return vertex_ext_degrees(ctx, app, emb, n_valid,
                              state).sum(dtype=torch.int64)


def finish_extend_vertex(emb: torch.Tensor, row: torch.Tensor,
                         u: torch.Tensor, add: torch.Tensor, out_cap: int,
                         fuse_filter: bool = True):
    """Step 3's write: compact survivors into the next SoA level."""
    if not fuse_filter:
        # materialise the full candidate list, then filter: the ablation
        # of paper Fig. 12d (what Arabesque and RStream do)
        cand = torch.stack([row, u], dim=1).clone()
        row, u = cand[:, 0], cand[:, 1]
    gather, n_new = compact_mask(add, out_cap)
    g = gather.long()
    live = torch.arange(out_cap, dtype=torch.int32,
                        device=emb.device) < n_new
    vid = torch.where(live, u[g], -1).to(torch.int32)
    idx = torch.where(live, row[g], 0).to(torch.int32)
    level = EmbeddingLevel(vid=vid, idx=idx, n=n_new)
    new_emb = torch.cat([emb[idx.long()], vid[:, None]], dim=1)
    return level, new_emb


# ---------------------------------------------------------------------------
# Backend assembly


class ReferenceBackend(PhaseBackend):
    """Every ported phase in plain PyTorch, on any device."""

    name = "torch-ref"

    # the enumeration is the backend-swappable step
    def _vertex_candidates(self, ctx, app, emb, n_valid, state, cand_cap):
        return _vertex_candidates(ctx, app, emb, n_valid, state, cand_cap)

    def candidate_bound_vertex(self, ctx, app, emb, n_valid, state=None):
        check_supported(app)
        return candidate_bound_vertex(ctx, app, emb, n_valid, state)

    def inspect_vertex(self, ctx, app, emb, n_valid, state, cand_cap):
        check_supported(app)
        _, _, _, add, total = self._vertex_candidates(ctx, app, emb,
                                                      n_valid, state,
                                                      cand_cap)
        return total, add.sum(dtype=torch.int64)

    def extend_vertex(self, ctx, app, emb, n_valid, state, cand_cap,
                      out_cap, fuse_filter=True):
        check_supported(app)
        emb, state = _pad_empty_frontier(emb, state)
        row, u, _, add, _ = self._vertex_candidates(ctx, app, emb, n_valid,
                                                    state, cand_cap)
        return finish_extend_vertex(emb, row, u, add, out_cap, fuse_filter)

    def extend_pruned(self, ctx, app, emb, n_valid, state, cand_cap,
                      out_cap, fuse_filter=True):
        check_supported(app)
        emb, state = _pad_empty_frontier(emb, state)
        row, u, _, add, total = self._vertex_candidates(
            ctx, app, emb, n_valid, state, cand_cap)
        level, new_emb = finish_extend_vertex(emb, row, u, add, out_cap,
                                              fuse_filter)
        return level, new_emb, total

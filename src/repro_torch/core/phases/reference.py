"""Plain PyTorch phase backend (counterpart of
``repro.core.phases.reference``), registered as ``torch-ref``.

EXTEND is the inspection-execution candidate generation of paper §5.3:
count candidates per (parent, slot) masked by ``toExtend``, expand each
output slot to its (parent, rank), gather the candidate from the CSR,
evaluate ``toAdd`` before writing, and compact the survivors by a prefix
sum.  REDUCE is the count reduce of vertex apps (a state histogram, the
app's ``get_pattern`` or the canonical-code table) and the domain (MNI)
support of FSM, and FILTER the support-based compaction of Alg. 2.  The module-level functions are the
single source of truth; :class:`ReferenceBackend` packages them, and the
CUDA backend overrides only the enumerations
(:meth:`ReferenceBackend._vertex_candidates`,
:meth:`ReferenceBackend._edge_candidates`) and ``extend_pruned``.

Both reduces keep static shapes and read nothing from the device (no
``torch.unique``, ``nonzero`` or boolean indexing, which wait for the host
on CUDA), so a warm replay runs without a sync.

Unlike XLA, torch raises on an out-of-range gather (and trips a
device-side assert on the card), so every gather the JAX code leaves to
XLA's clamping is clipped here explicitly.
"""
from __future__ import annotations

import itertools
from typing import Optional

import torch

from repro_torch.core import pattern as P
from repro_torch.core.api import (GraphCtx, MiningApp,
                                  is_auto_canonical_edge,
                                  is_auto_canonical_vertex,
                                  resolve_kernel_predicate,
                                  resolve_state_kernel)
from repro_torch.core.embedding_list import EmbeddingLevel, materialize_edges
from repro_torch.core.phases.base import PhaseBackend
from repro_torch.sparse.ops import compact_mask, expand_ragged

# Candidate slots are int32 and capacities are powers of two, so one level
# can plan at most 2^30 candidate slots.
MAX_CAND_CAP = 1 << 30
INT_MAX = P.INT_MAX


def check_supported(app: MiningApp) -> None:
    """Raise for an app kind the port does not know."""
    if app.kind not in ("vertex", "edge"):
        raise ValueError(f"app {app.name!r}: unknown kind {app.kind!r}")


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
    (int32 [cap, k]).  With a ``to_extend_state`` hook and a state column
    the mask is per embedding (the trie's dead branches enumerate
    nothing)."""
    cap, k = emb.shape
    valid = torch.arange(cap, dtype=torch.int32, device=emb.device) < n_valid
    if app.to_extend_state is not None and state is not None:
        ext = app.to_extend_state(ctx, emb, state)
    elif app.to_extend is not None:
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


def label_table(ctx: GraphCtx) -> torch.Tensor:
    """The vertex labels a labeled predicate gathers: the graph's, or one
    zero label when it has none (as JAX gathers them)."""
    if ctx.labels is not None:
        return ctx.labels.to(torch.int32).contiguous()
    return torch.zeros(1, dtype=torch.int32, device=ctx.device)


def gather_labels(labels: torch.Tensor, emb_cols, u: torch.Tensor):
    """``(lab_cols, lab_u)`` of a labeled predicate, each gather clipped to
    the table, as JAX clips it."""
    nv = labels.shape[0]
    lab_cols = tuple(labels[c.clamp(0, nv - 1).long()] for c in emb_cols)
    return lab_cols, labels[u.clamp(0, nv - 1).long()]


def eval_spec(pred, labels: Optional[torch.Tensor], emb_cols, u, src_slot,
              st, conn) -> torch.Tensor:
    """Evaluate a kernel predicate, gathering labels when it reads them."""
    if getattr(pred, "needs_labels", False):
        lab_cols, lab_u = gather_labels(labels, emb_cols, u)
        return pred(emb_cols, u, src_slot, st, conn, lab_cols, lab_u)
    return pred(emb_cols, u, src_slot, st, conn)


def _kernel_operands(ctx: GraphCtx, emb: torch.Tensor, row_c: torch.Tensor,
                     u: torch.Tensor, state: Optional[torch.Tensor]):
    """The elementwise operands of a kernel predicate or state update on
    flat batches: ``(emb_cols, st, conn)``, connectivity probed here (one
    bit test against the full pack, else a CSR search)."""
    k = emb.shape[1]
    rows = row_c.long()
    parent = emb[rows]
    emb_cols = tuple(parent[:, j] for j in range(k))
    conn = tuple(ctx.is_connected(parent[:, j], u) for j in range(k))
    st = (torch.zeros(u.shape, dtype=torch.int32, device=u.device)
          if state is None else state[rows])
    return emb_cols, st, conn


def apply_kernel_predicate(ctx: GraphCtx, pred, emb: torch.Tensor,
                           row_c: torch.Tensor, u: torch.Tensor,
                           src_slot: torch.Tensor,
                           state: Optional[torch.Tensor],
                           live: torch.Tensor) -> torch.Tensor:
    """Evaluate the kernel predicate on flat batches, with the parents'
    state and, for a labeled predicate, the labels."""
    emb_cols, st, conn = _kernel_operands(ctx, emb, row_c, u, state)
    return eval_spec(pred, label_table(ctx), emb_cols, u, src_slot, st,
                     conn) & live


def apply_state_kernel(ctx: GraphCtx, upd, emb: torch.Tensor,
                       row_c: torch.Tensor, u: torch.Tensor,
                       src_slot: torch.Tensor,
                       state: Optional[torch.Tensor]) -> torch.Tensor:
    """Evaluate an ``update_state_kernel`` on flat batches (the operands of
    :func:`apply_kernel_predicate`); the compaction drops the values of
    candidates that do not survive."""
    emb_cols, st, conn = _kernel_operands(ctx, emb, row_c, u, state)
    return upd(emb_cols, u, src_slot, st, conn).to(torch.int32)


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


def _nonempty(t: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """``t``, or one ``fill`` entry when it is empty (a zero-edge graph),
    so a masked gather from it stays valid."""
    if t.shape[0]:
        return t
    return torch.full((1,), fill, dtype=t.dtype, device=t.device)


def _col_idx(ctx: GraphCtx) -> torch.Tensor:
    """The CSR column array, padded to one entry on a zero-edge graph."""
    return _nonempty(ctx.col_idx)


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
                         fuse_filter: bool = True,
                         new_state: Optional[torch.Tensor] = None):
    """Step 3's write: compact survivors into the next SoA level.
    ``new_state`` (int32[cand_cap], from ``update_state_kernel``) is
    compacted by the same gather into the level's ``state`` column, 0 past
    the survivors."""
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
    st = (None if new_state is None
          else torch.where(live, new_state[g], 0).to(torch.int32))
    level = EmbeddingLevel(vid=vid, idx=idx, n=n_new, state=st)
    new_emb = torch.cat([emb[idx.long()], vid[:, None]], dim=1)
    return level, new_emb


# ---------------------------------------------------------------------------
# EXTEND: edge-induced


def edge_vertex_slots(v0: torch.Tensor, vid: torch.Tensor, his: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Vertex slots [cap, E+1] and first-appearance mask.

    Slot 0 = v0; slot s>=1 = destination vertex of edge s-1.  A slot is
    "fresh" iff its vertex did not appear in an earlier slot (edges closing
    cycles repeat vertices).
    """
    slots = torch.cat([v0[:, None], vid], dim=1)
    fresh = torch.ones(slots.shape, dtype=torch.bool, device=slots.device)
    for s in range(1, slots.shape[1]):
        seen = torch.zeros(slots.shape[:1], dtype=torch.bool,
                           device=slots.device)
        for t in range(s):
            seen = seen | (slots[:, t] == slots[:, s])
        fresh[:, s] = ~seen
    return slots, fresh


def edge_ext_degrees(ctx: GraphCtx, app: MiningApp, slots: torch.Tensor,
                     fresh: torch.Tensor, n_valid: torch.Tensor
                     ) -> torch.Tensor:
    """Per-(row, slot) candidate counts of an edge level (int32 [cap, E+1]):
    the degree of each fresh vertex slot of a valid row, masked by
    ``toExtend``."""
    cap = slots.shape[0]
    valid = torch.arange(cap, dtype=torch.int32, device=slots.device) < n_valid
    ext = fresh & valid[:, None]
    if app.to_extend is not None:
        ext = ext & app.to_extend(ctx, slots)
    return torch.where(ext, ctx.degree(slots), 0).to(torch.int32)


def _edge_candidates(ctx: GraphCtx, app: MiningApp, v0, vid, his, eid,
                     n_valid: torch.Tensor, cand_cap: int):
    """Enumerate candidate edges: (row, s, u, new_eid, add, n_candidates),
    the first four int32[cand_cap], ``add`` bool[cand_cap] and the total
    an int64 sum."""
    check_cand_cap(cand_cap)
    cap, E = vid.shape
    n_slots = E + 1
    slots, fresh = edge_vertex_slots(v0, vid, his)
    deg = edge_ext_degrees(ctx, app, slots, fresh, n_valid)
    slot_parent, rank, _ = expand_ragged(deg.reshape(-1), cand_cap)
    total = deg.sum(dtype=torch.int64)
    # floor division and floor mod, as jnp's // and %
    row = torch.div(slot_parent, n_slots, rounding_mode="floor").clamp(
        0, cap - 1)
    s = torch.remainder(slot_parent, n_slots).clamp(0, n_slots - 1)
    live = slot_parent >= 0
    w = slots[row.long(), s.long()]                    # source vertex
    ptr = ctx.row_ptr[w.clamp(0, ctx.n_vertices - 1).long()] + rank
    ptr = ptr.clamp(0, max(ctx.n_edges - 1, 0)).long()
    u = torch.where(live, _col_idx(ctx)[ptr], -1)      # destination vertex
    new_eid = torch.where(live, _nonempty(ctx.edge_uid)[ptr], -1)

    # endpoints of the existing edges (for the shares-endpoint test)
    eids_row = eid[row.long()]                         # [cand, E]
    e_uid = eids_row.clamp(0, max(ctx.n_uedges - 1, 0)).long()
    e_src = _nonempty(ctx.usrc)[e_uid]
    e_dst = _nonempty(ctx.udst)[e_uid]
    add = is_auto_canonical_edge(ctx, eids_row, new_eid, w, u, e_src, e_dst)
    if app.to_add_vertex_mask is not None:
        vm = app.to_add_vertex_mask(ctx)
        add = add & vm[u.clamp(0, ctx.n_vertices - 1).long()]
    elif app.to_add is not None:
        add = add & app.to_add(ctx, slots[row.long()], u, None)
    add = add & live
    return (row.to(torch.int32), s.to(torch.int32), u.to(torch.int32),
            new_eid.to(torch.int32), add, total)


def candidate_bound_edge(ctx: GraphCtx, app: MiningApp, v0, vid, his,
                         n_valid: torch.Tensor) -> torch.Tensor:
    """Cheap upper bound on the candidate count (degree sum, int64)."""
    slots, fresh = edge_vertex_slots(v0, vid, his)
    cap = slots.shape[0]
    valid = torch.arange(cap, dtype=torch.int32, device=slots.device) < n_valid
    deg = torch.where(fresh & valid[:, None], ctx.degree(slots), 0)
    return deg.sum(dtype=torch.int64)


def finish_extend_edge(row, s, u, new_eid, add, out_cap: int
                       ) -> EmbeddingLevel:
    """Compact surviving edge candidates into the next SoA level."""
    gather, n_new = compact_mask(add, out_cap)
    g = gather.long()
    live = torch.arange(out_cap, dtype=torch.int32, device=u.device) < n_new
    return EmbeddingLevel(vid=torch.where(live, u[g], -1),
                          idx=torch.where(live, row[g], 0), n=n_new,
                          his=torch.where(live, s[g], 0),
                          eid=torch.where(live, new_eid[g], -1))


# ---------------------------------------------------------------------------
# REDUCE: vertex-induced (count support)


def build_adjacency(ctx: GraphCtx, emb: torch.Tensor) -> torch.Tensor:
    """Pairwise connectivity of embedding vertices: bool[N, k, k]."""
    n, k = emb.shape
    adj = torch.zeros((n, k, k), dtype=torch.bool, device=emb.device)
    for i in range(k):
        for j in range(i + 1, k):
            c = ctx.is_connected(emb[:, i], emb[:, j])
            adj[:, i, j] = c
            adj[:, j, i] = c
    return adj


def reduce_count(ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                 n_valid: torch.Tensor, state: Optional[torch.Tensor]):
    """Classify + count: ``(p_map int32[max_patterns], pat int32[cap],
    new_state)``, equal to JAX's ``reduce_count``.

    Three branches: the app's ``state_histogram`` of the state column (the
    pattern-set trie's leaf bits), its ``get_pattern`` classifier, or the
    canonical code of each embedding's induced subgraph, numbered by a
    fixed-size unique whose ``INT_MAX`` padding bucket (the invalid rows)
    sorts last and is dropped.
    """
    cap = emb.shape[0]
    dev = emb.device
    valid = torch.arange(cap, dtype=torch.int32, device=dev) < n_valid
    if app.state_histogram is not None:
        p_map = app.state_histogram(state, valid).to(torch.int32)
        return p_map, torch.zeros(cap, dtype=torch.int32, device=dev), state
    if app.get_pattern is not None:
        pat, new_state = app.get_pattern(ctx, emb, state, valid)
    else:
        adj = build_adjacency(ctx, emb)
        codes = P.canonical_code(adj, None, emb.shape[1])
        codes = torch.where(valid, codes, INT_MAX)
        _, pat = P.unique_fixed(codes, app.max_patterns + 1)
        new_state = pat
    pat = pat.clamp(0, app.max_patterns)
    p_map = torch.zeros(app.max_patterns + 1, dtype=torch.int32, device=dev)
    p_map.index_add_(0, pat.long(), valid.to(torch.int32))
    return p_map[:app.max_patterns], pat.to(torch.int32), new_state


# ---------------------------------------------------------------------------
# REDUCE: edge-induced — embedding -> labeled local graph


def edge_embedding_graph(ctx: GraphCtx, levels: list[EmbeddingLevel]):
    """Per-embedding labeled local graphs from the SoA prefix tree.

    Returns (vert_vid int32[cap, V], labels int32[cap, V], adj bool[cap, V,
    V], n_verts int32[cap], eids int32[cap, E]) with V = E + 1 slots;
    vertices are in first-appearance order; pad vertices carry label
    ``ctx.n_labels`` (one past the real alphabet).
    """
    v0, vid, his, eid = materialize_edges(levels)
    cap, E = vid.shape
    V = E + 1
    dev = vid.device
    slots, fresh = edge_vertex_slots(v0, vid, his)        # [cap, V]
    # local id per slot: fresh slots take their rank; stale slots copy the
    # local id of the first earlier slot holding the same vertex.  The rank
    # is a running sum over the V columns (a cumsum along dim 1 of a tall,
    # V-wide tensor is a slow scan on CUDA)
    lid = torch.empty((cap, V), dtype=torch.int32, device=dev)
    rank = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    for s in range(V):
        rank = rank + fresh[:, s].to(torch.int32)
        lid[:, s] = rank
    for s in range(1, V):
        match = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        for t in range(s):
            hit = (slots[:, t] == slots[:, s]) & (match < 0)
            match = torch.where(hit, lid[:, t], match)
        lid[:, s] = torch.where(fresh[:, s], lid[:, s], match)
    n_verts = fresh.sum(dim=1, dtype=torch.int32)
    rows = torch.arange(cap, device=dev)
    vert_vid = torch.full((cap, V), -1, dtype=torch.int32, device=dev)
    for s in range(V):
        tgt = torch.where(fresh[:, s], lid[:, s], V)  # V = scratch (dropped)
        tc = tgt.clamp(0, V - 1).long()
        vert_vid[rows, tc] = torch.where(fresh[:, s] & (tgt < V),
                                         slots[:, s], vert_vid[rows, tc])
    if ctx.labels is not None:
        lab = ctx.labels[vert_vid.clamp(0, ctx.n_vertices - 1).long()]
    else:
        lab = torch.zeros((cap, V), dtype=torch.int32, device=dev)
    is_real = (torch.arange(V, dtype=torch.int32, device=dev)[None, :]
               < n_verts[:, None])
    lab = torch.where(is_real, lab, ctx.n_labels).to(torch.int32)
    # adjacency: edge j connects lid[his_j] -- lid[j+1]
    adj = torch.zeros((cap, V, V), dtype=torch.bool, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)
    for j in range(E):
        a = lid[rows, his[:, j].clamp(0, V - 1).long()].clamp(0, V - 1).long()
        b = lid[:, j + 1].clamp(0, V - 1).long()
        adj.index_put_((rows, a, b), true)
        adj.index_put_((rows, b, a), true)
    return vert_vid, lab, adj, n_verts, eid


def _decode_n_verts(codes: torch.Tensor, k: int, n_eff: int) -> torch.Tensor:
    """Recover #real vertices from a packed code (pad label = n_eff - 1)."""
    lab_part = codes >> (k * (k - 1) // 2)
    n_real = torch.zeros(codes.shape, dtype=torch.int32, device=codes.device)
    for _ in range(k):
        li = torch.remainder(lab_part, n_eff)
        lab_part = torch.div(lab_part, n_eff, rounding_mode="floor")
        n_real = n_real + (li != (n_eff - 1)).to(torch.int32)
    return n_real


def _canonical_edge_codes(ctx: GraphCtx, app: MiningApp,
                          levels: list[EmbeddingLevel]):
    """Shared FSM-reduce front half: per-embedding canonical codes.

    Returns (vert_vid int32[cap, V], n_verts int32[cap], valid bool[cap],
    perms, codes_all int32[cap, n_perms], canon int32[cap]) with invalid
    rows' canon parked at INT_MAX.
    """
    vert_vid, lab, adj, n_verts, _ = edge_embedding_graph(ctx, levels)
    cap, V = lab.shape
    n_eff = ctx.n_labels + 1
    valid = (torch.arange(cap, dtype=torch.int32, device=lab.device)
             < levels[-1].n)
    perms = list(itertools.permutations(range(V)))
    codes_all = torch.stack([P.pack_code(adj, lab, V, n_eff, perm=p)
                             for p in perms], dim=1)    # [cap, n_perms]
    canon = codes_all.min(dim=1).values
    canon = torch.where(valid, canon, INT_MAX)
    return vert_vid, n_verts, valid, perms, codes_all, canon


def _domain_contributions(n_verts, ok, perm, pat, V: int, park: int
                          ) -> torch.Tensor:
    """Buckets int64[cap, V] of one permutation's MNI contributions: local
    vertex l of a row goes to domain ``perm^-1(l)`` of the row's pattern,
    ``bucket = pat * V + domain``; a dead contribution (row not ``ok``,
    past the row's vertices, or of a pattern past a truncated table) is
    parked at ``park``."""
    inv = sorted(range(V), key=perm.__getitem__)        # argsort of perm
    base = pat.long() * V
    bucket = torch.stack([base + inv[l] for l in range(V)], dim=1)
    real = (torch.arange(V, dtype=torch.int32, device=pat.device)[None]
            < n_verts[:, None])
    return torch.where(ok[:, None] & real, bucket, park).clamp(max=park)


def reduce_domain(ctx: GraphCtx, app: MiningApp,
                  levels: list[EmbeddingLevel]):
    """FSM reduce: canonical codes + MNI (domain) support.

    Returns (codes int32[P], support int32[P], pat int32[cap], pat_valid
    bool[P]) with P = app.max_patterns, equal to JAX's ``reduce_domain``.
    Distinct (pattern, domain, vertex) triples are counted on a dense
    membership table, ``uint8[P * V + 1, n_vertices]`` whose last row takes
    the parked contributions, as JAX's ``reduce_domain_sharded(packed=
    False)`` does, one permutation at a time, instead of sorting all
    ``V! * V`` contributions per embedding.
    """
    vert_vid, n_verts, valid, perms, codes_all, canon = \
        _canonical_edge_codes(ctx, app, levels)
    cap, V = vert_vid.shape
    n_eff = ctx.n_labels + 1
    Pn = app.max_patterns
    n = max(ctx.n_vertices, 1)
    uniq, pat = P.unique_fixed(canon, Pn)
    pat_valid = uniq != INT_MAX
    park = Pn * V
    member = torch.zeros((park + 1) * n, dtype=torch.uint8,
                         device=canon.device)
    vid_c = vert_vid.clamp(0, n - 1).long()
    for pi, perm in enumerate(perms):
        ok = (codes_all[:, pi] == canon) & valid
        bucket = _domain_contributions(n_verts, ok, perm, pat, V, park)
        member.index_fill_(0, (bucket * n + vid_c).reshape(-1), 1)
    distinct = member.view(park + 1, n)[:park].sum(dim=1, dtype=torch.int32)
    return _domain_support(app, uniq, pat_valid, distinct.view(Pn, V), pat,
                           valid, V, n_eff)


def _domain_support(app, uniq, pat_valid, distinct, pat, valid, V, n_eff):
    """Back half of the FSM reduce: MNI support = min over real domains."""
    n_real = _decode_n_verts(uniq, V, n_eff)
    dom_ok = (torch.arange(V, dtype=torch.int32, device=uniq.device)[None, :]
              < n_real[:, None])
    support = torch.where(dom_ok, distinct, INT_MAX).min(dim=1).values
    support = torch.where(pat_valid, support, 0)
    pat = torch.where(valid, pat, app.max_patterns - 1)
    return uniq, support.to(torch.int32), pat.to(torch.int32), pat_valid


# ---------------------------------------------------------------------------
# FILTER phase (paper Alg. 2 lines 14-17)


def filter_levels(levels: list[EmbeddingLevel], keep: torch.Tensor,
                  out_cap: int) -> list[EmbeddingLevel]:
    """Compact the last level by ``keep`` (support-based pruning)."""
    last = levels[-1]
    cap = last.vid.shape[0]
    keep = keep & (torch.arange(cap, dtype=torch.int32,
                                device=keep.device) < last.n)
    gather, n_new = compact_mask(keep, out_cap)
    g = gather.long()
    live = torch.arange(out_cap, dtype=torch.int32,
                        device=keep.device) < n_new

    def take(col, fill):
        return (None if col is None
                else torch.where(live, _nonempty(col, fill)[g], fill))

    new_last = EmbeddingLevel(vid=take(last.vid, -1), idx=take(last.idx, 0),
                              n=n_new, his=take(last.his, 0),
                              eid=take(last.eid, -1))
    return levels[:-1] + [new_last]


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
        row, u, src_slot, add, total = self._vertex_candidates(
            ctx, app, emb, n_valid, state, cand_cap)
        upd = resolve_state_kernel(app, emb.shape[1])
        new_st = (None if upd is None
                  else apply_state_kernel(ctx, upd, emb, row, u, src_slot,
                                          state))
        level, new_emb = finish_extend_vertex(emb, row, u, add, out_cap,
                                              fuse_filter,
                                              new_state=new_st)
        return level, new_emb, total

    # -- edge EXTEND (the enumeration is the backend-swappable step, like
    #    _vertex_candidates)
    def _edge_candidates(self, ctx, app, v0, vid, his, eid, n_valid,
                         cand_cap):
        return _edge_candidates(ctx, app, v0, vid, his, eid, n_valid,
                                cand_cap)

    def candidate_bound_edge(self, ctx, app, v0, vid, his, n_valid):
        check_supported(app)
        return candidate_bound_edge(ctx, app, v0, vid, his, n_valid)

    def inspect_edge(self, ctx, app, v0, vid, his, eid, n_valid, cand_cap):
        check_supported(app)
        _, _, _, _, add, total = self._edge_candidates(
            ctx, app, v0, vid, his, eid, n_valid, cand_cap)
        return total, add.sum(dtype=torch.int64)

    def extend_edge(self, ctx, app, v0, vid, his, eid, n_valid, cand_cap,
                    out_cap):
        check_supported(app)
        row, s, u, new_eid, add, total = self._edge_candidates(
            ctx, app, v0, vid, his, eid, n_valid, cand_cap)
        return finish_extend_edge(row, s, u, new_eid, add, out_cap), total

    # -- REDUCE / FILTER
    def reduce_count(self, ctx, app, emb, n_valid, state):
        return reduce_count(ctx, app, emb, n_valid, state)

    def reduce_domain(self, ctx, app, levels):
        return reduce_domain(ctx, app, levels)

    def filter_levels(self, levels, keep, out_cap):
        return filter_levels(levels, keep, out_cap)

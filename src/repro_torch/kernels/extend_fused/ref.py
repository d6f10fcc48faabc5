"""Plain PyTorch versions of the fused extend kernels.

Each function computes exactly what its CUDA kernel in ``csrc/extend.cu``
computes, with PyTorch ops, on any device.  The wrappers in ``ops.py`` take
these for CPU tensors; the tests hold them against the JAX package's jnp
oracles (``repro.kernels.extend_fused.ref``), and ``chip_smoke.py`` holds
each kernel against them on the card.  ``calls`` on each function counts
how often it ran, so a run can show the plain versions stayed off its path.

Each also takes an optional slot range ``slots=(lo, hi)`` and then computes
only what slots ``lo .. hi-1`` of the same launch produce, so a launch too
large for the plain version's temporaries can be checked piece by piece.
For the pruned pair, ``lo`` and ``hi`` are tile-aligned (or ``hi`` is
``cand_cap``); the single-pass version takes any range and the survivor
offset of the slots before it.

The pruned versions evaluate every spec kind of ``repro_torch.core.api``
(a conjunction, the canonical test, a branch set); ``state`` (int32[cap],
the parents' state, which a branch set reads) and ``labels`` (the vertex
labels, which a labeled spec gathers, clipped to the table) are keyword
arguments.  A branch set's bitmap is also compacted, as a third output
beside ``row`` and ``u``.  ``conn_mode`` "mixed" probes a partial or core
pack (``row_slot``, ``n_rows``, ``n_cols``, keyword arguments) as
``GraphCtx.is_connected`` does.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.intersect import binary_contains

# Candidate slots per tile of the pruned pair (the JAX kernels' block_c).
BLOCK_C = 512


def _slot_range(slots, cand_cap: int, tiled: bool) -> tuple[int, int]:
    lo, hi = (0, cand_cap) if slots is None else slots
    if not 0 <= lo < hi <= cand_cap:
        raise ValueError(f"slots {slots} outside [0, {cand_cap})")
    if tiled and (lo % BLOCK_C or (hi % BLOCK_C and hi != cand_cap)):
        raise ValueError(f"slots {slots} are not tile-aligned")
    return lo, hi


def _parents(offsets: torch.Tensor, lo: int, hi: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per slot of ``lo .. hi-1``, the first parent p with offsets[p] >
    slot, clipped to the last parent (searchsorted-right on the inclusive
    prefix sum)."""
    slots = torch.arange(lo, hi, dtype=torch.int32, device=offsets.device)
    p = torch.searchsorted(offsets, slots, right=True, out_int32=True)
    return slots, p.clamp(0, offsets.shape[0] - 1)


def extend_candidates_ref(col_idx, offsets, starts, emb_flat, vlo, vhi, *,
                          k: int, cand_cap: int, n_steps: int, slots=None):
    """Unpruned enumeration (counterpart of ``fused_extend_ref``).

    For each candidate slot: its parent by a search of the inclusive prefix
    sum ``offsets``, the candidate ``u = col_idx[vlo[p] + rank]``, and the
    k-way connectivity bitmask (bit j: u in N(emb[row, j])).  Returns
    (row, u, src_slot, conn), each int32[cand_cap] (or int32[hi - lo]);
    slots past the true total carry the clipped last parent's values for
    the caller to mask.
    """
    extend_candidates_ref.calls += 1
    lo, hi = _slot_range(slots, cand_cap, tiled=False)
    n_parents = offsets.shape[0]
    m = col_idx.shape[0]
    slots, p = _parents(offsets, lo, hi)
    row = torch.div(p, k, rounding_mode="floor")
    src_slot = p - row * k
    pl = p.long()
    ptr = vlo[pl] + (slots - starts[pl])
    u = col_idx[ptr.clamp(0, m - 1).long()]
    conn = torch.zeros(hi - lo, dtype=torch.int32, device=u.device)
    for j in range(k):
        pj = (row * k + j).clamp(0, n_parents - 1).long()
        found = binary_contains(col_idx, vlo[pj], vhi[pj], u, n_steps)
        found = found & (emb_flat[pj] >= 0) & (u >= 0)
        conn = conn | (found.to(torch.int32) << j)
    return row, u, src_slot, conn


extend_candidates_ref.calls = 0


def _pruned_mask(col_idx, offsets, starts, emb_flat, vlo, vhi, bits, *,
                 lo: int, hi: int, k: int, n_steps: int, n_vertices: int,
                 n_words: int, spec, conn_mode: str, state=None,
                 labels=None, row_slot=None, n_rows=None, n_cols=None):
    """Stage K1 of the pruned kernels: enumerate, probe, apply the spec.

    Returns (row, u, keep, new_state) over slots ``lo .. hi-1``, where
    ``new_state`` is a branch set's bitmap (None for the other kinds).
    ``conn_mode`` is "bitmap" (``bits`` holds the full pack, one int32 row
    pattern per vertex), "search" (CSR binary search; ``bits`` unused) or
    "mixed": the parent vertex's row is ``row_slot[ev]``; a packed row
    (and, when ``n_cols < n_vertices``, a candidate below ``n_cols``)
    answers from the bitmap, anything else from the CSR search.
    """
    n_parents = offsets.shape[0]
    m = col_idx.shape[0]
    slots, p = _parents(offsets, lo, hi)
    row = torch.div(p, k, rounding_mode="floor")
    src_slot = p - row * k
    pl = p.long()
    ptr = vlo[pl] + (slots - starts[pl])
    u = col_idx[ptr.clamp(0, m - 1).long()]
    live = slots < offsets[n_parents - 1]
    u_b = u.clamp(0, n_vertices - 1)
    emb_cols, conn_cols = [], []
    for j in range(k):
        pj = (row * k + j).clamp(0, n_parents - 1).long()
        ev = emb_flat[pj]
        if conn_mode == "bitmap":
            ev_c = ev.clamp(0, n_vertices - 1).long()
            w = bits[ev_c * n_words + (u_b >> 5).long()]
            found = ((w >> (u_b & 31)) & 1) == 1
        elif conn_mode == "search":
            found = binary_contains(col_idx, vlo[pj], vhi[pj], u, n_steps)
        elif conn_mode == "mixed":
            pack_row = row_slot[ev.clamp(0, n_vertices - 1).long()]
            in_pack = pack_row >= 0
            if n_cols < n_vertices:            # a core pack's column guard
                in_pack = in_pack & (u < n_cols)
            u_c = u.clamp(0, n_cols - 1)
            w = bits[pack_row.clamp(0, n_rows - 1).long() * n_words
                     + (u_c >> 5).long()]
            hit = ((w >> (u_c & 31)) & 1) == 1
            found = torch.where(in_pack, hit, binary_contains(
                col_idx, vlo[pj], vhi[pj], u, n_steps))
        else:
            raise ValueError(f"conn_mode {conn_mode!r} not in "
                             "('bitmap', 'search', 'mixed')")
        emb_cols.append(ev)
        conn_cols.append(found & (ev >= 0) & (u >= 0))
    emb_cols, conn_cols = tuple(emb_cols), tuple(conn_cols)
    if state is None:
        st = torch.zeros(hi - lo, dtype=torch.int32, device=u.device)
    else:
        st = state[row.clamp(0, n_parents // k - 1).long()]
    new_st = None
    if spec.writes_state:
        new_st = spec.bits(emb_cols, u, src_slot, st, conn_cols)
        keep = new_st != 0
    elif spec.needs_labels:
        nl = labels.shape[0]
        lab_cols = tuple(labels[c.clamp(0, nl - 1).long()]
                         for c in emb_cols)
        lab_u = labels[u.clamp(0, nl - 1).long()]
        keep = spec(emb_cols, u, src_slot, st, conn_cols, lab_cols, lab_u)
    else:
        keep = spec(emb_cols, u, src_slot, st, conn_cols)
    return row, u, keep & live, new_st


def _tile_keep(keep, lo: int, hi: int):
    """``keep`` as int32 tiles of ``BLOCK_C`` slots, zero-padded:
    int32[n_tiles, BLOCK_C]."""
    n_tiles = -(-(hi - lo) // BLOCK_C)
    ki = torch.zeros(n_tiles * BLOCK_C, dtype=torch.int32, device=keep.device)
    ki[:hi - lo] = keep.to(torch.int32)
    return ki.view(n_tiles, BLOCK_C)


def extend_count_ref(col_idx, offsets, starts, emb_flat, vlo, vhi, bits, *,
                     k: int, cand_cap: int, n_steps: int, n_vertices: int,
                     n_words: int, spec, conn_mode: str, state=None,
                     labels=None, row_slot=None, n_rows=None, n_cols=None,
                     slots=None):
    """Pass 1 of the pruned pair: survivors per tile of ``BLOCK_C`` slots
    (int32[ceil(cand_cap / BLOCK_C)], or the tiles of ``slots``)."""
    extend_count_ref.calls += 1
    lo, hi = _slot_range(slots, cand_cap, tiled=True)
    _, _, keep, _ = _pruned_mask(
        col_idx, offsets, starts, emb_flat, vlo, vhi, bits, lo=lo, hi=hi,
        k=k, n_steps=n_steps, n_vertices=n_vertices, n_words=n_words,
        spec=spec, conn_mode=conn_mode, state=state, labels=labels,
        row_slot=row_slot, n_rows=n_rows, n_cols=n_cols)
    return _tile_keep(keep, lo, hi).sum(dim=1, dtype=torch.int32)


extend_count_ref.calls = 0


def extend_scatter_ref(col_idx, offsets, starts, emb_flat, vlo, vhi, bits,
                       bases, *, k: int, cand_cap: int, out_cap: int,
                       n_steps: int, n_vertices: int, n_words: int, spec,
                       conn_mode: str, state=None, labels=None, row_slot=None,
                       n_rows=None, n_cols=None, slots=None):
    """Pass 2 of the pruned pair: survivor r of tile i goes to
    ``bases[i] + r`` when that is below ``out_cap``.

    Returns (row, u), each int32[out_cap], and for a branch set also the
    compacted bitmap (row, u, state); slots no survivor reaches hold 0, -1
    and 0 (with ``slots``, only that range's survivors are written).
    """
    extend_scatter_ref.calls += 1
    lo, hi = _slot_range(slots, cand_cap, tiled=True)
    row, u, keep, new_st = _pruned_mask(
        col_idx, offsets, starts, emb_flat, vlo, vhi, bits, lo=lo, hi=hi,
        k=k, n_steps=n_steps, n_vertices=n_vertices, n_words=n_words,
        spec=spec, conn_mode=conn_mode, state=state, labels=labels,
        row_slot=row_slot, n_rows=n_rows, n_cols=n_cols)
    ki = _tile_keep(keep, lo, hi)
    n_tiles = ki.shape[0]
    rank = torch.cumsum(ki, dim=1, dtype=torch.int32).view(-1)[:hi - lo] - 1
    t0 = lo // BLOCK_C
    tile_base = bases[t0:t0 + n_tiles].repeat_interleave(BLOCK_C)[:hi - lo]
    return _place(row, u, new_st, keep, tile_base.long() + rank, out_cap)


extend_scatter_ref.calls = 0


def _place(row, u, new_st, keep, dest, out_cap: int):
    """Write each kept slot's (row, u[, state]) at ``dest`` when that is
    below ``out_cap``; each output int32[out_cap] holds 0, -1 (and 0)
    elsewhere.  ``new_st`` None writes no state."""
    dest = torch.where(keep & (dest < out_cap), dest, out_cap)
    cols = [(row, 0), (u, -1)] + ([] if new_st is None else [(new_st, 0)])
    out = []
    for vals, fill in cols:
        buf = torch.full((out_cap + 1,), fill, dtype=torch.int32,
                         device=u.device)
        buf.index_put_((dest,), vals.to(torch.int32))
        out.append(buf[:out_cap])
    return tuple(out)


def extend_pruned_1p_ref(col_idx, offsets, starts, emb_flat, vlo, vhi, bits,
                         *, k: int, cand_cap: int, out_cap: int, n_steps: int,
                         n_vertices: int, n_words: int, spec, conn_mode: str,
                         state=None, labels=None, row_slot=None, n_rows=None,
                         n_cols=None, slots=None, base: int = 0):
    """The single-pass pruned extend (counterpart of
    ``fused_extend_pruned_ref``): enumerate, apply the predicate, and
    compact the survivors in slot order by one prefix sum.

    Returns (row int32[out_cap], u int32[out_cap], n_surv int32[]), and for
    a branch set (row, u, state int32[out_cap], n_surv); the survivor count
    may exceed ``out_cap``, and lanes past ``min(n_surv, out_cap)`` hold 0,
    -1 (and 0).  The same buffers as the two-pass pair's.  With
    ``slots=(lo, hi)`` (any range), only those slots' survivors are
    written, from position ``base`` on (the survivors of slots before
    ``lo``), and ``n_surv`` is ``base`` plus their number, so a launch can
    be checked piece by piece with the offset carried from piece to piece.
    """
    extend_pruned_1p_ref.calls += 1
    lo, hi = _slot_range(slots, cand_cap, tiled=False)
    row, u, keep, new_st = _pruned_mask(
        col_idx, offsets, starts, emb_flat, vlo, vhi, bits, lo=lo, hi=hi,
        k=k, n_steps=n_steps, n_vertices=n_vertices, n_words=n_words,
        spec=spec, conn_mode=conn_mode, state=state, labels=labels,
        row_slot=row_slot, n_rows=n_rows, n_cols=n_cols)
    incl = torch.cumsum(keep, 0, dtype=torch.int64)
    out = _place(row, u, new_st, keep, base + incl - 1, out_cap)
    n_surv = (base + incl[-1]).to(torch.int32)
    return out + (n_surv,)


extend_pruned_1p_ref.calls = 0


def extend_edge_ref(col_idx, edge_uid, offsets, starts, slots_flat, vlo,
                    eids_flat, usrc, udst, vmask=None, *, n_slots: int,
                    cand_cap: int, n_uedges: int, n_vertices: int,
                    slots=None):
    """Edge-induced enumeration (counterpart of ``fused_extend_edge_ref``).

    The parent tables are per slot-parent, ``[cap * n_slots]`` flattened
    (``n_slots = E + 1`` vertex slots per embedding): ``offsets`` and
    ``starts`` the inclusive and exclusive prefix sums of per-slot
    candidate counts, ``slots_flat`` the slot's vertex, ``vlo`` its CSR row
    start.  ``eids_flat`` is the ``[cap * E]`` table of existing edge uids,
    ``usrc``/``udst`` the endpoints of each uid, ``vmask`` (int32
    [n_vertices], optional) the app's per-vertex eager ``toAdd`` mask.

    For each candidate slot: its parent by a search of ``offsets``, the
    candidate ``u`` and its edge uid from the CSR, the canonical-edge test
    against the row's E edges, and the mask.  Returns (row, s, u, new_eid,
    add), each int32[cand_cap] (or int32[hi - lo]), the same value on every
    lane as the kernel: a dead lane (slot past the total) carries the last
    parent's row and s, ``u = new_eid = -1`` and ``add = 0``.
    """
    extend_edge_ref.calls += 1
    lo, hi = _slot_range(slots, cand_cap, tiled=False)
    n_parents = offsets.shape[0]
    m = col_idx.shape[0]
    E = n_slots - 1
    e_rows = n_parents // n_slots * E
    slot, p = _parents(offsets, lo, hi)
    row = torch.div(p, n_slots, rounding_mode="floor")
    s = p - row * n_slots
    pl = p.long()
    ptr = (vlo[pl].long() + (slot - starts[pl]).long()).clamp(0, m - 1)
    live = slot < offsets[n_parents - 1]      # every slot is < cand_cap
    u = torch.where(live, col_idx[ptr], -1)
    new_eid = torch.where(live, edge_uid[ptr], -1)
    w = slots_flat[pl]
    base = row.long() * E
    eid0 = eids_flat[base.clamp(0, e_rows - 1)]
    ok = new_eid > eid0
    found = torch.zeros(ok.shape, dtype=torch.bool, device=ok.device)
    for j in range(E):
        eidj = eids_flat[(base + j).clamp(0, e_rows - 1)]
        ec = eidj.clamp(0, max(n_uedges - 1, 0)).long()
        es, ed = usrc[ec], udst[ec]
        shares = (w == es) | (w == ed) | (u == es) | (u == ed)
        ok = ok & ~(found & (new_eid < eidj))
        found = found | shares
        ok = ok & (new_eid != eidj)
    add = ok & found
    if vmask is not None:
        add = add & (vmask[u.clamp(0, n_vertices - 1).long()] != 0)
    add = add & live
    return row, s, u, new_eid, add.to(torch.int32)


extend_edge_ref.calls = 0

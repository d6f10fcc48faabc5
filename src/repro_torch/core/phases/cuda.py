"""CUDA phase backends: EXTEND on hand-written Hopper kernels (counterparts
of ``repro.core.phases.pallas``: ``cuda`` under the ``pallas-mp`` contract,
``cuda-1p`` a single pass like ``pallas``).

* ``_vertex_candidates`` (the cold inspection pass) runs the unpruned
  enumeration kernel ``extend_candidates`` and evaluates the app's
  predicate spec on its connectivity bitmask, with the parents' state and,
  for a labeled spec, the labels.
* ``extend_pruned`` (every level, cold and warm) runs the two-pass pair
  ``extend_count`` / ``extend_scatter``: no state crosses thread blocks
  except the tile counts' exclusive scan between the passes, so the
  compaction contract is ``two-pass-scan`` on a ``concurrent`` grid.
  ``cuda-1p`` (:class:`CudaLookbackBackend`) swaps exactly this call for
  the single-pass ``extend_pruned_1p``, whose tiles find their bases by a
  decoupled look-back across thread blocks (``decoupled-lookback``, one
  pass, still a ``concurrent`` grid); everything else is shared.  The
  kernels evaluate every spec kind: a conjunction (the clique rules, a
  compiled pattern's level, labeled or not), the canonical test, and a
  pattern-set trie level, whose branch bitmap they compact into the next
  level's state column.
* ``_edge_candidates`` (every edge level, cold inspection and extension)
  runs ``extend_edge``: the ragged expansion, CSR and edge-uid gathers, the
  canonical-edge test and the app's per-vertex eager mask in one kernel.
* The reduces are the plain backend's PyTorch, on the device with no host
  read (JAX computes them outside Pallas too).

The pruned kernels probe connectivity as the ``pallas`` backend does: from
the full bit-packed adjacency when the graph has one (``bitmap``), from a
partial or core pack with the CSR search for what it does not cover
(``mixed``), and by CSR binary search otherwise (``search``).
``fuse_filter=False`` (the materialise-then-filter ablation) runs the base
class's unfused path: the inspection kernel, the spec in PyTorch, then the
full candidate list filtered.  What the kernels cannot express raises
NotImplementedError instead of running plain PyTorch: a vertex app without
a predicate spec, a state update other than a branch set's own bitmap, an
edge app with a general batch ``to_add`` and no per-vertex mask.

On CPU tensors the kernel wrappers run their plain versions, which is how
the tests drive this backend without a card.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import (GraphCtx, MiningApp,
                                  resolve_kernel_predicate,
                                  resolve_state_kernel, spec_state_update)
from repro_torch.core.embedding_list import EmbeddingLevel
from repro_torch.core.phases.reference import (ReferenceBackend,
                                               _col_idx, _pad_empty_frontier,
                                               check_cand_cap,
                                               check_supported,
                                               edge_ext_degrees,
                                               edge_vertex_slots, eval_spec,
                                               label_table,
                                               vertex_ext_degrees)
from repro_torch.kernels.extend_fused import ops

# Candidate slots per chunk of the inspection predicate, which bounds its
# temporaries at cold 4-CF's 2^30 candidates.
PREDICATE_CHUNK = 1 << 25


class CudaBackend(ReferenceBackend):
    """Plain pipeline with the vertex EXTEND enumeration on CUDA kernels."""

    name = "cuda"
    compaction = "two-pass-scan"
    compaction_passes = 2
    grid_contract = "concurrent"

    # The ``ops`` wrapper behind extend_pruned, by name: looked up at each
    # call, so a wrapper replaced in ``ops`` (as the smoke script's checks
    # do) is the one that runs.  A subclass swaps only this, and every line
    # of input prep stays shared.
    _pruned_kernel = "extend_pruned"

    @staticmethod
    def _edge_fusible(app: MiningApp) -> bool:
        """The edge kernel runs the canonical test and a per-vertex eager
        mask; a general batch ``to_add`` hook it cannot run."""
        return app.to_add is None or app.to_add_vertex_mask is not None

    @staticmethod
    def _refusal(app: MiningApp, k: int) -> str | None:
        """Why the kernels cannot run ``app``'s level of parent width
        ``k`` (a capability tag), or None."""
        spec = resolve_kernel_predicate(app, k)
        if spec is None:
            return "no-predicate-spec"
        upd = resolve_state_kernel(app, k)
        if upd is not None and not spec_state_update(spec, upd):
            return "state-update"
        return None

    def capabilities(self, app: MiningApp | None = None) -> dict:
        caps = super().capabilities(app)
        fused = "cuda-kernel"
        if app is None:
            caps["extend_vertex"] = caps["extend_pruned"] = fused
            caps["extend_edge"] = fused
        elif app.kind == "vertex":
            why = [self._refusal(app, k)
                   for k in range(2, max(app.max_size, 3))]
            if any(why):
                fused = f"unsupported:{next(w for w in why if w)}"
            caps["extend_vertex"] = caps["extend_pruned"] = fused
            caps["extend_edge"] = "n/a"
        else:
            caps["extend_vertex"] = caps["extend_pruned"] = "n/a"
            caps["extend_edge"] = (fused if self._edge_fusible(app)
                                   else "unsupported:batch-to-add")
        return caps

    @classmethod
    def _spec(cls, app: MiningApp, k: int):
        check_supported(app)
        why = cls._refusal(app, k)
        if why == "no-predicate-spec":
            raise NotImplementedError(
                f"app {app.name!r} has no kernel predicate spec for k={k}; "
                "the cuda backend runs only spec predicates")
        if why == "state-update":
            raise NotImplementedError(
                f"app {app.name!r}: the kernels compute the state column "
                "only as a branch set's own bitmap (BranchSetSpec.bits); "
                "this update_state_kernel runs on torch-ref only")
        return resolve_kernel_predicate(app, k)

    @staticmethod
    def _kernel_inputs(ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                       n_valid: torch.Tensor, state=None):
        deg = vertex_ext_degrees(ctx, app, emb, n_valid, state)
        counts = deg.reshape(-1)
        offsets = torch.cumsum(counts, 0, dtype=torch.int32)  # inclusive
        starts = offsets - counts
        embc = emb.clamp(0, ctx.n_vertices - 1).reshape(-1).long()
        vlo = ctx.row_ptr[embc]
        vhi = ctx.row_ptr[embc + 1]
        return offsets, starts, vlo, vhi, counts.sum(dtype=torch.int64)

    @staticmethod
    def _state_labels(ctx: GraphCtx, spec, state, cap: int):
        """The state and label tables the kernels read for ``spec`` (None
        where it reads none)."""
        st = lab = None
        if spec.kind == "branches":
            st = (torch.zeros(cap, dtype=torch.int32, device=ctx.device)
                  if state is None else state.to(torch.int32).contiguous())
        if spec.needs_labels:
            lab = label_table(ctx)
        return st, lab

    def _vertex_candidates(self, ctx: GraphCtx, app: MiningApp,
                           emb: torch.Tensor, n_valid: torch.Tensor, state,
                           cand_cap: int):
        check_cand_cap(cand_cap)
        emb, state = _pad_empty_frontier(emb, state)
        cap, k = emb.shape
        spec = self._spec(app, k)
        offsets, starts, vlo, vhi, total = self._kernel_inputs(
            ctx, app, emb, n_valid, state)
        row, u, src_slot, conn = ops.extend_candidates(
            _col_idx(ctx), offsets, starts, emb.reshape(-1).contiguous(),
            vlo, vhi, k=k, cand_cap=cand_cap, n_steps=ctx.n_steps)
        # The predicate runs over the kernel's outputs chunk by chunk, and
        # masks them in place (they are this call's own buffers): at cold
        # 4-CF the outputs alone are 16 GiB.  It sees the parents' state
        # (``state[row]``) and labels, as the pruned kernels do.
        add = torch.empty(cand_cap, dtype=torch.bool, device=u.device)
        labels = label_table(ctx) if spec.needs_labels else None
        for s in range(0, cand_cap, PREDICATE_CHUNK):
            e = min(s + PREDICATE_CHUNK, cand_cap)
            live = torch.arange(s, e, dtype=torch.int32,
                                device=u.device) < offsets[-1]
            r = row[s:e].clamp_(0, cap - 1)
            uu = u[s:e].masked_fill_(~live, -1)
            cb = conn[s:e]
            parent = emb[r.long()]
            st = (torch.zeros(e - s, dtype=torch.int32, device=u.device)
                  if state is None else state[r.long()])
            add[s:e] = eval_spec(
                spec, labels, tuple(parent[:, j] for j in range(k)), uu,
                src_slot[s:e], st,
                tuple(((cb >> j) & 1).bool() & live
                      for j in range(k))) & live
        return row, u, src_slot, add, total

    @staticmethod
    def _pack_args(ctx: GraphCtx, device) -> dict:
        """The probe mode and pack arguments of the pruned kernels (as
        ``repro.core.phases.pallas`` picks them): full pack -> bitmap,
        partial or core pack -> mixed, no pack -> search."""
        pg = ctx.packed
        if pg is None:
            return dict(conn_mode="search", n_words=1, bits=torch.zeros(
                1, dtype=torch.int32, device=device))
        if pg.full:
            return dict(conn_mode="bitmap", n_words=pg.n_words,
                        bits=pg.words.reshape(-1))
        return dict(conn_mode="mixed", n_words=pg.n_words,
                    bits=pg.words.reshape(-1), row_slot=pg.row_slot,
                    n_rows=pg.n_packed, n_cols=pg.n_cols)

    def extend_pruned(self, ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                      n_valid: torch.Tensor, state, cand_cap: int,
                      out_cap: int, fuse_filter: bool = True):
        if not fuse_filter:
            # the ablation: K3 enumerates, then the spec and the filter run
            # over the materialised candidate list
            return super().extend_pruned(ctx, app, emb, n_valid, state,
                                         cand_cap, out_cap,
                                         fuse_filter=False)
        check_cand_cap(cand_cap)
        emb, state = _pad_empty_frontier(emb, state)
        cap, k = emb.shape
        spec = self._spec(app, k)
        offsets, starts, vlo, vhi, total = self._kernel_inputs(
            ctx, app, emb, n_valid, state)
        pack = self._pack_args(ctx, emb.device)
        bits = pack.pop("bits")
        st, lab = self._state_labels(ctx, spec, state, cap)
        out = getattr(ops, self._pruned_kernel)(
            _col_idx(ctx), offsets, starts, emb.reshape(-1).contiguous(),
            vlo, vhi, bits, k=k, cand_cap=cand_cap, out_cap=out_cap,
            n_steps=ctx.n_steps, n_vertices=ctx.n_vertices, spec=spec,
            state=st, labels=lab, **pack)
        row, u = out[0], out[1]
        n_surv = out[3] if spec.writes_state else out[2]
        # a branch set's bitmap is the new state where the app updates it
        st_out = (out[2] if spec.writes_state
                  and resolve_state_kernel(app, k) is not None else None)
        live = torch.arange(out_cap, dtype=torch.int32,
                            device=emb.device) < n_surv
        vid = torch.where(live, u, -1)
        idx = torch.where(live, row.clamp(0, cap - 1), 0)
        level = EmbeddingLevel(vid=vid, idx=idx, n=n_surv, state=st_out)
        new_emb = torch.cat([emb[idx.long()], vid[:, None]], dim=1)
        return level, new_emb, total

    def _edge_candidates(self, ctx: GraphCtx, app: MiningApp, v0, vid, his,
                         eid, n_valid: torch.Tensor, cand_cap: int):
        """Edge-induced enumeration on ``extend_edge`` (counterpart of the
        pallas backend's ``_edge_candidates``).  The [cap, E+1] work (slot
        freshness, toExtend, degree prefix sum) is PyTorch; the
        candidate-scale work is the kernel."""
        check_supported(app)
        check_cand_cap(cand_cap)
        if not self._edge_fusible(app):
            raise NotImplementedError(
                f"app {app.name!r} has a batch to_add hook and no "
                "to_add_vertex_mask; the cuda backend's edge kernel runs "
                "only the per-vertex mask")
        E = vid.shape[1]
        if ctx.n_edges == 0:
            # No candidate exists: every lane is dead, which the kernel's
            # inputs (an empty CSR) cannot express.  This is the dead
            # output itself, not the plain version run in its place.
            dev = vid.device
            zero = torch.zeros(cand_cap, dtype=torch.int32, device=dev)
            dead = torch.full((cand_cap,), -1, dtype=torch.int32, device=dev)
            return (zero, zero.clone(), dead, dead.clone(),
                    torch.zeros(cand_cap, dtype=torch.bool, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev))
        slots, fresh = edge_vertex_slots(v0, vid, his)
        counts = edge_ext_degrees(ctx, app, slots, fresh, n_valid).reshape(-1)
        offsets = torch.cumsum(counts, 0, dtype=torch.int32)  # inclusive
        slots_c = slots.clamp(0, ctx.n_vertices - 1).reshape(-1)
        vlo = ctx.row_ptr[slots_c.long()]
        vmask = None
        if app.to_add_vertex_mask is not None:
            vmask = app.to_add_vertex_mask(ctx).to(torch.int32)
        row, s, u, new_eid, add = ops.extend_edge(
            ctx.col_idx, ctx.edge_uid, offsets, offsets - counts,
            slots_c.contiguous(), vlo, eid.reshape(-1).contiguous(),
            ctx.usrc, ctx.udst, vmask, n_slots=E + 1, cand_cap=cand_cap,
            n_uedges=ctx.n_uedges, n_vertices=ctx.n_vertices)
        return row, s, u, new_eid, add.bool(), counts.sum(dtype=torch.int64)


class CudaLookbackBackend(CudaBackend):
    """The ``cuda`` backend with the single-pass pruned extend
    (``extend_pruned_1p``, the port of the ``pallas`` backend's
    ``fused_extend_pruned``): one enumeration per level instead of two, the
    same buffers bit for bit.  Inspection, the edge path and what the
    ``cuda`` backend refuses are inherited unchanged."""

    name = "cuda-1p"
    compaction = "decoupled-lookback"
    compaction_passes = 1
    grid_contract = "concurrent"
    _pruned_kernel = "extend_pruned_1p"

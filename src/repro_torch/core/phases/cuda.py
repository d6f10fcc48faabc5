"""CUDA phase backend: vertex EXTEND on hand-written Hopper kernels
(counterpart of ``repro.core.phases.pallas`` under the ``pallas_mp``
contract).

* ``_vertex_candidates`` (the cold inspection pass) runs the unpruned
  enumeration kernel ``extend_candidates`` and evaluates the app's
  predicate spec on its connectivity bitmask.
* ``extend_pruned`` (every level, cold and warm) runs the two-pass pair
  ``extend_count`` / ``extend_scatter``: no state crosses thread blocks
  except the tile counts' exclusive scan between the passes, so the
  compaction contract is ``two-pass-scan`` on a ``concurrent`` grid.

Connectivity is probed from the full bit-packed adjacency when the graph
has one (``bitmap``) and by CSR binary search otherwise (``search``).
What the kernels cannot express raises NotImplementedError instead of
running plain PyTorch: an app without a predicate spec, ``fuse_filter=
False``, a partial or core pack, labels, a state-updating app.

On CPU tensors the kernel wrappers run their plain versions, which is how
the tests drive this backend without a card.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import GraphCtx, MiningApp, resolve_kernel_predicate
from repro_torch.core.embedding_list import EmbeddingLevel
from repro_torch.core.phases.reference import (ReferenceBackend,
                                               _col_idx, _pad_empty_frontier,
                                               check_cand_cap,
                                               check_supported,
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

    def capabilities(self, app: MiningApp | None = None) -> dict:
        caps = super().capabilities(app)
        fused = "cuda-kernel"
        if app is not None:
            ks = range(2, max(app.max_size, 3))
            if any(resolve_kernel_predicate(app, k) is None for k in ks):
                fused = "unsupported:no-predicate-spec"
        caps["extend_vertex"] = caps["extend_pruned"] = fused
        return caps

    @staticmethod
    def _spec(ctx: GraphCtx, app: MiningApp, k: int):
        check_supported(app)
        spec = resolve_kernel_predicate(app, k)
        if spec is None:
            raise NotImplementedError(
                f"app {app.name!r} has no kernel predicate spec for k={k}; "
                "the cuda backend runs only spec predicates")
        if ctx.labels is not None:
            raise NotImplementedError("in-kernel label gathers are not "
                                      "ported yet")
        return spec

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

    def _vertex_candidates(self, ctx: GraphCtx, app: MiningApp,
                           emb: torch.Tensor, n_valid: torch.Tensor, state,
                           cand_cap: int):
        check_cand_cap(cand_cap)
        emb, state = _pad_empty_frontier(emb, state)
        cap, k = emb.shape
        spec = self._spec(ctx, app, k)
        offsets, starts, vlo, vhi, total = self._kernel_inputs(
            ctx, app, emb, n_valid, state)
        row, u, src_slot, conn = ops.extend_candidates(
            _col_idx(ctx), offsets, starts, emb.reshape(-1).contiguous(),
            vlo, vhi, k=k, cand_cap=cand_cap, n_steps=ctx.n_steps)
        # The predicate runs over the kernel's outputs chunk by chunk, and
        # masks them in place (they are this call's own buffers): at cold
        # 4-CF the outputs alone are 16 GiB.
        add = torch.empty(cand_cap, dtype=torch.bool, device=u.device)
        st = None
        for s in range(0, cand_cap, PREDICATE_CHUNK):
            e = min(s + PREDICATE_CHUNK, cand_cap)
            live = torch.arange(s, e, dtype=torch.int32,
                                device=u.device) < offsets[-1]
            r = row[s:e].clamp_(0, cap - 1)
            uu = u[s:e].masked_fill_(~live, -1)
            cb = conn[s:e]
            parent = emb[r.long()]
            if st is None or st.shape[0] != e - s:
                st = torch.zeros(e - s, dtype=torch.int32, device=u.device)
            add[s:e] = spec(tuple(parent[:, j] for j in range(k)), uu,
                            src_slot[s:e], st,
                            tuple(((cb >> j) & 1).bool() & live
                                  for j in range(k))) & live
        return row, u, src_slot, add, total

    def extend_pruned(self, ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                      n_valid: torch.Tensor, state, cand_cap: int,
                      out_cap: int, fuse_filter: bool = True):
        if not fuse_filter:
            raise NotImplementedError("the cuda backend fuses the filter; "
                                      "fuse_filter=False is not ported")
        check_cand_cap(cand_cap)
        emb, state = _pad_empty_frontier(emb, state)
        cap, k = emb.shape
        spec = self._spec(ctx, app, k)
        offsets, starts, vlo, vhi, total = self._kernel_inputs(
            ctx, app, emb, n_valid, state)
        pg = ctx.packed
        if pg is None:
            conn_mode, n_words = "search", 1
            bits = torch.zeros(1, dtype=torch.int32, device=emb.device)
        elif pg.full:
            conn_mode, n_words = "bitmap", pg.n_words
            bits = pg.words.reshape(-1)
        else:
            raise NotImplementedError("mixed connectivity (partial or core "
                                      "pack) is not ported yet")
        row, u, n_surv, _ = ops.extend_pruned(
            _col_idx(ctx), offsets, starts, emb.reshape(-1).contiguous(),
            vlo, vhi, bits, k=k, cand_cap=cand_cap, out_cap=out_cap,
            n_steps=ctx.n_steps, n_vertices=ctx.n_vertices, n_words=n_words,
            spec=spec, conn_mode=conn_mode)
        live = torch.arange(out_cap, dtype=torch.int32,
                            device=emb.device) < n_surv
        vid = torch.where(live, u, -1)
        idx = torch.where(live, row.clamp(0, cap - 1), 0)
        level = EmbeddingLevel(vid=vid, idx=idx, n=n_surv)
        new_emb = torch.cat([emb[idx.long()], vid[:, None]], dim=1)
        return level, new_emb, total

"""Phase-backend interface (counterpart of ``repro.core.phases.base``).

The engine owns the per-level loop; a :class:`PhaseBackend` owns the set
operations the loop composes.  Ported so far:

  candidate_bound_vertex   cheap degree-sum upper bound
  inspect_vertex           exact (candidate, survivor) counts
  extend_vertex            produce the next SoA level
  extend_pruned            fused extend + filter + compaction with counts
                           (the warm-path op)
  candidate_bound_edge     the same three for edge-induced levels
  inspect_edge
  extend_edge
  reduce_count             vertex reduce: classify + count per pattern
  reduce_domain            FSM reduce: canonical codes + MNI support
  reduce_domain_sharded    the same over the ranks of a process group
                           (global pattern table, union of the domains)
  filter_levels            support-based compaction of the last level

The JAX package's ``phase.op_tracings`` counter, which counts jit
tracings of each op, has no counterpart: PyTorch runs each op eagerly and
traces nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.api import GraphCtx, MiningApp
from repro_torch.core.embedding_list import EmbeddingLevel


class PhaseBackend:
    """Abstract extend op set.  Subclass and register."""

    name: str = "abstract"

    # How extend_pruned resolves cross-tile survivor offsets and what
    # grid order that assumes; folded into the plan identity
    # (repro_torch.core.plan.plan_app_key), as in the JAX package:
    #   compaction          "xla-scan" (prefix-sum compaction outside any
    #                       kernel) | "two-pass-scan" (per-tile counts ->
    #                       exclusive scan -> masked scatter) |
    #                       "decoupled-lookback" (one pass; each tile's
    #                       base from its predecessors' published counts)
    #   compaction_passes   kernel passes over the candidate range
    #   grid_contract       "any" | "sequential" | "concurrent"
    compaction: str = "xla-scan"
    compaction_passes: int = 0
    grid_contract: str = "any"

    def capabilities(self, app: Optional[MiningApp] = None) -> dict:
        return {"backend": self.name, "compaction": self.compaction,
                "compaction_passes": self.compaction_passes,
                "grid_contract": self.grid_contract,
                "extend_vertex": "plain", "extend_pruned": "plain",
                "extend_edge": "plain"}

    def candidate_bound_vertex(self, ctx: GraphCtx, app: MiningApp,
                               emb: torch.Tensor, n_valid: torch.Tensor,
                               state: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        raise NotImplementedError

    def inspect_vertex(self, ctx: GraphCtx, app: MiningApp,
                       emb: torch.Tensor, n_valid: torch.Tensor,
                       state: Optional[torch.Tensor], cand_cap: int):
        raise NotImplementedError

    def extend_vertex(self, ctx: GraphCtx, app: MiningApp,
                      emb: torch.Tensor, n_valid: torch.Tensor,
                      state: Optional[torch.Tensor], cand_cap: int,
                      out_cap: int, fuse_filter: bool = True):
        raise NotImplementedError

    def extend_pruned(self, ctx: GraphCtx, app: MiningApp,
                      emb: torch.Tensor, n_valid: torch.Tensor,
                      state: Optional[torch.Tensor], cand_cap: int,
                      out_cap: int, fuse_filter: bool = True):
        """Fused extend + eager toAdd filter + stream compaction.

        Returns ``(level, new_emb, n_candidates)``; the survivor count is
        ``level.n``, and an app with a kernel state update gets the new
        state column as ``level.state``.  Both counts come back as device tensors, so a plan
        replay checks overflow without an inspection pass and without a
        host read.
        """
        raise NotImplementedError

    # -- EXTEND: edge-induced

    def candidate_bound_edge(self, ctx, app, v0, vid, his, n_valid):
        raise NotImplementedError

    def inspect_edge(self, ctx, app, v0, vid, his, eid, n_valid,
                     cand_cap: int):
        raise NotImplementedError

    def extend_edge(self, ctx, app, v0, vid, his, eid, n_valid,
                    cand_cap: int, out_cap: int):
        """Produce the next edge-induced level.

        Returns ``(level, n_candidates)``, the fused-counts contract of
        :meth:`extend_pruned` (survivors are ``level.n``).
        """
        raise NotImplementedError

    # -- REDUCE / FILTER

    def reduce_count(self, ctx: GraphCtx, app: MiningApp, emb: torch.Tensor,
                     n_valid: torch.Tensor, state: Optional[torch.Tensor]):
        """Vertex reduce: ``(p_map int32[max_patterns], pat int32[cap],
        new_state)``, with no host read."""
        raise NotImplementedError

    def reduce_domain(self, ctx: GraphCtx, app: MiningApp,
                      levels: list[EmbeddingLevel]):
        """FSM reduce: ``(codes, supports, pat, pat_valid)``."""
        raise NotImplementedError

    def reduce_domain_sharded(self, ctx: GraphCtx, app: MiningApp,
                              levels: list[EmbeddingLevel], group=None,
                              packed: bool = True):
        """FSM reduce across the ranks of a ``torch.distributed`` group:
        exact global MNI support through collectives; ``group=None`` is
        the local reduce."""
        raise NotImplementedError

    def filter_levels(self, levels: list[EmbeddingLevel],
                      keep: torch.Tensor, out_cap: int
                      ) -> list[EmbeddingLevel]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<PhaseBackend {self.name}>"

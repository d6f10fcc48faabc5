"""Execution engine (paper Alg. 1: extend -> reduce -> filter per level;
counterpart of ``repro.core.engine``).

There is one level loop, :func:`run_level_loop`, shared by the vertex- and
edge-induced pipeline adapters, and a capacity policy decides how each
level's static capacities are obtained: the cold :meth:`Miner.run`
inspects every level on the host (``HostCapPolicy``) and records a
:class:`~repro_torch.core.plan.MiningPlan`; later runs replay it
(``PlanCapPolicy``) through :class:`~repro_torch.core.plan.MiningExecutor`
without a host read until the end.  Every phase op resolves through the
backend registry (:mod:`repro_torch.core.phases`).

Vertex apps with ``needs_reduce`` (motif counting, pattern sets) end in
the count reduce and return ``MineResult.p_map``, cold and warm.

Not ported yet: edge blocks, the sampled estimator and the plan cache,
bounded and sharded mining (``bounded_mine_edge``, the sharded FSM
reduce), and the observability spans and metrics of ``repro.obs``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import GraphCtx, MiningApp, make_ctx
from repro_torch.core.embedding_list import (EmbeddingLevel,
                                             init_level0_edge,
                                             init_level0_vertex, materialize,
                                             materialize_edges, total_bytes)
from repro_torch.core.phases import BackendSpec, get_backend
from repro_torch.core.phases.reference import INT_MAX
from repro_torch.core.plan import HostCapPolicy, MiningExecutor, bucket_pow2
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.graph.csr import CSRGraph, Relabeling
from repro_torch.graph.csr import pack_hit_rate as _pack_hit_rate
from repro_torch.graph.csr import relabel as relabel_graph
from repro_torch.graph.dag import orient_dag


@dataclasses.dataclass
class LevelStats:
    level: int
    n_candidates: int
    n_embeddings: int
    capacity: int
    bytes: int
    seconds: float
    live_bytes: int = 0       # embedding list + materialised frontier


@dataclasses.dataclass
class MineResult:
    count: int
    p_map: Optional[np.ndarray] = None          # count support per pattern
    codes: Optional[np.ndarray] = None          # canonical codes (FSM)
    supports: Optional[np.ndarray] = None       # MNI supports (FSM)
    stats: list[LevelStats] = dataclasses.field(default_factory=list)
    levels: Optional[list[EmbeddingLevel]] = None


class _PhaseOps:
    """Backend phase ops bound to one (ctx, app, backend) triple.

    An edge app's ``to_add_vertex_mask`` hook runs here, once: the backend
    is handed an app whose hook returns that tensor at every level.
    """

    def __init__(self, ctx: GraphCtx, app: MiningApp, backend,
                 fuse_filter: bool = True):
        if app.kind == "edge" and app.to_add_vertex_mask is not None:
            vmask = app.to_add_vertex_mask(ctx)
            app = dataclasses.replace(app,
                                      to_add_vertex_mask=lambda _ctx: vmask)
        self.ctx, self.app, self.backend = ctx, app, backend
        self.fuse_filter = fuse_filter

    def inspect(self, emb, n, st, *, cand_cap):
        return self.backend.inspect_vertex(self.ctx, self.app, emb, n, st,
                                           cand_cap)

    def bound(self, emb, n, st):
        return self.backend.candidate_bound_vertex(self.ctx, self.app, emb,
                                                   n, st)

    def extend(self, emb, n, st, *, cand_cap, out_cap):
        # fused extend + filter + compaction with counts: the one
        # enumeration per level (no separate inspection on replay)
        return self.backend.extend_pruned(self.ctx, self.app, emb, n, st,
                                          cand_cap, out_cap,
                                          fuse_filter=self.fuse_filter)

    def reduce(self, emb, n, st):
        return self.backend.reduce_count(self.ctx, self.app, emb, n, st)

    # -- edge-induced
    def bound_e(self, v0, vid, his, n):
        return self.backend.candidate_bound_edge(self.ctx, self.app, v0, vid,
                                                 his, n)

    def inspect_e(self, v0, vid, his, eid, n, *, cand_cap):
        return self.backend.inspect_edge(self.ctx, self.app, v0, vid, his,
                                         eid, n, cand_cap)

    def extend_e(self, v0, vid, his, eid, n, *, cand_cap, out_cap):
        return self.backend.extend_edge(self.ctx, self.app, v0, vid, his,
                                        eid, n, cand_cap, out_cap)

    def reduce_e(self, levels):
        return self.backend.reduce_domain(self.ctx, self.app, levels)

    def filter_e(self, levels, keep, *, out_cap):
        return self.backend.filter_levels(levels, keep, out_cap)


class _VertexPipeline:
    """Vertex-induced frontier: emb matrix + memo state, count reduce."""

    def __init__(self, ops: _PhaseOps, src, dst, n0):
        self.ops = ops
        self.levels = init_level0_vertex(src, dst, n0)
        self.emb = materialize(self.levels)
        self.n = self.levels[0].n
        app = ops.app
        self.state = (app.init_state(ops.ctx, self.emb, self.n)
                      if app.init_state is not None
                      else torch.zeros(self.emb.shape[:1], dtype=torch.int32,
                                       device=self.emb.device))
        self.p_map = None

    def level_range(self):
        return range(2, self.ops.app.max_size)

    def pre_loop(self, policy):
        return None

    def frontier_nbytes(self) -> int:
        return self.emb.numel() * self.emb.element_size()

    def bound(self):
        return self.ops.bound(self.emb, self.n, self.state)

    def inspect(self, cand_cap: int):
        return self.ops.inspect(self.emb, self.n, self.state,
                                cand_cap=cand_cap)

    def extend(self, cand_cap: int, out_cap: int):
        new_level, self.emb, n_cand = self.ops.extend(
            self.emb, self.n, self.state, cand_cap=cand_cap,
            out_cap=out_cap)
        self.levels.append(new_level)
        self.n = new_level.n
        # the memo state follows the tree; an app with a kernel state
        # update gets the column the extend compacted (the trie's branch
        # bitmap).  Only a reduce reads a memo state that follows the tree:
        # for any other app reduce_filter renews it before it is read, so
        # it is not gathered (at warm 4-CF's last level, 292 M rows)
        app = self.ops.app
        if new_level.state is not None:
            self.state = new_level.state
        elif app.get_pattern is None and app.state_histogram is None:
            pass
        elif self.state.shape[0] == 0:       # empty level-0 worklist
            self.state = torch.zeros(new_level.idx.shape, dtype=torch.int32,
                                     device=new_level.idx.device)
        else:
            self.state = self.state.index_select(0, new_level.idx)
        return n_cand, new_level.n

    def reduce_filter(self, level: int, policy):
        app = self.ops.app
        if app.get_pattern is not None or (app.needs_reduce
                                           and level == app.max_size - 1):
            self.p_map, _, self.state = self.ops.reduce(self.emb, self.n,
                                                        self.state)
        elif app.update_state_kernel is None:
            # apps without a kernel state update get a fresh memo slot per
            # level; kernel-threaded state survives between levels
            self.state = torch.zeros(self.emb.shape[:1], dtype=torch.int32,
                                     device=self.emb.device)

    def result(self, stats) -> MineResult:
        return MineResult(
            count=int(self.n),
            p_map=None if self.p_map is None else self.p_map.cpu().numpy(),
            stats=stats, levels=self.levels)

    def bounded_result(self, policy):
        """The replay's device results: (count, p_map, overflowed)."""
        p_map = (self.p_map if self.p_map is not None
                 else torch.zeros(self.ops.app.max_patterns,
                                  dtype=torch.int32, device=self.emb.device))
        return self.n, p_map, policy.overflow()


def _frequent(app: MiningApp, codes: np.ndarray,
              supports: np.ndarray) -> int:
    """How many patterns of an FSM result are frequent."""
    return int(((supports >= app.min_support) & (codes != INT_MAX)).sum())


class _EdgePipeline:
    """Edge-induced frontier: (v0, vid, his, eid), domain reduce + filter.

    The level-0 worklist defaults to the full undirected edge list of the
    graph context; explicit ``(src, dst, eid, n)`` tensors are the
    executor's padded worklist.
    """

    def __init__(self, ops: _PhaseOps, src=None, dst=None, eid=None,
                 n=None):
        self.ops = ops
        ctx = ops.ctx
        if src is None:
            src, dst = ctx.usrc, ctx.udst
            eid = torch.arange(ctx.n_uedges, dtype=torch.int32,
                               device=ctx.device)
            n = ctx.n_uedges
        self.levels = init_level0_edge(src, dst, eid, n)
        self.codes = self.supports = None
        self._front = None        # frontier cache, one materialize per level

    def level_range(self):
        # k-FSM: patterns of max_size - 1 edges; level 1 is pre-loop
        return range(2, self.ops.app.max_size)

    def pre_loop(self, policy):
        self._reduce_filter(policy)
        return 1                  # the initial reduce+filter is "level 1"

    def _frontier(self):
        if self._front is None:
            self._front = materialize_edges(self.levels)
        return self._front

    def frontier_nbytes(self) -> int:
        """Bytes of the cached per-slot frontier expansion (0 if dropped)."""
        if self._front is None:
            return 0
        return sum(a.numel() * a.element_size() for a in self._front)

    def bound(self):
        v0, vid, his, _ = self._frontier()
        return self.ops.bound_e(v0, vid, his, self.levels[-1].n)

    def inspect(self, cand_cap: int):
        return self.ops.inspect_e(*self._frontier(), self.levels[-1].n,
                                  cand_cap=cand_cap)

    def extend(self, cand_cap: int, out_cap: int):
        new_level, n_cand = self.ops.extend_e(
            *self._frontier(), self.levels[-1].n, cand_cap=cand_cap,
            out_cap=out_cap)
        self.levels.append(new_level)
        self._front = None
        return n_cand, new_level.n

    def reduce_filter(self, level: int, policy):
        self._reduce_filter(policy)

    def _reduce_filter(self, policy):
        app = self.ops.app
        codes, supports, pat, _ = self.ops.reduce_e(self.levels)
        self.codes, self.supports = codes, supports
        if app.needs_filter:
            sup_of = supports[pat.clamp(0, app.max_patterns - 1).long()]
            keep = sup_of >= app.min_support
            live = torch.arange(keep.shape[0], dtype=torch.int32,
                                device=keep.device) < self.levels[-1].n
            n_keep = (keep & live).sum(dtype=torch.int32)
            out_cap = policy.filter_cap(n_keep)
            self.levels = self.ops.filter_e(self.levels, keep,
                                            out_cap=out_cap)
            self._front = None

    def result(self, stats) -> MineResult:
        codes = self.codes.cpu().numpy()
        supports = self.supports.cpu().numpy()
        return MineResult(count=_frequent(self.ops.app, codes, supports),
                          codes=codes, supports=supports, stats=stats,
                          levels=self.levels)

    def bounded_result(self, policy):
        """The replay's device results: (codes, supports, overflowed)."""
        return self.codes, self.supports, policy.overflow()


def run_level_loop(pipe, policy, collect_stats: bool = False
                   ) -> list[LevelStats]:
    """Drive a pipeline through all levels under a capacity policy.

    With a ``HostCapPolicy`` this is the host driver and ``collect_stats``
    is honoured; with a ``PlanCapPolicy`` the loop reads nothing from the
    device, so it must be off.
    """
    stats: list[LevelStats] = []
    if policy.traceable and collect_stats:
        raise ValueError("per-level stats need the host policy")

    def record(level, n_cand, t0):
        last = pipe.levels[-1]
        if last.vid.is_cuda:
            torch.cuda.synchronize(last.vid.device)
        nbytes = total_bytes(pipe.levels)
        stats.append(LevelStats(level, n_cand, int(last.n), last.capacity,
                                nbytes, time.perf_counter() - t0,
                                nbytes + pipe.frontier_nbytes()))

    t0 = time.perf_counter()
    pre_level = pipe.pre_loop(policy)
    if collect_stats and pre_level is not None:
        record(pre_level, 0, t0)
    for level in pipe.level_range():
        t0 = time.perf_counter()
        cand_cap, out_cap = policy.extend_caps(pipe)
        n_cand, n_surv = pipe.extend(cand_cap, out_cap)
        policy.note_extend(n_cand, n_surv, cand_cap, out_cap)
        pipe.reduce_filter(level, policy)
        if collect_stats:
            record(level, int(n_cand), t0)
    return stats


class Miner:
    """Host-driver mining engine for one (graph, app, backend) triple.

    The first :meth:`run` is the host inspection pass and records a
    :class:`~repro_torch.core.plan.MiningPlan`; later runs replay it
    through one :class:`~repro_torch.core.plan.MiningExecutor`, reading
    the device once per run.  ``device=None`` runs on the CUDA device and
    raises when there is none; pass ``device="cpu"`` for the host.
    ``backend=None`` is the app's preferred backend, and else the ``cuda``
    backend.  A vertex app with ``needs_reduce`` (or a ``get_pattern``)
    returns its per-pattern counts as ``MineResult.p_map``.

    The layout options are the JAX package's: ``search="linear"`` is the
    CSR-scan ablation (no pack); ``pack_partial=True`` packs the
    highest-degree rows when the full pack does not fit
    ``pack_max_bytes``; ``relabel=True`` (or an order name) relabels the
    graph by degree before the DAG orientation, and then, unless
    ``pack_core`` says otherwise, packs the square core.  Results are
    unchanged by all of them.
    """

    def __init__(self, graph: CSRGraph, app: MiningApp,
                 search: str = "binary", fuse_filter: bool = True,
                 backend: BackendSpec = None, pack_max_bytes: int = 4 << 20,
                 pack_partial: bool = False, relabel: bool | str = False,
                 pack_core: Optional[bool] = None,
                 device: DeviceSpec = None):
        self.device = resolve_device(device)
        self.app = app
        self.backend = get_backend(backend if backend is not None
                                   else app.backend)
        graph = graph.to(self.device)
        # relabel before the DAG orientation, so the oriented CSR, the pack
        # and the level-0 worklist all live in the permuted id space
        self.relabeling: Optional[Relabeling] = None
        if relabel:
            order = "degree" if relabel is True else str(relabel)
            self.relabeling = relabel_graph(graph, order=order)
            graph = self.relabeling.graph
        self.graph_in = graph
        g = orient_dag(graph) if app.use_dag else graph
        self.graph = g
        if pack_core is None:       # the core pack pays off once relabeled
            pack_core = self.relabeling is not None
        self.ctx = make_ctx(g, search=search,
                            with_edge_uids=(app.kind == "edge"),
                            pack_max_bytes=pack_max_bytes,
                            pack_partial=pack_partial, pack_core=pack_core)
        self.fuse_filter = fuse_filter
        self.ops = _PhaseOps(self.ctx, app, self.backend,
                             fuse_filter=fuse_filter)
        self._executors: dict[int, MiningExecutor] = {}
        self._digest: Optional[str] = None
        self._edges: Optional[tuple[torch.Tensor, torch.Tensor]] = None

    def graph_digest(self) -> str:
        """Stable fingerprint of the (oriented) CSR arrays and the labels;
        the same bytes as the JAX package hashes, so both compute the same
        digest."""
        if self._digest is None:
            h = hashlib.sha1()
            h.update(self.graph.row_ptr.cpu().numpy().tobytes())
            h.update(self.graph.col_idx.cpu().numpy().tobytes())
            if self.graph.labels is not None:   # FSM survivor counts
                h.update(self.graph.labels.cpu().numpy().tobytes())
            self._digest = h.hexdigest()[:16]
        return self._digest

    def pack_hit_rate(self) -> Optional[float]:
        """Degree-weighted probability that a connectivity probe answers
        from the packed bitmap (None when no pack was built)."""
        if self.ctx.packed is None:
            return None
        return _pack_hit_rate(self.graph, self.ctx.packed)

    def executor(self, cap0: int) -> MiningExecutor:
        """The (cached) executor for level-0 capacity ``cap0``."""
        ex = self._executors.get(cap0)
        if ex is None:
            ex = MiningExecutor(self, cap0)
            self._executors[cap0] = ex
        return ex

    def init_edges(self):
        """Level-0 worklist: DAG edges (directed) or undirected src < dst.

        Built once per Miner (it reads the graph's degrees on the host), so
        a warm run reads nothing from the device before its replay.
        """
        if self._edges is None:
            if self.app.use_dag or self.app.directed_worklist:
                self._edges = self.graph.edge_list()
            else:
                self._edges = self.graph.undirected_edge_list()
        return self._edges

    def run(self, collect_stats: bool = False, plan_source: str = "inspect",
            block_size: Optional[int] = None) -> MineResult:
        """Mine the graph.  A cold run inspects every level (the paper's
        inspection-execution) and records the plan; a warm run replays it.
        ``collect_stats`` forces the host path.  Blocks and the
        ``estimate`` and ``cache`` plan sources are not ported yet and
        raise."""
        if plan_source != "inspect":
            raise NotImplementedError(
                f"plan_source={plan_source!r} is not ported yet")
        if block_size:
            raise NotImplementedError("edge blocks are not ported yet")
        if self.app.kind == "edge":
            return self._run_edge(collect_stats)
        src, dst = self.init_edges()
        m = int(src.shape[0])
        cap0 = bucket_pow2(m)
        ex = self.executor(cap0)
        if collect_stats or not ex.has_plan:
            return self._host_run(_VertexPipeline(self.ops, src, dst, m),
                                  ex, collect_stats)
        pad = cap0 - m
        src = torch.nn.functional.pad(src, (0, pad))
        dst = torch.nn.functional.pad(dst, (0, pad))
        count, p_map = ex.execute(src, dst, m)
        return MineResult(count=count,
                          p_map=p_map if self._p_map_meaningful() else None)

    def _p_map_meaningful(self) -> bool:
        return self.app.get_pattern is not None or self.app.needs_reduce

    def _host_run(self, pipe, executor: MiningExecutor,
                  collect_stats: bool) -> MineResult:
        """Inspection-execution host run; records the executor's plan."""
        policy = HostCapPolicy()
        stats = run_level_loop(pipe, policy, collect_stats)
        executor.adopt_plan(policy.caps, policy.filter_caps)
        return pipe.result(stats)

    def edge_worklist(self):
        """Level-0 worklist of the edge-induced replay: (src, dst, eid),
        every undirected edge once, padded to the power-of-two ``cap0``."""
        m = self.ctx.n_uedges
        pad = (0, bucket_pow2(m) - m)
        eid = torch.arange(m, dtype=torch.int32, device=self.device)
        return tuple(torch.nn.functional.pad(t, pad)
                     for t in (self.ctx.usrc, self.ctx.udst, eid))

    def _run_edge(self, collect_stats: bool) -> MineResult:
        """The edge-induced (FSM) path: the whole undirected edge list is
        the level-0 worklist (the paper disables blocking for FSM)."""
        m = self.ctx.n_uedges
        cap0 = bucket_pow2(m)
        ex = self.executor(cap0)
        if collect_stats or not ex.has_plan:
            return self._host_run(_EdgePipeline(self.ops), ex,
                                  collect_stats)
        codes, supports = ex.execute_edge(*self.edge_worklist(), m)
        return MineResult(count=_frequent(self.app, codes, supports),
                          codes=codes, supports=supports)

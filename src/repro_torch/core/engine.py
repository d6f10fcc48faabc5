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

A cold run may also plan without inspection: from the sampled estimator
(``plan_source="estimate"``) or from the cached plan of the nearest degree
profile (``"cache"``, plan transfer).  Vertex apps can mine the level-0
worklist in edge blocks (paper §5.2), of an explicit ``block_size`` or
sized from a device-byte budget (``block_bytes``), streamed to the device
by :class:`~repro_torch.core.blocks.BlockQueue`, with a checkpoint after
each block and ``resume_from`` to restart after the last one.  Blocks are
also the way past the 2^30 candidate slots one level may hold.

Bounded mining (:func:`bounded_mine_vertex`, :func:`bounded_mine_edge`) is
the same loop under a ``PlanCapPolicy`` with capacities given by the
caller, reading nothing from the device; :func:`mine_sharded` runs it on
every rank of a ``torch.distributed`` process group, one level-0 edge block
a rank (the paper's edge blocking as the distribution unit): counts and
pattern maps merge by a sum, and FSM keeps its support exact through the
collective domain reduce (the paper's global support sync).

The host inspection reports through :mod:`repro_torch.obs` under the JAX
package's names: an ``op.<name>`` span around each phase op, a ``level``
span and the ``mine.*`` gauges and counters per level, the ``miner.run``
and ``block`` spans, and the live-bytes gauges of
:func:`_note_live_bytes`.  Plan replays and the estimator's probe stay
uninstrumented, so tracing adds no device read to a warm run.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core.api import GraphCtx, MiningApp, make_ctx
from repro_torch.core.blocks import (BlockQueue, auto_block_size,
                                     estimate_live_bytes, make_blocks,
                                     scale_caps, stack_blocks)
from repro_torch.core.embedding_list import (EmbeddingLevel,
                                             init_level0_edge,
                                             init_level0_vertex, materialize,
                                             materialize_edges, total_bytes)
from repro_torch.core.phases import BackendSpec, get_backend
from repro_torch.core.phases.reference import INT_MAX
from repro_torch.core.plan import (HostCapPolicy, MiningExecutor, MiningPlan,
                                   PlanCache, PlanCapPolicy, bucket_pow2,
                                   clip_caps, compatible_caps,
                                   estimate_plan, transfer_caps)
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.graph.csr import CSRGraph, Relabeling, degree_profile
from repro_torch.graph.csr import pack_hit_rate as _pack_hit_rate
from repro_torch.graph.csr import relabel as relabel_graph
from repro_torch.graph.dag import orient_dag
from repro_torch.obs import metrics as _M
from repro_torch.obs import trace as _T


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
                 fuse_filter: bool = True, materialize_fn=None):
        if app.kind == "edge" and app.to_add_vertex_mask is not None:
            vmask = app.to_add_vertex_mask(ctx)
            app = dataclasses.replace(app,
                                      to_add_vertex_mask=lambda _ctx: vmask)
        self.ctx, self.app, self.backend = ctx, app, backend
        self.fuse_filter = fuse_filter
        self.materialize = materialize_fn or materialize

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

    def reduce_e(self, levels, group=None):
        """Domain reduce; with a process group, its collective variant."""
        if group is not None:
            return self.backend.reduce_domain_sharded(self.ctx, self.app,
                                                      levels, group)
        return self.backend.reduce_domain(self.ctx, self.app, levels)

    def filter_e(self, levels, keep, *, out_cap):
        return self.backend.filter_levels(levels, keep, out_cap)


def _obs_op(name: str, backend_name: str, device: torch.device, fn):
    """``fn`` in an ``op.<name>`` span (cat ``phase``) while tracing is on.

    The span measures the host time to queue the op's kernels; with
    ``--trace-sync`` (:func:`repro_torch.obs.trace.sync_enabled`) it also
    waits for the card, for exact attribution."""
    def wrapped(*args, **kwargs):
        if not _T.on:
            return fn(*args, **kwargs)
        with _T.span("op." + name, cat="phase", backend=backend_name):
            out = fn(*args, **kwargs)
            if _T.sync_enabled() and device.type == "cuda":
                torch.cuda.synchronize(device)
        return out
    return wrapped


class _TracedOps:
    """The host inspection's view of a :class:`_PhaseOps`: each phase op in an
    ``op.<name>`` span under the JAX package's op names.  Only the host
    inspection runs through it; replays and the estimator's probe use the
    bare ops."""

    _SPANS = {"inspect": "inspect_vertex", "bound": "bound_vertex",
              "extend": "extend_pruned", "reduce": "reduce_count",
              "bound_e": "bound_edge", "inspect_e": "inspect_edge",
              "extend_e": "extend_edge", "reduce_e": "reduce_domain",
              "filter_e": "filter_levels"}

    def __init__(self, ops: _PhaseOps):
        self.ctx, self.app, self.backend = ops.ctx, ops.app, ops.backend
        self.materialize = ops.materialize
        for attr, name in self._SPANS.items():
            setattr(self, attr, _obs_op(name, ops.backend.name,
                                        ops.ctx.device, getattr(ops, attr)))


class _VertexPipeline:
    """Vertex-induced frontier: emb matrix + memo state, count reduce."""

    def __init__(self, ops: _PhaseOps, src, dst, n0):
        self.ops = ops
        self.levels = init_level0_vertex(src, dst, n0)
        self.emb = ops.materialize(self.levels)
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

    def checkpoint_payload(self):
        return None if self.p_map is None else self.p_map.cpu().numpy()

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
    executor's padded worklist or one rank's block, and ``group`` (a
    process group) switches the domain reduce to its collective variant
    for exact global MNI support.
    """

    def __init__(self, ops: _PhaseOps, src=None, dst=None, eid=None,
                 n=None, group=None):
        self.ops = ops
        ctx = ops.ctx
        if src is None:
            src, dst = ctx.usrc, ctx.udst
            eid = torch.arange(ctx.n_uedges, dtype=torch.int32,
                               device=ctx.device)
            n = ctx.n_uedges
        self.levels = init_level0_edge(src, dst, eid, n)
        self.group = group
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
        codes, supports, pat, _ = self.ops.reduce_e(self.levels,
                                                    group=self.group)
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

    def checkpoint_payload(self):
        return (None if self.supports is None
                else self.supports.cpu().numpy())

    def result(self, stats) -> MineResult:
        codes = self.codes.cpu().numpy()
        supports = self.supports.cpu().numpy()
        return MineResult(count=_frequent(self.ops.app, codes, supports),
                          codes=codes, supports=supports, stats=stats,
                          levels=self.levels)

    def bounded_result(self, policy):
        """The replay's device results: (codes, supports, overflowed)."""
        return self.codes, self.supports, policy.overflow()


def run_level_loop(pipe, policy, collect_stats: bool = False,
                   checkpoint_cb: Optional[Callable] = None
                   ) -> list[LevelStats]:
    """Drive a pipeline through all levels under a capacity policy.

    With a ``HostCapPolicy`` this is the host driver, and ``collect_stats``
    and ``checkpoint_cb`` (called after each level as ``checkpoint_cb(level,
    levels, payload)``, the payload the p_map or the FSM supports) are
    honoured; with a ``PlanCapPolicy`` the loop reads nothing from the
    device, so both must be off.
    """
    stats: list[LevelStats] = []
    if policy.traceable and (collect_stats or checkpoint_cb is not None):
        raise ValueError("per-level stats and checkpoints need the host "
                         "policy")

    def record(level, n_cand, t0):
        last = pipe.levels[-1]
        if last.vid.is_cuda:
            torch.cuda.synchronize(last.vid.device)
        nbytes = total_bytes(pipe.levels)
        stats.append(LevelStats(level, n_cand, int(last.n), last.capacity,
                                nbytes, time.perf_counter() - t0,
                                nbytes + pipe.frontier_nbytes()))

    # observability is the host policy's only: a replay (or the
    # estimator's probe) must not read the device per level
    host = not policy.traceable
    t0 = time.perf_counter()
    pre_level = pipe.pre_loop(policy)
    if collect_stats and pre_level is not None:
        record(pre_level, 0, t0)
    for level in pipe.level_range():
        t0 = time.perf_counter()
        sp = (_T.span("level", level=level).__enter__()
              if (host and _T.on) else None)
        cand_cap, out_cap = policy.extend_caps(pipe)
        n_cand, n_surv = pipe.extend(cand_cap, out_cap)
        policy.note_extend(n_cand, n_surv, cand_cap, out_cap)
        pipe.reduce_filter(level, policy)
        if host:
            # cap utilisation: true counts over the planned caps
            nc, ns = int(n_cand), int(n_surv)
            _M.set_gauge("mine.cap_utilization",
                         ns / out_cap if out_cap else 0.0, level=level)
            _M.set_gauge("mine.cand_cap_utilization",
                         nc / cand_cap if cand_cap else 0.0, level=level)
            _M.inc("mine.candidates", nc, level=level)
            _M.inc("mine.survivors", ns, level=level)
            if sp is not None:
                sp.set(candidates=nc, survivors=ns, cand_cap=cand_cap,
                       out_cap=out_cap,
                       utilization=ns / out_cap if out_cap else 0.0)
                sp.end()
        if collect_stats:
            record(level, int(n_cand), t0)
        if checkpoint_cb is not None:
            checkpoint_cb(level, pipe.levels, pipe.checkpoint_payload())
    return stats


def _note_live_bytes(kind: str, plan, cap0: int, stats,
                     block: Optional[int] = None) -> None:
    """Record the run's measured peak live bytes beside the live-bytes
    model's price of its plan (:func:`~repro_torch.core.blocks.
    estimate_live_bytes`), as the gauges ``blocks.live_bytes.actual`` and
    ``.predicted``; a measured peak above the price adds to
    ``blocks.live_bytes.overrun`` and drops a ``live_bytes_overrun``
    warning event.  Needs a host run's per-level stats."""
    if plan is None or not stats:
        return
    actual = max((s.live_bytes for s in stats), default=0)
    if actual <= 0:
        return
    predicted = estimate_live_bytes(kind, plan.caps, plan.filter_caps, cap0)
    labels = {} if block is None else {"block": block}
    _M.set_gauge("blocks.live_bytes.actual", actual, **labels)
    _M.set_gauge("blocks.live_bytes.predicted", predicted, **labels)
    if actual > predicted:
        _M.inc("blocks.live_bytes.overrun")
        _T.instant("live_bytes_overrun", cat="warning", actual=actual,
                   predicted=predicted, **labels)


class Miner:
    """Host-driver mining engine for one (graph, app, backend) triple.

    The first :meth:`run` is the host inspection pass (or, with
    ``plan_source="estimate"`` or ``"cache"``, a sampled estimate or a
    transferred plan) and records a
    :class:`~repro_torch.core.plan.MiningPlan`; later runs, and every edge
    block after the first, replay it through one
    :class:`~repro_torch.core.plan.MiningExecutor` per level-0 capacity,
    reading the device once per run or block (``block_queue`` is the last
    blocked run's queue).  ``device=None`` runs on the CUDA device and
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
    unchanged by all of them.  ``materialize_fn`` replaces
    :func:`~repro_torch.core.embedding_list.materialize`, which turns the
    level-0 worklist into the vertex frontier's ``[n, k]`` matrix.
    """

    def __init__(self, graph: CSRGraph, app: MiningApp,
                 search: str = "binary", fuse_filter: bool = True,
                 backend: BackendSpec = None, pack_max_bytes: int = 4 << 20,
                 pack_partial: bool = False, relabel: bool | str = False,
                 pack_core: Optional[bool] = None, materialize_fn=None,
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
                             fuse_filter=fuse_filter,
                             materialize_fn=materialize_fn)
        self._host_ops = _TracedOps(self.ops)
        self._executors: dict[int, MiningExecutor] = {}
        self._digest: Optional[str] = None
        self._profile: Optional[tuple[tuple[float, ...], int]] = None
        self._edges: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        self._edges_host: Optional[tuple[np.ndarray, np.ndarray]] = None
        # the full-worklist estimate a byte budget was sized from:
        # (caps, filter_caps, cap0), unclipped
        self._full_plan: Optional[tuple] = None
        # the last blocked run's queue (its stage_s and mine_s)
        self.block_queue: Optional[BlockQueue] = None

    # -- identity / executors ----------------------------------------------

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

    def profile_sketch(self) -> tuple[tuple[float, ...], int]:
        """Degree-profile sketch of the (oriented) graph, the identity plan
        transfer compares."""
        if self._profile is None:
            self._profile = (degree_profile(self.graph),
                             int(self.graph.n_edges))
        return self._profile

    def pack_hit_rate(self) -> Optional[float]:
        """Degree-weighted probability that a connectivity probe answers
        from the packed bitmap (None when no pack was built)."""
        if self.ctx.packed is None:
            return None
        return _pack_hit_rate(self.graph, self.ctx.packed)

    def executor(self, cap0: int, plan_cache: Optional[PlanCache] = None
                 ) -> MiningExecutor:
        """The (cached) executor for level-0 capacity ``cap0``."""
        ex = self._executors.get(cap0)
        if ex is None:
            ex = MiningExecutor(self, cap0, cache=plan_cache)
            self._executors[cap0] = ex
        else:
            ex.attach_cache(plan_cache)
        return ex

    def plan_reports(self) -> list[dict]:
        """Public view of the executors' plans (for logging), each with
        the backend's per-app capability dict."""
        caps_report = self.backend.capabilities(self.app)
        out = []
        for cap0, ex in sorted(self._executors.items()):
            if ex.plan is not None:
                out.append({"cap0": cap0, "source": ex.plan.source,
                            "caps": list(ex.plan.caps),
                            "filter_caps": list(ex.plan.filter_caps),
                            "out_cap_total":
                                sum(o for _, o in ex.plan.caps)
                                + sum(ex.plan.filter_caps),
                            "executions": ex.n_executions,
                            "replans": ex.n_replans,
                            "capabilities": dict(caps_report)})
        return out

    def peak_live_bytes(self) -> Optional[int]:
        """Analytic peak device-resident bytes over all planned executors
        (:func:`~repro_torch.core.blocks.estimate_live_bytes`).  Blocked
        runs plan at the block's ``cap0``, so they price below the same
        workload unblocked."""
        vals = [estimate_live_bytes(self.app.kind, ex.plan.caps,
                                    ex.plan.filter_caps, ex.cap0)
                for ex in self._executors.values() if ex.plan is not None]
        return max(vals) if vals else None

    def _p_map_meaningful(self) -> bool:
        return self.app.get_pattern is not None or self.app.needs_reduce

    # -- public ------------------------------------------------------------

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

    def run(self, block_size: Optional[int] = None,
            collect_stats: bool = False,
            checkpoint_cb: Optional[Callable] = None,
            plan_cache: Optional[str | PlanCache] = None,
            plan_source: str = "inspect", safety_factor: float = 2.0,
            sample_size: int = 256, plan_seed: int = 0,
            block_bytes: Optional[int] = None,
            resume_from: Optional[dict] = None) -> MineResult:
        """Mine the graph; ``plan_source`` picks how a cold run plans.

        * ``"inspect"`` — the paper's inspection-execution: exact per-level
          host inspection, which records the plan.  The default.
        * ``"estimate"`` — the sampled estimator (``sample_size`` level-0
          embeddings from ``plan_seed``, every capacity times
          ``safety_factor``); the first run goes straight to the plan
          replay, and the overflow backstop keeps the results exact.
        * ``"cache"`` — first transfer the cached plan of the nearest
          degree profile (across graphs and backends); else estimate.

        ``block_size`` mines the vertex worklist in contiguous blocks
        through one executor; ``block_bytes`` (without ``block_size``)
        sizes them from a device-byte budget: the estimator prices the
        full-worklist plan, :func:`~repro_torch.core.blocks.auto_block_size`
        picks the largest block that fits, and the scaled plan seeds the
        block executor.  A blocked run calls ``checkpoint_cb(block, None,
        {"block", "count", "p_map"})`` after each block, and
        ``resume_from`` (such a payload) skips the blocks it covers and
        carries its totals.  FSM ignores both (paper §5.2).  An exact
        plan-cache hit always wins; ``collect_stats`` and a per-level
        ``checkpoint_cb`` force the host inspection path.  A level that
        needs more than 2^30 candidate slots raises ``OverflowError``:
        smaller blocks are the way past it.
        """
        if plan_source not in ("inspect", "estimate", "cache"):
            raise ValueError(f"plan_source {plan_source!r} not in "
                             "('inspect', 'estimate', 'cache')")
        cache = (PlanCache(plan_cache) if isinstance(plan_cache, str)
                 else plan_cache)
        seeding = (None if plan_source == "inspect" or collect_stats
                   or checkpoint_cb is not None
                   else (plan_source, safety_factor, sample_size,
                         plan_seed, cache))
        with _T.span("miner.run", app=self.app.name,
                     backend=self.backend.name, kind=self.app.kind,
                     plan_source=plan_source):
            if self.app.kind == "edge":
                return self._run_edge(collect_stats, checkpoint_cb, cache,
                                      seeding)
            src, dst = self.init_edges()
            m = int(src.shape[0])
            if block_bytes and not block_size:
                block_size = self._auto_block_size(m, block_bytes,
                                                   sample_size,
                                                   safety_factor, plan_seed)
            if not block_size or block_size >= m:
                return self._run_vertex_full(src, dst, m, collect_stats,
                                             checkpoint_cb, cache, seeding)
            return self._run_vertex_blocked(m, block_size, collect_stats,
                                            checkpoint_cb, cache, seeding,
                                            resume_from)

    def _auto_block_size(self, m: int, budget_bytes: int,
                         sample_size: int = 256,
                         safety_factor: float = 2.0,
                         plan_seed: int = 0) -> int:
        """Block size fitting ``budget_bytes``, from an estimated plan of
        the full worklist, which is kept (unclipped) so the block executor
        is seeded with its block-ratio rescale, not a second sample."""
        cap0 = bucket_pow2(m)
        caps, fcaps = estimate_plan(self, cap0, sample_size=sample_size,
                                    safety_factor=safety_factor,
                                    seed=plan_seed)
        self._full_plan = (caps, fcaps, cap0)
        return auto_block_size(m, caps, fcaps, budget_bytes,
                               kind=self.app.kind)

    def _seed_plan(self, ex: MiningExecutor, seeding) -> None:
        """Give a cold executor an estimated or transferred plan."""
        if seeding is None or ex.has_plan:
            return
        plan_source, safety_factor, sample_size, plan_seed, cache = seeding
        if plan_source == "cache" and cache is not None:
            profile, n_edges = self.profile_sketch()
            near = cache.nearest(ex.app_key, self.app.kind, profile,
                                 n_edges, exclude=(ex.signature,),
                                 transfer_key=ex.transfer_key,
                                 cap0=ex.cap0)
            # a cross-backend match may still have another cap schedule
            # (another max_size): shape-check it, else estimate
            if near is not None and compatible_caps(near, self.app):
                caps, fcaps = transfer_caps(near, ex.cap0, safety_factor)
                ex.adopt_plan(caps, fcaps, source="transfer")
                return
        caps, fcaps = estimate_plan(self, ex.cap0, sample_size=sample_size,
                                    safety_factor=safety_factor,
                                    seed=plan_seed)
        ex.adopt_plan(caps, fcaps, source="estimated")

    def _host_run(self, pipe, executor: MiningExecutor, collect_stats: bool,
                  checkpoint_cb: Optional[Callable] = None,
                  block: Optional[int] = None) -> MineResult:
        """Inspection-execution host run; records the executor's plan."""
        policy = HostCapPolicy()
        stats = run_level_loop(pipe, policy, collect_stats, checkpoint_cb)
        executor.adopt_plan(policy.caps, policy.filter_caps)
        if collect_stats:
            _note_live_bytes(self.app.kind, executor.plan, executor.cap0,
                             stats, block=block)
        return pipe.result(stats)

    # -- vertex-induced paths ----------------------------------------------

    def _run_vertex_full(self, src, dst, m, collect_stats, checkpoint_cb,
                         cache, seeding=None) -> MineResult:
        cap0 = bucket_pow2(m)
        ex = self.executor(cap0, cache)
        self._seed_plan(ex, seeding)
        if collect_stats or checkpoint_cb is not None or not ex.has_plan:
            return self._host_run(
                _VertexPipeline(self._host_ops, src, dst, m), ex,
                collect_stats, checkpoint_cb)
        pad = cap0 - m
        src = torch.nn.functional.pad(src, (0, pad))
        dst = torch.nn.functional.pad(dst, (0, pad))
        count, p_map = ex.execute(src, dst, m)
        return MineResult(count=count,
                          p_map=p_map if self._p_map_meaningful() else None)

    def worklist_host(self) -> tuple[np.ndarray, np.ndarray]:
        """The level-0 worklist (:meth:`init_edges`) as host numpy arrays,
        read from the device once per Miner: what the block queue
        stages."""
        if self._edges_host is None:
            self._edges_host = tuple(t.cpu().numpy()
                                     for t in self.init_edges())
        return self._edges_host

    def _run_vertex_blocked(self, m, block_size, collect_stats,
                            checkpoint_cb, cache, seeding=None,
                            resume_from=None) -> MineResult:
        # Edge blocking (§5.2): contiguous level-0 blocks streamed through
        # one executor, bounding peak memory; counts and pattern maps
        # accumulate.  Only the first block of a cold miner runs the host
        # inspection (which plans), unless an estimated, transferred or
        # block-ratio-rescaled plan lets it skip even that.
        cap0 = bucket_pow2(block_size)
        ex = self.executor(cap0, cache)
        if not ex.has_plan and self._full_plan is not None:
            fcaps, ffcaps, fcap0 = self._full_plan
            sc, fc = scale_caps(fcaps, ffcaps, cap0 / fcap0)
            ex.adopt_plan(sc, fc, source="estimated")
        self._seed_plan(ex, seeding)
        total = 0
        p_map = None
        done = -1                 # last completed block index
        if resume_from:
            done = int(resume_from.get("block", -1))
            total = int(resume_from.get("count", 0))
            pm = resume_from.get("p_map")
            p_map = None if pm is None else np.asarray(pm, dtype=np.int64)
        stats: list[LevelStats] = []
        blocks = [b for b in make_blocks(m, block_size) if b.index > done]
        self.block_queue = BlockQueue(self.worklist_host(), blocks, cap0,
                                      self.device)
        for blk, (s, d) in self.block_queue:
            with _T.span("block", index=blk.index, n=blk.n):
                if collect_stats or not ex.has_plan:
                    r = self._host_run(
                        _VertexPipeline(self._host_ops, s, d, blk.n), ex,
                        collect_stats, block=blk.index)
                    cnt, pm = r.count, r.p_map
                    stats.extend(r.stats)
                    del r             # the block's levels
                else:
                    cnt, pm_arr = ex.execute(s, d, blk.n)
                    pm = pm_arr if self._p_map_meaningful() else None
            del s, d
            total += cnt
            if pm is not None:
                # summed in int64: the pattern maps of many blocks may pass
                # what one block's int32 map holds
                pm = np.asarray(pm, dtype=np.int64)
                p_map = pm if p_map is None else p_map + pm
            if checkpoint_cb is not None:
                checkpoint_cb(blk.index, None,
                              {"count": total, "p_map": p_map,
                               "block": blk.index})
        return MineResult(count=total, p_map=p_map, stats=stats)

    # -- edge-induced (FSM) path -------------------------------------------

    def edge_worklist(self):
        """Level-0 worklist of the edge-induced replay: (src, dst, eid),
        every undirected edge once, padded to the power-of-two ``cap0``."""
        m = self.ctx.n_uedges
        pad = (0, bucket_pow2(m) - m)
        eid = torch.arange(m, dtype=torch.int32, device=self.device)
        return tuple(torch.nn.functional.pad(t, pad)
                     for t in (self.ctx.usrc, self.ctx.udst, eid))

    def _run_edge(self, collect_stats, checkpoint_cb, cache,
                  seeding=None) -> MineResult:
        """The edge-induced (FSM) path: the whole undirected edge list is
        the level-0 worklist (the paper disables blocking for FSM, whose
        support is global)."""
        m = self.ctx.n_uedges
        cap0 = bucket_pow2(m)
        ex = self.executor(cap0, cache)
        self._seed_plan(ex, seeding)
        if collect_stats or checkpoint_cb is not None or not ex.has_plan:
            return self._host_run(_EdgePipeline(self._host_ops), ex,
                                  collect_stats, checkpoint_cb)
        codes, supports = ex.execute_edge(*self.edge_worklist(), m)
        return MineResult(count=_frequent(self.app, codes, supports),
                          codes=codes, supports=supports)


# ---------------------------------------------------------------------------
# Bounded mining and its distribution over a process group


def bounded_mine_vertex(ctx: GraphCtx, app: MiningApp, src: torch.Tensor,
                        dst: torch.Tensor, n_valid, caps,
                        backend: BackendSpec = None):
    """A whole vertex-induced mining run at the caller's capacities.

    ``caps[i]`` is the ``(cand_cap, out_cap)`` of extension level ``i``,
    clipped to 2^30 candidate slots (:func:`~repro_torch.core.plan.
    clip_caps`).  Returns device tensors ``(count, p_map
    int32[max_patterns], overflowed int32)``, reading nothing from the
    device.  Capacities that overflow truncate the worklist and
    ``overflowed`` says so (1; 2 when a level passes 2^30 slots, which no
    capacity can cure); callers re-run with bigger caps (the bounded
    contract).  This is the one level loop under a ``PlanCapPolicy``.
    """
    be = get_backend(backend if backend is not None else app.backend)
    pipe = _VertexPipeline(_PhaseOps(ctx, app, be), src, dst, n_valid)
    caps, _ = clip_caps(caps)
    policy = PlanCapPolicy(MiningPlan(kind="vertex", caps=caps), ctx.device)
    run_level_loop(pipe, policy)
    return pipe.bounded_result(policy)


def bounded_mine_edge(ctx: GraphCtx, app: MiningApp, src: torch.Tensor,
                      dst: torch.Tensor, eid: torch.Tensor, n_valid, caps,
                      filter_caps, backend: BackendSpec = None, group=None):
    """A whole edge-induced (FSM) mining run at the caller's capacities.

    ``(src, dst, eid)`` is the level-0 undirected-edge worklist (a block of
    ``(ctx.usrc, ctx.udst, arange(n_uedges))``); ``filter_caps`` are the
    support filter's output capacities, the pre-loop one first.  Returns
    device tensors ``(codes int32[max_patterns], supports
    int32[max_patterns], overflowed int32)`` as :func:`bounded_mine_vertex`
    does.  With a process ``group`` the domain reduce is collective
    (:func:`~repro_torch.core.phases.reference.reduce_domain_sharded`), so
    every rank's support filter sees the global MNI supports.
    """
    be = get_backend(backend if backend is not None else app.backend)
    pipe = _EdgePipeline(_PhaseOps(ctx, app, be), src=src, dst=dst, eid=eid,
                         n=n_valid, group=group)
    caps, filter_caps = clip_caps(caps, filter_caps)
    policy = PlanCapPolicy(MiningPlan(kind="edge", caps=caps,
                                      filter_caps=filter_caps), ctx.device)
    run_level_loop(pipe, policy)
    return pipe.bounded_result(policy)


def mine_sharded(graph: CSRGraph, app: MiningApp, caps, group=None,
                 backend: BackendSpec = None, filter_caps=None,
                 relabel: bool | str = False, device: DeviceSpec = None):
    """Distributed mining: one level-0 edge block per rank of ``group``.

    SPMD: every rank of the ``torch.distributed`` group calls this with the
    same arguments and its own ``device``.  Every rank builds the same
    :class:`Miner` (the graph is replicated); rank ``r`` mines block ``r``
    of ``make_blocks(m, ceil(m / world), count=world)``, zero-padded to
    ``bucket_pow2(per_rank)`` (:func:`~repro_torch.core.blocks.
    stack_blocks`), with :func:`bounded_mine_vertex` or, for FSM (which
    needs ``filter_caps``), :func:`bounded_mine_edge` and its collective
    domain reduce.  Counts and pattern maps merge by ``all_reduce(SUM)``
    (in int64), the overflow flags by ``all_reduce(MAX)``
    (:mod:`repro_torch.core.collectives`).  ``group=None`` mines the whole
    worklist as one rank.

    Returns the global values on every rank: ``(count, p_map int64,
    overflowed)`` for vertex apps, ``(count, codes, supports, overflowed)``
    for FSM.  There is no grow-and-retry: on ``overflowed`` the caller runs
    again with bigger caps.  A level past 2^30 candidate slots raises
    ``OverflowError`` on every rank (smaller blocks, so more ranks, are the
    way past it).  The ``shard.mine`` and ``shard.merge`` spans time the
    two halves (with ``--trace-sync``, each ends after the card is idle).
    """
    if app.kind == "edge" and filter_caps is None:
        raise ValueError("sharded FSM needs filter_caps (support-filter "
                         "output capacities per level)")
    rank, world = C.world(group)
    miner = Miner(graph, app, backend=backend, relabel=relabel,
                  device=device)
    ctx, dev = miner.ctx, miner.device
    if app.kind == "edge":
        m = ctx.n_uedges
        arrays = (ctx.usrc.cpu().numpy(), ctx.udst.cpu().numpy(),
                  np.arange(m, dtype=np.int32))
    else:
        arrays = miner.worklist_host()
        m = int(arrays[0].shape[0])
    per_rank = -(-m // world)
    blk = make_blocks(m, per_rank, count=world)[rank]
    cols = [t[0] for t in stack_blocks(arrays, [blk], bucket_pow2(per_rank),
                                       dev)]

    def synced(sp):
        if _T.sync_enabled() and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sp.set(rank=rank, world=world, n=blk.n)

    if app.kind == "edge":
        with _T.span("shard.mine", cat="shard") as sp:
            codes, supports, ovf = bounded_mine_edge(
                ctx, app, *cols, blk.n, caps, filter_caps,
                backend=miner.backend, group=group)
            synced(sp)
        with _T.span("shard.merge", cat="shard") as sp:
            ovf = C.all_reduce(ovf.reshape(1).to(torch.int32), "max", group)
            synced(sp)
        flat = torch.cat([codes.long(), supports.long(), ovf.long()]).tolist()
        _raise_past_limit(flat[-1])
        n_pat = app.max_patterns
        codes = np.asarray(flat[:n_pat], dtype=np.int32)
        supports = np.asarray(flat[n_pat:2 * n_pat], dtype=np.int32)
        return (_frequent(app, codes, supports), codes, supports,
                bool(flat[-1]))
    with _T.span("shard.mine", cat="shard") as sp:
        count, p_map, ovf = bounded_mine_vertex(ctx, app, *cols[:2], blk.n,
                                                caps, backend=miner.backend)
        synced(sp)
    with _T.span("shard.merge", cat="shard") as sp:
        total = C.all_reduce(torch.cat([count.reshape(1).long(),
                                        p_map.long()]), "sum", group)
        ovf = C.all_reduce(ovf.reshape(1).to(torch.int32), "max", group)
        synced(sp)
    flat = torch.cat([total, ovf.long()]).tolist()
    _raise_past_limit(flat[-1])
    return flat[0], np.asarray(flat[1:-1], dtype=np.int64), bool(flat[-1])


def _raise_past_limit(overflowed: int) -> None:
    if overflowed == 2:
        raise OverflowError("a level of a sharded run needs more than 2^30 "
                            "int32 candidate slots on one rank: mine on more "
                            "ranks (smaller blocks)")

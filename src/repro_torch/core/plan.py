"""Plan-once / execute-many, matching half (counterpart of
``repro.core.plan``).

* :class:`MiningPlan` — the per-level ``(cand_cap, out_cap)`` schedule (and
  for FSM the per-level filter capacities) and the identity it was planned
  for, read and written as JSON in the JAX
  package's schema, so a plan recorded by either package replays in the
  other (see :mod:`repro_torch.interop`).
* :class:`HostCapPolicy` — the paper's inspection-execution: per level,
  read the exact candidate and survivor counts from the device and record
  the capacities.  A cold run is the planning pass.
* :class:`PlanCapPolicy` — replay a plan with static capacities and no host
  read: the overflow flag stays a device tensor.
* :class:`MiningExecutor` — run the replay, read the count and the overflow
  flag from the device once at the end, and on overflow grow the plan and
  retry.
* :class:`PlanCache` — a directory of plans, one JSON file a signature, read
  and written in the JAX package's schema; :meth:`PlanCache.nearest` finds
  the plan of the same app recorded on the graph of the nearest degree
  profile, and :func:`transfer_caps` rescales it to a new worklist (plan
  transfer, across graphs, backends and the two packages).
* :func:`estimate_plan` — the sampled estimator: mine a sample of the
  level-0 worklist at fixed probe capacities through the miner's own
  backend and scale the true counts it reports.

PyTorch runs eagerly, so there is no compiled program per plan (and no
count of compiles).  The JAX package's trace and metric names are kept
all the same (:mod:`repro_torch.obs`): a ``plan.<event>`` instant and
counter for each plan adopted, taken from a cache or grown; the
``plan.estimate`` span; and an ``executor.compile`` span (cat
``executor``) for an executor's first run of a capacity schedule, where
the JAX package compiles, then ``executor.replay`` spans, with the
``executor.compiles`` / ``executor.replays`` counters and the seconds in
``executor.compile_s`` / ``executor.replay_s``.  Here the first run of a
schedule only runs, so the two differ by nothing but their place.

One deliberate difference from the JAX package: candidate slots are int32
here, so an executor clips every capacity it adopts to 2^30
(:data:`~repro_torch.core.phases.reference.MAX_CAND_CAP`,
:func:`clip_caps`), and a level whose true count passes 2^30 raises
``OverflowError`` instead of growing past it.  Plans that are only priced
(the full-worklist estimate a byte budget is sized from, the scaled plans of
:mod:`repro_torch.core.blocks`) are not clipped.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.phases.reference import MAX_CAND_CAP
from repro_torch.obs import metrics as _M
from repro_torch.obs import trace as _T


def bucket_pow2(n: int, minimum: int = 128) -> int:
    """Round up to the next power of two."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def bucket_cap(n: int, quantum: int = 128, minimum: int = 128) -> int:
    """Survivor-scale capacity: round up to a multiple of ``quantum``."""
    n = max(int(n), minimum)
    return -(-n // quantum) * quantum


PLAN_SCHEMA = 4


class StalePlanError(ValueError):
    """A serialised plan from an incompatible schema."""


@dataclasses.dataclass(frozen=True)
class MiningPlan:
    """Static capacity schedule for one mining run.

    ``caps[i]`` is the ``(cand_cap, out_cap)`` pair of extension level
    ``i`` (paper level ``i + 2``).  The fields and their JSON are those of
    the JAX package's schema 4.
    """

    kind: str
    caps: tuple[tuple[int, int], ...]
    filter_caps: tuple[int, ...] = ()
    cap0: int = 0
    signature: str = ""
    source: str = "manual"
    app_key: str = ""
    profile: tuple[float, ...] = ()
    n_edges: int = 0
    transfer_key: str = ""

    def grown(self, factor: int = 2) -> "MiningPlan":
        """Overflow response: scale every capacity."""
        return dataclasses.replace(
            self,
            caps=tuple((c * factor, o * factor) for c, o in self.caps),
            filter_caps=tuple(f * factor for f in self.filter_caps),
            source="grown")

    def to_json(self) -> str:
        return json.dumps({
            "schema": PLAN_SCHEMA, "kind": self.kind, "cap0": self.cap0,
            "caps": [list(c) for c in self.caps],
            "filter_caps": list(self.filter_caps),
            "signature": self.signature, "source": self.source,
            "app_key": self.app_key, "profile": list(self.profile),
            "n_edges": self.n_edges, "transfer_key": self.transfer_key})

    @classmethod
    def from_json(cls, text: str) -> "MiningPlan":
        d = json.loads(text)
        schema = d.get("schema")
        if schema != PLAN_SCHEMA:
            raise StalePlanError(
                f"plan schema {schema!r} != current {PLAN_SCHEMA}")
        return cls(kind=d["kind"], cap0=int(d["cap0"]),
                   caps=tuple((int(c), int(o)) for c, o in d["caps"]),
                   filter_caps=tuple(int(f) for f in d["filter_caps"]),
                   signature=d.get("signature", ""),
                   source=d.get("source", "cache"),
                   app_key=d.get("app_key", ""),
                   profile=tuple(float(x) for x in d.get("profile", ())),
                   n_edges=int(d.get("n_edges", 0)),
                   transfer_key=d.get("transfer_key", ""))


def plan_app_key(app, backend_name: str, fuse_filter: bool = True,
                 compaction: str = "xla-scan") -> str:
    """App and backend identity without the graph (the JAX hash over the
    same fields, so equal inputs give equal keys in both packages)."""
    fields = (app.name, app.kind, app.max_size, app.use_dag,
              app.needs_reduce, app.needs_filter, app.support_mode,
              app.max_patterns, app.min_support, app.plan_key,
              app.directed_worklist, backend_name, bool(fuse_filter),
              str(compaction))
    return hashlib.sha1(repr(fields).encode()).hexdigest()[:20]


def plan_transfer_key(app, fuse_filter: bool = True) -> str:
    """App identity without backend or compaction: capacities are counts
    every backend produces bit for bit, so plans whose transfer keys match
    are capacity-comparable across backends, and across the two packages."""
    fields = (app.name, app.kind, app.max_size, app.use_dag,
              app.needs_reduce, app.needs_filter, app.support_mode,
              app.max_patterns, app.min_support, app.plan_key,
              app.directed_worklist, bool(fuse_filter))
    return hashlib.sha1(repr(fields).encode()).hexdigest()[:20]


def plan_signature(graph_digest: str, app, backend_name: str, cap0: int,
                   fuse_filter: bool = True,
                   compaction: str = "xla-scan") -> str:
    """Stable identity of (graph, app knobs, backend, block capacity)."""
    fields = (graph_digest,
              plan_app_key(app, backend_name, fuse_filter, compaction),
              int(cap0))
    return hashlib.sha1(repr(fields).encode()).hexdigest()[:20]


def compatible_caps(plan: MiningPlan, app) -> bool:
    """Can ``plan``'s capacity schedule drive a run of ``app``?  The same
    embedding kind, one ``(cand_cap, out_cap)`` pair per extension level,
    and for support-filtered FSM one filter capacity per compaction (the
    pre-loop one and one per level)."""
    if plan.kind != app.kind or not plan.caps:
        return False
    n_levels = max(app.max_size - 2, 0)
    if len(plan.caps) != n_levels:
        return False
    if app.kind == "edge" and app.needs_filter:
        return len(plan.filter_caps) == n_levels + 1
    return True


def clip_caps(caps: tuple[tuple[int, int], ...],
              filter_caps: tuple[int, ...] = ()
              ) -> tuple[tuple[tuple[int, int], ...], tuple[int, ...]]:
    """Capacities an executor can run: each ``cand_cap`` (and filter
    capacity) at most 2^30 int32 candidate slots, each ``out_cap`` at most
    its level's clipped ``cand_cap``.  The JAX package has no ceiling; on
    plans below 2^30 this is the identity."""
    clipped = []
    for c, o in caps:
        c = min(int(c), MAX_CAND_CAP)
        clipped.append((c, min(int(o), c)))
    return (tuple(clipped),
            tuple(min(int(f), MAX_CAND_CAP) for f in filter_caps))


class PlanCache:
    """Directory of ``<signature>.json`` plans (atomic writes), in the JAX
    package's layout and schema, so either package reads the other's.

    Stale-schema or corrupt entries are ignored on load and deleted by an
    exact :meth:`get`.  ``max_entries`` caps the directory with LRU-by-mtime
    eviction: reads touch a file's mtime, writes evict the oldest entries
    past the cap.
    """

    def __init__(self, directory: str, max_entries: Optional[int] = None):
        self.directory = directory
        self.max_entries = max_entries

    def _path(self, signature: str) -> str:
        return os.path.join(self.directory, f"{signature}.json")

    def get(self, signature: str) -> Optional[MiningPlan]:
        path = self._path(signature)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                plan = MiningPlan.from_json(f.read())
        except (StalePlanError, ValueError, KeyError):
            try:
                os.remove(path)              # stale schema / corrupt entry
            except OSError:
                pass
            return None
        if plan.signature != signature:
            # a renamed, copied or edited entry whose recorded signature
            # disagrees with its file name: its capacities were planned for
            # another (graph, app, backend, cap0), for FSM another
            # min_support, so it is dropped
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        try:
            os.utime(path)                   # LRU touch
        except OSError:
            pass
        return dataclasses.replace(plan, source="cache")

    def nearest(self, app_key: str, kind: str, profile: tuple[float, ...],
                n_edges: int, exclude: tuple[str, ...] = (),
                transfer_key: Optional[str] = None,
                cap0: Optional[int] = None) -> Optional[MiningPlan]:
        """The cached plan of this app with the nearest degree profile.

        Candidates match on ``app_key`` (same backend) or, with
        ``transfer_key``, on the backend-free transfer key; same-backend
        plans win ties (:data:`CROSS_BACKEND_PENALTY`).  With ``cap0`` the
        worklist-size ratio weighs in (:data:`CAP0_WEIGHT`), since rescaling
        a tiny graph's plan 1000x amplifies its noise 1000x.  Stale or
        corrupt entries are skipped, not deleted.
        """
        try:
            names = [n for n in os.listdir(self.directory)
                     if n.endswith(".json")]
        except OSError:
            return None
        best, best_d = None, None
        for name in sorted(names):
            try:
                with open(os.path.join(self.directory, name)) as f:
                    plan = MiningPlan.from_json(f.read())
            except (OSError, StalePlanError, ValueError, KeyError):
                continue
            same_backend = plan.app_key == app_key
            transferable = (transfer_key is not None and plan.transfer_key
                            and plan.transfer_key == transfer_key)
            if (not (same_backend or transferable) or plan.kind != kind
                    or plan.signature in exclude or not plan.caps):
                continue
            d = profile_distance(profile, n_edges, plan.profile,
                                 plan.n_edges)
            if d is None:
                continue
            if cap0 is not None and plan.cap0:
                d += CAP0_WEIGHT * float(
                    np.log(int(cap0) / plan.cap0) ** 2)
            if not same_backend:
                d += CROSS_BACKEND_PENALTY
            if best_d is None or d < best_d:
                best, best_d = plan, d
        return best

    def put(self, plan: MiningPlan) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(plan.signature)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            f.write(plan.to_json())
        os.replace(tmp, path)
        self._evict()
        return path

    def _evict(self) -> None:
        if self.max_entries is None:
            return
        try:
            names = [n for n in os.listdir(self.directory)
                     if n.endswith(".json")]
        except OSError:
            return
        if len(names) <= self.max_entries:
            return

        def mtime(name):
            try:
                return os.path.getmtime(os.path.join(self.directory, name))
            except OSError:
                return 0.0
        for name in sorted(names, key=mtime)[: len(names)
                                             - self.max_entries]:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass


# nearest()'s distance weights: the cap0-ratio term dominates once the
# worklist sizes are more than about a decade apart (log^2 10 ~ 5.3 against
# the O(0.1) profile terms of similar graphs); the cross-backend penalty is
# only a tiebreak (capacities transfer exactly across backends)
CAP0_WEIGHT = 1.0
CROSS_BACKEND_PENALTY = 1e-6


def profile_distance(profile_a: tuple[float, ...], m_a: int,
                     profile_b: tuple[float, ...], m_b: int
                     ) -> Optional[float]:
    """Distance between two degree-profile sketches: the mean squared
    difference of their quantiles in ``log1p`` space plus a squared log
    edge-count ratio; None when the sketches are not comparable."""
    if not profile_a or len(profile_a) != len(profile_b):
        return None
    a = np.log1p(np.asarray(profile_a, np.float64))
    b = np.log1p(np.asarray(profile_b, np.float64))
    size_term = np.log((m_a + 1.0) / (m_b + 1.0)) ** 2
    return float(np.mean((a - b) ** 2) + size_term)


def transfer_caps(plan: MiningPlan, cap0: int, safety_factor: float = 2.0
                  ) -> tuple[tuple[tuple[int, int], ...],
                             tuple[int, ...]]:
    """Rescale a transferred plan to a new worklist: every capacity times
    ``cap0 / plan.cap0`` times the safety factor, re-bucketed.  A seed, not
    a guarantee: overflow grows it."""
    ratio = (int(cap0) / max(plan.cap0, 1)) * float(safety_factor)
    caps = tuple((bucket_pow2(int(np.ceil(c * ratio))),
                  bucket_cap(int(np.ceil(o * ratio))))
                 for c, o in plan.caps)
    filter_caps = tuple(bucket_cap(int(np.ceil(f * ratio)))
                        for f in plan.filter_caps)
    return caps, filter_caps


# ---------------------------------------------------------------------------
# Capacity policies


class HostCapPolicy:
    """Inspection-execution with a host read per level; records the plan.

    ``extend_caps`` reads the degree-sum bound, then the exact inspection
    counts.  Candidate capacities bucket to powers of two, output
    capacities to tight survivor-scale multiples.
    """

    traceable = False

    def __init__(self):
        self.caps: list[tuple[int, int]] = []
        self.filter_caps: list[int] = []

    def extend_caps(self, pipe):
        bound = int(pipe.bound())
        if bound > MAX_CAND_CAP:
            raise OverflowError(
                f"{bound} candidates at one level, more than 2^30 int32 "
                "candidate slots: mine in edge blocks (Miner.run's "
                "block_size or block_bytes)")
        cand_cap = bucket_pow2(bound)
        _, n_next = pipe.inspect(cand_cap)
        out_cap = bucket_cap(int(n_next))
        self.caps.append((cand_cap, out_cap))
        return cand_cap, out_cap

    def note_extend(self, n_cand, n_surv, cand_cap: int,
                    out_cap: int) -> None:
        # inspection and extension must agree; with tight caps a
        # disagreement would truncate results, so fail loudly
        if int(n_surv) > out_cap or int(n_cand) > cand_cap:
            raise RuntimeError(
                f"extend produced {int(n_surv)} survivors / {int(n_cand)} "
                f"candidates for planned caps ({cand_cap}, {out_cap}): "
                "inspection and extension disagree")

    def filter_cap(self, n_keep) -> int:
        cap = bucket_cap(int(n_keep))
        self.filter_caps.append(cap)
        return cap

    def overflow(self):
        return False


class PlanCapPolicy:
    """Replay a :class:`MiningPlan` with no host read.

    Capacities that overflow truncate the worklist; the overflow flag is a
    device tensor folded from each level's true counts, read once by the
    caller: 0 when every level fit, 1 on an overflow that a grown plan can
    cure, 2 when a level's true candidate count passes the 2^30 slots a
    plan may hold (no plan can: only smaller blocks).
    """

    traceable = True

    def __init__(self, plan: MiningPlan, device: torch.device):
        self.plan = plan
        self._li = 0
        self._fi = 0
        self._ovf = torch.zeros((), dtype=torch.bool, device=device)
        self._past_limit = torch.zeros((), dtype=torch.bool, device=device)

    def extend_caps(self, pipe):
        cand_cap, out_cap = self.plan.caps[self._li]
        self._li += 1
        return cand_cap, out_cap

    def note_extend(self, n_cand, n_surv, cand_cap: int,
                    out_cap: int) -> None:
        self._ovf = self._ovf | (n_cand > cand_cap) | (n_surv > out_cap)
        self._past_limit = self._past_limit | (n_cand > MAX_CAND_CAP)

    def filter_cap(self, n_keep) -> int:
        cap = self.plan.filter_caps[self._fi]
        self._fi += 1
        self._ovf = self._ovf | (n_keep > cap)
        return cap

    def overflow(self):
        return self._ovf.to(torch.int32) + self._past_limit.to(torch.int32)


# ---------------------------------------------------------------------------
# Sampled capacity estimation
#
# The estimator mines a small sample of the level-0 worklist at fixed
# sample-scale capacities, through the same pipeline adapters, app hooks and
# backend as the real run, and scales the true per-level candidate,
# survivor and keep counts it reports by the sampling fraction (correcting
# for any probe-capacity truncation, which the true counts make
# observable) times a safety factor.  The semantics are exact by
# construction; only the scale is statistical, and the executor's
# grow-and-retry backstop turns an under-estimate into a replan, never a
# wrong answer.

# Fixed probe capacities.  Overflowing them only truncates the sample; the
# reported true counts let the host correct the scale.
SAMPLE_CAND_CAP = 1 << 15
SAMPLE_OUT_CAP = 4096


class _ProbePolicy(PlanCapPolicy):
    """Replay fixed probe capacities; collect the true counts (device
    tensors, read once after the last level)."""

    def __init__(self, plan: MiningPlan, device: torch.device):
        super().__init__(plan, device)
        self.n_cand: list = []
        self.n_surv: list = []
        self.n_keep: list = []

    def note_extend(self, n_cand, n_surv, cand_cap: int,
                    out_cap: int) -> None:
        self.n_cand.append(n_cand)
        self.n_surv.append(n_surv)
        super().note_extend(n_cand, n_surv, cand_cap, out_cap)

    def filter_cap(self, n_keep) -> int:
        self.n_keep.append(n_keep)
        return super().filter_cap(n_keep)


def _minimal_plan(app) -> tuple[tuple[tuple[int, int], ...],
                                tuple[int, ...]]:
    """Floor-capacity plan for degenerate inputs (empty worklist)."""
    n_levels = max(app.max_size - 2, 0)
    caps = ((bucket_pow2(0), bucket_cap(0)),) * n_levels
    filter_caps = ((bucket_cap(0),) * (n_levels + 1)
                   if app.kind == "edge" and app.needs_filter else ())
    return caps, filter_caps


def estimate_plan(miner, cap0: int, sample_size: int = 256,
                  safety_factor: float = 2.0, seed: int = 0
                  ) -> tuple[tuple[tuple[int, int], ...],
                             tuple[int, ...]]:
    """Estimate a capacity plan from a sampled worklist (no inspection).

    Draws ``sample_size`` level-0 embeddings with
    ``numpy.random.default_rng(seed)`` (the JAX package's sample: shuffled
    for vertex apps, stratified over degree bands after relabeling, sorted
    for FSM), probes them through the miner's own backend on its device at
    the fixed capacities ``SAMPLE_CAND_CAP`` / ``SAMPLE_OUT_CAP``, reads
    the true per-level counts from the device once, and returns ``(caps,
    filter_caps)``: those counts scaled by the sampling fraction times
    ``safety_factor``, bucketed like the exact planner's.  Every backend
    reports the same counts (the parity contract), so the caps are the JAX
    package's, which probes on its reference backend.

    FSM's support filter runs on the sample with ``min_support`` rescaled
    by the sampling fraction.  The result is not clipped to 2^30 (an
    executor clips what it adopts).  Exactness is not this function's
    contract: the executor's overflow backstop is.  It runs in a
    ``plan.estimate`` span.
    """
    with _T.span("plan.estimate", cat="plan", sample_size=sample_size):
        return _estimate_plan(miner, cap0, sample_size, safety_factor, seed)


def _estimate_plan(miner, cap0, sample_size, safety_factor, seed
                   ) -> tuple[tuple[tuple[int, int], ...], tuple[int, ...]]:
    from repro_torch.core import engine as E
    from repro_torch.graph.sampler import (sample_worklist,
                                           sample_worklist_stratified)

    app, ctx, dev = miner.app, miner.ctx, miner.device
    rng = np.random.default_rng(seed)
    if app.kind == "edge":
        m = int(ctx.n_uedges)
    else:
        src, dst = miner.init_edges()
        m = int(src.shape[0])
    if m == 0 or app.max_size <= 2:
        return _minimal_plan(app)

    # a sorted sample keeps every edge-uid comparison of FSM's canonical
    # growth test; a relabeled vertex miner samples degree strata, so the
    # hub head cannot be missed
    if app.kind != "edge" and miner.relabeling is not None:
        idx = sample_worklist_stratified(m, sample_size, rng)
    else:
        idx = sample_worklist(m, sample_size, rng,
                              sort=(app.kind == "edge"))
    n_sample = len(idx)
    samp_app = app
    if app.kind == "edge" and app.needs_filter and n_sample < m:
        samp_app = dataclasses.replace(
            app, min_support=max(1, int(round(app.min_support
                                              * n_sample / m))))
    n_levels = app.max_size - 2
    needs_filter = app.kind == "edge" and app.needs_filter
    probe_plan = MiningPlan(
        kind=app.kind,
        caps=((SAMPLE_CAND_CAP, SAMPLE_OUT_CAP),) * n_levels,
        filter_caps=((SAMPLE_OUT_CAP,) * (n_levels + 1)
                     if needs_filter else ()))
    ops = E._PhaseOps(ctx, samp_app, miner.backend,
                      fuse_filter=miner.fuse_filter,
                      materialize_fn=miner.ops.materialize)
    sel = torch.from_numpy(idx).to(dev)
    n = torch.tensor(n_sample, dtype=torch.int32, device=dev)
    if app.kind == "edge":
        pipe = E._EdgePipeline(ops, src=ctx.usrc[sel], dst=ctx.udst[sel],
                               eid=sel.to(torch.int32), n=n)
    else:
        pipe = E._VertexPipeline(ops, src[sel], dst[sel], n)
    policy = _ProbePolicy(probe_plan, dev)
    E.run_level_loop(pipe, policy)
    counts = [t.to(torch.int64).reshape(1) for t in
              (*policy.n_cand, *policy.n_surv, *policy.n_keep)]
    flat = torch.cat(counts).tolist()              # the one device read
    n_cand = flat[:n_levels]
    n_surv = flat[n_levels:2 * n_levels]
    n_keep = flat[2 * n_levels:]
    del pipe, policy, counts

    # Host-side scale arithmetic.  scale = (estimated true frontier) /
    # (sample frontier); probe truncation shrinks the sample frontier but
    # the true counts are reported before truncation, so every truncation
    # folds into the scale instead of biasing the estimate downward.
    caps: list[tuple[int, int]] = []
    fcaps: list[int] = []
    scale = min(m, int(cap0)) / n_sample

    def est(x: float) -> int:
        return int(np.ceil(x * scale * safety_factor))

    ki = 0
    if needs_filter:                    # pre-loop filter ("level 1")
        k = n_keep[ki]
        ki += 1
        fcaps.append(bucket_cap(est(k)))
        kept = min(k, SAMPLE_OUT_CAP)
        scale = (k * scale) / kept if kept else scale
    for li in range(n_levels):
        c, s = n_cand[li], n_surv[li]
        c_seen = min(c, SAMPLE_CAND_CAP)
        # survivors were counted among the first c_seen candidates only
        s_corr = s * (c / c_seen) if c_seen else 0.0
        caps.append((bucket_pow2(est(c)), bucket_cap(est(s_corr))))
        kept = min(s, SAMPLE_OUT_CAP)
        scale = (s_corr * scale) / kept if kept else scale
        if needs_filter:
            k = n_keep[ki]
            ki += 1
            if c > SAMPLE_CAND_CAP or s > SAMPLE_OUT_CAP:
                # The probe truncated this level, so its support filter saw
                # a prefix of the sample's frontier (for FSM's sorted
                # sample, the extensions of its first few edges), whose
                # supports fall short of the rescaled threshold: the keep
                # count, down to 0, says nothing of the full run, and a
                # 128-slot floor against millions is past what the
                # backstop's doublings recover.  The filter is planned at
                # what it can keep at most, the level's survivors, and the
                # scale is left as is.  The JAX package trusts the count;
                # this is the port's second deliberate difference from it.
                fcaps.append(caps[-1][1])
                continue
            fcaps.append(bucket_cap(est(k)))
            kkept = min(k, SAMPLE_OUT_CAP)
            scale = (k * scale) / kkept if kkept else scale
    return tuple(caps), tuple(fcaps)


# ---------------------------------------------------------------------------
# The executor


def _clipped(plan: Optional[MiningPlan]) -> Optional[MiningPlan]:
    """``plan`` with its capacities clipped (:func:`clip_caps`): a plan
    from a cache may come from the JAX package, which has no ceiling."""
    if plan is None:
        return None
    caps, filter_caps = clip_caps(plan.caps, plan.filter_caps)
    return dataclasses.replace(plan, caps=caps, filter_caps=filter_caps)


_PAST_LIMIT = ("mining plan {}: a level needs more than 2^30 int32 "
               "candidate slots; mine in smaller edge blocks (Miner.run's "
               "block_size or block_bytes)")


class MiningExecutor:
    """One plan for one (graph, app, backend, cap0) signature, replayed
    across blocks and runs.  ``execute`` reads the device once per attempt
    (the count and the overflow flag together) and retries with a grown
    plan on overflow.  With a :class:`PlanCache` the executor starts from
    the cached plan of its signature and writes every plan it adopts or
    grows back."""

    def __init__(self, miner, cap0: int, plan: Optional[MiningPlan] = None,
                 cache: Optional[PlanCache] = None, max_retries: int = 6):
        self.miner = miner
        self.cap0 = int(cap0)
        self.cache = cache
        self.max_retries = max_retries
        self.kind = miner.app.kind
        compaction = miner.backend.compaction
        self.signature = plan_signature(miner.graph_digest(), miner.app,
                                        miner.backend.name, self.cap0,
                                        miner.fuse_filter, compaction)
        self.app_key = plan_app_key(miner.app, miner.backend.name,
                                    miner.fuse_filter, compaction)
        self.transfer_key = plan_transfer_key(miner.app, miner.fuse_filter)
        from_cache = plan is None and cache is not None
        if from_cache:
            plan = cache.get(self.signature)
        self._plan = _clipped(plan)
        if from_cache and plan is not None:
            self._note_plan_event("cache_hit")
        self._run_keys: set = set()       # capacity schedules run so far
        self.n_executions = 0
        self.n_replans = 0

    @property
    def plan(self) -> Optional[MiningPlan]:
        return self._plan

    @property
    def has_plan(self) -> bool:
        return self._plan is not None

    def _note_plan_event(self, event: str, **extra) -> None:
        """Plan provenance: a ``plan.<event>`` counter and trace instant."""
        _M.inc("plan." + event, kind=self.kind)
        if _T.on:
            args = {"signature": self.signature, "cap0": self.cap0}
            if self._plan is not None:
                args["caps"] = str(self._plan.caps)
                args["source"] = self._plan.source
            args.update(extra)
            _T.instant("plan." + event, cat="plan", **args)

    def attach_cache(self, cache: Optional[PlanCache]) -> None:
        """Use ``cache`` from now on: take its plan of this signature when
        the executor has none, else write the executor's plan to it."""
        if cache is None or (self.cache is not None
                             and self.cache.directory == cache.directory):
            return                    # same cache: plan already persisted
        self.cache = cache
        if self._plan is None:
            self._plan = _clipped(cache.get(self.signature))
            if self._plan is not None:
                self._note_plan_event("cache_hit")
        elif self._plan.signature == self.signature:
            cache.put(self._plan)

    def adopt_plan(self, caps, filter_caps=(), source: str = "inspect"
                   ) -> None:
        """Install a plan (an inspection pass's, a sampled estimate, a
        transfer or a block-scaled seed: ``source`` says which) with the
        graph's degree profile; a plan already in place wins.  The
        capacities are clipped to 2^30 slots (:func:`clip_caps`), as a
        plan taken from a cache is: priced plans stay unclipped."""
        if self._plan is not None:
            return
        caps, filter_caps = clip_caps(caps, filter_caps)
        profile, n_edges = self.miner.profile_sketch()
        self._plan = MiningPlan(kind=self.kind, caps=caps,
                                filter_caps=filter_caps,
                                cap0=self.cap0, signature=self.signature,
                                source=source, app_key=self.app_key,
                                profile=profile, n_edges=n_edges,
                                transfer_key=self.transfer_key)
        self._note_plan_event(source)
        if self.cache is not None:
            self.cache.put(self._plan)

    def _grow(self) -> None:
        """Double every capacity, clipped to 2^30 slots; raise when the
        plan cannot grow (every capacity already at the ceiling)."""
        grown = self._plan.grown()
        caps, filter_caps = clip_caps(grown.caps, grown.filter_caps)
        if (caps, filter_caps) == (self._plan.caps, self._plan.filter_caps):
            raise OverflowError(_PAST_LIMIT.format(self.signature))
        self.n_replans += 1
        self._plan = dataclasses.replace(grown, caps=caps,
                                         filter_caps=filter_caps)
        self._note_plan_event("grown", replans=self.n_replans)
        if self.cache is not None:
            self.cache.put(self._plan)

    def _run_once(self, *args):
        """One replay with no host read: the pipeline's result tensors, the
        overflow flag last, all on the device."""
        from repro_torch.core import engine as E
        m = self.miner
        pipe_cls = (E._VertexPipeline if self.kind == "vertex"
                    else E._EdgePipeline)
        pipe = pipe_cls(m.ops, *args)
        policy = PlanCapPolicy(self._plan, m.device)
        E.run_level_loop(pipe, policy)
        return pipe.bounded_result(policy)

    def _run_with_retry(self, *args) -> list[int]:
        """Replay the plan, growing it on overflow.  Each attempt reads the
        device once, after the last level: the results and the overflow
        flag, flattened into one int64 vector, in one transfer (which also
        makes the attempt's ``executor.*`` span cover the card's work)."""
        for attempt in range(self.max_retries + 1):
            key = (self._plan.caps, self._plan.filter_caps)
            fresh = key not in self._run_keys
            self._run_keys.add(key)
            what = "executor.compile" if fresh else "executor.replay"
            t0 = time.perf_counter()
            with _T.span(what, cat="executor", kind=self.kind,
                         attempt=attempt) as sp:
                outs = self._run_once(*args)
                self.n_executions += 1
                flat = torch.cat([o.to(torch.int64).reshape(-1)
                                  for o in outs]).tolist()
                sp.set(overflow=bool(flat[-1]))
            _M.inc(what + "_s", time.perf_counter() - t0, kind=self.kind)
            _M.inc("executor.compiles" if fresh else "executor.replays",
                   kind=self.kind)
            if not flat[-1]:
                return flat[:-1]
            if flat[-1] == 2:
                raise OverflowError(_PAST_LIMIT.format(self.signature))
            if attempt == self.max_retries:
                break
            self._grow()
        raise RuntimeError(f"mining plan {self.signature} still overflows "
                           f"after {self.max_retries + 1} attempts")

    def execute(self, src, dst, n_valid: int) -> tuple[int, np.ndarray]:
        """Replay the plan on a vertex-induced worklist; returns ``(count,
        p_map)``, the per-pattern counts int32[max_patterns] (zeros for an
        app without a reduce), read with the count in the one transfer."""
        assert self.kind == "vertex"
        n = torch.tensor(n_valid, dtype=torch.int32, device=self.miner.device)
        flat = self._run_with_retry(src, dst, n)
        return flat[0], np.asarray(flat[1:], dtype=np.int32)

    def execute_edge(self, src, dst, eid, n_valid: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Replay the plan on an edge-induced (FSM) worklist; returns
        ``(codes, supports)``, each int32[max_patterns]."""
        assert self.kind == "edge"
        n = torch.tensor(n_valid, dtype=torch.int32, device=self.miner.device)
        flat = self._run_with_retry(src, dst, eid, n)
        half = len(flat) // 2
        return (np.asarray(flat[:half], dtype=np.int32),
                np.asarray(flat[half:], dtype=np.int32))

"""PyTorch port, the sampled planner and plan transfer against the JAX
package: the samplers draw the same indices, ``estimate_plan`` gives the
same capacities on both port backends, ``PlanCache`` keeps the JAX
package's files and rules (a cache written by JAX seeds a port Miner),
estimated and transferred runs count what JAX's do, and the port's one
difference, the 2^30 clip of adopted capacities.

The JAX side runs on its reference backend only, each result cached per
worker; torch runs on one thread (see ``test_torch_mixed.py``).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import PlanCache as JaxPlanCache
from repro.core import make_cf_app as jax_make_cf_app
from repro.core import make_fsm_app as jax_make_fsm_app
from repro.core import make_mc_app as jax_make_mc_app
from repro.core import make_tc_app as jax_make_tc_app
from repro.core import plan as JP
from repro.graph import generators as G
from repro.graph import sampler as JS
from repro_torch.core import (Miner, PlanCache, estimate_plan, make_cf_app,
                              make_fsm_app, make_mc_app, make_tc_app)
from repro_torch.core import plan as TP
from repro_torch.core.phases.reference import MAX_CAND_CAP
from repro_torch.graph import generators as TG
from repro_torch.graph import sampler as TS
from repro_torch.graph.csr import from_edge_list


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GRAPHS = {"er80": (lambda: G.erdos_renyi(80, 0.1, seed=0),
                   lambda: TG.erdos_renyi(80, 0.1, seed=0, device="cpu")),
          "rmat8": (lambda: G.rmat(8, 16, seed=0),
                    lambda: TG.rmat(8, 16, seed=0, device="cpu"))}
LABELED = {"er80l": (lambda: G.erdos_renyi(80, 0.1, seed=0, labels=3),
                     lambda: TG.erdos_renyi(80, 0.1, seed=0, labels=3,
                                            device="cpu")),
           "rmat8l": (lambda: G.rmat(8, 16, seed=0, labels=4),
                      lambda: TG.rmat(8, 16, seed=0, labels=4,
                                      device="cpu"))}
APPS = {"tc": (jax_make_tc_app, make_tc_app),
        "4-cf": (lambda: jax_make_cf_app(4), lambda: make_cf_app(4)),
        "3-mc": (lambda: jax_make_mc_app(3), lambda: make_mc_app(3))}
FSM_SUPPORT = 3


def _fsm(make, ms=FSM_SUPPORT):
    return make(3, ms, max_patterns=64)


@functools.lru_cache(maxsize=None)
def jax_estimate(gname, aname, relabel):
    """JAX's estimated caps of a full run: ``(cap0, caps, filter_caps)``."""
    if aname == "3-fsm":
        m = JaxMiner(LABELED[gname][0](), _fsm(jax_make_fsm_app))
        m0 = int(m.ctx.n_uedges)
    else:
        m = JaxMiner(GRAPHS[gname][0](), APPS[aname][0](), relabel=relabel)
        m0 = int(m.init_edges()[0].shape[0])
    cap0 = JP.bucket_pow2(m0)
    return (cap0, *JP.estimate_plan(m, cap0))


def port_miner(gname, aname, backend="torch-ref", relabel=False):
    if aname == "3-fsm":
        return Miner(LABELED[gname][1](), _fsm(make_fsm_app),
                     backend=backend, device="cpu")
    return Miner(GRAPHS[gname][1](), APPS[aname][1](), backend=backend,
                 relabel=relabel, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_run(gname, aname, plan_source="inspect"):
    """JAX's result of one cold run and its plan: (count, p_map or
    supports, caps, filter_caps, source)."""
    if aname == "3-fsm":
        m = JaxMiner(LABELED[gname][0](), _fsm(jax_make_fsm_app))
    else:
        m = JaxMiner(GRAPHS[gname][0](), APPS[aname][0]())
    r = m.run(plan_source=plan_source)
    (rep,) = m.plan_reports()
    table = r.supports if aname == "3-fsm" else r.p_map
    return (r.count, None if table is None else np.asarray(table).tolist(),
            rep["caps"], rep["filter_caps"], rep["source"])


# -- samplers -----------------------------------------------------------------


@pytest.mark.parametrize("m,size,seed,sort", [
    (1000, 64, 0, True), (1000, 64, 1, False), (5, 64, 2, True),
    (250, 250, 3, False), (1, 1, 4, True)])
def test_sample_worklist_draws_jax_indices(m, size, seed, sort):
    got = TS.sample_worklist(m, size, np.random.default_rng(seed), sort)
    want = JS.sample_worklist(m, size, np.random.default_rng(seed), sort)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("m,size,bands,seed,sort", [
    (1000, 64, 8, 0, False), (1000, 64, 8, 1, True), (37, 20, 8, 2, False),
    (5, 64, 8, 3, False), (100, 0, 8, 4, False), (999, 256, 3, 5, False)])
def test_stratified_sample_draws_jax_indices(m, size, bands, seed, sort):
    got = TS.sample_worklist_stratified(m, size, np.random.default_rng(seed),
                                        bands, sort)
    want = JS.sample_worklist_stratified(m, size,
                                         np.random.default_rng(seed), bands,
                                         sort)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fanouts,seed", [((4, 2), 0), ((3,), 7),
                                          ((2, 2, 2), 3)])
def test_sample_fanout_draws_jax_frontiers(fanouts, seed):
    seeds = np.array([0, 5, 17, 3], np.int32)
    got = TS.sample_fanout(TG.rmat(6, 4, seed=1, device="cpu"), seeds,
                           fanouts, seed)
    want = JS.sample_fanout(G.rmat(6, 4, seed=1), seeds, fanouts, seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))


def test_sample_fanout_on_a_graph_without_edges():
    g = from_edge_list(np.zeros((0, 2)), n_vertices=5, device="cpu")
    frontiers = TS.sample_fanout(g, np.array([0, 3], np.int32), (4, 2))
    assert [f.shape for f in frontiers] == [(2,), (8,), (16,)]
    assert set(frontiers[1][:4]) == {0} and set(frontiers[1][4:]) == {3}


# -- plan transfer's pure functions -------------------------------------------


@pytest.mark.parametrize("a,ma,b,mb", [
    ((1.0, 2.0, 3.0), 100, (1.0, 2.5, 4.0), 120),
    ((0.0,) * 7, 0, (3.0,) * 7, 50),
    ((), 0, (1.0,), 3), ((1.0, 2.0), 5, (1.0,), 5)])
def test_profile_distance_is_jax(a, ma, b, mb):
    assert TP.profile_distance(a, ma, b, mb) == JP.profile_distance(a, ma,
                                                                    b, mb)


@pytest.mark.parametrize("caps,fcaps,cap0,new_cap0,sf", [
    (((1024, 512),), (256,), 1024, 2048, 1.0),
    (((4096, 1000), (65536, 30000)), (), 256, 100_000, 2.0),
    (((128, 128),), (128, 128), 4096, 64, 1.5)])
def test_transfer_caps_are_jax(caps, fcaps, cap0, new_cap0, sf):
    got = TP.transfer_caps(TP.MiningPlan(kind="vertex", caps=caps,
                                         filter_caps=fcaps, cap0=cap0),
                           new_cap0, sf)
    want = JP.transfer_caps(JP.MiningPlan(kind="vertex", caps=caps,
                                          filter_caps=fcaps, cap0=cap0),
                            new_cap0, sf)
    assert got == want


@pytest.mark.parametrize("kind,caps,fcaps", [
    ("vertex", ((256, 128),), ()), ("vertex", ((256, 128),) * 2, ()),
    ("vertex", (), ()), ("edge", ((256, 128),), (128, 128)),
    ("edge", ((256, 128),), (128,))])
@pytest.mark.parametrize("aname", ["tc", "4-cf", "3-fsm"])
def test_compatible_caps_are_jax(kind, caps, fcaps, aname):
    if aname == "3-fsm":
        japp, tapp = _fsm(jax_make_fsm_app), _fsm(make_fsm_app)
    else:
        japp, tapp = APPS[aname][0](), APPS[aname][1]()
    got = TP.compatible_caps(TP.MiningPlan(kind=kind, caps=caps,
                                           filter_caps=fcaps), tapp)
    want = JP.compatible_caps(JP.MiningPlan(kind=kind, caps=caps,
                                            filter_caps=fcaps), japp)
    assert got == want


# -- the estimator ------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@pytest.mark.parametrize("aname,relabel", [
    ("tc", False), ("4-cf", False), ("3-mc", False), ("3-mc", True)])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_estimate_plan_caps_are_jax(gname, aname, relabel, backend):
    cap0, caps, fcaps = jax_estimate(gname, aname, relabel)
    m = port_miner(gname, aname, backend, relabel)
    assert estimate_plan(m, cap0) == (caps, fcaps)


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@pytest.mark.parametrize("gname", sorted(LABELED))
def test_fsm_estimate_plan_caps_are_jax(gname, backend):
    cap0, caps, fcaps = jax_estimate(gname, "3-fsm", False)
    assert len(fcaps) == 2
    assert estimate_plan(port_miner(gname, "3-fsm", backend), cap0) == \
        (caps, fcaps)


def test_estimate_plan_on_an_empty_worklist_is_minimal():
    g = from_edge_list(np.zeros((0, 2)), n_vertices=4, device="cpu")
    m = Miner(g, make_cf_app(4), device="cpu")
    assert estimate_plan(m, 128) == (((128, 128),) * 2, ())


def test_the_probe_reads_the_device_once(monkeypatch):
    m = port_miner("rmat8", "4-cf", "cuda")
    reads = []

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads.append(name)
            return orig(self, *a, **kw)
        return read

    m.init_edges()
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    estimate_plan(m, 2048)
    monkeypatch.undo()
    assert reads == ["tolist"]


@pytest.mark.parametrize("backend", ["torch-ref", "cuda", "cuda-1p"])
@pytest.mark.parametrize("aname", ["tc", "4-cf", "3-mc"])
def test_estimated_runs_count_as_jax(aname, backend):
    count, p_map, caps, fcaps, source = jax_run("rmat8", aname, "estimate")
    m = port_miner("rmat8", aname, backend)
    for _ in ("cold", "warm"):
        r = m.run(plan_source="estimate")
        assert r.count == count
        assert (None if r.p_map is None else r.p_map.tolist()) == p_map
    (ex,) = m._executors.values()
    # the same plan, replanned the same way: the clip changed nothing here
    assert (list(ex.plan.caps), list(ex.plan.filter_caps),
            ex.plan.source) == (caps, fcaps, source)
    assert ex.plan.profile == m.profile_sketch()[0] and ex.plan.n_edges


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
def test_estimated_fsm_runs_find_jax_supports(backend):
    count, supports, caps, fcaps, source = jax_run("er80l", "3-fsm",
                                                   "estimate")
    m = port_miner("er80l", "3-fsm", backend)
    r = m.run(plan_source="estimate", block_size=8)   # FSM ignores blocks
    assert (r.count, r.supports.tolist()) == (count, supports)
    (ex,) = m._executors.values()
    assert (list(ex.plan.caps), list(ex.plan.filter_caps),
            ex.plan.source) == (caps, fcaps, source)


def test_unknown_plan_source_raises_as_jax_does():
    m = port_miner("er80", "tc")
    with pytest.raises(ValueError, match="plan_source"):
        m.run(plan_source="guess")


# -- the plan cache -----------------------------------------------------------


def _plan(sig, **kw):
    return TP.MiningPlan(kind="vertex", caps=((256, 128),), cap0=128,
                         signature=sig, **kw)


def test_plan_cache_round_trip_and_exact_hit(tmp_path):
    cache = PlanCache(str(tmp_path))
    m = port_miner("er80", "4-cf")
    r = m.run(plan_cache=cache)
    (ex,) = m._executors.values()
    assert os.path.exists(tmp_path / f"{ex.signature}.json")
    assert cache.get(ex.signature) == dataclasses.replace(ex.plan,
                                                          source="cache")
    m2 = port_miner("er80", "4-cf")
    assert m2.run(plan_source="cache", plan_cache=str(tmp_path)).count == \
        r.count
    (ex2,) = m2._executors.values()
    assert ex2.plan.source == "cache" and ex2.n_executions == 1


def test_plan_cache_drops_stale_and_mismatched_entries(tmp_path):
    cache = PlanCache(str(tmp_path))
    cache.put(_plan("aaaa"))
    stale = (tmp_path / "aaaa.json").read_text().replace(
        '"schema": 4', '"schema": 3')
    (tmp_path / "aaaa.json").write_text(stale)
    assert cache.get("aaaa") is None
    assert not (tmp_path / "aaaa.json").exists()
    cache.put(_plan("bbbb"))
    os.replace(tmp_path / "bbbb.json", tmp_path / "cccc.json")
    assert cache.get("cccc") is None             # signature != file name
    assert not (tmp_path / "cccc.json").exists()
    (tmp_path / "dddd.json").write_text("{not json")
    assert cache.get("dddd") is None


def test_plan_cache_evicts_least_recently_used(tmp_path):
    cache = PlanCache(str(tmp_path), max_entries=2)
    for i, sig in enumerate(("p0", "p1")):
        cache.put(_plan(sig))
        os.utime(tmp_path / f"{sig}.json", (100 + i, 100 + i))
    assert cache.get("p0") is not None           # touched: now the newest
    cache.put(_plan("p2"))
    assert sorted(os.listdir(tmp_path)) == ["p0.json", "p2.json"]


def test_nearest_matches_app_key_transfer_key_and_cap0(tmp_path):
    cache = PlanCache(str(tmp_path))
    prof = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0)
    far = tuple(10 * x for x in prof)
    cache.put(_plan("near", app_key="A", transfer_key="T", profile=prof,
                    n_edges=100))
    cache.put(_plan("far", app_key="A", transfer_key="T", profile=far,
                    n_edges=100))
    cache.put(_plan("other", app_key="B", transfer_key="U", profile=prof,
                    n_edges=100))
    assert cache.nearest("A", "vertex", prof, 100).signature == "near"
    assert cache.nearest("A", "vertex", prof, 100,
                         exclude=("near",)).signature == "far"
    assert cache.nearest("Z", "vertex", prof, 100) is None
    assert cache.nearest("Z", "vertex", prof, 100,
                         transfer_key="T").signature == "near"
    assert cache.nearest("A", "edge", prof, 100) is None
    # the worklist ratio outweighs a slightly worse profile
    big = dataclasses.replace(_plan("big", app_key="A", profile=far,
                                    n_edges=100), cap0=1 << 20)
    cache.put(big)
    assert cache.nearest("A", "vertex", prof, 100,
                         cap0=1 << 20).signature == "big"
    assert cache.nearest("A", "vertex", prof, 100,
                         cap0=128).signature == "near"


def test_a_cache_written_by_jax_seeds_a_port_miner(tmp_path):
    """JAX records TC's plan on a nearby graph; the port mines er80 with
    plan_source="cache": no exact hit (another graph, another backend), the
    transfer key matches, and the count is JAX's."""
    donor = JaxMiner(G.erdos_renyi(90, 0.1, seed=9), jax_make_tc_app())
    donor.run(plan_cache=JaxPlanCache(str(tmp_path)))
    count = jax_run("er80", "tc")[0]
    m = port_miner("er80", "tc", "cuda")
    assert m.run(plan_source="cache", plan_cache=str(tmp_path)).count == \
        count
    (ex,) = m._executors.values()
    assert ex.plan.source in ("transfer", "grown")
    assert ex.n_replans == 0 or ex.plan.source == "grown"
    # the port's own plan is written beside JAX's, and JAX reads it
    back = JaxPlanCache(str(tmp_path)).get(ex.signature)
    assert back is not None and tuple(back.caps) == ex.plan.caps


def test_cache_mode_without_a_donor_estimates(tmp_path):
    m = port_miner("er80", "tc")
    r = m.run(plan_source="cache", plan_cache=str(tmp_path))
    assert r.count == jax_run("er80", "tc")[0]
    assert m.plan_reports()[0]["source"] in ("estimated", "grown")


def test_grown_plans_are_written_to_the_cache(tmp_path):
    m = port_miner("rmat8", "4-cf")
    cap0 = TP.bucket_pow2(int(m.init_edges()[0].shape[0]))
    ex = m.executor(cap0, plan_cache=PlanCache(str(tmp_path)))
    ex.adopt_plan(((4096, 1024), (8192, 4096)))
    assert m.run().count == jax_run("rmat8", "4-cf", "estimate")[0]
    assert ex.n_replans >= 1
    assert PlanCache(str(tmp_path)).get(ex.signature).caps == ex.plan.caps


# -- the 2^30 clip ----------------------------------------------------------


def test_clip_is_the_identity_below_the_ceiling():
    caps, fcaps = ((1 << 20, 1 << 19), (1 << 30, 1 << 30)), (128, 1 << 30)
    assert TP.clip_caps(caps, fcaps) == (caps, fcaps)


def test_adopted_plans_above_the_ceiling_are_clipped():
    m = port_miner("er80", "4-cf")
    ex = m.executor(128)
    ex.adopt_plan(((1 << 33, 1_177_200_896), (1 << 31, 1 << 27)),
                  source="estimated")
    assert ex.plan.caps == ((MAX_CAND_CAP, MAX_CAND_CAP),
                            (MAX_CAND_CAP, 1 << 27))
    assert ex.plan.source == "estimated"


def test_a_jax_cached_plan_above_the_ceiling_is_clipped(tmp_path):
    m = port_miner("er80", "4-cf")
    sig = m.executor(128).signature
    JaxPlanCache(str(tmp_path)).put(JP.MiningPlan(
        kind="vertex", caps=((1 << 31, 1 << 31), (1 << 32, 256)), cap0=128,
        signature=sig))
    ex = m.executor(128, plan_cache=PlanCache(str(tmp_path)))
    assert ex.plan.caps == ((MAX_CAND_CAP, MAX_CAND_CAP),
                            (MAX_CAND_CAP, 256))


def test_growth_stops_at_the_ceiling():
    m = port_miner("er80", "4-cf")
    ex = m.executor(128)
    ex.adopt_plan(((1 << 30, 1 << 29), (1 << 29, 1 << 28)))
    ex._grow()
    assert ex.plan.caps == ((1 << 30, 1 << 30), (1 << 30, 1 << 29))
    ex._grow()
    assert ex.plan.caps == ((1 << 30, 1 << 30),) * 2
    with pytest.raises(OverflowError, match="block_size or block_bytes"):
        ex._grow()
    assert ex.n_replans == 2


def test_a_level_past_the_ceiling_raises_and_blocks_get_past_it(
        monkeypatch):
    """With the ceiling lowered to 8192 slots, 4-CF on RMAT-8 (levels of
    22,237 and 59,095 candidates) raises OverflowError naming the block
    options on the inspection and the estimated replay alike, and mines the
    right count in blocks that fit."""
    monkeypatch.setattr(TP, "MAX_CAND_CAP", 8192)
    want = jax_run("rmat8", "4-cf", "estimate")[0]
    for kw in ({}, {"plan_source": "estimate"}):
        with pytest.raises(OverflowError, match="block_size or block_bytes"):
            port_miner("rmat8", "4-cf").run(**kw)
    m = port_miner("rmat8", "4-cf")
    for _ in ("cold", "warm"):
        assert m.run(block_size=128, plan_source="estimate").count == want
    assert max(c for c, _ in m._executors[128].plan.caps) <= 8192


# -- the second deliberate difference: a filter after a truncated level ------


def test_a_filter_after_a_truncated_probe_level_is_planned_at_its_survivors(
        monkeypatch):
    """Probe capacities cut down so the probe truncates 3-FSM's level 2 on
    er80l: every capacity but that level's filter is JAX's; the filter is
    planned at the level's survivor estimate (JAX plans it from the keep
    count of the truncated frontier), and the estimated run finds JAX's
    supports."""
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "SAMPLE_CAND_CAP", 1024)
        monkeypatch.setattr(mod, "SAMPLE_OUT_CAP", 256)
    jm = JaxMiner(LABELED["er80l"][0](), _fsm(jax_make_fsm_app))
    cap0 = JP.bucket_pow2(int(jm.ctx.n_uedges))
    want_caps, want_fcaps = JP.estimate_plan(jm, cap0)
    m = port_miner("er80l", "3-fsm", "cuda")
    caps, fcaps = estimate_plan(m, cap0)
    assert caps == want_caps and fcaps[0] == want_fcaps[0]
    assert fcaps[1] == caps[0][1] > want_fcaps[1]
    count, supports = jax_run("er80l", "3-fsm", "estimate")[:2]
    r = m.run(plan_source="estimate")
    assert (r.count, r.supports.tolist()) == (count, supports)

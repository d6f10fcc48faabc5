"""PyTorch port, edge blocks against the JAX package: the block arithmetic
(``make_blocks``, ``estimate_live_bytes``, ``scale_caps``,
``auto_block_size``) equal exactly, the block queue's staged columns, and
blocked ``Miner.run``s (explicit block sizes and byte budgets, with and
without relabeling) whose counts, pattern maps and plans equal JAX's, with
their checkpoints, kill and resume.

The JAX side runs on its reference backend only, each result cached per
worker; torch runs on one thread (see ``test_torch_mixed.py``).
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import blocks as JB
from repro.core import make_mc_app as jax_make_mc_app
from repro.core import make_tc_app as jax_make_tc_app
from repro.graph import generators as G
from repro_torch.core import Miner, make_mc_app, make_tc_app
from repro_torch.core import blocks as TB
from repro_torch.graph import generators as TG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


APPS = {"tc": (jax_make_tc_app, make_tc_app),
        "3-mc": (lambda: jax_make_mc_app(3), lambda: make_mc_app(3))}
RELABEL = pytest.mark.parametrize("relabel", [False, True],
                                  ids=["plain", "relabel"])
BUDGET = 16 << 10


def port_graph():
    return TG.erdos_renyi(30, 0.25, seed=2, device="cpu")


def key(r):
    return r.count, None if r.p_map is None else np.asarray(r.p_map).tolist()


@functools.lru_cache(maxsize=None)
def jax_unblocked(aname):
    return key(JaxMiner(G.erdos_renyi(30, 0.25, seed=2),
                        APPS[aname][0]()).run())


@functools.lru_cache(maxsize=None)
def jax_sequence(aname, relabel, run_kw):
    """JAX's results and block plan after a cold and a warm blocked run:
    (keys, caps, source, replans)."""
    m = JaxMiner(G.erdos_renyi(30, 0.25, seed=2), APPS[aname][0](),
                 relabel=relabel)
    keys = [key(m.run(**dict(run_kw))) for _ in ("cold", "warm")]
    (rep,) = m.plan_reports()
    return keys, rep["caps"], rep["source"], rep["replans"], rep["cap0"]


# -- block arithmetic ---------------------------------------------------------


@pytest.mark.parametrize("m,block_size,count", [
    (100, 32, None), (100, 64, 4), (0, 8, None), (7, 100, None),
    (100, 1, None), (37, 37, 3), (64, 16, 4)])
def test_make_blocks_are_jax(m, block_size, count):
    got = [(b.index, b.lo, b.n) for b in TB.make_blocks(m, block_size, count)]
    want = [(b.index, b.lo, b.n) for b in JB.make_blocks(m, block_size,
                                                         count)]
    assert got == want


def test_make_blocks_refuses_too_few_blocks():
    with pytest.raises(ValueError, match="exceed requested count"):
        TB.make_blocks(100, 10, count=2)


CAP_GRID = [((), ()), (((4096, 1024),), ()),
            (((4096, 1024), (8192, 2048)), ()),
            (((1 << 33, 1_177_200_896),), ()),
            (((65536, 16384), (131072, 32768)), (512, 512, 640)),
            (((256, 128),), (128, 128))]


@pytest.mark.parametrize("kind", ["vertex", "edge"])
@pytest.mark.parametrize("caps,fcaps", CAP_GRID)
@pytest.mark.parametrize("cap0", [0, 128, 2048, 1 << 21])
def test_estimate_live_bytes_are_jax(kind, caps, fcaps, cap0):
    assert TB.estimate_live_bytes(kind, caps, fcaps, cap0) == \
        JB.estimate_live_bytes(kind, caps, fcaps, cap0)


@pytest.mark.parametrize("caps,fcaps", CAP_GRID)
@pytest.mark.parametrize("ratio", [1.0, 0.5, 1 / 3, 65536 / 1_819_076,
                                   2 ** 16 / 2 ** 21, 1e-6])
def test_scale_caps_are_jax(caps, fcaps, ratio):
    assert TB.scale_caps(caps, fcaps, ratio) == JB.scale_caps(caps, fcaps,
                                                              ratio)


@pytest.mark.parametrize("kind", ["vertex", "edge"])
@pytest.mark.parametrize("caps,fcaps", CAP_GRID[1:])
@pytest.mark.parametrize("m,budget", [
    (100_000, 1 << 20), (100_000, 1 << 30), (100_000, 1),
    (1_819_076, 17_179_869_184), (1_819_076, 25_769_803_776),
    (300, 50_000)])
def test_auto_block_size_is_jax(kind, caps, fcaps, m, budget):
    assert TB.auto_block_size(m, caps, fcaps, budget, kind) == \
        JB.auto_block_size(m, caps, fcaps, budget, kind)


def test_three_mc_at_rmat16_prices_as_jax_does():
    """The full plan that exact counts give 3-MC on RMAT-16 (2^33 slots):
    65,536-entry blocks at 16 GiB, each seeded at (2^28, 36,787,584)."""
    caps, m = ((1 << 33, 1_177_200_896),), 1_819_076
    b = TB.auto_block_size(m, caps, (), 17_179_869_184)
    assert b == JB.auto_block_size(m, caps, (), 17_179_869_184) == 65536
    assert len(TB.make_blocks(m, b)) == 28
    sc = TB.scale_caps(caps, (), b / TB.bucket_pow2(m))
    assert sc == (((1 << 28, 36_787_584),), ())


# -- the block queue ----------------------------------------------------------


@pytest.mark.parametrize("m,block_size,cap0", [(10, 4, 8), (10, 4, 4),
                                               (9, 3, 128), (0, 4, 8)])
def test_block_queue_stages_jax_blocks(m, block_size, cap0):
    src = np.arange(m, dtype=np.int32)
    cols = (src, src * 2 + 1)
    blocks = TB.make_blocks(m, block_size)
    q = TB.BlockQueue(cols, blocks, cap0, device="cpu")
    got = [(b.index, [c.tolist() for c in staged]) for b, staged in q]
    want = [(b.index, [np.asarray(c).tolist() for c in staged])
            for b, staged in JB.BlockQueue(cols, JB.make_blocks(
                m, block_size), cap0)]
    assert got == want
    assert len(q) == len(blocks) and q.stage_s > 0 and q.mine_s > 0


def test_block_queue_counts_time_when_the_consumer_stops():
    src = np.arange(10, dtype=np.int32)
    q = TB.BlockQueue((src,), TB.make_blocks(10, 4), 4, device="cpu")
    for blk, _ in q:
        if blk.index == 1:
            break
    assert q.mine_s > 0


def test_stack_blocks_are_jax():
    src = np.arange(10, dtype=np.int32)
    blocks = TB.make_blocks(10, 4, count=3)
    got = TB.stack_blocks((src, src + 7), blocks, 8, device="cpu")
    want = JB.stack_blocks((src, src + 7), JB.make_blocks(10, 4, count=3),
                           8)
    assert [g.tolist() for g in got] == [np.asarray(w).tolist()
                                         for w in want]


# -- blocked runs -------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@RELABEL
@pytest.mark.parametrize("block_size", [16, 37, 64])
@pytest.mark.parametrize("aname", sorted(APPS))
def test_blocked_runs_equal_jax(aname, block_size, relabel, backend):
    m = Miner(port_graph(), APPS[aname][1](), backend=backend,
              relabel=relabel, device="cpu")
    for _ in ("cold", "warm"):
        assert key(m.run(block_size=block_size)) == jax_unblocked(aname)
    assert len(m.block_queue) == -(-int(m.init_edges()[0].shape[0])
                                   // block_size)


@pytest.mark.parametrize("run_kw", [
    (("block_size", 37),),
    (("block_size", 37), ("plan_source", "estimate")),
    (("block_bytes", BUDGET), ("plan_source", "estimate"))],
    ids=["inspect", "estimate", "bytes"])
@RELABEL
def test_blocked_plans_follow_jax(run_kw, relabel):
    """After a cold and a warm blocked run, the block executor's plan (caps,
    source, replans) is JAX's, and so are the results."""
    keys, caps, source, replans, cap0 = jax_sequence("3-mc", relabel,
                                                     run_kw)
    m = Miner(port_graph(), make_mc_app(3), relabel=relabel, device="cpu")
    assert [key(m.run(**dict(run_kw))) for _ in ("cold", "warm")] == keys
    ex = m._executors[cap0]
    assert (list(ex.plan.caps), ex.plan.source, ex.n_replans) == \
        (caps, source, replans)


@RELABEL
def test_byte_budget_blocks_price_below_the_unblocked_run(relabel):
    g = TG.rmat(8, 6, seed=3, device="cpu")
    full = Miner(g, make_tc_app(), relabel=relabel, device="cpu")
    blocked = Miner(g, make_tc_app(), relabel=relabel, device="cpu")
    r0 = full.run(plan_source="estimate")
    budget = full.peak_live_bytes() // 4
    r1 = blocked.run(block_bytes=budget, plan_source="estimate")
    assert r1.count == r0.count
    assert len(blocked.block_queue) > 1
    assert blocked.peak_live_bytes() < full.peak_live_bytes()


def test_fsm_ignores_block_size():
    from repro_torch.core import make_fsm_app
    g = TG.erdos_renyi(40, 0.15, seed=1, labels=3, device="cpu")
    m = Miner(g, make_fsm_app(3, 2, max_patterns=64), device="cpu")
    r0 = m.run()
    r1 = m.run(block_size=4, block_bytes=1024)
    assert (r1.count, r1.supports.tolist()) == (r0.count,
                                                r0.supports.tolist())
    assert m.block_queue is None and len(m._executors) == 1


# -- checkpoints and resume ---------------------------------------------------


class _Killed(Exception):
    pass


def _payloads(miner) -> list:
    got = []
    miner.run(block_size=16, checkpoint_cb=lambda b, lv, pl: got.append(
        (b, lv, pl["block"], pl["count"], np.asarray(pl["p_map"]).tolist())))
    return got


@functools.lru_cache(maxsize=None)
def jax_payloads() -> list:
    return _payloads(JaxMiner(G.erdos_renyi(30, 0.25, seed=2),
                              jax_make_mc_app(3)))


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
def test_checkpoint_payloads_follow_jax(backend):
    got = _payloads(Miner(port_graph(), make_mc_app(3), backend=backend,
                          device="cpu"))
    assert got == jax_payloads()
    assert len(got) > 4
    assert [p[0] for p in got] == list(range(len(got)))


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
def test_per_level_checkpoints_of_an_unblocked_run(backend):
    got = []
    m = Miner(port_graph(), make_mc_app(3), backend=backend, device="cpu")
    r = m.run(checkpoint_cb=lambda lvl, levels, pl: got.append(
        (lvl, len(levels), pl.tolist())))
    assert got == [(2, 2, list(r.p_map))]


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@RELABEL
def test_killed_run_resumes_to_the_unblocked_result(relabel, backend):
    saved = []

    def cb(bi, levels, payload):
        saved.append(dict(payload))
        if bi == 1:
            raise _Killed

    m = Miner(port_graph(), make_mc_app(3), backend=backend, relabel=relabel,
              device="cpu")
    with pytest.raises(_Killed):
        m.run(block_size=16, checkpoint_cb=cb)
    assert saved[-1]["block"] == 1 and len(saved) == 2
    m2 = Miner(port_graph(), make_mc_app(3), backend=backend,
               relabel=relabel, device="cpu")
    r = m2.run(block_size=16, resume_from=saved[-1])
    assert key(r) == jax_unblocked("3-mc")
    n_blocks = -(-int(m2.init_edges()[0].shape[0]) // 16)
    assert [b.index for b in m2.block_queue.blocks] == \
        list(range(2, n_blocks))


def test_resume_past_every_block_is_the_identity():
    m = Miner(port_graph(), make_mc_app(3), device="cpu")
    done = []
    m.run(block_size=16, checkpoint_cb=lambda b, lv, pl: done.append(pl))
    r = m.run(block_size=16, resume_from=done[-1])
    assert key(r) == jax_unblocked("3-mc")
    assert len(m.block_queue) == 0

"""PyTorch port, bounded and multi-device mining against the JAX package.

``bounded_mine_vertex`` / ``bounded_mine_edge`` on one process equal
JAX's (jitted, one CPU device) exactly, overflow included; the sharded FSM
reduce with no group equals JAX's local oracle and the port's
``reduce_domain`` on both merge paths, and its packed words are JAX's bit
layout; one spawn of four ``gloo`` ranks runs ``mine_sharded`` for TC,
4-MC and 3-FSM (the caps of ``tests/test_distributed_mining.py``) and
every rank returns JAX's ``Miner.run`` results, and flags overflow; the
errors come before any collective.

The JAX side is imported inside the cached helpers, so the spawned ranks,
which import this module to find their function, load torch alone.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import (Miner, bounded_mine_edge, bounded_mine_vertex,
                              make_fsm_app, make_mc_app, make_tc_app,
                              mine_sharded)
from repro_torch.core.phases import reference as R
from repro_torch.core.plan import bucket_pow2
from repro_torch.graph import generators as TG
from repro_torch.launch import mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the graphs and capacities of tests/test_distributed_mining.py
UNLABELED = (40, 0.2, 3, None)
LABELED = (24, 0.25, 7, 3)
TC_CAPS = ((2048, 1024),)
MC4_CAPS = ((8192, 8192), (32768, 32768))
FSM_CAPS, FSM_FILTER = ((8192, 8192),), (2048, 2048)
TINY = ((8, 4),)
# one process mines the whole worklist: 4-MC's level 3 needs more than the
# four-device caps, so the bounded runs take these
MC4_ONE = ((8192, 8192), (65536, 65536))


def port_app(name):
    return {"tc": make_tc_app, "4-mc": lambda: make_mc_app(4),
            "3-fsm": lambda: make_fsm_app(3, min_support=2,
                                          max_patterns=64)}[name]()


def jax_app(name):
    from repro.core import make_fsm_app as f, make_mc_app as m
    from repro.core import make_tc_app as t
    return {"tc": t, "4-mc": lambda: m(4),
            "3-fsm": lambda: f(3, min_support=2, max_patterns=64)}[name]()


def port_graph(spec, device="cpu"):
    n, p, seed, labels = spec
    return TG.erdos_renyi(n, p, seed=seed, labels=labels, device=device)


def jax_graph(spec):
    from repro.graph import generators as G
    n, p, seed, labels = spec
    return G.erdos_renyi(n, p, seed=seed, labels=labels)


@functools.lru_cache(maxsize=None)
def jax_run(name, spec):
    """JAX ``Miner.run``: (count, p_map, codes, supports)."""
    from repro.core import Miner as JaxMiner
    if name == "3-fsm" and spec == LABELED:
        r = jax_fsm_levels()[1]
    else:
        r = JaxMiner(jax_graph(spec), jax_app(name)).run()
    lst = (lambda a: None if a is None else np.asarray(a).tolist())
    return r.count, lst(r.p_map), lst(r.codes), lst(r.supports)


@functools.lru_cache(maxsize=None)
def jax_bounded(name, spec, caps, filter_caps=None):
    """JAX's bounded run over the whole worklist, jitted on one device."""
    import jax
    import jax.numpy as jnp
    from repro.core import Miner as JaxMiner
    from repro.core import bounded_mine_edge as jbe
    from repro.core import bounded_mine_vertex as jbv
    app = jax_app(name)
    miner = JaxMiner(jax_graph(spec), app)
    ctx = miner.ctx
    if app.kind == "edge":
        m = ctx.n_uedges
        pad = (0, bucket_pow2(m) - m)
        cols = [jnp.pad(c, pad) for c in
                (ctx.usrc, ctx.udst, jnp.arange(m, dtype=jnp.int32))]
        out = jax.jit(lambda s, d, e, n: jbe(ctx, app, s, d, e, n, caps,
                                             filter_caps))(
            *cols, jnp.int32(m))
    else:
        src, dst = miner.init_edges()
        m = int(src.shape[0])
        pad = (0, bucket_pow2(m) - m)
        out = jax.jit(lambda s, d, n: jbv(ctx, app, s, d, n, caps))(
            jnp.pad(src, pad), jnp.pad(dst, pad), jnp.int32(m))
    return tuple(np.asarray(x).tolist() for x in out)


def port_bounded(name, spec, caps, filter_caps=None, backend=None):
    app = port_app(name)
    miner = Miner(port_graph(spec), app, backend=backend, device="cpu")
    ctx = miner.ctx
    if app.kind == "edge":
        out = bounded_mine_edge(ctx, app, *miner.edge_worklist(),
                                ctx.n_uedges, caps, filter_caps,
                                backend=backend)
    else:
        src, dst = miner.init_edges()
        m = int(src.shape[0])
        pad = (0, bucket_pow2(m) - m)
        out = bounded_mine_vertex(
            ctx, app, torch.nn.functional.pad(src, pad),
            torch.nn.functional.pad(dst, pad), m, caps, backend=backend)
    return tuple(x.tolist() for x in out)


# -- bounded mining on one process ---------------------------------------------


@pytest.mark.parametrize("name,spec,caps,fcaps,backend", [
    ("tc", UNLABELED, TC_CAPS, None, "cuda"),
    ("4-mc", UNLABELED, MC4_ONE, None, "torch-ref"),
    ("3-fsm", LABELED, FSM_CAPS, FSM_FILTER, "cuda-1p"),
    ("tc", UNLABELED, TINY, None, "cuda"),
    ("3-fsm", LABELED, TINY, (128, 128), "torch-ref"),
], ids=["tc", "4-mc", "3-fsm", "tc-overflow", "3-fsm-overflow"])
def test_bounded_mining_is_jax(name, spec, caps, fcaps, backend):
    got = port_bounded(name, spec, caps, fcaps, backend)
    want = jax_bounded(name, spec, caps, fcaps)
    assert got[:2] == want[:2]
    assert bool(got[2]) == bool(want[2])
    assert bool(got[2]) == (caps == TINY)


# -- the sharded FSM reduce, locally ---------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_fsm_levels():
    """A JAX 3-FSM Miner and its cold run's result (with its levels)."""
    from repro.core import Miner as JaxMiner
    miner = JaxMiner(jax_graph(LABELED), jax_app("3-fsm"))
    return miner, miner.run(collect_stats=True)


@functools.lru_cache(maxsize=None)
def jax_local_reduce(packed):
    """JAX's reduce_domain_sharded with no mesh axes on the last levels of
    a cold 3-FSM run."""
    import jax
    from repro.core.phases.reference import reduce_domain_sharded
    miner, result = jax_fsm_levels()
    codes, sup, _, _ = jax.jit(lambda lv: reduce_domain_sharded(
        miner.ctx, miner.app, lv, (), packed=packed))(result.levels)
    return np.asarray(codes).tolist(), np.asarray(sup).tolist()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_local_sharded_reduce_is_jax_and_reduce_domain(packed):
    miner = Miner(port_graph(LABELED), port_app("3-fsm"), device="cpu")
    levels = miner.run().levels
    got = R.reduce_domain_sharded(miner.ctx, miner.ops.app, levels, None,
                                  packed=packed)
    plain = R.reduce_domain(miner.ctx, miner.ops.app, levels)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert (got[0].tolist(), got[1].tolist()) == jax_local_reduce(packed)
    assert int((got[1] >= 2).sum()) > 1       # frequent patterns counted


# 70 vertices: three words a row, bit 31 (the sign bit) of two of them
WIDE = (70, 0.08, 5, 3)


def _fsm_membership_args():
    """The arguments of the membership builders on the last level of a cold
    3-FSM run of a labeled graph of 70 vertices: (ctx, vert_vid, n_verts,
    ok_rows, perms, codes_all, canon, pat, V, park)."""
    miner = Miner(port_graph(WIDE), port_app("3-fsm"), device="cpu")
    app = miner.ops.app
    vert_vid, n_verts, valid, perms, codes_all, canon = \
        R._canonical_edge_codes(miner.ctx, app, miner.run().levels)
    V = vert_vid.shape[1]
    _, pat = R.P.unique_fixed(canon, app.max_patterns)
    return (miner.ctx, vert_vid, n_verts, valid, perms, codes_all, canon,
            pat, V, app.max_patterns * V)


def test_packed_words_are_jax_bit_layout():
    """The packed membership is the dense one packed in JAX's ``uint32``
    layout (vertex v is bit v & 31 of word v >> 5), and its popcounts are
    the dense rows' sums."""
    args = _fsm_membership_args()
    member = R._membership(*args).numpy()
    words = R._packed_membership(*args)
    park, n = member.shape
    n_words = -(-n // 32)
    padded = np.zeros((park, n_words * 32), np.uint8)
    padded[:, :n] = member
    want = np.packbits(padded, axis=1, bitorder="little").view("<u4")
    assert words.dtype == torch.int32 and words.shape == (park, n_words)
    assert np.array_equal(words.numpy().view(np.uint32), want)
    assert (want >> 31).any()                # the sign bit is exercised
    counts = R.popcount32(words).sum(dim=1)
    assert counts.tolist() == member.sum(axis=1).tolist()


def test_packed_reduce_builds_no_dense_table(monkeypatch):
    """The packed path never builds the dense ``uint8[park, n_vertices]``
    table: with the dense builder made to fail, it still equals the dense
    path's answer."""
    miner = Miner(port_graph(LABELED), port_app("3-fsm"), device="cpu")
    levels = miner.run().levels
    dense = R.reduce_domain_sharded(miner.ctx, miner.ops.app, levels, None,
                                    packed=False)

    def refuse(*a, **kw):
        raise AssertionError("the packed path built the dense table")
    monkeypatch.setattr(R, "_membership", refuse)
    packed = R.reduce_domain_sharded(miner.ctx, miner.ops.app, levels, None,
                                     packed=True)
    for a, b in zip(packed, dense):
        assert torch.equal(a, b)


def test_popcount_counts_every_bit_the_sign_bit_included():
    vals = np.array([0, 1, -1, -2**31, 2**31 - 1, 0x55555555, -0x55555556],
                    dtype=np.int32)
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in vals]
    assert R.popcount32(torch.from_numpy(vals)).tolist() == want


# -- four gloo ranks ------------------------------------------------------------


def _prefix_reduces(rank, group, device):
    """The sharded FSM reduce on both merge paths, rank ``r`` holding the
    first (r + 1) / 4 of a cold run's last level: the union over the ranks
    is the whole level, so every rank's codes and supports must be the
    local reduce's of the whole level."""
    import dataclasses
    miner = Miner(port_graph(LABELED, device), port_app("3-fsm"),
                  device=device)
    ctx, app = miner.ctx, miner.ops.app
    levels = miner.run().levels
    whole = R.reduce_domain(ctx, app, levels)
    n = int(levels[-1].n) * (rank + 1) // 4
    mine = levels[:-1] + [dataclasses.replace(
        levels[-1], n=torch.tensor(n, dtype=torch.int32))]
    mine_alone = R.reduce_domain(ctx, app, mine)
    out = {"differs alone": not torch.equal(mine_alone[1], whole[1])}
    for packed in (True, False):
        got = R.reduce_domain_sharded(ctx, app, mine, group, packed=packed)
        out[packed] = all(torch.equal(got[i], whole[i]) for i in (0, 1, 3))
    return out


def _four_ranks(rank, group, device):
    """Each rank's results: TC, 4-MC and 3-FSM at the four-device caps, TC
    at tiny caps, the sharded reduce of level prefixes; gathered to every
    rank."""
    import torch.distributed as dist
    g = port_graph(UNLABELED, device)
    gl = port_graph(LABELED, device)
    out = {
        "prefixes": _prefix_reduces(rank, group, device),
        "tc": mine_sharded(g, port_app("tc"), TC_CAPS, group=group,
                           device=device),
        "4-mc": mine_sharded(g, port_app("4-mc"), MC4_CAPS, group=group,
                             backend="cuda-1p", device=device),
        "3-fsm": mine_sharded(gl, port_app("3-fsm"), FSM_CAPS, group=group,
                              filter_caps=FSM_FILTER, device=device),
        "overflow": mine_sharded(g, port_app("tc"), TINY, group=group,
                                 backend="torch-ref", device=device),
        "transport": dist.get_backend(group),
    }
    ranks = [None] * dist.get_world_size(group)
    dist.all_gather_object(ranks, out, group=group)
    return ranks


@pytest.fixture(scope="module")
def four_ranks():
    return mesh.spawn(_four_ranks, 4, backend="gloo", device="cpu")


def test_four_gloo_ranks_return_jax_results(four_ranks):
    assert len(four_ranks) == 4
    tc = jax_run("tc", UNLABELED)
    mc = jax_run("4-mc", UNLABELED)
    fsm = jax_run("3-fsm", LABELED)
    for out in four_ranks:
        assert out["transport"] == "gloo"
        count, _, ovf = out["tc"]
        assert (count, ovf) == (tc[0], False)
        count, p_map, ovf = out["4-mc"]
        assert not ovf and p_map.tolist() == mc[1] and count == mc[0]
        count, codes, supports, ovf = out["3-fsm"]
        assert not ovf and count == fsm[0]
        assert codes.tolist() == fsm[2] and supports.tolist() == fsm[3]


def test_four_gloo_ranks_flag_overflow(four_ranks):
    assert all(out["overflow"][2] for out in four_ranks)


def test_four_gloo_ranks_merge_domains_as_a_union(four_ranks):
    prefixes = [out["prefixes"] for out in four_ranks]
    assert all(p[True] and p[False] for p in prefixes)
    assert prefixes[0]["differs alone"]         # the merge did something


# -- errors ------------------------------------------------------------------------


def test_sharded_fsm_requires_filter_caps():
    g = TG.erdos_renyi(10, 0.3, seed=1, labels=2, device="cpu")
    with pytest.raises(ValueError, match="filter_caps"):
        mine_sharded(g, make_fsm_app(3, min_support=1), ((64, 64),),
                     device="cpu")


def test_nccl_needs_a_card_a_rank():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="gloo"):
        mesh.rank_device("nccl", 0, cards + 1, "cuda")
    with pytest.raises(ValueError, match="gloo"):
        mesh.spawn(_four_ranks, cards + 1, backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        mesh.rank_device("nccl", 0, 1, "cpu")

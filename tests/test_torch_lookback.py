"""PyTorch port, the single-pass pruned extend (K4) and the ``cuda-1p``
backend.

``extend_pruned_1p_ref``, the plain version the wrapper runs on the CPU, is
held bit for bit against the JAX package's single-pass oracle
``fused_extend_pruned_ref`` and its Pallas kernel in interpret mode, and
against the port's own two-pass pair, on the shapes that break an
order-preserving compaction across tiles: every lane alive, none alive,
survivors straddling tiles, a survivor total past ``out_cap`` and an empty
frontier.  Then ``Miner(backend="cuda-1p")`` against JAX's
``Miner(backend="pallas")``: counts, cold and warm, and each level's
buffers over the valid prefix.  The CUDA kernel is held against the plain
version on the card by ``test_torch_gpu_kernels.py``.
"""
import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import make_cf_app as jax_make_cf_app
from repro.core import make_tc_app as jax_make_tc_app
from repro.graph import generators as G
from repro.graph.csr import pack_adjacency as jax_pack
from repro.kernels.extend_fused import (fused_extend_pruned,
                                        fused_extend_pruned_ref)
from repro_torch.core import Miner, get_backend, make_cf_app, make_tc_app
from repro_torch.core.api import PredicateSpec, resolve_kernel_predicate
from repro_torch.core.plan import plan_app_key
from repro_torch.graph import generators as TG
from repro_torch.kernels.extend_fused import ops, ref


def _jax_alive(emb_cols, u, src_slot, st, conn):
    return u >= 0


def _jax_dead(emb_cols, u, src_slot, st, conn):
    return src_slot == len(emb_cols)           # no slot has this index


def _jax_straddle(emb_cols, u, src_slot, st, conn):
    return (u >= 0) & (src_slot == 0)


PREDICATES = {
    "alive": (_jax_alive, lambda k: PredicateSpec()),
    "dead": (_jax_dead, lambda k: PredicateSpec(src_slot_eq=k)),
    "straddle": (_jax_straddle, lambda k: PredicateSpec(src_slot_eq=0)),
    "clique": (jax_make_cf_app(4).to_add_kernel,
               lambda k: resolve_kernel_predicate(make_cf_app(4), k)),
}


@functools.lru_cache(maxsize=None)
def _inputs(conn_mode, empty=False):
    """Kernel inputs as numpy: 120 random 3-vertex parents on an ER graph
    (a few thousand candidate slots, several 512-slot tiles), or none
    alive (``empty``: every parent slot is padding)."""
    g = G.erdos_renyi(60, 0.3, seed=3)
    rng = np.random.default_rng(3)
    emb = rng.integers(-1, 60, size=(120, 3)).astype(np.int32)
    if empty:
        emb[:] = -1
    rp = np.asarray(g.row_ptr)
    embc = np.clip(emb, 0, 59).reshape(-1)
    vlo, vhi = rp[embc], rp[embc + 1]
    deg = np.where(emb.reshape(-1) >= 0, vhi - vlo, 0).astype(np.int32)
    offsets = np.cumsum(deg).astype(np.int32)
    args = tuple(np.array(x, dtype=np.int32) for x in (
        g.col_idx, offsets, offsets - deg, emb.reshape(-1), vlo, vhi))
    if conn_mode == "bitmap":
        bits = np.array(jax_pack(g).words).view(np.int32).reshape(-1)
        n_words = -(-60 // 32)
    else:
        bits, n_words = np.zeros(1, np.int32), 1
    n_steps = max(1, math.ceil(math.log2(g.max_degree + 1)))
    return args, bits, dict(k=3, n_steps=n_steps, n_vertices=60,
                            n_words=n_words)


def _caps(args, tight):
    total = int(args[1][-1])
    cand_cap = max(-(-total // 256) * 256 + 256, 256)
    return cand_cap, (100 if tight else cand_cap)


@functools.lru_cache(maxsize=None)
def jax_pruned(pred, conn_mode, tight, empty, pallas):
    """JAX's single-pass oracle, or its Pallas kernel in interpret mode."""
    args, bits, kw = _inputs(conn_mode, empty)
    cand_cap, out_cap = _caps(args, tight)
    jargs = tuple(jnp.asarray(a) for a in args)
    state = jnp.zeros((120,), jnp.int32)
    common = dict(k=3, cand_cap=cand_cap, out_cap=out_cap,
                  n_steps=kw["n_steps"], pred=PREDICATES[pred][0])
    if not pallas:
        out = fused_extend_pruned_ref(*jargs, state, **common)
    else:
        out = fused_extend_pruned(
            *jargs, state, jnp.asarray(bits.view(np.uint32)),
            jnp.zeros((1,), jnp.int32), n_vertices=60,
            n_words=kw["n_words"], n_rows=60, conn_mode=conn_mode,
            block_c=ref.BLOCK_C, interpret=True, **common)
    return tuple(np.asarray(x) for x in out)


def _port_pruned(pred, conn_mode, tight, empty, fn):
    args, bits, kw = _inputs(conn_mode, empty)
    cand_cap, out_cap = _caps(args, tight)
    return fn(*map(torch.from_numpy, args), torch.from_numpy(bits),
              cand_cap=cand_cap, out_cap=out_cap,
              spec=PREDICATES[pred][1](3), conn_mode=conn_mode, **kw)


# the Pallas comparison on a few cases only: each interpret-mode trace
# costs seconds on the CPU
PALLAS_CASES = {("clique", "bitmap", False), ("straddle", "search", True),
                ("alive", "search", False)}


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "overflow"])
@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
@pytest.mark.parametrize("pred", sorted(PREDICATES))
def test_single_pass_plain_matches_jax_and_the_pair(pred, conn_mode, tight):
    ops.reset_counts()
    got = _port_pruned(pred, conn_mode, tight, False, ops.extend_pruned_1p)
    assert ops.LAUNCHES["extend_pruned_1p"] == 0       # CPU: no launch
    assert ref.extend_pruned_1p_ref.calls == 1
    row, u, n_surv = got
    assert row.dtype == u.dtype == n_surv.dtype == torch.int32
    cases = [jax_pruned(pred, conn_mode, tight, False, False)]
    if (pred, conn_mode, tight) in PALLAS_CASES:
        cases.append(jax_pruned(pred, conn_mode, tight, False, True))
    for want in cases:
        for w, o in zip(want, got):
            np.testing.assert_array_equal(w, o.numpy())
    pair = _port_pruned(pred, conn_mode, tight, False, ops.extend_pruned)
    for p, o in zip(pair[:3], got):
        assert torch.equal(p, o)
    args, _, _ = _inputs(conn_mode)
    total = int(args[1][-1])
    if pred == "dead":
        assert int(n_surv) == 0
    if pred == "alive":
        assert int(n_surv) == total
    if tight and pred in ("alive", "straddle"):
        assert int(n_surv) > 100                     # overflow reported


@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
def test_single_pass_on_an_empty_frontier(conn_mode):
    got = _port_pruned("alive", conn_mode, False, True, ops.extend_pruned_1p)
    want = jax_pruned("alive", conn_mode, False, True, False)
    for w, o in zip(want, got):
        np.testing.assert_array_equal(w, o.numpy())
    assert int(got[2]) == 0 and (got[1] == -1).all()


@pytest.mark.parametrize("piece", [300, 512, 1000])
def test_pieces_with_the_offset_carried_match_the_whole(piece):
    args, bits, kw = _inputs("search")
    cand_cap, out_cap = _caps(args, True)
    targs = (*map(torch.from_numpy, args), torch.from_numpy(bits))
    common = dict(cand_cap=cand_cap, out_cap=out_cap, spec=PredicateSpec(
        src_slot_eq=0), conn_mode="search", **kw)
    row, u, n_surv = ref.extend_pruned_1p_ref(*targs, **common)
    base = 0
    for lo in range(0, cand_cap, piece):
        hi = min(lo + piece, cand_cap)
        prow, pu, n = ref.extend_pruned_1p_ref(*targs, **common,
                                               slots=(lo, hi), base=base)
        w0, w1 = min(base, out_cap), min(int(n), out_cap)
        assert torch.equal(prow[w0:w1], row[w0:w1])
        assert torch.equal(pu[w0:w1], u[w0:w1])
        base = int(n)
    assert base == int(n_surv) > out_cap


# -- the cuda-1p backend through Miner.run ----------------------------------

GRAPHS = {"er40": (lambda: G.erdos_renyi(40, 0.3, seed=1),
                   lambda: TG.erdos_renyi(40, 0.3, seed=1, device="cpu")),
          "rmat7": (lambda: G.rmat(7, seed=0),
                    lambda: TG.rmat(7, seed=0, device="cpu"))}
APPS = {"tc": (jax_make_tc_app, make_tc_app),
        "4-cf": (lambda: jax_make_cf_app(4), lambda: make_cf_app(4)),
        "5-cf": (lambda: jax_make_cf_app(5), lambda: make_cf_app(5))}


@functools.lru_cache(maxsize=None)
def jax_levels(gname, aname):
    """JAX's pallas backend, cold: the count and each level's (vid, idx,
    n) as numpy."""
    r = JaxMiner(GRAPHS[gname][0](), APPS[aname][0](),
                 backend="pallas").run()
    return r.count, [(np.asarray(lv.vid), np.asarray(lv.idx), int(lv.n))
                     for lv in r.levels[1:]]


# JAX's pallas Miner runs its kernels in interpret mode, 5-CF the longest
@pytest.mark.parametrize("gname,aname", [
    ("er40", "tc"), ("er40", "4-cf"), ("er40", "5-cf"), ("rmat7", "tc"),
    ("rmat7", "4-cf")])
def test_cuda_1p_miner_matches_jax_pallas(gname, aname):
    want, want_levels = jax_levels(gname, aname)
    m = Miner(GRAPHS[gname][1](), APPS[aname][1](), backend="cuda-1p",
              device="cpu")
    ops.reset_counts()
    cold = m.run()
    assert cold.count == want
    levels = cold.levels[1:]
    assert len(levels) == len(want_levels) >= 1
    for lv, (vid, idx, n) in zip(levels, want_levels):
        assert int(lv.n) == n and lv.vid.shape == vid.shape
        np.testing.assert_array_equal(vid[:n], lv.vid[:n].numpy())
        np.testing.assert_array_equal(idx[:n], lv.idx[:n].numpy())
    assert m.run().count == want                      # warm: plan replay
    (ex,) = m._executors.values()
    assert ex.n_executions == 1 and ex.n_replans == 0
    calls = {f.__name__: f.calls for f in ops.PLAIN_VERSIONS}
    assert calls["extend_pruned_1p_ref"] == 2 * len(levels)
    assert calls["extend_count_ref"] == calls["extend_scatter_ref"] == 0


def test_cuda_1p_contract():
    cuda, lookback = get_backend("cuda"), get_backend("cuda-1p")
    assert (lookback.name, lookback.compaction, lookback.compaction_passes,
            lookback.grid_contract) == ("cuda-1p", "decoupled-lookback", 1,
                                        "concurrent")
    app = make_tc_app()
    assert plan_app_key(app, "cuda", True, cuda.compaction) != plan_app_key(
        app, "cuda-1p", True, lookback.compaction)
    # the compaction alone changes the key, not only the backend's name
    assert plan_app_key(app, "x", True, cuda.compaction) != plan_app_key(
        app, "x", True, lookback.compaction)
    plan_keys = ("backend", "compaction", "compaction_passes")
    for a in (None, app, make_cf_app(4), make_cf_app(3, use_dag=False,
                                                      eager_prune=False)):
        want = {k: v for k, v in cuda.capabilities(a).items()
                if k not in plan_keys}
        got = {k: v for k, v in lookback.capabilities(a).items()
               if k not in plan_keys}
        assert got == want


def test_cuda_1p_refuses_what_cuda_refuses():
    g = TG.erdos_renyi(30, 0.25, seed=2, device="cpu")
    with pytest.raises(NotImplementedError, match="fuse_filter"):
        Miner(g, make_tc_app(), backend="cuda-1p", fuse_filter=False,
              device="cpu").run()
    with pytest.raises(NotImplementedError, match="predicate spec"):
        Miner(g, make_cf_app(3, use_dag=False, eager_prune=False),
              backend="cuda-1p", device="cpu").run()
    with pytest.raises(NotImplementedError, match="state column"):
        Miner(g, dataclasses.replace(make_tc_app(),
                                     update_state_kernel=lambda *a: a[3]),
              backend="cuda-1p", device="cpu").run()
    m = Miner(g, make_tc_app(), backend="cuda-1p", device="cpu")
    m.ctx = dataclasses.replace(m.ctx, packed=dataclasses.replace(
        m.ctx.packed, full=False))
    m.ops.ctx = m.ctx
    with pytest.raises(NotImplementedError, match="partial"):
        m.run()


def test_wrapper_checks_its_inputs():
    args, bits, kw = _inputs("search")
    targs = (*map(torch.from_numpy, args), torch.from_numpy(bits))
    common = dict(cand_cap=1024, spec=PredicateSpec(), **kw)
    with pytest.raises(ValueError, match="out_cap"):
        ops.extend_pruned_1p(*targs, out_cap=0, conn_mode="search", **common)
    with pytest.raises(ValueError, match="conn_mode"):
        ops.extend_pruned_1p(*targs, out_cap=8, conn_mode="mixed", **common)
    with pytest.raises(ValueError, match="int32"):
        ops.extend_pruned_1p(*targs[:-1], targs[-1].long(), out_cap=8,
                             conn_mode="search", **common)

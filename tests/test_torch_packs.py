"""PyTorch port, the graph layer of the mixed connectivity probe: the full,
partial and core bit-packed adjacency, ``core_size``, ``pack_hit_rate``,
degree relabeling, the degree profile and the small helpers, ``make_ctx``'s
packing gates and ``GraphCtx.is_connected`` in every mode, each held equal
to the JAX package's on the same seeded inputs (passed as numpy)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import make_ctx as jax_make_ctx
from repro.graph import csr as jcsr
from repro.graph import generators as G
from repro.graph.dag import orient_dag as jax_orient
from repro.sparse.intersect import adj_contains as jax_adj_contains
from repro_torch.core.api import make_ctx
from repro_torch.graph import csr
from repro_torch.graph import generators as TG
from repro_torch.graph.dag import orient_dag
from repro_torch.sparse.intersect import adj_contains

GRAPHS = {
    **{f"rmat{s}": (functools.partial(G.rmat, s, seed=s),
                    functools.partial(TG.rmat, s, seed=s, device="cpu"))
       for s in (7, 8, 9, 10)},
    "rmat8-dag": (lambda: jax_orient(G.rmat(8, seed=1)),
                  lambda: orient_dag(TG.rmat(8, seed=1, device="cpu"))),
    "er": (lambda: G.erdos_renyi(90, 0.1, seed=4),
           lambda: TG.erdos_renyi(90, 0.1, seed=4, device="cpu")),
    "er-labeled": (lambda: G.erdos_renyi(40, 0.2, seed=5, labels=3),
                   lambda: TG.erdos_renyi(40, 0.2, seed=5, labels=3,
                                          device="cpu")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _graphs(name):
    make_jax, make_port = GRAPHS[name]
    return make_jax(), make_port()


def _budgets(n):
    """The full pack's bytes, and budgets of one row less than it, a
    quarter, two rows, one row and below one row."""
    row = -(-n // 32) * 4
    return (n * row, n * row - 1, n * row // 4, 2 * row, row, row - 1)


def _assert_same_pack(jp, tp):
    assert (jp is None) == (tp is None)
    if jp is None:
        return
    assert (tp.n_words, tp.full, tp.n_cols, tp.n_packed) == (
        jp.n_words, jp.full, jp.n_cols, jp.n_packed)
    assert tp.words.dtype == tp.row_slot.dtype == torch.int32
    np.testing.assert_array_equal(tp.row_slot.numpy(),
                                  np.asarray(jp.row_slot))
    np.testing.assert_array_equal(
        tp.words.numpy(), np.asarray(jp.words).view(np.int32))


@pytest.mark.parametrize("core", [False, True], ids=["partial", "core"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_packs_equal_jax(name, core):
    jg, tg = _graphs(name)
    for budget in _budgets(tg.n_vertices):
        jp = jcsr.pack_adjacency(jg, max_bytes=budget, core=core)
        tp = csr.pack_adjacency(tg, max_bytes=budget, core=core)
        _assert_same_pack(jp, tp)
        assert csr.pack_hit_rate(tg, tp) == jcsr.pack_hit_rate(jg, jp)


def test_pack_is_none_for_an_empty_graph_and_a_degenerate_budget():
    empty = csr.build_csr(0, np.zeros(0), np.zeros(0), device="cpu")
    assert csr.pack_adjacency(empty) is None
    assert csr.pack_hit_rate(empty, None) == 0.0
    jg, tg = _graphs("rmat7")
    row = -(-tg.n_vertices // 32) * 4
    assert csr.pack_adjacency(tg, max_bytes=row - 1) is None
    assert jcsr.pack_adjacency(jg, max_bytes=row - 1) is None
    # the core pack's degenerate budget: not one 4-byte word
    assert csr.pack_adjacency(tg, max_bytes=3, core=True) is None
    assert jcsr.pack_adjacency(jg, max_bytes=3, core=True) is None


def test_partial_pack_takes_the_highest_degree_rows():
    _, tg = _graphs("rmat9")
    pg = csr.pack_adjacency(tg, max_bytes=_budgets(tg.n_vertices)[3])
    deg = tg.degrees().numpy()
    packed = np.flatnonzero(pg.row_slot.numpy() >= 0)
    assert packed.shape[0] == pg.n_packed == 2
    assert deg[packed].min() >= np.sort(deg)[-2]
    np.testing.assert_array_equal(pg.row_slot.numpy()[packed], [0, 1])


@pytest.mark.parametrize("n,budget", [(0, 100), (100, 0), (10, 1 << 20),
                                      (1000, 4096), (65536, 134217728),
                                      (32768, 33554432), (5000, 12345)])
def test_core_size_equals_jax(n, budget):
    assert csr.core_size(n, budget) == jcsr.core_size(n, budget)


@pytest.mark.parametrize("order", ["degree", "identity"])
@pytest.mark.parametrize("name", ["rmat9", "er-labeled"])
def test_relabel_equals_jax(name, order):
    jg, tg = _graphs(name)
    jr, tr = jcsr.relabel(jg, order=order), csr.relabel(tg, order=order)
    np.testing.assert_array_equal(tr.perm, jr.perm)
    np.testing.assert_array_equal(tr.inv, jr.inv)
    g, j = tr.graph, jr.graph
    assert (g.n_vertices, g.n_edges) == (j.n_vertices, j.n_edges)
    np.testing.assert_array_equal(g.row_ptr.numpy(), np.asarray(j.row_ptr))
    np.testing.assert_array_equal(g.col_idx.numpy(), np.asarray(j.col_idx))
    assert (g.labels is None) == (j.labels is None)
    if g.labels is not None:
        np.testing.assert_array_equal(g.labels.numpy(),
                                      np.asarray(j.labels))
    with pytest.raises(ValueError, match="order"):
        csr.relabel(tg, order="random")


def test_degree_relabel_puts_the_core_first():
    _, tg = _graphs("rmat10")
    rg = csr.relabel(tg).graph
    deg = rg.degrees().numpy()
    assert (np.diff(deg) <= 0).all()
    assert deg.sum() == tg.degrees().numpy().sum()
    # the core pack of the relabeled graph answers more probes than the
    # core pack of the original labeling
    budget = _budgets(tg.n_vertices)[2]
    assert csr.pack_hit_rate(rg, csr.pack_adjacency(rg, budget, core=True)) \
        > csr.pack_hit_rate(tg, csr.pack_adjacency(tg, budget, core=True))


@pytest.mark.parametrize("name", ["rmat8", "er", "er-labeled"])
def test_degree_profile_neighbors_and_networkx_equal_jax(name):
    jg, tg = _graphs(name)
    assert csr.degree_profile(tg) == jcsr.degree_profile(jg)
    assert csr.DEGREE_QUANTILES == jcsr.DEGREE_QUANTILES
    for v in (0, 3, tg.n_vertices - 1):
        np.testing.assert_array_equal(csr.neighbors_np(tg, v),
                                      jcsr.neighbors_np(jg, v))
    tn, jn = csr.to_networkx(tg), jcsr.to_networkx(jg)
    assert sorted(tn.edges) == sorted(jn.edges)
    assert dict(tn.nodes(data=True)) == dict(jn.nodes(data=True))
    empty = csr.build_csr(0, np.zeros(0), np.zeros(0), device="cpu")
    assert csr.degree_profile(empty) == (0.0,) * len(csr.DEGREE_QUANTILES)


def test_linear_search_ablation_skips_packing():
    g = TG.erdos_renyi(20, 0.3, seed=1, device="cpu")
    assert make_ctx(g, search="linear").packed is None
    assert make_ctx(g, pack_bits=False).packed is None
    assert make_ctx(g).packed is not None
    # partial and core packs are opt-in
    n_words = -(-g.n_vertices // 32)
    assert make_ctx(g, pack_max_bytes=4 * n_words * 4).packed is None
    partial = make_ctx(g, pack_max_bytes=4 * n_words * 4,
                       pack_partial=True).packed
    assert partial is not None and not partial.full
    core = make_ctx(g, pack_max_bytes=4 * n_words * 4, pack_core=True).packed
    assert core is not None and core.n_cols < g.n_vertices
    # a full pack stays full whatever the flags ask
    assert make_ctx(g, pack_partial=True, pack_core=True).packed.full
    with pytest.raises(ValueError, match="search"):
        make_ctx(g, search="hash")


def test_partial_pack_falls_back_to_csr():
    g = TG.erdos_renyi(80, 0.1, seed=4, device="cpu")
    n_words = -(-g.n_vertices // 32)
    pg = csr.pack_adjacency(g, max_bytes=10 * n_words * 4)  # 10 rows only
    assert not pg.full and pg.n_packed == 10
    deg = g.degrees().numpy()
    packed_rows = np.flatnonzero(pg.row_slot.numpy() >= 0)
    assert deg[packed_rows].min() >= np.sort(deg)[-10:].min()
    ctx = make_ctx(g, pack_max_bytes=10 * n_words * 4, pack_partial=True)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.integers(0, 80, 2000).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, 80, 2000).astype(np.int32))
    want = adj_contains(g.row_ptr, g.col_idx, u, v, ctx.n_steps)
    assert torch.equal(ctx.is_connected(u, v), want)


CTX_MODES = {
    "full": dict(),
    "partial": dict(pack_partial=True, quarter=True),
    "core": dict(pack_core=True, quarter=True),
    "linear": dict(search="linear"),
    "none": dict(pack_bits=False),
}


@pytest.mark.parametrize("mode", sorted(CTX_MODES))
@pytest.mark.parametrize("name", ["rmat9", "rmat8-dag"])
def test_is_connected_equals_jax(name, mode):
    """Seeded random pairs, -1 padding and (for the core pack) columns past
    n_cols included, against JAX's ``GraphCtx.is_connected``."""
    jg, tg = _graphs(name)
    kw = dict(CTX_MODES[mode])
    if kw.pop("quarter", False):
        kw["pack_max_bytes"] = _budgets(tg.n_vertices)[2]
    jctx, tctx = jax_make_ctx(jg, **kw), make_ctx(tg, **kw)
    _assert_same_pack(jctx.packed, tctx.packed)
    assert tctx.search == jctx.search
    n = tg.n_vertices
    rng = np.random.default_rng(7)
    u = rng.integers(-1, n, 6000).astype(np.int32)
    v = rng.integers(-1, n, 6000).astype(np.int32)
    # every pair of an edge's endpoints too, so the hits are many
    src, dst = (x.numpy() for x in tg.edge_list())
    u = np.concatenate([u, src, dst]).astype(np.int32)
    v = np.concatenate([v, dst, src]).astype(np.int32)
    if mode == "core":
        assert tctx.packed.n_cols < n and (v >= tctx.packed.n_cols).any()
    got = tctx.is_connected(torch.from_numpy(u), torch.from_numpy(v))
    want = np.asarray(jctx.is_connected(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_array_equal(got.numpy(), want)
    csr_only = jax_adj_contains(jg.row_ptr, jg.col_idx, jnp.asarray(u),
                                jnp.asarray(v), jctx.n_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(csr_only))

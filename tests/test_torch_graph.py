"""PyTorch port, graph layer: generators, CSR arrays, DAG orientation, the
full bit-packed adjacency and the ragged primitives, each held array-equal
against the JAX package on the same seeded inputs (passed as numpy)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as G
from repro.graph.csr import from_edge_list
from repro.graph.csr import pack_adjacency as jax_pack
from repro.graph.csr import packed_contains as jax_packed_contains
from repro.graph.dag import orient_dag as jax_orient
from repro.sparse.intersect import adj_contains as jax_adj_contains
from repro.sparse.ops import compact_mask as jax_compact
from repro.sparse.ops import expand_ragged as jax_expand
from repro_torch.graph import generators as TG
from repro_torch.graph.csr import from_edge_list as port_from_edge_list
from repro_torch.graph.csr import pack_adjacency, packed_contains
from repro_torch.graph.dag import orient_dag
from repro_torch.sparse.intersect import adj_contains
from repro_torch.sparse.ops import compact_mask, expand_ragged

GRAPHS = {
    "er": (lambda: G.erdos_renyi(60, 0.15, seed=3),
           lambda: TG.erdos_renyi(60, 0.15, seed=3, device="cpu")),
    "er-labeled": (lambda: G.erdos_renyi(20, 0.3, seed=5, labels=3),
                   lambda: TG.erdos_renyi(20, 0.3, seed=5, labels=3,
                                          device="cpu")),
    "rmat": (lambda: G.rmat(7, seed=1), lambda: TG.rmat(7, seed=1,
                                                        device="cpu")),
    "clique": (lambda: G.clique(9), lambda: TG.clique(9, device="cpu")),
    "fig2": (G.paper_fig2_graph, lambda: TG.paper_fig2_graph(device="cpu")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_csr(jg, tg):
    assert (jg.n_vertices, jg.n_edges) == (tg.n_vertices, tg.n_edges)
    np.testing.assert_array_equal(_np(jg.row_ptr), _np(tg.row_ptr))
    np.testing.assert_array_equal(_np(jg.col_idx), _np(tg.col_idx))
    assert tg.row_ptr.dtype == tg.col_idx.dtype == torch.int32
    assert (jg.labels is None) == (tg.labels is None)
    if jg.labels is not None:
        np.testing.assert_array_equal(_np(jg.labels), _np(tg.labels))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_give_identical_csr(name):
    make_jax, make_port = GRAPHS[name]
    jg, tg = make_jax(), make_port()
    _assert_same_csr(jg, tg)
    assert jg.max_degree == tg.max_degree
    for js, ts in zip(jg.edge_list(), tg.edge_list()):
        np.testing.assert_array_equal(_np(js), _np(ts))
    for js, ts in zip(jg.undirected_edge_list(), tg.undirected_edge_list()):
        np.testing.assert_array_equal(_np(js), _np(ts))


EDGES = np.array([[0, 1], [1, 2], [2, 0], [3, 3], [1, 2], [4, 1]])
MORE_GRAPHS = {
    "cycle7": (lambda: G.cycle(7), lambda: TG.cycle(7, device="cpu")),
    "star6": (lambda: G.star(6), lambda: TG.star(6, device="cpu")),
    "directed": (lambda: from_edge_list(EDGES, symmetrize=False),
                 lambda: port_from_edge_list(EDGES, symmetrize=False,
                                             device="cpu")),
    "symmetric": (lambda: from_edge_list(EDGES, n_vertices=6),
                  lambda: port_from_edge_list(EDGES, n_vertices=6,
                                              device="cpu")),
}


@pytest.mark.parametrize("name", sorted(MORE_GRAPHS))
def test_cycle_star_and_directed_edge_lists_match(name):
    make_jax, make_port = MORE_GRAPHS[name]
    _assert_same_csr(make_jax(), make_port())


def test_graph_package_exports_jax_names():
    import repro_torch.graph as port_graph
    for name in ("CSRGraph", "build_csr", "from_edge_list", "orient_dag",
                 "generators"):
        assert hasattr(port_graph, name), name
    assert port_graph.generators is TG
    g = port_graph.from_edge_list(EDGES, symmetrize=False, device="cpu")
    assert g.n_edges == 4                       # no loop, no duplicate


@pytest.mark.parametrize("order", ["degree", "id"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_orient_dag_matches(name, order):
    make_jax, make_port = GRAPHS[name]
    _assert_same_csr(jax_orient(make_jax(), order),
                     orient_dag(make_port(), order))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_full_pack_words_match(name):
    make_jax, make_port = GRAPHS[name]
    jg, tg = make_jax(), make_port()
    jp, tp = jax_pack(jg), pack_adjacency(tg)
    assert jp.full and tp.full
    assert (jp.n_words, jp.n_cols, jp.n_packed) == (tp.n_words, tp.n_cols,
                                                    tp.n_packed)
    # u32 words in the JAX package, the same bit patterns as int32 here
    np.testing.assert_array_equal(np.asarray(jp.words).view(np.int32),
                                  tp.words.numpy())
    np.testing.assert_array_equal(np.asarray(jp.row_slot),
                                  tp.row_slot.numpy())
    rng = np.random.default_rng(0)
    n = jg.n_vertices
    u = rng.integers(-2, n + 2, size=400).astype(np.int32)
    v = rng.integers(-2, n + 2, size=400).astype(np.int32)
    want = np.asarray(jax_packed_contains(jp, jnp.asarray(u), jnp.asarray(v)))
    got = packed_contains(tp, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(want, got.numpy())
    want = np.asarray(jax_adj_contains(jg.row_ptr, jg.col_idx,
                                       jnp.asarray(u), jnp.asarray(v), 8))
    got = adj_contains(tg.row_ptr, tg.col_idx, torch.from_numpy(u),
                       torch.from_numpy(v), 8)
    np.testing.assert_array_equal(want, got.numpy())


def test_pack_bit31_reads_from_int32_words():
    """Vertex 31 of a row sits in the sign bit of the int32 word."""
    tg = TG.clique(33, device="cpu")
    tp = pack_adjacency(tg)
    assert int(tp.words[0, 0]) < 0                   # bit 31 set
    assert bool(packed_contains(tp, torch.tensor([0]), torch.tensor([31])))
    assert not bool(packed_contains(tp, torch.tensor([31]),
                                    torch.tensor([31])))


def test_partial_pack_is_not_ported():
    """Over budget the pack is the JAX package's partial pack, not a
    refusal: 64 bytes hold the four highest-degree rows of RMAT-7."""
    tp = pack_adjacency(TG.rmat(7, seed=1, device="cpu"), max_bytes=64)
    jp = jax_pack(G.rmat(7, seed=1), max_bytes=64)
    assert not tp.full and (tp.n_packed, tp.n_cols) == (4, 128)
    np.testing.assert_array_equal(tp.row_slot.numpy(), np.asarray(jp.row_slot))
    np.testing.assert_array_equal(tp.words.numpy(),
                                  np.asarray(jp.words).view(np.int32))


def test_entry_points_need_a_device_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.clique(5)


@pytest.mark.parametrize("seed", range(3))
def test_expand_ragged_matches(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, size=int(rng.integers(1, 40))).astype(
        np.int32)
    counts[rng.random(counts.shape[0]) < 0.3] = 0
    total = int(counts.sum())
    for capacity in (max(total // 2, 1), total + 9):
        want = jax_expand(jnp.asarray(counts), capacity)
        got = expand_ragged(torch.from_numpy(counts), capacity)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            assert g.dtype == torch.int32


def test_expand_ragged_all_zero_counts():
    parent, rank, total = expand_ragged(torch.zeros(6, dtype=torch.int32), 8)
    assert int(total) == 0
    assert (parent.numpy() == -1).all()
    assert (rank.numpy() == 0).all()


def test_expand_ragged_empty_counts():
    parent, rank, total = expand_ragged(torch.zeros(0, dtype=torch.int32), 4)
    want = jax_expand(jnp.zeros((0,), jnp.int32), 4)
    for w, g in zip(want, (parent, rank, total)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_expand_ragged_capacity_overflow_truncates():
    parent, rank, total = expand_ragged(
        torch.tensor([3, 2, 4], dtype=torch.int32), 5)
    assert int(total) == 9
    assert parent.tolist() == [0, 0, 0, 1, 1]
    assert rank.tolist() == [0, 1, 2, 0, 1]


@pytest.mark.parametrize("seed", range(4))
def test_compact_mask_matches(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(int(rng.integers(1, 60))) < 0.4
    n = int(mask.sum())
    for capacity in (max(n // 2, 1), n + 1, n + 7):
        want = jax_compact(jnp.asarray(mask), capacity)
        got = compact_mask(torch.from_numpy(mask), capacity)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_compact_mask_all_false():
    gather, n = compact_mask(torch.zeros(5, dtype=torch.bool), 4)
    assert int(n) == 0
    assert (gather.numpy() == 0).all()


def test_compact_mask_capacity_overflow_truncates():
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    gather, n = compact_mask(mask, 3)
    assert int(n) == 5
    assert gather.tolist() == [0, 2, 3]


@pytest.mark.parametrize("name", ["er-labeled", "rmat"])
def test_graph_from_jax_arrays(name):
    from repro_torch.interop import graph_from_arrays

    jg = GRAPHS[name][0]()
    labels = None if jg.labels is None else np.asarray(jg.labels)
    tg = graph_from_arrays(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                           labels=labels, device="cpu")
    _assert_same_csr(jg, tg)
    with pytest.raises(ValueError, match="row_ptr"):
        graph_from_arrays(np.asarray(jg.row_ptr),
                          np.asarray(jg.col_idx)[:-1], device="cpu")

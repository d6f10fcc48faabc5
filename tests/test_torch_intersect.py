"""PyTorch port, the intersection count (K6) and the hand-optimised TC.

The port's ``intersect_count_sorted`` and the kernel wrapper's plain
version (its CPU dispatch) are held per pair against the JAX package's
``intersect_count_sorted`` and its Pallas kernel in interpret mode, on the
cases of the JAX package's own kernel tests plus empty segments, a
``max_deg`` shorter than a segment, a one-step search, and the input
classes that the CUDA kernel's gates split (``ops.kernel_paths``): pairs
grouped by source, reversed rows, repeated neighbours, ids too wide for
its bitmap in every row or in every other row, and malformed bounds;
``triangle_count_fused`` against JAX's, with and without its kernel.  All
exact.  The CUDA kernel itself is held against the plain version on the
card by ``test_torch_gpu_kernels.py``.
"""
import functools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import triangle_count_fused as jax_triangle_count_fused
from repro.graph import generators as G
from repro.kernels.intersect import intersect_count as jax_intersect_count
from repro.sparse.intersect import (intersect_count_sorted as
                                    jax_intersect_count_sorted)
from repro_torch.core import triangle_count_fused
from repro_torch.graph import generators as TG
from repro_torch.kernels.intersect import ops, ref
from repro_torch.sparse.intersect import intersect_count_sorted

# (graph seed, n, p, n_pairs, variant): the first three are the shapes of
# the JAX package's test_intersect_kernel_shapes (n_pairs not a multiple
# of a tile), the fourth one of its property test's draws
CASES = {"shapes-100": (4, 60, 0.25, 100, "plain"),
         "shapes-700": (4, 60, 0.25, 700, "plain"),
         "shapes-513": (4, 60, 0.25, 513, "plain"),
         "er40": (7, 40, 0.3, 130, "plain"),
         "empty-segments": (4, 60, 0.25, 300, "empty"),
         "truncated": (4, 60, 0.25, 300, "truncated"),
         "one-step": (4, 60, 0.25, 300, "one-step"),
         "grouped": (4, 60, 0.25, 300, "grouped"),
         "unsorted-b": (4, 60, 0.25, 300, "unsorted-b"),
         "dup-a": (4, 60, 0.25, 300, "dup-a"),
         "wide-ids": (4, 60, 0.25, 300, "wide-ids"),
         "mixed-ids": (4, 60, 0.25, 300, "mixed-ids"),
         "malformed": (4, 60, 0.25, 300, "malformed")}
# the kernel paths (ops.PATHS) each gate-splitting case must reach
CASE_PATHS = {"grouped": {"bitmap"},
              "unsorted-b": {"bitmap", "search"},
              "dup-a": {"bitmap", "search"},
              "wide-ids": {"list"},
              "mixed-ids": {"bitmap", "list"},
              "malformed": {"empty", "search"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(col_idx, (lo_a, hi_a, lo_b, hi_b), max_deg, n_steps) as numpy."""
    seed, n, p, n_pairs, variant = CASES[name]
    g = G.erdos_renyi(n, p, seed=seed)
    rp = np.asarray(g.row_ptr)
    col = np.array(g.col_idx)
    rng = np.random.default_rng(n_pairs)
    a, b = rng.integers(0, n, n_pairs), rng.integers(0, n, n_pairs)
    if variant in ("grouped", "mixed-ids"):           # runs of equal A
        a = np.sort(a)
    bounds = [rp[a].copy(), rp[a + 1].copy(), rp[b].copy(), rp[b + 1].copy()]
    max_deg = g.max_degree
    n_steps = max(1, math.ceil(math.log2(max_deg + 1)))
    if variant == "empty":
        bounds[3][::5] = bounds[2][::5]               # empty B
        bounds[1][2::7] = bounds[0][2::7]             # empty A
    elif variant == "truncated":
        max_deg = 4                                   # A cut at 4 elements
    elif variant == "one-step":
        n_steps = 1
    elif variant == "unsorted-b":                     # rows reversed
        for v in range(0, n, 3):
            col[rp[v]:rp[v + 1]] = col[rp[v]:rp[v + 1]][::-1].copy()
    elif variant == "dup-a":                          # a repeated neighbour
        for v in range(0, n, 4):
            if rp[v + 1] - rp[v] > 2:
                col[rp[v] + 1] = col[rp[v]]
    elif variant == "wide-ids":                       # spans past 2^16 ids
        col = (1 << 20) + col * 4099
    elif variant == "mixed-ids":                      # odd rows widened
        for v in range(1, n, 2):
            col[rp[v]:rp[v + 1]] = (1 << 20) + col[rp[v]:rp[v + 1]] * 4099
    elif variant == "malformed":
        for lo, hi, at in ((0, 1, slice(0, None, 6)),
                           (2, 3, slice(3, None, 6))):
            bounds[lo][at], bounds[hi][at] = (bounds[hi][at] + 1,
                                              bounds[lo][at])
        bounds[2][1::10] -= 3                         # B from before col
        bounds[1][5::10] = col.shape[0] + 2           # A past col's end
    bounds = tuple(x.astype(np.int32) for x in bounds)
    return col.astype(np.int32), bounds, max_deg, n_steps


@functools.lru_cache(maxsize=None)
def jax_counts(name):
    """JAX's ``intersect_count_sorted`` and its Pallas kernel (interpret
    mode) on the case, as numpy."""
    col, bounds, max_deg, n_steps = _case(name)
    args = (jnp.asarray(col), *map(jnp.asarray, bounds))
    want = jax_intersect_count_sorted(*args, max_deg=max_deg,
                                      n_steps=n_steps)
    pallas = jax_intersect_count(*args, max_deg=max_deg, n_steps=n_steps,
                                 block_n=128, interpret=True)
    return np.asarray(want), np.asarray(pallas)


def _torch_args(name):
    col, bounds, max_deg, n_steps = _case(name)
    return (tuple(torch.from_numpy(x) for x in (col, *bounds)),
            dict(max_deg=max_deg, n_steps=n_steps))


@pytest.mark.parametrize("case", sorted(CASES))
def test_intersect_count_matches_jax(case):
    want, pallas = jax_counts(case)
    np.testing.assert_array_equal(want, pallas)
    args, kw = _torch_args(case)
    ops.reset_counts()
    got = ops.intersect_count(*args, **kw)
    assert ops.LAUNCHES == {"intersect_count": 0}     # CPU: no launch
    assert ref.intersect_count_ref.calls == 1         # ... one plain call
    for out in (got, intersect_count_sorted(*args, **kw)):
        assert out.dtype == torch.int32 and out.shape == want.shape
        np.testing.assert_array_equal(want, out.numpy())
    if case == "empty-segments":
        assert (want[::5] == 0).all() and (want > 0).any()
    if case in CASE_PATHS:
        paths = {ops.PATHS[i] for i in ops.kernel_paths(*args, **kw).tolist()}
        assert CASE_PATHS[case] <= paths, paths


def test_kernel_paths_name_each_gate(monkeypatch):
    """``kernel_paths`` on hand-made pairs over a sorted row, a reversed
    row and a wide one: each path, and each gate that sends a pair to the
    search."""
    col = torch.tensor([1, 3, 5, 7, 9, 8, 6, 4, 100_000], dtype=torch.int32)
    paths = {                       # (lo_a, hi_a, lo_b, hi_b): path
        (0, 3, 0, 3): "bitmap",
        (0, 9, 0, 3): "bitmap",     # max_deg 3 cuts A to [1, 3, 5]
        (0, 0, 0, 3): "empty",      # A empty
        (3, 1, 0, 3): "empty",      # A reversed: empty
        (0, 3, 3, 1): "empty",      # B reversed: empty
        (7, 9, 0, 3): "list",       # A' = [4, 100000]: too wide a span
        (4, 7, 0, 3): "search",     # A' out of order
        (0, 3, 4, 7): "search",     # B out of order
        (-1, 2, 0, 3): "search",    # A before col
        (0, 3, 7, 10): "search",    # B past col's end
        (0, 3, 0, 4): "search"}     # |B| = 4 > 2^2 - 1
    lo_a, hi_a, lo_b, hi_b = (torch.tensor(c, dtype=torch.int32)
                              for c in zip(*paths))
    kw = dict(max_deg=3, n_steps=2)
    got = ops.kernel_paths(col, lo_a, hi_a, lo_b, hi_b, **kw)
    assert [ops.PATHS[i] for i in got.tolist()] == list(paths.values())
    monkeypatch.setattr(ops, "LIST_WORDS", 1)      # A' longer than a list
    got = ops.kernel_paths(col, lo_a, hi_a, lo_b, hi_b, **kw)
    assert ops.PATHS[got[5]] == "search"


def test_kernel_limits_match_the_source():
    """``ops``' copies of the kernel's limits are the constants of
    ``csrc/intersect.cu``: a buffer of kWords words, a bitmap of
    kBits = 32 kWords ids."""
    text = ops.SOURCE.read_text()
    words = re.search(r"constexpr int kWords = (\d+);", text)
    assert words and re.search(r"constexpr int kBits = kWords \* 32;", text)
    assert ops.LIST_WORDS == int(words.group(1))
    assert ops.BITMAP_BITS == 32 * int(words.group(1))


def test_bench_inputs_keep_the_triangle_count():
    """The timing harness's four inputs on RMAT-8 hold the same pairs and
    count the same triangles; ``spread`` keeps every row strictly
    ascending and widens the ids."""
    from repro_torch.kernels.intersect import bench
    inputs, kw = bench.launch_args(8, device="cpu")
    want = int(ref.intersect_count_ref(*inputs["sorted"], **kw).sum())
    assert want == triangle_count_fused(TG.rmat(8, 16, seed=0,
                                                device="cpu"))
    for a in inputs.values():
        assert int(ref.intersect_count_ref(*a, **kw).sum()) == want
    col, spread = inputs["sorted"][0], inputs["spread"][0]
    assert int(spread.max()) > 2 * int(col.max())
    assert torch.equal(spread.argsort(stable=True), col.argsort(stable=True))
    assert not torch.equal(inputs["shuffled"][1], inputs["sorted"][1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_count_equals_the_search_where_the_gates_pass(case):
    """The kernel's fast paths count the elements of B found in A' (a
    bitmap or list membership); on every pair that ``kernel_paths`` sends
    there, that count is the plain version's search count, and an
    ``empty`` pair counts 0."""
    args, kw = _torch_args(case)
    want = ref.intersect_count_ref(*args, **kw).tolist()
    paths = ops.kernel_paths(*args, **kw).tolist()
    col = args[0].tolist()
    fast = 0
    for p, (la, ha, lb, hb) in enumerate(zip(*(t.tolist()
                                               for t in args[1:]))):
        if ops.PATHS[paths[p]] == "empty":
            assert want[p] == 0
        elif ops.PATHS[paths[p]] != "search":
            staged = set(col[la:la + min(ha - la, kw["max_deg"])])
            assert sum(b in staged for b in col[lb:hb]) == want[p]
            fast += 1
    assert fast > 0 or case == "one-step"     # there no B has 1 element


def test_plain_version_by_pair_range_matches_the_whole():
    args, kw = _torch_args("shapes-513")
    whole = ref.intersect_count_ref(*args, **kw)
    pieces = [ref.intersect_count_ref(*args, **kw, pairs=(lo, min(lo + 100,
                                                                  513)))
              for lo in range(0, 513, 100)]
    assert torch.equal(torch.cat(pieces), whole)
    with pytest.raises(ValueError, match="outside"):
        ref.intersect_count_ref(*args, **kw, pairs=(500, 600))


GRAPHS = {"er80": (lambda: G.erdos_renyi(80, 0.1, seed=0),
                   lambda: TG.erdos_renyi(80, 0.1, seed=0, device="cpu")),
          "rmat8": (lambda: G.rmat(8, seed=0),
                    lambda: TG.rmat(8, seed=0, device="cpu")),
          "clique8": (lambda: G.clique(8), lambda: TG.clique(8,
                                                            device="cpu")),
          "fig2": (G.paper_fig2_graph,
                   lambda: TG.paper_fig2_graph(device="cpu"))}


@functools.lru_cache(maxsize=None)
def jax_triangles(gname):
    g = GRAPHS[gname][0]()
    return (jax_triangle_count_fused(g),
            jax_triangle_count_fused(g, use_kernel=True, interpret=True))


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_triangle_count_fused_matches_jax(gname):
    want, want_kernel = jax_triangles(gname)
    assert want == want_kernel
    g = GRAPHS[gname][1]()
    ops.reset_counts()
    assert triangle_count_fused(g) == want            # the kernel's wrapper
    assert ops.LAUNCHES["intersect_count"] == 0
    assert ref.intersect_count_ref.calls == 1
    assert triangle_count_fused(g, use_kernel=False) == want
    assert ref.intersect_count_ref.calls == 1         # no wrapper call


def test_triangle_count_fused_on_an_edgeless_graph():
    g = TG.erdos_renyi(10, 0.0, seed=0, device="cpu")
    assert g.n_edges == 0
    assert triangle_count_fused(g) == 0
    assert jax_triangle_count_fused(G.erdos_renyi(10, 0.0, seed=0)) == 0


def test_wrapper_checks_its_inputs():
    args, kw = _torch_args("shapes-100")
    col, lo_a, hi_a, lo_b, hi_b = args
    with pytest.raises(ValueError, match="int32"):
        ops.intersect_count(col, lo_a.long(), hi_a, lo_b, hi_b, **kw)
    with pytest.raises(ValueError, match="differ in length"):
        ops.intersect_count(col, lo_a, hi_a[:-1], lo_b, hi_b, **kw)
    with pytest.raises(ValueError, match="n_steps"):
        ops.intersect_count(*args, max_deg=kw["max_deg"], n_steps=0)
    with pytest.raises(ValueError, match="empty"):
        ops.intersect_count(col[:0], lo_a, hi_a, lo_b, hi_b, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.intersect_count(*(t.to("meta") for t in args), **kw)
    with pytest.raises(ValueError, match="several devices"):
        ops.intersect_count(col.to("meta"), lo_a, hi_a, lo_b, hi_b, **kw)

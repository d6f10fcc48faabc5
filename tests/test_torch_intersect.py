"""PyTorch port, the intersection count (K6) and the hand-optimised TC.

The port's ``intersect_count_sorted`` and the kernel wrapper's plain
version (its CPU dispatch) are held per pair against the JAX package's
``intersect_count_sorted`` and its Pallas kernel in interpret mode, on the
cases of the JAX package's own kernel tests plus empty segments, a
``max_deg`` shorter than a segment and a one-step search;
``triangle_count_fused`` against JAX's, with and without its kernel.  All
exact.  The CUDA kernel itself is held against the plain version on the
card by ``test_torch_gpu_kernels.py``.
"""
import functools
import math

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
         "one-step": (4, 60, 0.25, 300, "one-step")}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(col_idx, (lo_a, hi_a, lo_b, hi_b), max_deg, n_steps) as numpy."""
    seed, n, p, n_pairs, variant = CASES[name]
    g = G.erdos_renyi(n, p, seed=seed)
    rp = np.asarray(g.row_ptr)
    rng = np.random.default_rng(n_pairs)
    a, b = rng.integers(0, n, n_pairs), rng.integers(0, n, n_pairs)
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
    bounds = tuple(x.astype(np.int32) for x in bounds)
    return np.array(g.col_idx), bounds, max_deg, n_steps


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

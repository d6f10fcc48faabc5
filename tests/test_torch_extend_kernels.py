"""PyTorch port, fused extend kernels.

On the CPU the kernel wrappers run their plain PyTorch versions; these are
held bit for bit against the JAX package's jnp oracles
(``fused_extend_ref``, ``fused_extend_pruned_mp_ref``) and against the
Pallas enumeration kernel in interpret mode, on the same seeded inputs.
The two-pass pruned pair is held against the oracle, never against the
live ``pallas-mp`` backend.  The CUDA kernels themselves are held against
these plain versions on the card by ``test_torch_gpu_kernels.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.apps.cf import make_cf_app as jax_make_cf_app
from repro.graph import generators as G
from repro.graph.csr import pack_adjacency as jax_pack
from repro.kernels.extend_fused import (fused_extend,
                                        fused_extend_pruned_mp_ref,
                                        fused_extend_ref)
from repro_torch.core.api import PredicateSpec
from repro_torch.core.apps.cf import make_cf_app
from repro_torch.core.api import resolve_kernel_predicate
from repro_torch.kernels.extend_fused import ops, ref


def _jax_inputs(g, emb):
    rp = jnp.asarray(g.row_ptr)
    embc = jnp.clip(emb, 0, g.n_vertices - 1).reshape(-1)
    vlo = rp[embc]
    vhi = rp[embc + 1]
    deg = jnp.where((emb >= 0).reshape(-1), vhi - vlo, 0).astype(jnp.int32)
    offsets = jnp.cumsum(deg)
    starts = offsets - deg
    n_steps = max(1, math.ceil(math.log2(g.max_degree + 1)))
    return (g.col_idx, offsets, starts, emb.reshape(-1), vlo, vhi), n_steps


def _torch(args, device="cpu"):
    return tuple(torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
                 for a in args)


def _case(seed, n, p, n_emb, k):
    g = G.erdos_renyi(n, p, seed=seed)
    rng = np.random.default_rng(seed)
    emb_np = rng.integers(-1, n, size=(n_emb, k)).astype(np.int32)
    args, n_steps = _jax_inputs(g, jnp.asarray(emb_np))
    return g, args, n_steps


# -- K3: unpruned enumeration -----------------------------------------------

K3_CASES = {"past-total": (6, 40, 0.25, 50, 3, +17),
            "truncated": (2, 30, 0.4, 20, 2, None),
            "k4": (4, 36, 0.3, 30, 4, +1)}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_extend_candidates_plain_matches_jax(case):
    seed, n, p, n_emb, k, extra = K3_CASES[case]
    g, args, n_steps = _case(seed, n, p, n_emb, k)
    total = int(args[1][-1])
    cand_cap = total + extra if extra is not None else max(total // 2, 8)
    kw = dict(k=k, cand_cap=cand_cap, n_steps=n_steps)
    want = fused_extend_ref(*args, **kw)
    calls = ref.extend_candidates_ref.calls
    got = ops.extend_candidates(*_torch(args), **kw)
    assert ref.extend_candidates_ref.calls == calls + 1
    for w, o in zip(want, got):
        assert o.dtype == torch.int32 and o.shape == (cand_cap,)
        np.testing.assert_array_equal(np.asarray(w), o.numpy())
    if case == "past-total":
        # the Pallas kernel in interpret mode, over the live prefix (one
        # case: each interpret-mode trace costs seconds on the CPU)
        pallas = fused_extend(*args, **kw, block_c=128, interpret=True)
        live = min(total, cand_cap)
        for pa, o in zip(pallas, got):
            np.testing.assert_array_equal(np.asarray(pa)[:live],
                                          o.numpy()[:live])


# -- K2: the two-pass pruned pair -------------------------------------------
#
# The shapes that break a concurrent compaction are tile-boundary ones:
# every lane alive, none alive, runs straddling tiles, and totals past
# out_cap.  Each case pairs a JAX predicate with the spec that expresses it.

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
    "clique-nodag": (jax_make_cf_app(4, use_dag=False).to_add_kernel,
                     lambda k: resolve_kernel_predicate(
                         make_cf_app(4, use_dag=False), k)),
}


def _pruned_case(seed, conn_mode):
    g, args, n_steps = _case(seed, 60, 0.3, 120, 3)
    if conn_mode == "bitmap":
        bits = np.array(jax_pack(g).words).view(np.int32).reshape(-1)
        n_words = -(-g.n_vertices // 32)
    else:
        bits, n_words = np.zeros(1, np.int32), 1
    return g, args, n_steps, bits, n_words


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "overflow"])
@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
@pytest.mark.parametrize("pred", sorted(PREDICATES))
def test_extend_pruned_plain_matches_mp_oracle(pred, conn_mode, tight):
    g, args, n_steps, bits, n_words = _pruned_case(3, conn_mode)
    total = int(args[1][-1])
    assert total > 4 * ref.BLOCK_C                 # several tiles
    cand_cap = -(-total // 256) * 256 + 256
    out_cap = 100 if tight else cand_cap
    jax_pred, make_spec = PREDICATES[pred]
    state = jnp.zeros((120,), jnp.int32)
    want = fused_extend_pruned_mp_ref(
        *args, state, k=3, cand_cap=cand_cap, out_cap=out_cap,
        n_steps=n_steps, pred=jax_pred, block_c=ref.BLOCK_C)
    got = ops.extend_pruned(
        *_torch(args), torch.from_numpy(bits), k=3, cand_cap=cand_cap,
        out_cap=out_cap, n_steps=n_steps, n_vertices=g.n_vertices,
        n_words=n_words, spec=make_spec(3), conn_mode=conn_mode)
    row_w, u_w, n_w, tiles_w = (np.asarray(x) for x in want)
    row, u, n_surv, tiles = got
    np.testing.assert_array_equal(tiles_w, tiles.numpy())
    assert int(n_w) == int(n_surv)
    np.testing.assert_array_equal(row_w, row.numpy())
    np.testing.assert_array_equal(u_w, u.numpy())
    if pred == "dead":
        assert int(n_surv) == 0
    if pred == "alive":
        assert int(n_surv) == total
    if tight and pred in ("alive", "straddle"):
        assert int(n_surv) > out_cap                 # overflow reported


def test_scatter_writes_only_below_out_cap():
    """Pass 2 drops survivors at or past out_cap, leaving the fill."""
    g, args, n_steps, bits, n_words = _pruned_case(1, "search")
    targs = _torch(args)
    kw = dict(k=3, cand_cap=8192, n_steps=n_steps, n_vertices=g.n_vertices,
              n_words=n_words, spec=PredicateSpec(), conn_mode="search")
    counts = ops.extend_count(*targs, torch.from_numpy(bits), **kw)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    row, u = ops.extend_scatter(*targs, torch.from_numpy(bits),
                                incl - counts, out_cap=7, **kw)
    full_row, full_u = ops.extend_scatter(*targs, torch.from_numpy(bits),
                                          incl - counts, out_cap=8192, **kw)
    assert torch.equal(row, full_row[:7]) and torch.equal(u, full_u[:7])
    n = int(incl[-1])
    assert (full_u[n:] == -1).all() and (full_row[n:] == 0).all()


def test_wrappers_check_their_inputs():
    g, args, n_steps, bits, n_words = _pruned_case(1, "search")
    targs = list(_torch(args))
    kw = dict(k=3, cand_cap=1024, n_steps=n_steps)
    with pytest.raises(ValueError, match="int32"):
        ops.extend_candidates(*targs[:-1], targs[-1].long(), **kw)
    with pytest.raises(ValueError, match="multiple of k"):
        ops.extend_candidates(*targs, k=7, cand_cap=1024, n_steps=n_steps)
    with pytest.raises(ValueError, match="full pack"):
        ops.extend_count(*targs, torch.from_numpy(bits), conn_mode="bitmap",
                         n_vertices=g.n_vertices, n_words=2,
                         spec=PredicateSpec(), **kw)
    with pytest.raises(ValueError, match="bases"):
        ops.extend_scatter(*targs, torch.from_numpy(bits),
                           torch.zeros(3, dtype=torch.int32), out_cap=8,
                           conn_mode="search", n_vertices=g.n_vertices,
                           n_words=1, spec=PredicateSpec(), **kw)


def test_cpu_dispatch_counts_no_launch():
    g, args, n_steps, bits, n_words = _pruned_case(1, "bitmap")
    ops.reset_counts()
    ops.extend_pruned(*_torch(args), torch.from_numpy(bits), k=3,
                      cand_cap=4096, out_cap=512, n_steps=n_steps,
                      n_vertices=g.n_vertices, n_words=n_words,
                      spec=PredicateSpec(), conn_mode="bitmap")
    assert set(ops.LAUNCHES.values()) == {0}
    assert {f.__name__: f.calls for f in ops.PLAIN_VERSIONS} == {
        "extend_candidates_ref": 0, "extend_count_ref": 1,
        "extend_scatter_ref": 1, "extend_edge_ref": 0,
        "extend_pruned_1p_ref": 0}


@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
def test_plain_versions_by_slot_range_match_the_whole(conn_mode):
    """A slot range of a plain version gives exactly that range's share of
    the whole launch (how the smoke script checks launches too large for
    the plain version's temporaries)."""
    g, args, n_steps, bits, n_words = _pruned_case(3, conn_mode)
    targs, b = _torch(args), torch.from_numpy(bits)
    total = int(args[1][-1])
    cand_cap = -(-total // ref.BLOCK_C) * ref.BLOCK_C + 300   # partial tile
    kw = dict(k=3, cand_cap=cand_cap, n_steps=n_steps)
    whole = ref.extend_candidates_ref(*targs, **kw)
    cuts = [0, 700, 1536, cand_cap]
    pieces = [ref.extend_candidates_ref(*targs, **kw, slots=(lo, hi))
              for lo, hi in zip(cuts, cuts[1:])]
    for j, w in enumerate(whole):
        assert torch.equal(torch.cat([p[j] for p in pieces]), w)

    kw.update(n_vertices=g.n_vertices, n_words=n_words, conn_mode=conn_mode,
              spec=resolve_kernel_predicate(make_cf_app(4), 3))
    cuts = [0, 1024, 2048, cand_cap]
    counts = ref.extend_count_ref(*targs, b, **kw)
    assert torch.equal(torch.cat([
        ref.extend_count_ref(*targs, b, **kw, slots=(lo, hi))
        for lo, hi in zip(cuts, cuts[1:])]), counts)
    with pytest.raises(ValueError, match="tile-aligned"):
        ref.extend_count_ref(*targs, b, **kw, slots=(0, 700))

    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    bases = incl - counts
    for out_cap in (int(incl[-1]) + 64, max(int(incl[-1]) // 2, 1)):
        row, u = ref.extend_scatter_ref(*targs, b, bases, out_cap=out_cap,
                                        **kw)
        for lo, hi in zip(cuts, cuts[1:]):
            prow, pu = ref.extend_scatter_ref(*targs, b, bases,
                                              out_cap=out_cap, **kw,
                                              slots=(lo, hi))
            w0 = min(int(bases[lo // ref.BLOCK_C]), out_cap)
            w1 = (min(int(bases[hi // ref.BLOCK_C]), out_cap)
                  if hi < cand_cap else out_cap)
            assert torch.equal(prow[w0:w1], row[w0:w1])
            assert torch.equal(pu[w0:w1], u[w0:w1])
            outside = torch.ones(out_cap, dtype=torch.bool)
            outside[w0:w1] = False
            assert (prow[outside] == 0).all() and (pu[outside] == -1).all()

"""PyTorch port, the edge-induced path below the engine: the edge kernel's
plain version (K5), the edge EXTEND ops of both port backends, and the FSM
reduce and filter, each held against the JAX package on the CPU.

K5's plain version is held on every lane, dead ones included, against the
JAX oracle ``fused_extend_edge_ref`` and the Pallas kernel
``fused_extend_edge_pallas`` in interpret mode.  The CUDA kernel itself is
held against the plain version on the card by ``test_torch_gpu_kernels.py``
and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import make_fsm_app as jax_make_fsm_app
from repro.core.api import make_ctx as jax_make_ctx
from repro.core.embedding_list import EmbeddingLevel as JaxLevel
from repro.core.engine import _EdgePipeline as JaxEdgePipeline
from repro.core.engine import _PhaseOps as JaxPhaseOps
from repro.core.engine import run_level_loop
from repro.core.embedding_list import materialize_edges as jax_materialize
from repro.core.phases import get_backend as jax_backend
from repro.core.phases import reference as jax_ref
from repro.core.plan import HostCapPolicy as JaxHostCapPolicy
from repro.graph import generators as G
from repro.kernels.extend_fused import (fused_extend_edge,
                                        fused_extend_edge_ref)
from repro_torch.core import Miner, get_backend, make_fsm_app
from repro_torch.core.embedding_list import EmbeddingLevel, materialize_edges
from repro_torch.core.phases import reference as port_ref
from repro_torch.graph import generators as TG
from repro_torch.kernels.extend_fused import ops, ref


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


# -- K5: the edge kernel's plain version ------------------------------------

def _k5_case(E: int, with_vmask: bool, seed: int = 3):
    """Seeded K5 inputs on a labeled ER graph: random embedding rows of E
    edge uids and E+1 vertex slots, some slots masked to zero degree."""
    g = G.erdos_renyi(40, 0.2, seed=seed)
    ctx = jax_make_ctx(g, with_edge_uids=True)
    rng = np.random.default_rng(seed + E)
    cap, n_slots = 30, E + 1
    n = g.n_vertices
    slots = rng.integers(0, n, size=cap * n_slots).astype(np.int32)
    rp = np.asarray(g.row_ptr)
    deg = (rp[slots + 1] - rp[slots]) * (rng.random(slots.shape) < 0.7)
    offsets = np.cumsum(deg).astype(np.int32)
    eids = rng.integers(-1, ctx.n_uedges, size=cap * E).astype(np.int32)
    vmask = ((rng.random(n) < 0.6).astype(np.int32) if with_vmask
             else None)
    args = (np.asarray(g.col_idx), np.asarray(ctx.edge_uid), offsets,
            offsets - deg.astype(np.int32), slots, rp[slots].astype(np.int32),
            eids, np.asarray(ctx.usrc), np.asarray(ctx.udst), vmask)
    kw = dict(n_slots=n_slots, n_uedges=ctx.n_uedges, n_vertices=n)
    return args, kw, int(offsets[-1])


@pytest.mark.parametrize("cap_case", ["past-total", "below-total"])
@pytest.mark.parametrize("with_vmask", [False, True], ids=["nomask", "vmask"])
@pytest.mark.parametrize("E", [1, 2, 3])
def test_extend_edge_plain_matches_jax_on_every_lane(E, with_vmask,
                                                     cap_case):
    args, kw, total = _k5_case(E, with_vmask)
    cand_cap = total + 37 if cap_case == "past-total" else total * 2 // 3
    jargs = tuple(None if a is None else jnp.asarray(a) for a in args)
    want = fused_extend_edge_ref(*jargs, cand_cap=cand_cap, **kw)
    pallas = fused_extend_edge(*jargs, cand_cap=cand_cap, block_c=128,
                               interpret=True, **kw)
    calls = ref.extend_edge_ref.calls
    got = ops.extend_edge(*(None if a is None else _t(a) for a in args),
                          cand_cap=cand_cap, **kw)
    assert ref.extend_edge_ref.calls == calls + 1
    assert sum(np.asarray(want[4])) > 0
    for w, pa, o in zip(want, pallas, got):
        assert o.dtype == torch.int32 and o.shape == (cand_cap,)
        np.testing.assert_array_equal(np.asarray(w), o.numpy())
        np.testing.assert_array_equal(np.asarray(pa), o.numpy())


def test_extend_edge_plain_by_slot_range_matches_the_whole():
    args, kw, total = _k5_case(2, True)
    targs = tuple(None if a is None else _t(a) for a in args)
    cand_cap = total + 100
    whole = ref.extend_edge_ref(*targs, cand_cap=cand_cap, **kw)
    for lo, hi in ((0, 64), (64, total), (total - 5, cand_cap)):
        piece = ref.extend_edge_ref(*targs, cand_cap=cand_cap, slots=(lo, hi),
                                    **kw)
        for w, p in zip(whole, piece):
            assert torch.equal(w[lo:hi], p)


def test_extend_edge_wrapper_refuses_bad_tables():
    args, kw, total = _k5_case(2, False)
    targs = [None if a is None else _t(a) for a in args]
    with pytest.raises(ValueError, match="n_slots"):
        ops.extend_edge(*targs, cand_cap=total, **{**kw, "n_slots": 9})
    bad = list(targs)
    bad[6] = bad[6][:-1]
    with pytest.raises(ValueError, match="eids_flat"):
        ops.extend_edge(*bad, cand_cap=total, **kw)
    bad = list(targs)
    bad[2] = bad[2].long()
    with pytest.raises(ValueError, match="int32"):
        ops.extend_edge(*bad, cand_cap=total, **kw)


# -- edge EXTEND, REDUCE and FILTER against the JAX backends ----------------

@functools.lru_cache(maxsize=None)
def jax_levels():
    """The three edge levels of 4-FSM at min_support 0 on a labeled ER
    graph (no embedding is dropped), from the JAX reference pipeline."""
    g = G.erdos_renyi(14, 0.3, seed=5, labels=3)
    app = jax_make_fsm_app(4, 0, max_patterns=64)
    m = JaxMiner(g, app)
    pipe = JaxEdgePipeline(JaxPhaseOps(m.ctx, app, jax_backend("reference"),
                                       jit=True))
    run_level_loop(pipe, JaxHostCapPolicy())
    return m.ctx, pipe.levels


def _port_ctx():
    return Miner(TG.erdos_renyi(14, 0.3, seed=5, labels=3, device="cpu"),
                 make_fsm_app(3, 0), device="cpu").ctx


def _to_port(levels):
    def col(a):
        return None if a is None else _t(np.asarray(a))
    return [EmbeddingLevel(vid=col(lv.vid), idx=col(lv.idx),
                           n=torch.tensor(int(lv.n), dtype=torch.int32),
                           his=col(lv.his), eid=col(lv.eid))
            for lv in levels]


def _assert_levels_equal(jax_levels_, port_levels):
    assert len(jax_levels_) == len(port_levels)
    for jl, pl in zip(jax_levels_, port_levels):
        assert int(jl.n) == int(pl.n)
        for name in ("vid", "idx", "his", "eid"):
            np.testing.assert_array_equal(np.asarray(getattr(jl, name)),
                                          getattr(pl, name).numpy())


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@pytest.mark.parametrize("n_levels", [1, 2])
def test_edge_extend_ops_match_jax(n_levels, backend):
    jctx, jlevels = jax_levels()
    jlevels = jlevels[:n_levels]
    app = jax_make_fsm_app(3, 2)
    front = jax_materialize(jlevels)
    n = jlevels[-1].n
    jbe = jax_backend("reference")
    bound = int(jbe.candidate_bound_edge(jctx, app, *front[:3], n))
    cand_cap = 1 << max(bound - 1, 1).bit_length()
    total, n_surv = jbe.inspect_edge(jctx, app, *front, n, cand_cap)
    jlevel, jtotal = jbe.extend_edge(jctx, app, *front, n, cand_cap, 256)

    ctx, papp = _port_ctx(), make_fsm_app(3, 2)
    be = get_backend(backend)
    pfront = materialize_edges(_to_port(jlevels))
    pn = torch.tensor(int(n), dtype=torch.int32)
    ops.reset_counts()
    assert int(be.candidate_bound_edge(ctx, papp, *pfront[:3], pn)) == bound
    got = be.inspect_edge(ctx, papp, *pfront, pn, cand_cap)
    assert (int(got[0]), int(got[1])) == (int(total), int(n_surv))
    level, ptotal = be.extend_edge(ctx, papp, *pfront, pn, cand_cap, 256)
    assert int(ptotal) == int(jtotal)
    _assert_levels_equal([jlevel], [level])
    # the cuda backend enumerates through the kernel wrapper (its plain
    # version on the CPU), the plain backend does not
    want = 2 if backend == "cuda" else 0
    assert ops.LAUNCHES["extend_edge"] == 0
    assert ref.extend_edge_ref.calls == want


@pytest.mark.parametrize("max_patterns", [3, 7, 64])
@pytest.mark.parametrize("n_levels", [1, 2, 3])
def test_reduce_domain_and_filter_match_jax(n_levels, max_patterns):
    jctx, jlevels = jax_levels()
    jlevels = jlevels[:n_levels]
    app = jax_make_fsm_app(n_levels + 1, 2, max_patterns=max_patterns)
    want = jax_ref.reduce_domain(jctx, app, jlevels)
    ctx = _port_ctx()
    papp = make_fsm_app(n_levels + 1, 2, max_patterns=max_patterns)
    plevels = _to_port(jlevels)
    got = port_ref.reduce_domain(ctx, papp, plevels)
    for w, o in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), o.numpy())
    if max_patterns == 3:        # the table is truncated
        assert int(np.asarray(want[2]).max()) >= max_patterns
    # the pipeline's filter: rows of patterns below min_support go
    codes, supports, pat, _ = want
    keep = supports[jnp.clip(pat, 0, max_patterns - 1)] >= 2
    out_cap = 128
    jf = jax_ref.filter_levels(jlevels, keep, out_cap)
    pf = get_backend("cuda").filter_levels(plevels, _t(np.asarray(keep))
                                           .bool(), out_cap)
    _assert_levels_equal(jf, pf)


def test_reduce_domain_of_an_empty_level():
    jctx, jlevels = jax_levels()
    dead = [jlevels[0], JaxLevel(vid=jnp.full((128,), -1, jnp.int32),
                                 idx=jnp.zeros((128,), jnp.int32),
                                 n=jnp.int32(0),
                                 his=jnp.zeros((128,), jnp.int32),
                                 eid=jnp.full((128,), -1, jnp.int32))]
    app = jax_make_fsm_app(3, 2)
    want = jax_ref.reduce_domain(jctx, app, dead)
    got = port_ref.reduce_domain(_port_ctx(), make_fsm_app(3, 2),
                                 _to_port(dead))
    for w, o in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), o.numpy())

"""PyTorch port, K1's ``mixed`` connectivity probe (a partial or core pack
in K2 and K4) and the Miner options that build those packs.

The plain versions the wrappers run on the CPU are held bit for bit in
``mixed`` mode against their own ``search`` and ``bitmap`` outputs and the
JAX package's oracles (``fused_extend_pruned_ref``,
``fused_extend_pruned_mp_ref``) for every spec kind, state included, and
once against JAX's pallas kernel in interpret mode with a partial pack.
Then ``Miner`` with ``pack_partial=True`` or ``relabel=True`` on
``torch-ref``, ``cuda`` and ``cuda-1p`` (plain versions on the CPU)
against JAX's ``Miner`` under the same options: counts, p_maps, FSM
supports and the levels bit for bit.  The CUDA kernels are held against
these plain versions on the card by ``test_torch_gpu_kernels.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import make_cf_app as jax_make_cf_app
from repro.core import make_fsm_app as jax_make_fsm_app
from repro.core import make_mc_app as jax_make_mc_app
from repro.core.api import is_auto_canonical_kernel
from repro.graph import generators as G
from repro.graph.csr import pack_adjacency as jax_pack
from repro.kernels.extend_fused import fused_extend_pruned
from repro_torch.core import (Miner, make_cf_app, make_fsm_app, make_mc_app,
                              make_tc_app)
from repro_torch.core.api import CANONICAL
from repro_torch.graph import generators as TG
from repro_torch.kernels.extend_fused import ops
from test_torch_state_kernels import (N, VARIANTS, _caps, _inputs, _variant,
                                      jax_oracle)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch CPU ops run on one thread.  The suite runs in
    several worker processes at once, and each one's OpenMP pool of a
    thread per core oversubscribes the cores: six concurrent runs of
    ``test_torch_mixed.py`` on an 8-core CPU took over 900 s with the
    default pools and 91 s with one thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# a partial pack of 10 of the 40 rows, and a core pack of rows and columns
# [0, 32), of the kernel-input graph (2 words a row)
PACKS = {"partial": (80, False), "core": (160, True)}


@functools.lru_cache(maxsize=None)
def _mixed_pack(pack):
    """(bits, row_slot, n_rows, n_cols, n_words) of the inputs' graph."""
    budget, core = PACKS[pack]
    pg = jax_pack(G.erdos_renyi(N, 0.25, seed=6, labels=3), max_bytes=budget,
                  core=core)
    assert not pg.full
    return (np.asarray(pg.words).view(np.int32).reshape(-1),
            np.asarray(pg.row_slot), pg.n_packed, pg.n_cols, pg.n_words)


def _port(variant, conn_mode, tight, fn):
    k, spec, _, _, labeled = _variant(variant)
    args, bits, state, labels, kw = _inputs(k, conn_mode)
    cand_cap, out_cap = _caps(args, tight)
    return fn(*map(torch.from_numpy, args), torch.from_numpy(bits), k=k,
              cand_cap=cand_cap, out_cap=out_cap, spec=spec,
              conn_mode=conn_mode,
              state=(torch.from_numpy(state) if spec.kind == "branches"
                     else None),
              labels=torch.from_numpy(labels) if labeled else None, **kw)


def _mixed(variant, pack, tight, fn):
    k, spec, _, _, labeled = _variant(variant)
    args, _, state, labels, kw = _inputs(k, "search")
    bits, row_slot, n_rows, n_cols, n_words = _mixed_pack(pack)
    cand_cap, out_cap = _caps(args, tight)
    return fn(*map(torch.from_numpy, args), torch.from_numpy(bits), k=k,
              cand_cap=cand_cap, out_cap=out_cap, spec=spec,
              conn_mode="mixed", row_slot=torch.from_numpy(row_slot),
              n_rows=n_rows, n_cols=n_cols,
              state=(torch.from_numpy(state) if spec.kind == "branches"
                     else None),
              labels=torch.from_numpy(labels) if labeled else None,
              **{**kw, "n_words": n_words})


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "overflow"])
@pytest.mark.parametrize("pack", sorted(PACKS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_mixed_plain_versions_equal_jax_and_the_other_modes(variant, pack,
                                                            tight):
    ops.reset_counts()
    pair = _mixed(variant, pack, tight, ops.extend_pruned)
    one = _mixed(variant, pack, tight, ops.extend_pruned_1p)
    _assert_equal(pair, jax_oracle(variant, tight, two_pass=True))
    _assert_equal(one, jax_oracle(variant, tight, two_pass=False))
    for mode in ("search", "bitmap"):
        _assert_equal(one, _port(variant, mode, tight, ops.extend_pruned_1p))
        _assert_equal(pair, _port(variant, mode, tight, ops.extend_pruned))
    # on the CPU the wrappers ran their plain versions, and no kernel
    assert sum(ops.LAUNCHES.values()) == 0
    assert ops.mode_launches() == {"search": 0, "bitmap": 0, "mixed": 0}


def test_core_pack_lanes_past_its_columns_take_the_csr():
    """The core pack covers columns [0, 32) of 40: candidates u >= 32 are
    answered by the CSR search, and their survivors are kept."""
    bits, row_slot, n_rows, n_cols, _ = _mixed_pack("core")
    assert (n_rows, n_cols) == (32, 32)
    row, u, n = _mixed("conjunction", "core", False, ops.extend_pruned_1p)
    assert (u[:int(n)] >= n_cols).any()


def test_mixed_plain_version_equals_pallas_in_interpret_mode():
    """One tiny launch against JAX's single-pass pallas kernel, interpreted,
    in mixed mode with a partial pack of 12 rows."""
    g = G.erdos_renyi(40, 0.25, seed=6)
    rng = np.random.default_rng(0)
    emb = rng.integers(0, 40, size=(50, 3)).astype(np.int32)
    rp = np.asarray(g.row_ptr)
    vlo, vhi = rp[emb.reshape(-1)], rp[emb.reshape(-1) + 1]
    deg = (vhi - vlo).astype(np.int32)
    offsets = np.cumsum(deg).astype(np.int32)
    args = tuple(np.ascontiguousarray(x, dtype=np.int32) for x in (
        g.col_idx, offsets, offsets - deg, emb.reshape(-1), vlo, vhi))
    n_steps = int(np.ceil(np.log2(g.max_degree + 1)))
    pg = jax_pack(g, max_bytes=12 * 2 * 4)
    assert not pg.full and pg.n_packed == 12
    kw = dict(k=3, cand_cap=int(offsets[-1]) + 17, out_cap=256,
              n_steps=n_steps)
    want = fused_extend_pruned(
        *map(jnp.asarray, args), jnp.zeros((50,), jnp.int32),
        pg.words.reshape(-1), pg.row_slot, n_vertices=40, n_words=2,
        n_rows=12, pred=is_auto_canonical_kernel, conn_mode="mixed",
        interpret=True, block_c=128, **kw)
    got = ops.extend_pruned_1p(
        *map(torch.from_numpy, args),
        torch.from_numpy(np.asarray(pg.words).view(np.int32).reshape(-1)),
        n_vertices=40, n_words=2, spec=CANONICAL, conn_mode="mixed",
        row_slot=torch.from_numpy(np.asarray(pg.row_slot)), n_rows=12,
        n_cols=40, **kw)
    _assert_equal(got, want)
    assert int(got[-1]) > 0


# ---------------------------------------------------------------------------
# Miner with partial and core packs

# a quarter of the full pack: 16 of the 64 rows, or rows and columns
# [0, 32) of the relabeled graph
OPTIONS = {
    "partial": dict(pack_partial=True, pack_max_bytes=128),
    "relabel": dict(relabel=True, pack_max_bytes=128),
}
APPS = {"4-cf": (lambda: make_cf_app(4), lambda: jax_make_cf_app(4)),
        "4-mc": (lambda: make_mc_app(4), lambda: jax_make_mc_app(4))}


def _graph(port: bool):
    return (TG.rmat(6, 8, seed=3, device="cpu") if port
            else G.rmat(6, 8, seed=3))


@functools.lru_cache(maxsize=None)
def jax_run(aname, opts):
    """JAX's reference Miner, cold: (count, p_map, [(n, vid, idx)])."""
    r = JaxMiner(_graph(False), APPS[aname][1](), backend="reference",
                 **OPTIONS.get(opts, {})).run()
    levels = [(int(lv.n), np.asarray(lv.vid), np.asarray(lv.idx))
              for lv in r.levels]
    return r.count, None if r.p_map is None else np.asarray(r.p_map), levels


@pytest.mark.parametrize("backend", ["torch-ref", "cuda", "cuda-1p"])
@pytest.mark.parametrize("opts", sorted(OPTIONS))
@pytest.mark.parametrize("aname", sorted(APPS))
def test_packed_miner_equals_jax(aname, opts, backend):
    m = Miner(_graph(True), APPS[aname][0](), backend=backend, device="cpu",
              **OPTIONS[opts])
    pg = m.ctx.packed
    assert pg is not None and not pg.full
    assert (pg.n_cols < m.ctx.n_vertices) == (opts == "relabel")
    count, p_map, levels = jax_run(aname, opts)
    cold = m.run()
    assert cold.count == m.run().count == count
    # no option changes a count
    assert Miner(_graph(True), APPS[aname][0](), backend=backend,
                 device="cpu").run().count == count
    if p_map is not None:
        np.testing.assert_array_equal(cold.p_map, p_map)
    for lv, (n, vid, idx) in zip(cold.levels, levels):
        assert int(lv.n) == n
        np.testing.assert_array_equal(lv.vid.numpy()[:n], vid[:n])
        np.testing.assert_array_equal(lv.idx.numpy()[:n], idx[:n])
    jm = JaxMiner(_graph(False), APPS[aname][1](), **OPTIONS[opts])
    assert m.pack_hit_rate() == jm.pack_hit_rate()
    assert m.graph_digest() == jm.graph_digest()  # the relabeled DAG's


@pytest.mark.parametrize("backend", ["cuda", "cuda-1p"])
def test_unfused_filter_equals_fused(backend):
    for aname in ("4-cf", "4-mc"):
        for opts in ({}, OPTIONS["partial"]):
            runs = [Miner(_graph(True), APPS[aname][0](), backend=backend,
                          fuse_filter=fuse, device="cpu", **opts).run()
                    for fuse in (True, False)]
            assert runs[0].count == runs[1].count
            if runs[0].p_map is not None:
                np.testing.assert_array_equal(runs[0].p_map, runs[1].p_map)
            for a, b in zip(runs[0].levels, runs[1].levels):
                n = int(a.n)
                assert n == int(b.n)
                assert torch.equal(a.vid[:n], b.vid[:n])
                assert torch.equal(a.idx[:n], b.idx[:n])


@functools.lru_cache(maxsize=None)
def jax_fsm():
    r = JaxMiner(G.erdos_renyi(30, 0.2, seed=5, labels=3),
                 jax_make_fsm_app(3, 2), relabel=True).run()
    return r.count, np.asarray(r.codes), np.asarray(r.supports)


@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
def test_relabeled_fsm_equals_jax(backend):
    g = TG.erdos_renyi(30, 0.2, seed=5, labels=3, device="cpu")
    m = Miner(g, make_fsm_app(3, 2), backend=backend, relabel=True,
              device="cpu")
    assert m.relabeling is not None and m.graph_in is m.relabeling.graph
    plain = Miner(g, make_fsm_app(3, 2), backend=backend,
                  device="cpu").run()
    count, codes, supports = jax_fsm()
    for r in (m.run(), plain):           # relabeling changes no result
        assert r.count == count
        np.testing.assert_array_equal(r.codes, codes)
        np.testing.assert_array_equal(r.supports, supports)


def test_linear_search_miner_counts_as_binary():
    g = TG.rmat(8, 8, seed=3, device="cpu")
    for make in (make_tc_app, lambda: make_mc_app(3)):
        binary = Miner(g, make(), backend="torch-ref", device="cpu").run()
        m = Miner(g, make(), backend="torch-ref", search="linear",
                  device="cpu")
        assert m.ctx.packed is None and m.ctx.search == "linear"
        assert m.pack_hit_rate() is None
        assert m.run().count == binary.count

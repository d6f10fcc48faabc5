"""PyTorch port, the state, canonical and labeled variants of the pruned
extend (K1 stage of K2 and K4).

The plain versions the wrappers run on the CPU (``extend_count_ref``,
``extend_scatter_ref``, ``extend_pruned_1p_ref``) are held bit for bit
against the JAX package's oracles ``fused_extend_pruned_ref`` (one pass)
and ``fused_extend_pruned_mp_ref`` (two passes, with their tile counts),
with the matching JAX ``pred`` and ``state_upd``, for every spec kind: a
compiled pattern's conjunction (forbidden slots), its labeled form, the
canonical test, and pattern-set trie levels whose bitmap is the compacted
state column (4-motif counting and a directed set with ``first_pair``);
in ``bitmap`` and ``search`` modes, with room to spare and overflowing.
Then the three repairs of the engine and the ``cuda`` backend that a
state-carrying app needs: inspection sees the parents' state,
``to_extend_state`` takes precedence, and the state threads from level to
level.  The CUDA kernels are held against these plain versions on the card
by ``test_torch_gpu_kernels.py``.
"""
import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import make_mc_app as jax_make_mc_app
from repro.core.api import is_auto_canonical_kernel
from repro.core.apps import psm as jax_psm
from repro.core.patterns import Pattern as JaxPattern
from repro.core.patterns import compile_pattern as jax_compile_pattern
from repro.core.patterns import compile_pattern_set as jax_compile_set
from repro.core.phases import reference as jax_ref_phases
from repro.core.api import make_ctx as jax_make_ctx
from repro.graph import generators as G
from repro.graph.csr import pack_adjacency as jax_pack
from repro.kernels.extend_fused import (fused_extend_pruned_mp_ref,
                                        fused_extend_pruned_ref)
from repro_torch.core import Miner, Pattern, make_mc_app, pattern_set_app
from repro_torch.core.api import CANONICAL, make_ctx
from repro_torch.core.apps import psm
from repro_torch.core.engine import _VertexPipeline
from repro_torch.core.patterns import compile_pattern, compile_pattern_set
from repro_torch.core.phases import get_backend
from repro_torch.core.phases import reference as ref_phases
from repro_torch.graph import generators as TG
from repro_torch.kernels.extend_fused import ops, ref

N, N_EMB = 40, 200


def _jax_set_pred(bits):
    return lambda *a: bits(*a) != 0


def _variant(name):
    """(k, port spec, JAX pred, JAX state_upd, labels?) of one variant."""
    if name == "canonical":
        return 3, CANONICAL, is_auto_canonical_kernel, None, False
    if name in ("conjunction", "labeled"):
        pat, jpat = Pattern.named("house"), JaxPattern.named("house")
        if name == "labeled":
            labels = (0, 1, 2, 0, 1)
            pat = dataclasses.replace(pat, labels=labels)
            jpat = dataclasses.replace(jpat, labels=labels)
        lp = compile_pattern(pat).levels[0]        # position 2: k = 2
        jlp = jax_compile_pattern(jpat).levels[0]
        if name == "labeled":
            return (2, psm.make_labeled_level_spec(lp, pat.labels),
                    jax_psm.make_labeled_level_kernel_predicate(
                        jlp, jpat.labels), None, True)
        return 2, psm.make_level_spec(lp), \
            jax_psm.make_level_kernel_predicate(jlp), None, False
    if name == "branches":
        pats = [Pattern.named(n) for n in ("4-star", "4-path", "4-cycle",
                                           "tailed-triangle", "diamond",
                                           "4-clique")]
        lvl = 1                                    # position 3: k = 3
    else:                                          # "first_pair"
        pats = [Pattern.named(n) for n in ("diamond", "4-cycle", "4-star")]
        lvl = 0
    jpats = [JaxPattern.named(p.name) for p in pats]
    plan, jplan = compile_pattern_set(pats), jax_compile_set(jpats)
    assert plan.directed == jplan.directed
    bits = jax_psm.make_set_branch_bits(jplan.levels[lvl])
    return (lvl + 2, psm.make_set_branch_spec(plan.levels[lvl]),
            _jax_set_pred(bits), bits, False)


VARIANTS = ("conjunction", "labeled", "canonical", "branches", "first_pair")


@functools.lru_cache(maxsize=None)
def _inputs(k, conn_mode, seed=6):
    """Kernel inputs as numpy: random parents (some slots dead) on an ER
    graph with labels, a random state column and the packed bits."""
    g = G.erdos_renyi(N, 0.25, seed=seed, labels=3)
    rng = np.random.default_rng(2)
    emb = rng.integers(-1, N, size=(N_EMB, k)).astype(np.int32)
    emb[:, 0] = np.abs(emb[:, 0])
    rp = np.asarray(g.row_ptr)
    embc = np.clip(emb, 0, N - 1).reshape(-1)
    vlo, vhi = rp[embc], rp[embc + 1]
    deg = np.where(emb.reshape(-1) >= 0, vhi - vlo, 0).astype(np.int32)
    offsets = np.cumsum(deg).astype(np.int32)
    args = tuple(np.array(x, dtype=np.int32) for x in (
        g.col_idx, offsets, offsets - deg, emb.reshape(-1), vlo, vhi))
    state = rng.integers(0, 1 << 6, size=(N_EMB,)).astype(np.int32)
    labels = np.array(g.labels, dtype=np.int32)
    if conn_mode == "bitmap":
        bits = np.array(jax_pack(g).words).view(np.int32).reshape(-1)
        n_words = -(-N // 32)
    else:
        bits, n_words = np.zeros(1, np.int32), 1
    n_steps = max(1, math.ceil(math.log2(g.max_degree + 1)))
    return args, bits, state, labels, dict(n_steps=n_steps, n_vertices=N,
                                           n_words=n_words)


def _caps(args, tight):
    total = int(args[1][-1])
    return total + 5, (5 if tight else total + 8)


@functools.lru_cache(maxsize=None)
def jax_oracle(variant, tight, two_pass):
    k, _, pred, upd, labeled = _variant(variant)
    args, _, state, labels, kw = _inputs(k, "search")
    cand_cap, out_cap = _caps(args, tight)
    fn = fused_extend_pruned_mp_ref if two_pass else fused_extend_pruned_ref
    out = fn(*map(jnp.asarray, args), jnp.asarray(state),
             jnp.asarray(labels) if labeled else None, k=k,
             cand_cap=cand_cap, out_cap=out_cap, n_steps=kw["n_steps"],
             pred=pred, state_upd=upd)
    return tuple(np.asarray(x) for x in out)


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


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "overflow"])
@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_single_pass_plain_version_equals_jax(variant, conn_mode, tight):
    ops.reset_counts()
    got = _port(variant, conn_mode, tight, ops.extend_pruned_1p)
    want = jax_oracle(variant, tight, two_pass=False)
    _assert_equal(got, want)
    assert ref.extend_pruned_1p_ref.calls == 1
    n = int(want[-1])
    out_cap = _caps(_inputs(_variant(variant)[0], conn_mode)[0], tight)[1]
    assert n > 0 and (n > out_cap) == tight
    if _variant(variant)[1].kind == "branches":
        # the compacted state is the survivors' bitmap: never 0 below the
        # survivor count, 0 past it
        st = got[2].numpy()
        m = min(n, st.shape[0])
        assert (st[:m] != 0).all() and (st[m:] == 0).all()


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "overflow"])
@pytest.mark.parametrize("conn_mode", ["bitmap", "search"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_two_pass_plain_versions_equal_jax(variant, conn_mode, tight):
    got = _port(variant, conn_mode, tight, ops.extend_pruned)
    _assert_equal(got, jax_oracle(variant, tight, two_pass=True))
    # and the one pass gives the pair's buffers
    one = _port(variant, conn_mode, tight, ops.extend_pruned_1p)
    _assert_equal(one, tuple(np.asarray(x) for x in got[:-1]))


def test_slot_ranges_compose_to_the_whole_launch():
    """The smoke script checks big launches piece by piece: tile-aligned
    pieces of the pair and carried offsets of the single pass rebuild the
    whole launch's state column too."""
    k, spec, *_ = _variant("branches")
    args, bits, state, _, kw = _inputs(k, "bitmap")
    targs = (*map(torch.from_numpy, args), torch.from_numpy(bits))
    cand_cap = _caps(args, False)[0]
    common = dict(k=k, cand_cap=cand_cap, out_cap=cand_cap, spec=spec,
                  conn_mode="bitmap", state=torch.from_numpy(state), **kw)
    whole = ref.extend_pruned_1p_ref(*targs, **common)
    base, bufs = 0, [torch.zeros_like(b) for b in whole[:-1]]
    for lo in range(0, cand_cap, 512):
        *piece, n = ref.extend_pruned_1p_ref(
            *targs, **common, slots=(lo, min(lo + 512, cand_cap)), base=base)
        for b, p in zip(bufs, piece):
            b[base:int(n)] = p[base:int(n)]
        base = int(n)
    assert base == int(whole[-1])
    for b, w in zip(bufs, whole[:-1]):
        assert torch.equal(b[:base], w[:base])


def test_wrappers_check_state_and_labels():
    k, spec, *_ = _variant("branches")
    args, bits, state, labels, kw = _inputs(k, "search")
    targs = (*map(torch.from_numpy, args), torch.from_numpy(bits))
    common = dict(k=k, cand_cap=1024, out_cap=64, conn_mode="search", **kw)
    st = torch.from_numpy(state)
    with pytest.raises(ValueError, match="reads the state column"):
        ops.extend_pruned_1p(*targs, spec=spec, **common)
    with pytest.raises(ValueError, match="rows"):
        ops.extend_pruned_1p(*targs, spec=spec, state=st[:-1], **common)
    with pytest.raises(ValueError, match="int32"):
        ops.extend_pruned_1p(*targs, spec=spec, state=st.long(), **common)
    with pytest.raises(ValueError, match="reads no state"):
        ops.extend_pruned_1p(*targs, spec=CANONICAL, state=st, **common)
    k2, lspec, *_ = _variant("labeled")
    args2, bits2, _, _, kw2 = _inputs(k2, "search")
    targs2 = (*map(torch.from_numpy, args2), torch.from_numpy(bits2))
    common2 = dict(k=k2, cand_cap=1024, out_cap=64, conn_mode="search",
                   **kw2)
    with pytest.raises(ValueError, match="reads the labels"):
        ops.extend_pruned_1p(*targs2, spec=lspec, **common2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.extend_pruned_1p(*targs2, spec=lspec,
                             labels=torch.from_numpy(labels)[::2], **common2)
    with pytest.raises(TypeError, match="kernel-readable"):
        ops.extend_pruned_1p(*targs2, spec=lambda *a: a[1] >= 0, **common2)


# ---------------------------------------------------------------------------
# The repairs a state-carrying app needs


def _set_app():
    return pattern_set_app([Pattern.named(n) for n in
                            ("diamond", "4-cycle", "4-star")])


def _jax_set_app():
    return jax_psm.pattern_set_app([JaxPattern.named(n) for n in
                                    ("diamond", "4-cycle", "4-star")])


def _frontier(seed=4):
    """3-vertex parents of a small graph with a random branch state."""
    g = G.erdos_renyi(N, 0.25, seed=seed)
    rng = np.random.default_rng(seed)
    emb = rng.integers(0, N, size=(N_EMB, 3)).astype(np.int32)
    state = rng.integers(0, 8, size=(N_EMB,)).astype(np.int32)
    state[::5] = 0                               # rows with no live branch
    tg = TG.erdos_renyi(N, 0.25, seed=seed, device="cpu")
    return g, tg, emb, state


def test_inspection_sees_the_parents_state():
    g, tg, emb, state = _frontier()
    ctx = make_ctx(tg)
    jctx = jax_make_ctx(g)
    n = torch.tensor(N_EMB - 3, dtype=torch.int32)
    want = jax_ref_phases.inspect_vertex(
        jctx, _jax_set_app(), jnp.asarray(emb), jnp.int32(N_EMB - 3),
        jnp.asarray(state), 1 << 13)
    for backend in ("torch-ref", "cuda", "cuda-1p"):
        got = get_backend(backend).inspect_vertex(
            ctx, _set_app(), torch.from_numpy(emb), n,
            torch.from_numpy(state), 1 << 13)
        assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert int(want[1]) > 0


def test_to_extend_state_takes_precedence():
    g, tg, emb, state = _frontier()
    want = jax_ref_phases.vertex_ext_degrees(
        jax_make_ctx(g), _jax_set_app(), jnp.asarray(emb), jnp.int32(N_EMB),
        jnp.asarray(state))
    got = ref_phases.vertex_ext_degrees(
        make_ctx(tg), _set_app(), torch.from_numpy(emb),
        torch.tensor(N_EMB, dtype=torch.int32), torch.from_numpy(state))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[::5] == 0).all()         # dead rows enumerate none


@functools.lru_cache(maxsize=None)
def _jax_levels(app_name):
    g = G.rmat(6, 8, seed=0)
    app = {"set": _jax_set_app, "memo": lambda: jax_make_mc_app(4, "memo"),
           "mc4": lambda: jax_make_mc_app(4)}[app_name]()
    r = JaxMiner(g, app).run()
    return r, [(int(l.n), np.asarray(l.vid), np.asarray(l.idx),
                None if l.state is None else np.asarray(l.state))
               for l in r.levels]


@pytest.mark.parametrize("backend", ["torch-ref", "cuda", "cuda-1p"])
@pytest.mark.parametrize("app_name", ["set", "memo", "mc4"])
def test_state_threads_from_level_to_level(app_name, backend):
    app = {"set": _set_app, "memo": lambda: make_mc_app(4, "memo"),
           "mc4": lambda: make_mc_app(4)}[app_name]()
    g = TG.rmat(6, 8, seed=0, device="cpu")
    m = Miner(g, app, backend=backend, device="cpu")
    # every embedding of a trie app starts at the root (bit 0)
    src, dst = m.init_edges()
    pipe = _VertexPipeline(m.ops, src, dst, int(src.shape[0]))
    want_init = 1 if app.init_state is not None else 0
    assert (pipe.state == want_init).all()
    jr, jlevels = _jax_levels(app_name)
    r = m.run()
    assert r.count == jr.count
    assert list(r.p_map) == list(jr.p_map)
    for lvl, (n, vid, idx, st) in zip(r.levels, jlevels):
        assert int(lvl.n) == n
        np.testing.assert_array_equal(lvl.vid[:n].numpy(), vid[:n])
        np.testing.assert_array_equal(lvl.idx[:n].numpy(), idx[:n])
        assert (lvl.state is None) == (st is None)
        if st is not None:
            np.testing.assert_array_equal(lvl.state[:n].numpy(), st[:n])


def test_cuda_backend_runs_only_its_own_state_update():
    app = dataclasses.replace(make_mc_app(3), update_state_kernel=tuple(
        (lambda spec: lambda *a: spec.bits(*a) | 1)(s)
        for s in make_mc_app(3).to_add_spec))
    g = TG.rmat(6, 8, seed=0, device="cpu")
    for backend in ("cuda", "cuda-1p"):
        assert get_backend(backend).capabilities(app)["extend_pruned"] == \
            "unsupported:state-update"
        with pytest.raises(NotImplementedError, match="state column"):
            Miner(g, app, backend=backend, device="cpu").run()
        caps = get_backend(backend).capabilities(make_mc_app(4))
        assert caps["extend_pruned"] == "cuda-kernel"
    # the plain backend runs any state update
    assert Miner(g, app, backend="torch-ref", device="cpu").run().count == \
        Miner(g, make_mc_app(3), backend="torch-ref",
              device="cpu").run().count

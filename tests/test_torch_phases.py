"""PyTorch port, phase backends: ``extend_pruned``, ``inspect_vertex`` and
``extend_vertex`` of ``torch-ref`` and ``cuda`` (on the CPU, so through the kernels' plain
versions) against the JAX ``reference`` and ``pallas`` (interpret mode)
backends, bit for bit, on the app matrix of the JAX package's
``test_extend_pruned_bitwise_parity``; plus what the ``cuda`` backend
refuses instead of quietly running plain PyTorch."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Miner as JaxMiner
from repro.core import make_cf_app as jax_make_cf_app
from repro.core import make_tc_app as jax_make_tc_app
from repro.core.embedding_list import init_level0_vertex as jax_level0
from repro.core.embedding_list import materialize as jax_materialize
from repro.graph import generators as G
from repro_torch.core import Miner, get_backend, make_cf_app, make_tc_app
from repro_torch.core.api import MiningApp
from repro_torch.core.embedding_list import init_level0_vertex, materialize
from repro_torch.graph import generators as TG
from repro_torch.graph.csr import PackedGraph

APPS = {"tc": (jax_make_tc_app, make_tc_app),
        "4-cf": (lambda: jax_make_cf_app(4), lambda: make_cf_app(4)),
        "3-cf-nodag": (lambda: jax_make_cf_app(3, use_dag=False),
                       lambda: make_cf_app(3, use_dag=False))}
PACKS = {"bitmap": 4 << 20, "search": 0}
CAND_CAP, OUT_CAP = 1024, 512


def _jax_buffers(miner, app, inspect: bool):
    src, dst = miner.init_edges()
    n = int(src.shape[0])
    emb = jax_materialize(jax_level0(src, dst, n))
    state = jnp.zeros(emb.shape[:1], jnp.int32)
    level, new_emb, n_cand = miner.backend.extend_pruned(
        miner.ctx, app, emb, jnp.int32(n), state, CAND_CAP, OUT_CAP)
    out = (np.asarray(level.vid), np.asarray(level.idx), int(level.n),
           np.asarray(new_emb), int(n_cand))
    if not inspect:
        return out, None
    total, n_surv = miner.backend.inspect_vertex(
        miner.ctx, app, emb, jnp.int32(n), state, CAND_CAP)
    level_v, _ = miner.backend.extend_vertex(
        miner.ctx, app, emb, jnp.int32(n), state, CAND_CAP, OUT_CAP)
    return out, ((int(total), int(n_surv)),
                 (np.asarray(level_v.vid), np.asarray(level_v.idx)))


@functools.lru_cache(maxsize=None)
def jax_results(aname, seed, pack):
    """``extend_pruned`` buffers of the JAX reference backend and, with the
    full pack, of the pallas backend in interpret mode, and the reference
    backend's ``inspect_vertex`` and ``extend_vertex`` results (computed
    once per case; the pallas enumeration kernel behind the latter two is
    held against the port in ``test_torch_extend_kernels.py``)."""
    g = G.erdos_renyi(24, 0.3, seed=seed)
    out, inspected = {}, None
    for backend in ("reference", "pallas")[:2 if pack == "bitmap" else 1]:
        app = APPS[aname][0]()
        m = JaxMiner(g, app, backend=backend, pack_max_bytes=PACKS[pack])
        out[backend], insp = _jax_buffers(m, app, backend == "reference")
        inspected = inspected or insp
    return out, inspected


@pytest.mark.parametrize("pack", sorted(PACKS))
@pytest.mark.parametrize("backend", ["torch-ref", "cuda"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("aname", sorted(APPS))
def test_extend_pruned_bitwise_parity(aname, seed, backend, pack):
    g = TG.erdos_renyi(24, 0.3, seed=seed, device="cpu")
    app = APPS[aname][1]()
    m = Miner(g, app, backend=backend, pack_max_bytes=PACKS[pack],
              device="cpu")
    assert (m.ctx.packed is not None) == (pack == "bitmap")
    src, dst = m.init_edges()
    n = int(src.shape[0])
    emb = materialize(init_level0_vertex(src, dst, n))
    state = torch.zeros(emb.shape[:1], dtype=torch.int32)
    nv = torch.tensor(n, dtype=torch.int32)
    level, new_emb, n_cand = m.backend.extend_pruned(
        m.ctx, app, emb, nv, state, CAND_CAP, OUT_CAP)
    total, n_surv = m.backend.inspect_vertex(m.ctx, app, emb, nv, state,
                                             CAND_CAP)
    level_v, _ = m.backend.extend_vertex(m.ctx, app, emb, nv, state,
                                         CAND_CAP, OUT_CAP)
    assert level.vid.dtype == level.idx.dtype == new_emb.dtype == torch.int32
    pruned, (insp, (vid_v, idx_v)) = jax_results(aname, seed, pack)
    for jb, (vid, idx, n_j, emb_j, c_j) in pruned.items():
        assert (int(level.n), int(n_cand)) == (n_j, c_j), jb
        np.testing.assert_array_equal(vid, level.vid.numpy())
        np.testing.assert_array_equal(idx, level.idx.numpy())
        live = vid >= 0
        np.testing.assert_array_equal(emb_j[live], new_emb.numpy()[live])
    assert (int(total), int(n_surv)) == insp
    np.testing.assert_array_equal(vid_v, level_v.vid.numpy())
    np.testing.assert_array_equal(idx_v, level_v.idx.numpy())


def test_backend_registry_and_contract():
    ref, cuda = get_backend("torch-ref"), get_backend("cuda")
    assert (ref.compaction, ref.compaction_passes) == ("xla-scan", 0)
    assert (cuda.compaction, cuda.compaction_passes,
            cuda.grid_contract) == ("two-pass-scan", 2, "concurrent")
    assert get_backend(None) is cuda
    with pytest.raises(KeyError, match="unknown phase backend"):
        get_backend("pallas")
    caps = cuda.capabilities(make_cf_app(3, use_dag=False,
                                         eager_prune=False))
    assert caps["extend_pruned"] == "unsupported:no-predicate-spec"
    assert cuda.capabilities(make_tc_app())["extend_pruned"] == "cuda-kernel"


def _small_miner(app, backend="cuda", **kw):
    return Miner(TG.erdos_renyi(30, 0.25, seed=2, device="cpu"), app,
                 backend=backend, device="cpu", **kw)


def test_cuda_backend_refuses_app_without_spec():
    app = make_cf_app(3, use_dag=False, eager_prune=False)
    with pytest.raises(NotImplementedError, match="predicate spec"):
        _small_miner(app).run()
    # the plain backend runs it through the canonical test
    assert _small_miner(app, "torch-ref").run().count == \
        _small_miner(make_tc_app(), "torch-ref").run().count


def test_cuda_backend_refuses_unfused_filter():
    with pytest.raises(NotImplementedError, match="fuse_filter"):
        _small_miner(make_tc_app(), fuse_filter=False).run()
    # the plain backend's materialise-then-filter ablation still counts
    assert _small_miner(make_tc_app(), "torch-ref",
                        fuse_filter=False).run().count == \
        _small_miner(make_tc_app(), "torch-ref").run().count


def test_cuda_backend_refuses_partial_pack():
    m = _small_miner(make_tc_app())
    pg = m.ctx.packed
    m.ctx = dataclasses.replace(m.ctx, packed=dataclasses.replace(
        pg, full=False))
    m.ops.ctx = m.ctx
    assert isinstance(m.ctx.packed, PackedGraph)
    with pytest.raises(NotImplementedError, match="partial"):
        m.run()


def test_cuda_backend_refuses_labels_and_state():
    # TC's clique spec reads no label, so the cuda backend counts a labeled
    # graph as it counts the unlabeled one
    g = TG.erdos_renyi(20, 0.3, seed=5, labels=3, device="cpu")
    unlabeled = TG.erdos_renyi(20, 0.3, seed=5, device="cpu")
    assert Miner(g, make_tc_app(), backend="cuda", device="cpu").run().count \
        == Miner(unlabeled, make_tc_app(), backend="cuda",
                 device="cpu").run().count
    # the kernels compute a state column only as a branch set's own
    # bitmap; the plain backend runs any state update
    app = dataclasses.replace(make_tc_app(),
                              update_state_kernel=lambda *a: a[3])
    with pytest.raises(NotImplementedError, match="state column"):
        _small_miner(app, "cuda").run()
    assert _small_miner(app, "torch-ref").run().count == \
        _small_miner(make_tc_app(), "torch-ref").run().count
    edge_app = MiningApp(name="fsm", kind="edge",
                         to_add=lambda ctx, emb, u, st: u >= 0)
    with pytest.raises(NotImplementedError, match="batch to_add"):
        _small_miner(edge_app).run()

"""PyTorch port, GAT and GraphSAGE, the GNN data and the GNN cells against
the JAX package on the CPU.

GAT (with a label mask), GraphSAGE full (with ``label_idx``) and GraphSAGE
sampled at their SMOKE configs on JAX's weights
(``gnn_params_from_numpy``) and JAX's inputs: logits, loss and parameter
gradients within 1e-5 of their norms; one ``build_cell(..., smoke=True)``
step leaves parameters within 1e-5 of JAX's cell step.
``node_classification_data`` equals JAX's bit for bit; ``molecule_batch``
has JAX's shapes, edges and ranges, its forces are minus the numpy float64
gradient of its target, and it is a pure function of (seed, step, shard).
The registry resolves every id of the JAX package to the same config,
``build_cell`` builds all 16 GNN cells (SMOKE and full), a mesh still
raises, and the GNN entry points need a card unless asked for the CPU.
JAX results are computed once per worker, one jit a case.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import gat_cora as jax_gat_cfg
from repro.configs import graphsage_reddit as jax_sage_cfg
from repro.configs import registry as JR
from repro.data import pipeline as JP
from repro.launch import steps as JS
from repro.models.gnn import gat as JGAT
from repro.models.gnn import graphsage as JSAGE
from repro.train import optimizer as JO
from repro_torch.configs import registry as TR
from repro_torch.data import pipeline as TP
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.models.gnn import equiformer_v2 as TEQ
from repro_torch.models.gnn import gat as TGAT
from repro_torch.models.gnn import graphsage as TSAGE
from repro_torch.models.gnn import nequip as TNQ
from repro_torch.train import optimizer as TO
from repro_torch.train.tree import leaves_with_paths

GNN_IDS = ("gat-cora", "graphsage-reddit", "nequip", "equiformer-v2")
N_NODES = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph_batch(cfg, kind: str) -> dict:
    """JAX's node-classification graph at the config's widths, as numpy,
    with GAT's label mask or GraphSAGE's ``label_idx``; or sampled blocks
    of 4 seeds at the config's fanouts."""
    rng = np.random.default_rng(5)
    if kind == "sampled":
        b, (f1, f2) = 4, cfg.sample_sizes
        return {"feat_blocks": [
            rng.standard_normal((n, cfg.d_in)).astype(np.float32)
            for n in (b, b * f1, b * f1 * f2)],
            "labels": rng.integers(0, cfg.n_classes, b).astype(np.int32)}
    g = {k: np.asarray(v) for k, v in JP.node_classification_data(
        1, N_NODES, cfg.d_in, cfg.n_classes).items()}
    if kind == "masked":
        g["label_mask"] = (rng.random(N_NODES) < 0.5).astype(np.float32)
    elif kind == "indexed":
        idx = rng.choice(N_NODES, 12, replace=False).astype(np.int32)
        g["label_idx"] = idx
        g["labels"] = g["labels"][idx]
    return g


CASES = {"gat": (JGAT, TGAT, jax_gat_cfg.SMOKE, "masked"),
         "sage-full": (JSAGE, TSAGE, jax_sage_cfg.SMOKE, "indexed"),
         "sage-sampled": (JSAGE, TSAGE, jax_sage_cfg.SMOKE, "sampled")}


def _jax_logits(jmod, cfg, p, b):
    if "feat_blocks" in b:
        return jmod.forward_sampled(cfg, p, b["feat_blocks"])
    fwd = jmod.forward if jmod is JGAT else jmod.forward_full
    return fwd(cfg, p, b["feats"], b["edge_src"], b["edge_dst"],
               b["feats"].shape[0])


@functools.lru_cache(maxsize=None)
def _jax_case(name: str):
    """JAX's weights, batch, logits, loss and gradients, as numpy: one
    jit."""
    jmod, _, cfg, kind = CASES[name]
    batch = _graph_batch(cfg, kind)

    @jax.jit
    def run(key, b):
        p = jmod.init_params(cfg, key)
        loss, grads = jax.value_and_grad(
            lambda pp: jmod.loss_fn(cfg, pp, b))(p)
        return p, _jax_logits(jmod, cfg, p, b), loss, grads

    return batch, jax.tree.map(np.asarray, run(jax.random.PRNGKey(0),
                                               batch))


def _torch_batch(batch: dict) -> dict:
    return {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
                else torch.from_numpy(np.array(v))) for k, v in batch.items()}


def _assert_grads(got, want_np, tol: float) -> None:
    want = dict(leaves_with_paths(gnn_params_from_numpy(want_np,
                                                        device="cpu")))
    got = dict(leaves_with_paths(got))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert float((g - w).norm()) <= tol * float(w.norm()) + 1e-8, path


@pytest.mark.parametrize("name", list(CASES))
def test_logits_loss_and_gradients_match_jax(name):
    _, tmod, cfg, _ = CASES[name]
    batch, (params, logits, loss, grads) = _jax_case(name)
    port_cfg = dataclasses.replace(TR.get_arch(
        "gat-cora" if tmod is TGAT else "graphsage-reddit").smoke)
    p = gnn_params_from_numpy(params, device="cpu")
    b = _torch_batch(batch)
    with torch.no_grad():
        if "feat_blocks" in b:
            got = tmod.forward_sampled(port_cfg, p, b["feat_blocks"])
        else:
            fwd = tmod.forward if tmod is TGAT else tmod.forward_full
            got = fwd(port_cfg, p, b["feats"], b["edge_src"], b["edge_dst"],
                      N_NODES)
    assert tuple(got.shape) == logits.shape
    assert float((got - torch.from_numpy(logits.copy())).norm()) <= \
        1e-5 * float(np.linalg.norm(logits))
    got_loss, got_grads = TS.loss_and_grads(
        lambda pp, bb: tmod.loss_fn(port_cfg, pp, bb), p, b)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    _assert_grads(got_grads, grads, 1e-5)


@functools.lru_cache(maxsize=None)
def _jax_cell_step(arch_id: str):
    """JAX's smoke full_graph_sm cell: weights, batch, and the params,
    optimizer state and loss after one step, as numpy."""
    cell = JS.build_cell(arch_id, "full_graph_sm", smoke=True)
    cfg = JR.get_arch(arch_id).smoke
    batch = _graph_batch(cfg, "plain")

    @jax.jit
    def run(key, b):
        p = cell.param_init(key)
        return p, cell.fn(p, JO.init_opt_state(p, cell.opt_cfg), b)

    return batch, jax.tree.map(np.asarray, run(jax.random.PRNGKey(0),
                                               batch))


@pytest.mark.parametrize("arch_id", ["gat-cora", "graphsage-reddit"])
def test_cell_step_matches_jax(arch_id):
    batch, (params, (new_p, new_s, loss)) = _jax_cell_step(arch_id)
    cell = TS.build_cell(arch_id, "full_graph_sm", smoke=True)
    assert (cell.kind, cell.n_micro, cell.opt_cfg) == ("train", 1,
                                                       TO.OptConfig())
    p = gnn_params_from_numpy(params, device="cpu")
    got_p, got_s, got_loss = cell.fn(p, TO.init_opt_state(p, cell.opt_cfg),
                                     _torch_batch(batch))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want = dict(leaves_with_paths(gnn_params_from_numpy(new_p,
                                                        device="cpu")))
    for path, x in leaves_with_paths(got_p):
        torch.testing.assert_close(x, want[path], atol=1e-5, rtol=0)
        assert not torch.equal(x, dict(leaves_with_paths(p))[path])
    assert int(got_s["step"]) == int(new_s["step"]) == 1


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("args", [(0, 100, 7, 3), (3, 500, 16, 5, 8),
                                  (1, 2708, 20, 7), (2, 3000, 4, 41, 12)],
                         ids=["tiny", "degree8", "cora-nodes", "degree12"])
def test_node_classification_data_equals_jax_bit_for_bit(args):
    want = JP.node_classification_data(*args)
    got = TP.node_classification_data(*args, device="cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        assert t.numpy().dtype == w.dtype and t.shape == w.shape
        np.testing.assert_array_equal(t.numpy(), w)


def _lj_forces_f64(pos: np.ndarray, es: np.ndarray, ed: np.ndarray):
    """The target's energy and -dE/dpos in float64, by hand."""
    rel = pos[ed] - pos[es]
    r = np.sqrt((rel ** 2).sum(-1) + 1e-9)
    energy = 0.5 * np.sum(4.0 * ((0.8 / r) ** 8 - (0.8 / r) ** 4))
    # dE/dr for each directed pair, halved, along rel / r
    de_dr = 0.5 * 4.0 * (-8 * 0.8 ** 8 / r ** 9 + 4 * 0.8 ** 4 / r ** 5)
    g = (de_dr / r)[:, None] * rel
    grad = np.zeros_like(pos)
    np.add.at(grad, ed, g)
    np.add.at(grad, es, -g)
    return energy, -grad


@functools.lru_cache(maxsize=None)
def _jax_molecule(n_atoms: int):
    return jax.tree.map(np.asarray, JP.molecule_batch(4, 2, n_atoms))


@pytest.mark.parametrize("n_atoms", [5, 30])
def test_molecule_batch_shapes_ranges_and_forces(n_atoms):
    """JAX's keys, dtypes, shapes and edges (JAX's at 30 atoms: its eager
    gradient costs seconds a call); the target's energy and forces in
    float64 by hand."""
    got = TP.molecule_batch(4, 2, n_atoms, device="cpu")
    want = _jax_molecule(30) if n_atoms == 30 else {
        "positions": np.zeros((n_atoms, 3), np.float32),
        "species": np.zeros(n_atoms, np.int32),
        "edge_src": np.meshgrid(np.arange(n_atoms), np.arange(
            n_atoms))[0][~np.eye(n_atoms, dtype=bool)].astype(np.int32),
        "edge_dst": np.meshgrid(np.arange(n_atoms), np.arange(
            n_atoms))[1][~np.eye(n_atoms, dtype=bool)].astype(np.int32),
        "energy": np.float32(0), "forces": np.zeros((n_atoms, 3),
                                                    np.float32)}
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        assert t.numpy().dtype == w.dtype and t.shape == w.shape
    for name in ("edge_src", "edge_dst"):      # the meshgrid's order
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert 0 <= int(got["species"].min()) and \
        int(got["species"].max()) < 4
    pos = got["positions"].double().numpy()
    energy, forces = _lj_forces_f64(pos, got["edge_src"].numpy(),
                                    got["edge_dst"].numpy())
    np.testing.assert_allclose(float(got["energy"]), energy, rtol=1e-4)
    assert np.linalg.norm(got["forces"].numpy() - forces) <= \
        1e-4 * np.linalg.norm(forces)


def test_molecule_batch_is_a_pure_function_of_seed_step_shard():
    a = TP.molecule_batch(0, 3, 12, shard=1, device="cpu")
    b = TP.molecule_batch(0, 3, 12, shard=1, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    for other in (TP.molecule_batch(0, 4, 12, shard=1, device="cpu"),
                  TP.molecule_batch(0, 3, 12, shard=0, device="cpu"),
                  TP.molecule_batch(1, 3, 12, shard=1, device="cpu")):
        assert not torch.equal(a["positions"], other["positions"])
    # positions normal with standard deviation 2 (1,800 draws)
    big = TP.molecule_batch(0, 0, 600, device="cpu")["positions"]
    assert abs(float(big.std()) - 2.0) < 0.15


# ---------------------------------------------------------------------------
# registry and cells


def test_every_arch_resolves_to_jax_config():
    """All ten ids resolve in both packages to the same family, shapes and
    config fields; an unknown id raises KeyError."""
    assert TR.list_archs() == JR.list_archs()
    for arch_id in JR.ARCH_IDS:
        j, t = JR.get_arch(arch_id), TR.get_arch(arch_id)
        assert (t.family, t.shapes) == (j.family, j.shapes)
        for jc, tc in ((j.config, t.config), (j.smoke, t.smoke)):
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch_id
    with pytest.raises(KeyError):
        TR.get_arch("no-such-arch")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_build_cell_builds_every_gnn_cell(smoke):
    cells = [(a, s) for a in GNN_IDS for s in TR.get_arch(a).shapes]
    assert len(cells) == 16
    for arch_id, shape in cells:
        cell = TS.build_cell(arch_id, shape, smoke=smoke)
        jcell = JS.build_cell(arch_id, shape, smoke=smoke)
        assert (cell.kind, cell.n_micro) == ("train", 1)
        assert cell.opt_cfg == TO.OptConfig() and callable(cell.fn)
        # the same model config as JAX's cell (d_in and fanouts included)
        params = jax.eval_shape(jcell.param_init, jax.random.PRNGKey(0))
        assert cell.param_init.args[0].name == cell.cfg.name
        if arch_id in ("gat-cora", "graphsage-reddit"):
            first = params["layers"][0]
            w = first["w"] if arch_id == "gat-cora" else first["w_self"]
            assert w.shape[0] == cell.cfg.d_in
    sampled = TS.build_cell("graphsage-reddit", "minibatch_lg", smoke=smoke)
    assert sampled.cfg.sample_sizes == ((5, 3) if smoke else (15, 10))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.build_cell("nequip", "molecule", mesh=object())


def test_gnn_node_features_are_jaxs():
    for arch_id in GNN_IDS:
        for name, shp in TR.get_arch(arch_id).shapes.items():
            assert TS.gnn_d_feat(name, shp) == \
                JS._gnn_sizes(name, shp, False)[2]


@pytest.mark.parametrize("mod", [TGAT, TSAGE, TNQ, TEQ],
                         ids=["gat", "sage", "nequip", "equiformer"])
def test_gnn_entry_points_need_a_card_unless_asked(mod):
    arch_id = {TGAT: "gat-cora", TSAGE: "graphsage-reddit",
               TNQ: "nequip", TEQ: "equiformer-v2"}[mod]
    cfg = TR.get_arch(arch_id).smoke
    p = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for _, t in leaves_with_paths(p))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.init_params(cfg, torch.Generator(), device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.node_classification_data(0, 10, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.molecule_batch(0, 0, 4)

"""PyTorch port, the equivariant substrate and the equivariant potentials
against the JAX package on the CPU.

Primitives: ``real_sph_harm`` within 2e-6 of JAX's; ``wigner_d_matrices``
against the entry-wise reference recursion (the port's to l = 6, JAX's to
l = 4) and the rotation law ``Y(R v) = D(R) Y(v)``;
``edge_align_rotation`` against JAX's, a degenerate edge included, with
finite gradients; ``cg_coefficients``
entry for entry within 1e-5 of JAX's, with the same sign, for every
triangle with l <= 3; ``tensor_product``, ``apply_wigner`` and
``block_diag_wigner`` against JAX's.

Models at their SMOKE configs, on JAX's weights
(``gnn_params_from_numpy``) and one molecule with a padding self-loop
edge: NequIP's and EquiformerV2's energy and forces within 1e-5 of JAX's,
the loss's parameter gradients within 1e-4 of their norms, all finite;
rotation invariance of the energy and NequIP's forces rotating with the
frame (``tests/test_models.py``'s checks, on the port); chunked
EquiformerV2 equal to unchunked; gradients with and without each layer
under ``torch.utils.checkpoint`` (JAX's remat) equal (1e-6).  JAX results are computed once per worker, one jit a
model.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equiformer_v2 as jax_eq_cfg
from repro.configs import nequip as jax_nq_cfg
from repro.models.gnn import equiformer_v2 as JEQ
from repro.models.gnn import equivariant as JE
from repro.models.gnn import nequip as JNQ
from repro_torch.configs.registry import get_arch
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.models.gnn import equiformer_v2 as TEQ
from repro_torch.models.gnn import equivariant as TE
from repro_torch.models.gnn import nequip as TNQ
from repro_torch.train.tree import leaves_with_paths

MODELS = {"nequip": (JNQ, TNQ, jax_nq_cfg.SMOKE),
          "equiformer-v2": (JEQ, TEQ, jax_eq_cfg.SMOKE)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unit_vectors(seed: int, n: int = 64) -> np.ndarray:
    v = np.random.default_rng(seed).standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rotation(seed: int) -> np.ndarray:
    Q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q.astype(np.float32)


# ---------------------------------------------------------------------------
# primitives


@pytest.mark.parametrize("l_max", [2, 6])
def test_real_sph_harm_matches_jax(l_max):
    v = _unit_vectors(0)
    v[0] = (0.0, 0.0, 1.0)                          # the pole: atan2 guard
    got = TE.real_sph_harm(torch.from_numpy(v), l_max)
    want = JE.real_sph_harm(jnp.asarray(v), l_max)
    assert tuple(got.shape) == (64, (l_max + 1) ** 2)
    # f32 rounding of sin(m phi) and the recursion: 1.04e-6 at l = 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_wigner_matrices_match_the_reference_recursion_and_rotate_sh():
    R = torch.from_numpy(np.stack([_rotation(s) for s in range(6)]))
    fast = TE.wigner_d_matrices(R, 6)
    ref = TE.wigner_d_matrices_reference(R, 6)
    for l, (a, b) in enumerate(zip(fast, ref)):
        assert tuple(a.shape) == (6, 2 * l + 1, 2 * l + 1)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # JAX's reference, eager op by op, up to l = 4 (seconds more at 6)
    jax_ref = JE.wigner_d_matrices_reference(jnp.asarray(R.numpy()), 4)
    for a, c in zip(fast, jax_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)
    # Y(R v) = D(R) Y(v), block by block
    v = torch.from_numpy(_unit_vectors(1, 6))
    y = TE.real_sph_harm(v, 6)
    y_rot = TE.real_sph_harm(torch.einsum("bij,bj->bi", R, v), 6)
    D = TE.block_diag_wigner(R, 6)
    np.testing.assert_allclose(y_rot.numpy(),
                               torch.einsum("bij,bj->bi", D, y).numpy(),
                               atol=2e-5)


def test_apply_and_block_diag_wigner_match_jax():
    R = np.stack([_rotation(s) for s in range(5)])
    x = np.random.default_rng(2).standard_normal((5, 3, 9)).astype(
        np.float32)
    Ds = TE.wigner_d_matrices(torch.from_numpy(R), 2)
    jDs = JE.wigner_d_matrices(jnp.asarray(R), 2)
    for transpose in (False, True):
        got = TE.apply_wigner(Ds, torch.from_numpy(x), transpose)
        want = JE.apply_wigner(jDs, jnp.asarray(x), transpose)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        TE.block_diag_wigner(torch.from_numpy(R), 2).numpy(),
        np.asarray(JE.block_diag_wigner(jnp.asarray(R), 2)), atol=1e-5)


def test_edge_align_rotation_matches_jax_with_a_degenerate_edge():
    v = np.random.default_rng(3).standard_normal((8, 3)).astype(np.float32)
    v[0] = 0.0                                      # a padding self loop
    v[1] = (0.0, 0.0, -2.0)                         # on the z axis
    x = torch.from_numpy(v).requires_grad_()
    R = TE.edge_align_rotation(x)
    np.testing.assert_allclose(R.detach().numpy(),
                               np.asarray(JE.edge_align_rotation(
                                   jnp.asarray(v))), atol=1e-6)
    # R v_hat = z_hat away from the degenerate edge
    vh = v[2:] / np.linalg.norm(v[2:], axis=1, keepdims=True)
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", R.detach().numpy()[2:], vh),
        np.tile([0.0, 0.0, 1.0], (6, 1)), atol=1e-6)
    (g,) = torch.autograd.grad(TE.wigner_d_matrices(R, 3)[3].sum(), x)
    assert torch.isfinite(g).all()


def _triangles(l_top: int = 3):
    return [(l1, l2, l3) for l1 in range(l_top + 1)
            for l2 in range(l_top + 1)
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_top) + 1)]


def test_cg_coefficients_match_jax_entry_for_entry():
    """Every triangle with l <= 3: the same coupling within 1e-5, the same
    sign, unit norm; a triangle that fails is zero in both."""
    for l1, l2, l3 in _triangles():
        got = TE.cg_coefficients(l1, l2, l3)
        want = JE.cg_coefficients(l1, l2, l3)
        assert got.shape == want.shape == (2 * l3 + 1, 2 * l1 + 1,
                                           2 * l2 + 1)
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-9)
    assert not TE.cg_coefficients(0, 1, 2).any()


def test_cg_coefficients_are_moved_to_a_device_once():
    a = TE._cg_on(1, 1, 2, torch.device("cpu"), torch.float32)
    assert a is TE._cg_on(1, 1, 2, torch.device("cpu"), torch.float32)
    assert a.dtype == torch.float32


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 0), (1, 2, 2), (2, 2, 1),
                                      (3, 1, 2)])
def test_tensor_product_matches_jax(l1, l2, l3):
    rng = np.random.default_rng(l1 * 9 + l2 * 3 + l3)
    h1 = rng.standard_normal((10, 4, 2 * l1 + 1)).astype(np.float32)
    h2 = rng.standard_normal((10, 1, 2 * l2 + 1)).astype(np.float32)
    got = TE.tensor_product(torch.from_numpy(h1), torch.from_numpy(h2),
                            l1, l2, l3)
    want = JE.tensor_product(jnp.asarray(h1), jnp.asarray(h2), l1, l2, l3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# NequIP and EquiformerV2


def _molecule(n: int = 8, seed: int = 0) -> dict:
    """All ordered pairs of ``n`` atoms plus one padding self loop (0,
    0), a target energy and forces, as numpy."""
    rng = np.random.default_rng(seed)
    es, ed = np.meshgrid(np.arange(n), np.arange(n))
    m = es != ed
    return {"species": rng.integers(0, 3, n).astype(np.int32),
            "positions": (rng.standard_normal((n, 3)) * 1.5).astype(
                np.float32),
            "edge_src": np.append(es[m], 0).astype(np.int32),
            "edge_dst": np.append(ed[m], 0).astype(np.int32),
            "energy": np.float32(1.5),
            "forces": rng.standard_normal((n, 3)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_model(arch_id: str):
    """JAX's weights, energy, forces, loss and the loss's gradients for
    the SMOKE config on ``_molecule()``, as numpy: one jit."""
    jmod, _, cfg = MODELS[arch_id]
    b = {k: jnp.asarray(v) for k, v in _molecule().items()}

    @jax.jit
    def run(key):
        p = jmod.init_params(cfg, key)

        def energy(pos):
            return jmod.forward(cfg, p, b["species"], pos, b["edge_src"],
                                b["edge_dst"])[0]
        e, g = jax.value_and_grad(energy)(b["positions"])
        loss, grads = jax.value_and_grad(
            lambda pp: jmod.loss_fn(cfg, pp, b))(p)
        return p, e, -g, loss, grads

    out = jax.tree.map(np.asarray, run(jax.random.PRNGKey(0)))
    return out


def _port(arch_id: str, **changes):
    _, tmod, cfg = MODELS[arch_id]
    port_cfg = dataclasses.replace(get_arch(arch_id).smoke, **changes)
    params = gnn_params_from_numpy(_jax_model(arch_id)[0], device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _molecule().items()}
    return tmod, port_cfg, params, batch


@pytest.mark.parametrize("arch_id", list(MODELS))
def test_energy_and_forces_match_jax(arch_id):
    _, e, f, _, _ = _jax_model(arch_id)
    tmod, cfg, params, batch = _port(arch_id)
    got_e, got_f = TNQ.energy_and_forces(
        lambda pos: tmod.forward(cfg, params, batch["species"], pos,
                                 batch["edge_src"], batch["edge_dst"]),
        batch, create_graph=False)
    np.testing.assert_allclose(float(got_e.detach()), float(e), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_f.numpy(), f, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch_id", list(MODELS))
def test_loss_gradients_match_jax_and_are_finite(arch_id):
    """The loss differentiates the forces: its parameter gradients (a
    gradient of a gradient, through the padding self loop) within 1e-4 of
    JAX's norms, every one finite."""
    _, _, _, loss, grads = _jax_model(arch_id)
    tmod, cfg, params, batch = _port(arch_id)
    got, got_g = TS.loss_and_grads(lambda p, b: tmod.loss_fn(cfg, p, b),
                                   params, batch)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    want = dict(leaves_with_paths(gnn_params_from_numpy(grads,
                                                        device="cpu")))
    assert set(want) == {p for p, _ in leaves_with_paths(got_g)}
    for path, g in leaves_with_paths(got_g):
        assert torch.isfinite(g).all(), path
        w = want[path]
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-7, path


@pytest.mark.parametrize("arch_id", list(MODELS))
def test_remat_changes_no_gradient(arch_id, monkeypatch):
    """JAX's scan checkpoints each layer.  The port checkpoints
    EquiformerV2's, which under the forces' double backward keeps less,
    and not NequIP's, which keeps no less; the other choice, patched in,
    gives the same loss and gradients (1e-6)."""
    from torch.utils.checkpoint import checkpoint
    tmod, cfg, params, batch = _port(arch_id)
    layer, calls = tmod._layer, []

    def remat(*a):
        calls.append(1)
        return checkpoint(layer, *a, use_reentrant=False)

    def plain(fn, *a, use_reentrant):
        calls.append(1)
        return fn(*a)

    def run():
        return TS.loss_and_grads(lambda p, b: tmod.loss_fn(cfg, p, b),
                                 params, batch)
    l2, g2 = run()
    if arch_id == "equiformer-v2":
        monkeypatch.setattr(tmod, "checkpoint", plain)
    else:
        monkeypatch.setattr(tmod, "_layer", remat)
    l1, g1 = run()
    assert len(calls) == cfg.n_layers
    assert float(l1) == float(l2)
    for (_, a), (_, b) in zip(leaves_with_paths(g1), leaves_with_paths(g2)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_equiformer_edge_chunks_equal_the_unchunked_forward():
    """Three edge blocks, the last one padded, against one: energy and
    features, and the loss's gradients."""
    tmod, cfg, params, batch = _port("equiformer-v2")
    args = (batch["species"], batch["positions"], batch["edge_src"],
            batch["edge_dst"])
    chunked = dataclasses.replace(cfg, edge_chunk=20)      # 57 edges
    e0, x0 = tmod.forward(cfg, params, *args)
    e1, x1 = tmod.forward(chunked, params, *args)
    torch.testing.assert_close(e1, e0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x1, x0, atol=1e-5, rtol=1e-5)
    g0 = TS.loss_and_grads(lambda p, b: tmod.loss_fn(cfg, p, b), params,
                           batch)[1]
    g1 = TS.loss_and_grads(lambda p, b: tmod.loss_fn(chunked, p, b), params,
                           batch)[1]
    for (_, a), (_, b) in zip(leaves_with_paths(g1), leaves_with_paths(g0)):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm()) + 1e-7


def _pairs(n: int):
    es, ed = np.meshgrid(np.arange(n), np.arange(n))
    m = es != ed
    return (torch.from_numpy(es[m].astype(np.int32)),
            torch.from_numpy(ed[m].astype(np.int32)))


@pytest.mark.parametrize("arch_id", list(MODELS))
def test_energy_is_rotation_invariant(arch_id):
    """``tests/test_models.py``'s check on the port: l_max 2 NequIP, l_max
    3 / m_max 2 EquiformerV2, 10 atoms, the energy within 1e-3 (relative)
    under a rotation."""
    rng = np.random.default_rng(0)
    n = 10
    pos = torch.from_numpy((rng.standard_normal((n, 3)) * 2).astype(
        np.float32))
    spec = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    es, ed = _pairs(n)
    if arch_id == "nequip":
        cfg = TNQ.NequIPConfig(name="x", n_layers=2, d_hidden=8, l_max=2,
                               n_rbf=4)
        mod = TNQ
    else:
        cfg = TEQ.EquiformerV2Config(name="x", n_layers=2, d_hidden=16,
                                     l_max=3, m_max=2, n_heads=4, n_rbf=4)
        mod = TEQ
    p = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    Q = torch.from_numpy(_rotation(7))
    with torch.no_grad():
        e1, _ = mod.forward(cfg, p, spec, pos, es, ed)
        e2, _ = mod.forward(cfg, p, spec, pos @ Q.T, es, ed)
    assert abs(float(e1 - e2)) < 1e-3 * max(1.0, abs(float(e1)))


def test_nequip_forces_rotate_with_the_frame():
    """F(R x) = R F(x), ``tests/test_models.py``'s check on the port."""
    rng = np.random.default_rng(1)
    n = 8
    pos = torch.from_numpy((rng.standard_normal((n, 3)) * 2).astype(
        np.float32))
    spec = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    es, ed = _pairs(n)
    cfg = TNQ.NequIPConfig(name="x", n_layers=2, d_hidden=8, l_max=2,
                           n_rbf=4)
    p = TNQ.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    Q = torch.from_numpy(_rotation(3))

    def forces(x):
        return TNQ.energy_and_forces(
            lambda pp: TNQ.forward(cfg, p, spec, pp, es, ed),
            {"positions": x}, create_graph=False)[1]
    torch.testing.assert_close(forces(pos @ Q.T), forces(pos) @ Q.T,
                               atol=2e-4, rtol=0)

"""PyTorch port, DIEN recsys serving against the JAX package on the CPU.

JAX's weights (``dien_params_from_numpy``) and JAX's request batch (fed
to the port as numpy: the port's ``recsys_batch`` draws from a
``torch.Generator``, so its bits cannot be JAX's) through ``user_state``,
``forward`` and ``score_candidates``, within 1e-5 of JAX, at the SMOKE
config and at ``DIENConfig(n_items=1000, seq_len=20)``; ``serve_recsys``
on a given batch gives JAX's scores on the same weights; ``serve.main``
answers ``--arch dien``; the port's ``recsys_batch`` has JAX's shapes,
ranges and label rule and is a pure function of (seed, step, shard).
JAX results are computed once per worker.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dien as jax_dien_cfg
from repro.data import pipeline as JP
from repro.models.recsys import dien as JD
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import recsys_batch
from repro_torch.interop import dien_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.recsys import dien as TD

BATCH, N_CAND = 16, 64
CONFIGS = {"smoke": jax_dien_cfg.SMOKE,
           "seq20": JD.DIENConfig(name="d", n_items=1000, seq_len=20)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_cfg(cfg):
    return TD.DIENConfig(**dataclasses.asdict(cfg))


def _jax_outputs(cfg, params, batch, cand):
    state, tgt = JD.user_state(cfg, params, batch)
    return (state, tgt, JD.forward(cfg, params, batch),
            JD.score_candidates(cfg, params, cand))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's weights, request batch, retrieval batch and outputs (user
    state, target embedding, logits, candidate scores), as numpy: one jit
    for the inputs, one for the outputs."""
    cfg = CONFIGS[name]

    def inputs(key):
        b = JP.recsys_batch(0, 0, BATCH, cfg.seq_len, cfg.n_items,
                            cfg.n_cats)
        items = jax.random.randint(key, (N_CAND,), 0, cfg.n_items)
        cand = {"hist_items": b["hist_items"][:1],
                "hist_cats": b["hist_cats"][:1], "cand_items": items,
                "cand_cats": items % cfg.n_cats}
        return JD.init_params(cfg, key), b, cand

    params, batch, cand = jax.jit(inputs)(jax.random.PRNGKey(0))
    run = jax.jit(functools.partial(_jax_outputs, cfg))
    as_np = functools.partial(jax.tree.map, np.asarray)
    return (run, as_np(params), as_np(batch), as_np(cand),
            as_np(run(params, batch, cand)))


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_dien_matches_jax(name):
    _, params, batch, cand, want = _jax_run(name)
    cfg = _port_cfg(CONFIGS[name])
    p = dien_params_from_numpy(params, device="cpu")
    state, tgt = TD.user_state(cfg, p, _torch(batch))
    got = (state, tgt, TD.forward(cfg, p, _torch(batch)),
           TD.score_candidates(cfg, p, _torch(cand)))
    shapes = ((BATCH, cfg.gru_dim + cfg.d_behavior), (BATCH, cfg.d_behavior),
              (BATCH,), (N_CAND,))
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == w.shape == shape
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def test_serve_recsys_on_jax_batch_gives_jax_scores():
    """The port's seeded weights carried to JAX, JAX's batch fed to
    ``serve_recsys``: JAX's logits within 1e-5."""
    run, _, batch, cand, _ = _jax_run("smoke")
    arch = get_arch("dien")
    stats = {}
    got = serve.serve_recsys(arch, True, BATCH, seed=3, device="cpu",
                             batch_data=batch, stats=stats)
    assert stats["requests"] == BATCH and stats["serve_s"] > 0
    params = TD.init_params(arch.smoke, torch.Generator().manual_seed(3),
                            device="cpu")
    want = run(jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
               batch, cand)[2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="requests"):
        serve.serve_recsys(arch, True, BATCH + 1, seed=3, device="cpu",
                           batch_data=batch)


def test_serve_main_answers_dien(capsys):
    scores = serve.main(["--arch", "dien", "--smoke", "--device", "cpu",
                         "--batch", "8"])
    assert tuple(scores.shape) == (8,) and torch.isfinite(scores).all()
    assert "[serve] dien: scored 8 requests" in capsys.readouterr().out


def test_interop_carries_the_mlp_list():
    _, params, _, _, _ = _jax_run("smoke")
    port = dien_params_from_numpy(params, device="cpu")
    assert isinstance(port["mlp"], list) and len(port["mlp"]) == 3
    for got, want in zip(port["mlp"], params["mlp"]):
        assert sorted(got) == ["b", "w"]
        for name in ("w", "b"):
            np.testing.assert_array_equal(got[name].numpy(), want[name])
    np.testing.assert_array_equal(port["gru"]["wz"].numpy(),
                                  params["gru"]["wz"])
    # the port's init gives JAX's tree: names, shapes and dtypes
    mine = TD.init_params(get_arch("dien").smoke,
                          torch.Generator().manual_seed(0), device="cpu")
    shape = functools.partial(jax.tree.map, lambda t: (tuple(t.shape),
                                                       str(t.dtype)[-7:]))
    assert shape(mine) == jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                       params)


def test_recsys_batch_shapes_ranges_and_determinism():
    n_items, n_cats = 5000, 37
    b = recsys_batch(7, 2, 4096, 12, n_items, n_cats, device="cpu")
    want = JP.recsys_batch(7, 2, 8, 12, n_items, n_cats)
    assert sorted(b) == sorted(want)
    for name, t in b.items():
        assert t.dtype == torch.int32
        assert t.shape[1:] == want[name].shape[1:] and t.shape[0] == 4096
    assert 0 <= int(b["hist_items"].min()) and \
        int(b["hist_items"].max()) < n_items
    assert torch.equal(b["hist_cats"], b["hist_items"] % n_cats)
    assert torch.equal(b["target_cat"], b["target_item"] % n_cats)
    # the label: the target in the history mod 1000, flipped 10% of the time
    appears = (b["hist_items"] % 1000 == (b["target_item"] % 1000)[:, None]
               ).any(1)
    flipped = float((appears.int() != b["label"]).float().mean())
    assert 0.08 < flipped < 0.12
    assert set(b["label"].unique().tolist()) == {0, 1}
    again = recsys_batch(7, 2, 4096, 12, n_items, n_cats, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    for other in (dict(seed=8), dict(step=3), dict(shard=1)):
        kw = {"seed": 7, "step": 2, "shard": 0, **other}
        o = recsys_batch(kw["seed"], kw["step"], 4096, 12, n_items, n_cats,
                         shard=kw["shard"], device="cpu")
        assert not torch.equal(o["hist_items"], b["hist_items"])
    half = recsys_batch(7, 2, 4096, 12, n_items, n_cats, shard=1,
                        n_shards=2, device="cpu")
    assert half["hist_items"].shape == (2048, 12)


def test_recsys_entry_points_need_a_card_unless_asked_for_the_cpu():
    arch = get_arch("dien")
    if torch.cuda.is_available():
        p = TD.init_params(arch.smoke, torch.Generator("cuda"), device=None)
        assert p["item_emb"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_recsys(arch, True, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.init_params(arch.smoke, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys_batch(0, 0, 4, 10, 100, 10)

"""PyTorch port, the training substrate against the JAX package on the CPU.

The optimizer (AdamW, factored second moments with ``beta1`` 0.9 and 0.0,
a bf16 first moment, ``scan_update``) over three steps from
``tests/test_train_substrate.py``'s parameters, and ``schedule_lr``,
against JAX's; checkpoints written by either package restored by the
other, leaves equal and dtypes kept (bf16 included); ``compressed_psum``
and ``psum_grads`` over four ``gloo`` CPU ranks against JAX's under
``jax.vmap(..., axis_name="i")`` on the same four shards; ``lm_batch``
(stateless by step, labels the rolled tokens, the follow rule, ids in the
vocab, JAX's share of the frequent ids); DIEN's SMOKE ``loss_fn`` and
gradients and its train cell; every GNN cell built by ``build_cell``
(meshes refused); and
``launch.train``'s fail, resume and clean runs (the resumed overlap equal
to the clean run exactly).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_ranks

from repro.configs import dien as jax_dien_cfg
from repro.data import pipeline as JP
from repro.models.recsys import dien as JD
from repro.train import checkpoint as JC
from repro.train import compression as JCmp
from repro.train import optimizer as JO
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as TP
from repro_torch.interop import dien_params_from_numpy, opt_state_from_numpy
from repro_torch.launch import mesh
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models.recsys import dien as TD
from repro_torch.train import checkpoint as TC
from repro_torch.train import compression as TCmp
from repro_torch.train import optimizer as TO
from repro_torch.train.tree import leaves, leaves_with_paths, tree_map

OPT_VARIANTS = {
    "adamw": dict(),
    "adamw-scan": dict(scan_update=True),
    "factored": dict(factored=True),
    "factored-bf16-scan": dict(factored=True, m_dtype="bfloat16",
                               scan_update=True),
    "factored-beta1-0": dict(factored=True, beta1=0.0, m_dtype="bfloat16",
                             scan_update=True, grad_clip=0.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return opt_state_from_numpy(tree, device="cpu")


def _assert_tree(got, want, **tol):
    """Every leaf of the numpy tree ``want`` against ``got``'s at its
    path, dtypes equal."""
    got_flat = {p: g for p, g in leaves_with_paths(got)}
    want_flat = {tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in path): w
                 for path, w in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got_flat) == set(want_flat)
    for path, w in want_flat.items():
        g = got_flat[path]
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# the optimizer


def _quad_params(seed=0):
    """``test_train_substrate.py``'s parameters, and three steps' random
    gradients."""
    rng = np.random.default_rng(seed)
    params = {"w": np.asarray([1.0, -2.0, 3.0], np.float32),
              "layers": {"k": np.ones((4, 8, 3), np.float32),
                         "b": rng.standard_normal((4, 3)).astype(
                             np.float32)}}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.1)
                          .astype(np.float32), params) for _ in range(3)]
    return params, grads


@functools.lru_cache(maxsize=None)
def _jax_opt_run(name):
    cfg = JO.OptConfig(lr=0.1, warmup_steps=2, total_steps=10,
                       **OPT_VARIANTS[name])
    params, grads = _quad_params()
    p = jax.tree.map(jnp.asarray, params)
    s = JO.init_opt_state(p, cfg)
    step = jax.jit(functools.partial(JO.apply_updates, cfg=cfg))
    for g in grads:
        p, s = step(p, g, s)
    return _np_tree(p), _np_tree(s)


@pytest.mark.parametrize("name", list(OPT_VARIANTS))
def test_optimizer_matches_jax(name):
    cfg = TO.OptConfig(lr=0.1, warmup_steps=2, total_steps=10,
                       **OPT_VARIANTS[name])
    params, grads = _quad_params()
    p = _torch_tree(params)
    s = TO.init_opt_state(p, cfg)
    for g in grads:
        p, s = TO.apply_updates(p, _torch_tree(g), s, cfg)
    want_p, want_s = _jax_opt_run(name)
    _assert_tree(p, want_p, atol=1e-6, rtol=1e-5)
    _assert_tree(s, want_s, atol=1e-7, rtol=1e-4)
    if cfg.factored:
        assert set(s["v"]["layers"]["k"]) == {"vr", "vc"}
        assert s["v"]["w"].shape == (3,)          # 1-D leaves stay dense
    if cfg.beta1 == 0.0:
        assert s["m"]["layers"]["k"].shape == ()


def test_schedule_lr_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, schedule="constant", warmup_steps=5)):
        jcfg, tcfg = JO.OptConfig(**kw), TO.OptConfig(**kw)
        steps = np.arange(0, 120, 7, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda t: JO.schedule_lr(jcfg, t))(
            jnp.asarray(steps)))
        got = TO.schedule_lr(tcfg, torch.from_numpy(steps)).numpy()
        # within an f32 rounding of the cosine (scaled by lr)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * kw["lr"])
        assert float(TO.schedule_lr(tcfg, 0)) == pytest.approx(
            float(want[0]), rel=1e-6)


def test_global_norm_and_unused_inputs():
    params, grads = _quad_params()
    g = _torch_tree(grads[0])
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, grads[0])))
    assert float(TO.global_norm(g)) == pytest.approx(want, rel=1e-6)
    p = _torch_tree(params)
    cfg = TO.OptConfig()
    s = TO.init_opt_state(p, cfg)
    before = [x.clone() for x in leaves(p)]
    TO.apply_updates(p, g, s, cfg)
    for x, y in zip(leaves(p), before):        # nothing updated in place
        assert torch.equal(x, y)
    assert int(s["step"]) == 0


# ---------------------------------------------------------------------------
# checkpoints across the two packages


def _ckpt_tree():
    rng = np.random.default_rng(5)
    return ({"embed": rng.standard_normal((4, 3)).astype(np.float32),
             "layers": {"wq": rng.standard_normal((2, 3, 3)).astype(
                 np.float32)},
             "mlp": [{"w": np.arange(6, dtype=np.int32).reshape(2, 3)}]},
            {"m": {"embed": np.zeros((), np.float32)},
             "v": {"layers": {"wq": {"vr": np.ones((2, 3), np.float32),
                                     "vc": np.full((2, 3), 2.0,
                                                   np.float32)}}},
             "step": np.asarray(7, np.int32)})


def _with_bf16(tree, to_bf16):
    """``tree`` with its ``embed`` leaf in bf16 (by ``to_bf16``)."""
    params, opt = tree
    return ({**params, "embed": to_bf16(params["embed"])}, opt)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tree = _with_bf16(_ckpt_tree(), lambda x: jnp.asarray(x, jnp.bfloat16))
    JC.save_checkpoint(str(tmp_path), 3, tree, extra={"seed": 1})
    like = _with_bf16(tuple(_torch_tree(t) for t in _ckpt_tree()),
                      lambda x: x.bfloat16())
    assert TC.latest_step(str(tmp_path)) == 3
    got, step, extra = TC.restore_checkpoint(str(tmp_path), like)
    assert (step, extra) == (3, {"seed": 1}) and isinstance(got, tuple)
    _assert_tree(got, _np_tree(tree), atol=0, rtol=0)
    assert got[0]["embed"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _with_bf16(tuple(_torch_tree(t) for t in _ckpt_tree()),
                      lambda x: x.bfloat16())
    TC.save_checkpoint(str(tmp_path), 12, tree, extra={"seed": 2})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000012.json", "ckpt_00000012.npz"]
    like = _with_bf16(jax.tree.map(jnp.asarray, _ckpt_tree()),
                      lambda x: x.astype(jnp.bfloat16))
    got, step, extra = JC.restore_checkpoint(str(tmp_path), like)
    assert (step, extra) == (12, {"seed": 2})
    assert got[0]["embed"].dtype == jnp.bfloat16
    _assert_tree(tree, _np_tree(got), atol=0, rtol=0)
    # the keys are JAX's: dict keys and indices joined by "/"
    with np.load(tmp_path / "ckpt_00000012.npz") as z:
        assert sorted(z.files) == [
            "0/embed", "0/layers/wq", "0/mlp/0/w", "1/m/embed", "1/step",
            "1/v/layers/wq/vc", "1/v/layers/wq/vr"]


# ---------------------------------------------------------------------------
# compressed gradient sums over four ranks

def test_compressed_psum_matches_jax_over_four_ranks():
    comp, exact, comp_tree = mesh.spawn(torch_train_ranks.psum_rank, 4,
                                        backend="gloo", device="cpu")
    xs = jnp.asarray(torch_train_ranks.SHARDS
                     * np.arange(1, 5, dtype=np.float32)[:, None])

    def per_rank(x):
        g = {"a": x, "b": [x[:8] * 3.0]}
        return (JCmp.compressed_psum(x, "i"), JCmp.psum_grads(g, "i"),
                JCmp.psum_grads(g, "i", "int8"))

    want = _np_tree(jax.jit(jax.vmap(per_rank, axis_name="i"))(xs))
    np.testing.assert_allclose(comp.numpy(), want[0][0], atol=1e-6)
    for got, w in ((exact, want[1]), (comp_tree, want[2])):
        np.testing.assert_allclose(got["a"].numpy(), w["a"][0], atol=1e-6)
        np.testing.assert_allclose(got["b"][0].numpy(), w["b"][0][0],
                                   atol=1e-6)
    # int8 is close to the exact sum, and one rank is quantize-dequantize
    assert float((comp - exact["a"]).abs().max()) < 0.05
    x = torch.from_numpy(torch_train_ranks.SHARDS[1])
    assert float((TCmp.compressed_psum(x, None) - x).abs().max()) < 0.01


# ---------------------------------------------------------------------------
# the LM batch


def _redraw(seed, step, batch, seq, vocab):
    """The base ids and the follow coin of ``lm_batch``'s draws."""
    g = TP._generator(seed, step, 0, torch.device("cpu"))
    logits = torch.zeros(vocab)
    logits[:min(vocab, 256)] = 3.0
    base = torch.multinomial(torch.softmax(logits, 0), batch * seq,
                             replacement=True, generator=g).view(batch, seq)
    return base, torch.rand((batch, seq), generator=g) < 0.5


def test_lm_batch_rule_and_statelessness():
    b = TP.lm_batch(0, 5, 8, 64, 512, device="cpu")
    assert all(t.dtype == torch.int32 and t.shape == (8, 64)
               for t in b.values())
    assert torch.equal(TP.lm_batch(0, 5, 8, 64, 512, device="cpu")["tokens"],
                       b["tokens"])
    assert not torch.equal(TP.lm_batch(0, 6, 8, 64, 512,
                                       device="cpu")["tokens"], b["tokens"])
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, 1))
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 512
    base, follow = _redraw(0, 5, 8, 64, 512)
    want = torch.where(follow, (torch.roll(base, 1, 1) + 1) % 512, base)
    assert torch.equal(b["tokens"], want.to(torch.int32))
    assert 0.4 < float(follow.float().mean()) < 0.6
    # JAX's distribution: the share of ids among the first 257
    big = TP.lm_batch(1, 0, 16, 512, 512, device="cpu")["tokens"]
    jax_big = np.asarray(jax.jit(lambda: JP.lm_batch(1, 0, 16, 512, 512))()[
        "tokens"])
    assert abs(float((big < 257).float().mean())
               - float((jax_big < 257).mean())) < 0.01
    # a shard is its slice of the batch size, and ids wrap at the vocab
    assert TP.lm_batch(0, 0, 8, 16, 300, shard=1, n_shards=2,
                       device="cpu")["tokens"].shape == (4, 16)
    small = TP.lm_batch(0, 0, 4, 64, 200, device="cpu")["tokens"]
    assert int(small.max()) < 200


# ---------------------------------------------------------------------------
# DIEN's training


@functools.lru_cache(maxsize=None)
def _jax_dien():
    cfg = jax_dien_cfg.SMOKE

    def inputs(key):            # one jit: eager JAX compiles op by op
        return (JD.init_params(cfg, key),
                JP.recsys_batch(0, 0, 16, cfg.seq_len, cfg.n_items,
                                cfg.n_cats))

    params, batch = jax.jit(inputs)(jax.random.PRNGKey(0))
    run = jax.jit(jax.value_and_grad(functools.partial(JD.loss_fn, cfg)))
    return _np_tree(params), _np_tree(batch), _np_tree(run(params, batch))


def test_dien_loss_and_grads_match_jax():
    params_np, batch, (loss, grads) = _jax_dien()
    cfg = TD.DIENConfig(**dataclasses.asdict(jax_dien_cfg.SMOKE))
    params = dien_params_from_numpy(params_np, device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    got_loss, got_grads = TS.loss_and_grads(
        functools.partial(TD.loss_fn, cfg), params, tb)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
    _assert_tree(got_grads, grads, atol=1e-6, rtol=1e-4)
    # serving keeps no graph
    assert not TD.score_candidates(cfg, params, {
        "hist_items": tb["hist_items"][:1], "hist_cats": tb["hist_cats"][:1],
        "cand_items": tb["target_item"],
        "cand_cats": tb["target_cat"]}).requires_grad


def test_dien_train_cell_step():
    params_np, batch, (loss, grads) = _jax_dien()
    cell = TS.build_cell("dien", "train_batch", smoke=True)
    assert (cell.kind, cell.n_micro) == ("train", 1)
    params = dien_params_from_numpy(params_np, device="cpu")
    state = TO.init_opt_state(params, cell.opt_cfg)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    new_p, new_s, got = cell.fn(params, state, tb)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    # the first AdamW step's first moment is (1 - beta1) times the
    # clipped gradient
    clip = min(1.0, 1.0 / float(JO.global_norm(grads)))
    _assert_tree(new_s["m"], jax.tree.map(lambda g: 0.1 * clip * g, grads),
                 atol=1e-7, rtol=1e-4)
    assert int(new_s["step"]) == 1
    assert not torch.equal(new_p["mlp"][0]["w"], params["mlp"][0]["w"])
    serve = TS.build_cell("dien", "serve_p99", smoke=True)
    assert serve.fn(new_p, tb).shape == (16,)


def test_build_cell_refuses_gnn_archs_and_meshes():
    """Every GNN (arch, shape) cell builds now, a train cell without
    microbatches under ``OptConfig()``; a mesh still raises."""
    for arch_id in ("gat-cora", "graphsage-reddit", "nequip",
                    "equiformer-v2"):
        for shape in get_arch(arch_id).shapes:
            cell = TS.build_cell(arch_id, shape)
            assert (cell.kind, cell.n_micro, cell.opt_cfg) == (
                "train", 1, TO.OptConfig())
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                TS.build_cell(arch_id, shape, mesh=object())
    assert TS.build_cell("gat-cora", "full_graph_sm").cfg.d_in == 1433
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.build_cell("qwen3-0.6b", "train_4k", mesh=object())
    cell = TS.build_cell("qwen3-0.6b", "train_4k")
    assert (cell.n_micro, cell.cfg.ce_chunk) == (4, 512)
    assert TS.build_cell("qwen3-0.6b", "train_4k", smoke=True).n_micro == 1
    assert TS.opt_config_for("qwen3-0.6b") == TO.OptConfig(scan_update=True)
    assert TS.train_policy_for("yi-34b") == (8, 512, "bfloat16")
    assert TS.build_cell("qwen3-0.6b", "decode_32k").kind == "decode"


# ---------------------------------------------------------------------------
# the launcher: fail, resume, clean


def test_train_restart_bit_exact(tmp_path, capsys):
    """Crash at step 6, resume, and match an uninterrupted run exactly:
    ``test_train_substrate.py``'s run, on the port."""
    args = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "10", "--batch",
            "4", "--seq", "16", "--device", "cpu"]
    d1 = str(tmp_path / "ck_crash")
    with pytest.raises(SystemExit) as exc:
        TT.main(args + ["--ckpt-dir", d1, "--ckpt-every", "3",
                        "--fail-at", "6"])
    assert exc.value.code == 42
    stats: list = []
    resumed = TT.main(args + ["--ckpt-dir", d1, "--ckpt-every", "3"],
                      stats=stats)
    clean = TT.main(args)
    assert "[train] resumed from step 6" in capsys.readouterr().out
    assert len(resumed) == 4 and len(clean) == 10
    assert resumed == clean[-4:]
    assert [s["step"] for s in stats] == [6, 7, 8, 9]
    assert all(s["loss"] == l and s["wall_s"] > 0 and s["rate"] > 0
               for s, l in zip(stats, resumed))


def test_train_dien_and_microbatched_lm_on_the_cpu(monkeypatch):
    losses = TT.main(["--arch", "dien", "--smoke", "--steps", "2",
                      "--batch", "32", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    # a cell with microbatches takes its batch as [n_micro, B / n_micro, S]
    shapes = []
    build = TS.build_cell
    monkeypatch.setattr(TS, "train_policy_for",
                        lambda *a, **k: (2, 0, "float32"))

    def forced(*a, **kw):
        cell = build(*a, **kw)
        fn = cell.fn
        cell.fn = lambda p, s, b: (shapes.append(b["tokens"].shape),
                                   fn(p, s, b))[1]
        return cell

    monkeypatch.setattr(TT, "build_cell", forced)
    TT.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1", "--batch",
             "4", "--seq", "8", "--device", "cpu"])
    assert shapes == [(2, 2, 8)]
    with pytest.raises(ValueError, match="microbatches"):
        TT.make_batch(get_arch("qwen3-0.6b"), get_arch("qwen3-0.6b").smoke,
                      0, 3, 8, 0, n_micro=2, device="cpu")
    assert tree_map(lambda x: x * 2, {"a": [1, 2]}) == {"a": [2, 4]}

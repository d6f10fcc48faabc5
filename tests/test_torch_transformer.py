"""PyTorch port, the transformer's serving path against the JAX package at
Qwen3-0.6B's SMOKE widths (2 layers, d_model 64, 4 query and 2 key/value
heads, d_head 32, qk_norm, vocab 512): JAX's weights carried across with
``transformer_params_from_numpy``, then ``prefill`` (last-token logits and
the K/V cache), eight greedy ``decode_step``s and a 4-token chunk,
``forward`` and ``serve_lm``, on the CPU, where attention runs the flash
kernel's plain version.  JAX results are computed once per worker."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jax_qwen
from repro.models import transformer as JT
from repro_torch.configs import qwen3_0_6b as port_qwen
from repro_torch.configs.registry import get_arch
from repro_torch.interop import transformer_params_from_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models import transformer as TT

B, S, STEPS, CHUNK = 2, 16, 8, 4
CACHE = S + STEPS + CHUNK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(impl="naive", dtype="float32"):
    return (dataclasses.replace(jax_qwen.SMOKE, attn_impl=impl, dtype=dtype),
            dataclasses.replace(port_qwen.SMOKE, attn_impl=impl, dtype=dtype))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    return JT.init_params(_cfgs(dtype=dtype)[0], jax.random.PRNGKey(0))


def _port_params(dtype):
    return transformer_params_from_numpy(
        jax.tree.map(np.asarray, _jax_params(dtype)), device="cpu")


def _f32(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_serving(impl, dtype):
    """JAX prefill, STEPS greedy decode steps and one CHUNK-token step:
    (prefill logits, cache k, cache v, [(step logits, token)], chunk
    logits), as numpy."""
    cfg = _cfgs(impl, dtype)[0]
    params = _jax_params(dtype)
    logits, cache = jax.jit(lambda p, t: JT.prefill(cfg, p, t, cache_len=CACHE)
                            )(params, jnp.asarray(_tokens((B, S), 0)))
    out = (_f32(logits), _f32(cache["k"]), _f32(cache["v"]))
    decode = jax.jit(lambda p, c, t, pos: JT.decode_step(cfg, p, c, t, pos))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    steps = []
    for i in range(STEPS):
        logits, cache = decode(params, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        steps.append((_f32(logits), np.asarray(tok)))
    chunk, _ = decode(params, cache, jnp.asarray(_tokens((B, CHUNK), 1)),
                      jnp.int32(S + STEPS))
    return out + (steps, _f32(chunk))


def _port_serving(impl, dtype):
    cfg = _cfgs(impl, dtype)[1]
    params = _port_params(dtype)
    logits, cache = TT.prefill(cfg, params, torch.from_numpy(
        _tokens((B, S), 0)), cache_len=CACHE)
    # copies: the decode steps below write into this cache in place
    out = (logits.float().numpy(), cache["k"].float().numpy().copy(),
           cache["v"].float().numpy().copy())
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    steps = []
    for i in range(STEPS):
        logits, cache = TT.decode_step(cfg, params, cache, tok, S + i)
        tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
        steps.append((logits.float().numpy(), tok.numpy()))
    chunk, _ = TT.decode_step(cfg, params, cache, torch.from_numpy(
        _tokens((B, CHUNK), 1)), S + STEPS)
    return out + (steps, chunk.float().numpy())


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_prefill_and_decode_match_jax(impl):
    """f32: logits and cache within 1e-5, the same greedy tokens, and the
    4-token chunk, whose grouped-head rows are (head, position) pairs."""
    flash_ops.reset_counts()
    want = _jax_serving(impl, "float32")
    got = _port_serving(impl, "float32")
    assert flash_ops.ref.attention_ref.calls == 2        # one per layer
    assert flash_ops.LAUNCHES["flash_attention"] == 0
    for name, g, w in zip(("logits", "k", "v"), got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    assert np.abs(got[1][:, :, :, S:]).max() == 0       # zeros past S
    for i, ((g, gt), (w, wt)) in enumerate(zip(got[3], want[3])):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_array_equal(gt, wt)
    assert got[4].shape == (B, CHUNK, 512)
    np.testing.assert_allclose(got[4], want[4], atol=1e-5)


def test_prefill_and_decode_match_jax_bf16():
    """bf16 weights and activations.  Both round every product and norm to
    bf16, but at other places (XLA fuses and keeps some intermediates in
    f32; PyTorch rounds each op's output), so a value differs by a bf16 ulp
    (2^-8 relative) here and there, and that grows through two layers: the
    logits and the cache are held to 0.03 of their own range (they differ
    by up to 0.015 of it), and the greedy tokens must be JAX's."""
    want = _jax_serving("naive", "bfloat16")
    got = _port_serving("naive", "bfloat16")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=0.03 * np.abs(w).max())
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))
    for (g, gt), (w, wt) in zip(got[3], want[3]):
        np.testing.assert_allclose(g, w, atol=0.03 * np.abs(w).max())
        np.testing.assert_array_equal(gt, wt)


def test_forward_matches_jax():
    jcfg, tcfg = _cfgs()
    toks = _tokens((B, S), 2)
    want, aux = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(
        _jax_params("float32"), jnp.asarray(toks))
    got, got_aux = TT.forward(tcfg, _port_params("float32"),
                              torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5)
    assert float(got_aux) == float(aux) == 0.0


def test_serve_lm_matches_jax_greedy_tokens():
    """serve_lm on the CPU with a given prompt decodes JAX's tokens: the
    JAX side runs its prefill and decode loop on the port's weights."""
    arch = get_arch("qwen3-0.6b")
    prompt = _tokens((B, S), 3)
    gen = 6
    got = serve.serve_lm(arch, True, B, S, gen, seed=5, device="cpu",
                         prompt=prompt)
    assert got.shape == (B, gen) and got.dtype == torch.int32
    cfg = _cfgs()[0]
    params = jax.tree.map(
        lambda t: jnp.asarray(t.numpy()),
        TT.init_params(port_qwen.SMOKE, torch.Generator().manual_seed(5),
                       device="cpu"))
    logits, cache = JT.prefill(cfg, params, jnp.asarray(prompt),
                               cache_len=S + gen)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    decode = jax.jit(lambda p, c, t, pos: JT.decode_step(cfg, p, c, t, pos))
    for i in range(gen - 1):
        logits, cache = decode(params, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))


def test_interop_is_bit_exact_on_bf16():
    tree = jax.tree.map(np.asarray, _jax_params("bfloat16"))
    port = transformer_params_from_numpy(tree, device="cpu")
    for name, leaf in [("embed", tree["embed"]),
                       ("wq", tree["layers"]["wq"]),
                       ("q_norm", tree["layers"]["q_norm"])]:
        t = port["embed"] if name == "embed" else port["layers"][name]
        assert leaf.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        assert t.shape == leaf.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      leaf.view(np.int16))
    assert sorted(port["layers"]) == sorted(tree["layers"])


def test_init_cache_matches_jax():
    want = JT.init_cache(jax_qwen.SMOKE, 3, 40)
    got = TT.init_cache(port_qwen.SMOKE, 3, 40, device="cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.float32 == getattr(
            torch, str(want[name].dtype))
        assert not got[name].any()
    bf16 = TT.init_cache(port_qwen.CONFIG, 1, 8, device="cpu")
    assert bf16["k"].dtype == torch.bfloat16
    assert tuple(bf16["k"].shape) == (28, 1, 8, 8, 128)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    arch = get_arch("qwen3-0.6b")
    if torch.cuda.is_available():
        p = TT.init_params(arch.smoke, torch.Generator("cuda"), device=None)
        assert p["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_lm(arch, True, 1, 4, 2, seed=0, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(arch.smoke, torch.Generator(), device=None)


def test_unported_parts_raise():
    """Every arch resolves now, the GNN ids to their family and configs
    (the same fields as the JAX package's, the port's equivariant configs
    adding ``remat``), their cells build; an unknown id still raises
    ``KeyError``, a mesh ``NotImplementedError``; the training functions
    are ported."""
    from repro.configs import registry as jax_registry
    for arch_id in ("gat-cora", "graphsage-reddit", "nequip",
                    "equiformer-v2"):
        arch, want = get_arch(arch_id), jax_registry.get_arch(arch_id)
        assert (arch.family, arch.shapes) == ("gnn", want.shapes)
        for cfg, jax_cfg in ((arch.config, want.config),
                             (arch.smoke, want.smoke)):
            assert type(cfg).__name__ == type(jax_cfg).__name__
            fields = dataclasses.asdict(cfg)
            assert fields.pop("remat", True) is True
            assert fields == dataclasses.asdict(jax_cfg)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dien
    assert steps.build_cell("graphsage-reddit", "minibatch_lg").cfg \
        .sample_sizes == (15, 10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        steps.build_cell("graphsage-reddit", "minibatch_lg", mesh=object())
    for module, name in ((TT, "loss_fn"), (TT, "loss_fn_chunked"),
                         (TT, "forward_hidden"), (dien, "loss_fn"),
                         (pipeline, "lm_batch"), (pipeline, "molecule_batch"),
                         (pipeline, "node_classification_data")):
        assert callable(getattr(module, name))
    assert [get_arch(a).family for a in (
        "deepseek-moe-16b", "kimi-k2-1t-a32b", "yi-34b",
        "command-r-plus-104b", "dien")] == ["lm"] * 4 + ["recsys"]
    # serve --mine is ported: it answers where it used to raise
    (res,) = serve.main(["--mine", "--graph", "clique:5", "--queries", "tc",
                         "--device", "cpu"])
    assert res["result"].count == 10
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(port_qwen.SMOKE, attn_impl="sdpa")
    assert port_qwen.CONFIG.param_count() == jax_qwen.CONFIG.param_count()
    assert dataclasses.asdict(port_qwen.CONFIG) == dataclasses.asdict(
        jax_qwen.CONFIG)

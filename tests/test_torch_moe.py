"""PyTorch port, the MoE serving path against the JAX package on the CPU.

``apply_moe`` at ``MoEConfig(n_routed=8, top_k=2, d_ff=32, n_shared=2)``
on ``tests/test_models.py``'s inputs (d_model 8, 16 tokens, JAX's weights
carried across), with capacity factors 2.0 and 0.5 (drops): the dispatch
integers exactly JAX's, ``y`` within 1e-5 and the aux loss within 1e-6
(f32).  The DeepSeek-MoE-16B and Kimi-K2 SMOKE models (the port's seeded
weights carried to JAX) through ``forward``,
``prefill``, eight greedy ``decode_step``s, ``prefill_chunked`` and
``serve_lm``: logits within 1e-4 and JAX's greedy tokens.  The registry's
new LM configs field-equal to JAX's, their parameter counts, the ``moe``
subtree carried bit for bit.  JAX results are computed once per worker,
each in one jit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs.registry import get_arch
from repro_torch.interop import transformer_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

MOE_ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
LM_ARCHS = MOE_ARCHS + ("yi-34b", "command-r-plus-104b")
B, S, STEPS, CHUNK = 2, 16, 8, 4
CACHE = S + STEPS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moe_cfg(cf):
    return JM.MoEConfig(n_routed=8, top_k=2, d_ff=32, n_shared=2,
                        capacity_factor=cf)


def _port_moe_cfg(cfg):
    return TM.MoEConfig(**dataclasses.asdict(cfg))


def _jax_dispatch(params, x, cfg):
    """JAX's routing and dispatch integers, in ``repro.models.moe``'s
    arithmetic (``apply_moe`` returns only y and aux): expert [T, K],
    order, slot and keep over the sorted assignments."""
    t = x.shape[0]
    e, k = cfg.n_routed, cfg.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
    _, expert = jax.lax.top_k(probs, k)
    capacity = int(max(1, round(t * k / e * cfg.capacity_factor)))
    e_flat = expert.reshape(-1)
    order = jnp.argsort(e_flat)
    sorted_e = e_flat[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(e), side="left")
    pos = jnp.arange(t * k) - starts[sorted_e]
    return expert, order, sorted_e * capacity + pos, pos < capacity


CAPACITY_FACTORS = (2.0, 0.5)


@functools.lru_cache(maxsize=None)
def _jax_moe(dtype="float32"):
    """JAX's weights, tokens, y, aux and dispatch integers at
    ``tests/test_models.py``'s keys, for each capacity factor (one jit),
    as numpy, with the capacity."""
    cfgs = [_moe_cfg(cf) for cf in CAPACITY_FACTORS]

    def run(key):
        x = jax.random.normal(jax.random.PRNGKey(1), (16, 8)).astype(dtype)
        out = []
        for cfg in cfgs:
            params = JM.init_moe(key, 8, cfg, jnp.dtype(dtype))
            out.append((params, x) + JM.apply_moe(params, x, cfg)
                       + (_jax_dispatch(params, x, cfg),))
        return out

    return {cfg.capacity_factor: (
        jax.tree.map(np.asarray, params), np.asarray(x),
        np.asarray(y.astype(jnp.float32)), float(aux),
        tuple(np.asarray(a) for a in dispatch)
        + (int(max(1, round(16 * cfg.top_k / cfg.n_routed
                            * cfg.capacity_factor))),))
        for cfg, (params, x, y, aux, dispatch) in zip(
            cfgs, jax.jit(run)(jax.random.PRNGKey(0)))}


def _port_tensor(a):
    return transformer_params_from_numpy({"a": a}, device="cpu")["a"]


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_apply_moe_matches_jax(cf):
    tree, x, y, aux, (expert, order, slot, keep, cap) = _jax_moe()[cf]
    params = transformer_params_from_numpy(tree, device="cpu")
    cfg = _port_moe_cfg(_moe_cfg(cf))
    r = TM.route(params, torch.from_numpy(x), cfg)
    assert r.capacity == cap == TM.capacity(16, cfg)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert keep.all() == (cf == 2.0)              # 0.5 drops, 2.0 does not
    got, got_aux = TM.apply_moe(params, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), y, atol=1e-5, rtol=0)
    assert abs(float(got_aux) - aux) <= 1e-6


def test_apply_moe_matches_jax_bf16():
    """bf16 tokens and experts (the router stays f32, so the dispatch is
    JAX's exactly); the expert products and the combine round to bf16 at
    other places than XLA's, so y is held to 2 bf16 ulps of its range."""
    tree, x, y, aux, (expert, _, slot, keep, _) = _jax_moe("bfloat16")[2.0]
    params = transformer_params_from_numpy(tree, device="cpu")
    assert params["router"].dtype == torch.float32
    assert params["w1"].dtype == torch.bfloat16
    xt = _port_tensor(x)
    cfg = _port_moe_cfg(_moe_cfg(2.0))
    r = TM.route(params, xt, cfg)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    got, got_aux = TM.apply_moe(params, xt, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), y,
                               atol=2 * 2 ** -8 * np.abs(y).max())
    assert abs(float(got_aux) - aux) <= 1e-6


def test_top_k_ties_go_to_the_lower_index():
    """A router whose columns repeat gives exact ties; jax.lax.top_k takes
    the lower expert first, and so does the port."""
    cfg = _moe_cfg(2.0)
    rng = np.random.default_rng(3)
    cols = rng.standard_normal((8, 4)).astype(np.float32)
    router = np.concatenate([cols, cols], axis=1)[:, [0, 4, 1, 5, 2, 6, 3,
                                                      7]]
    x = rng.standard_normal((16, 8)).astype(np.float32)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router), 2)
    r = TM.route({"router": torch.from_numpy(router)}, torch.from_numpy(x),
                 _port_moe_cfg(cfg))
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(want))
    assert (r.expert[:, 0] + 1 == r.expert[:, 1]).all()    # the tie pairs


def test_capacity_follows_the_host_formula():
    moe = get_arch("deepseek-moe-16b").config.moe
    # decode at batch 4 keeps one slot an expert; sets A and B of the card
    assert [TM.capacity(t, moe) for t in (4, 4 * 4096, 32768)] == \
        [1, 1920, 3840]
    # Python's round: half to even
    cfg = TM.MoEConfig(n_routed=4, top_k=1, d_ff=4, capacity_factor=1.0)
    assert [TM.capacity(t, cfg) for t in (2, 6, 10)] == [1, 2, 2]


def _jax_cfg(arch_id, dtype="float32"):
    return dataclasses.replace(jax_registry.get_arch(arch_id).smoke,
                               dtype=dtype)


def _port_cfg(arch_id, dtype="float32"):
    return dataclasses.replace(get_arch(arch_id).smoke, dtype=dtype)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def _f32(x):
    return np.asarray(x, np.float32)


def _port_params(arch_id, dtype, seed=0):
    return TT.init_params(_port_cfg(arch_id, dtype),
                          torch.Generator().manual_seed(seed), device="cpu")


def _to_jax(params):
    """The port's weights as JAX arrays, bf16 leaves bit for bit."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy())
    return jax.tree.map(leaf, params)


def _jax_run(cfg, params, toks):
    """JAX forward (logits, aux), prefill (logits, cache k), STEPS greedy
    decode steps (logits, tokens) and prefill_chunked (logits, cache v):
    one jit."""
    fwd, aux = JT.forward(cfg, params, toks)
    logits, cache = JT.prefill(cfg, params, toks, cache_len=CACHE)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)

    def step(carry, i):
        cache, tok = carry
        lg, cache = JT.decode_step(cfg, params, cache, tok, S + i)
        tok = jnp.argmax(lg[:, 0], -1)[:, None].astype(jnp.int32)
        return (cache, tok), (lg, tok)

    _, steps = jax.lax.scan(step, (cache, tok),
                            jnp.arange(STEPS, dtype=jnp.int32))
    last, chunked = JT.prefill_chunked(cfg, params, toks, CHUNK,
                                       cache_len=CACHE)
    return fwd, aux, logits, cache["k"], steps, last, chunked["v"]


@functools.lru_cache(maxsize=None)
def _jax_serving(arch_id, dtype):
    cfg = _jax_cfg(arch_id, dtype)
    out = jax.jit(functools.partial(_jax_run, cfg))(
        _to_jax(_port_params(arch_id, dtype)),
        jnp.asarray(_tokens((B, S), 0)))
    return jax.tree.map(_f32, out)


def _port_serving(arch_id, dtype):
    cfg = _port_cfg(arch_id, dtype)
    params = _port_params(arch_id, dtype)
    toks = torch.from_numpy(_tokens((B, S), 0))
    fwd, aux = TT.forward(cfg, params, toks)
    logits, cache = TT.prefill(cfg, params, toks, cache_len=CACHE)
    out = [fwd, aux, logits, cache["k"].clone()]
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    steps = ([], [])
    for i in range(STEPS):
        lg, cache = TT.decode_step(cfg, params, cache, tok, S + i)
        tok = torch.argmax(lg[:, 0], -1)[:, None].to(torch.int32)
        steps[0].append(lg)
        steps[1].append(tok)
    last, chunked = TT.prefill_chunked(cfg, params, toks, CHUNK,
                                       cache_len=CACHE)
    out += [tuple(torch.stack(s) for s in steps), last, chunked["v"]]
    return jax.tree.map(lambda t: t.float().numpy(), out)


def _compare(got, want, atol):
    """Forward, prefill and chunked-prefill logits and caches within
    ``atol(want)``, the decode steps' logits too, and JAX's tokens."""
    for i, name in ((0, "forward"), (2, "prefill"), (3, "cache k"),
                    (5, "chunked"), (6, "chunked cache v")):
        np.testing.assert_allclose(got[i], want[i], atol=atol(want[i]),
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(got[4][0], want[4][0], atol=atol(want[4][0]),
                               rtol=0, err_msg="decode steps")
    np.testing.assert_array_equal(got[4][1], want[4][1])
    np.testing.assert_array_equal(got[2].argmax(-1), want[2].argmax(-1))


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_smoke_models_match_jax(arch_id):
    """f32: forward's logits and summed aux, prefill's logits and cache,
    eight greedy decode steps (capacity 1 at batch 2: tokens drop, as in
    JAX), and prefill_chunked (capacity per 4-token chunk): logits within
    1e-4, aux within 1e-6, JAX's greedy tokens."""
    want = _jax_serving(arch_id, "float32")
    got = _port_serving(arch_id, "float32")
    _compare(got, want, lambda w: 1e-4)
    assert want[1] > 0 and abs(got[1] - want[1]) <= 1e-6


def test_moe_smoke_model_matches_jax_bf16():
    """DeepSeek-MoE's SMOKE model in bf16.  Both round every product to
    bf16 but at other places, and a router near-tie can then pick another
    expert, so the logits and cache are held to 0.05 of their range
    (test_torch_transformer's dense bf16 case: 0.03) and the greedy tokens
    must be JAX's."""
    want = _jax_serving("deepseek-moe-16b", "bfloat16")
    got = _port_serving("deepseek-moe-16b", "bfloat16")
    _compare(got, want, lambda w: 0.05 * np.abs(w).max())


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_serve_lm_matches_jax_greedy_tokens(arch_id):
    """serve_lm on the CPU with a given prompt decodes JAX's tokens: the
    JAX side runs its prefill and decode loop on the port's weights."""
    arch = get_arch(arch_id)
    prompt = _tokens((B, S), 3)
    gen = 4
    got = serve.serve_lm(arch, True, B, S, gen, seed=5, device="cpu",
                         prompt=prompt)
    assert got.shape == (B, gen) and got.dtype == torch.int32
    cfg = _jax_cfg(arch_id)

    def greedy(params, prompt):
        logits, cache = JT.prefill(cfg, params, prompt, cache_len=S + gen)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)

        def step(carry, i):
            cache, tok = carry
            logits, cache = JT.decode_step(cfg, params, cache, tok, S + i)
            tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
            return (cache, tok), tok[:, 0]

        _, rest = jax.lax.scan(step, (cache, tok),
                               jnp.arange(gen - 1, dtype=jnp.int32))
        return jnp.concatenate([tok, rest.T], axis=1)

    want = jax.jit(greedy)(_to_jax(_port_params(arch_id, "float32", seed=5)),
                           jnp.asarray(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch_id", LM_ARCHS + ("dien",))
def test_configs_equal_jax(arch_id):
    mine, theirs = get_arch(arch_id), jax_registry.get_arch(arch_id)
    assert (mine.family, mine.shapes) == (theirs.family, theirs.shapes)
    for a, b in ((mine.config, theirs.config), (mine.smoke, theirs.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        if mine.family == "lm":
            assert a.param_count() == b.param_count()
            assert a.head_dim == b.head_dim


def test_deepseek_param_count_and_layout():
    """The card's model: 16,669,853,696 parameters (33.3 GB in bf16); the
    port's init gives JAX's tree, ``layers["moe"]`` a dict of [L, ...]
    leaves with an f32 router, the rest in the model's dtype."""
    assert get_arch("deepseek-moe-16b").config.param_count() == 16669853696
    for arch_id in MOE_ARCHS:
        cfg = dataclasses.replace(get_arch(arch_id).smoke, dtype="bfloat16")
        got = TT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        want = jax.eval_shape(lambda c=_jax_cfg(arch_id, "bfloat16"):
                              JT.init_params(c, jax.random.PRNGKey(0)))
        flat_got = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), got))
        flat_want = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda s: (s.shape, str(s.dtype)), want))
        assert flat_got == flat_want
        assert got["layers"]["moe"]["router"].dtype == torch.float32
        if not cfg.qk_norm:          # param_count leaves the qk norms out
            n = sum(t.numel() for t in jax.tree.leaves(got))
            assert n == cfg.param_count()


def test_interop_carries_the_moe_subtree_bit_for_bit():
    """JAX's bf16 tree (its structure from JAX's init, its leaves numpy
    arrays of JAX's dtypes) carried across with every bit."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        jax.eval_shape(lambda: JT.init_params(
            _jax_cfg("deepseek-moe-16b", "bfloat16"),
            jax.random.PRNGKey(0))))
    port = transformer_params_from_numpy(tree, device="cpu")
    moe = tree["layers"]["moe"]
    assert sorted(port["layers"]["moe"]) == sorted(moe)
    for name, leaf in moe.items():
        t = port["layers"]["moe"][name]
        assert t.shape == leaf.shape
        if name == "router":
            assert leaf.dtype == np.float32 and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), leaf)
        else:
            assert leaf.dtype.name == "bfloat16"
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16))


def test_prefill_chunked_refuses_a_ragged_prompt():
    cfg = _port_cfg("deepseek-moe-16b")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TT.prefill_chunked(cfg, _port_params("deepseek-moe-16b", "float32"),
                           torch.zeros((1, 6), dtype=torch.int32), 4)


@pytest.mark.parametrize("arch_id", ("yi-34b", "command-r-plus-104b",
                                     "deepseek-moe-16b"))
def test_head_dim_16_is_padded_to_the_kernels_width(arch_id):
    """Three SMOKE configs have head dim 16, which the attention kernel
    lacks (32, 64, 128): the transformer zero-pads it to 32, and the
    result is the plain attention's at 16 (and, for the dense ones, JAX's
    forward)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    cfg = _port_cfg(arch_id)
    assert cfg.head_dim == 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, cfg.n_heads, 16, 16, generator=g)
    k, v = (torch.randn(2, cfg.n_kv_heads, 16, 16, generator=g)
            for _ in range(2))
    flash_ops.reset_counts()
    got = TT._self_attention(cfg, q, k, v)
    assert flash_ops.ref.attention_ref.calls == 1
    want = flash_ref.attention_ref(q, k, v).transpose(1, 2).reshape(
        2, 16, cfg.n_heads * 16)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    if cfg.moe is None:
        toks = _tokens((B, S), 4)
        jcfg = _jax_cfg(arch_id)
        params = _port_params(arch_id, "float32")
        want, _ = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(
            _to_jax(params), jnp.asarray(toks))
        got, _ = TT.forward(cfg, params, torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-4,
                                   rtol=0)

"""PyTorch port, LM training against the JAX package on the CPU.

``cross_entropy_loss`` with and without a mask; ``attention_grad`` (the
backward of the flash-attention wrapper, through its autograd Function and
the transformer's head-dim padding) against ``jax.grad`` of JAX's
``attention_ref`` for GQA groups 1 and 2, causal or not, head dims 16, 32
and 128, within 1e-5; Qwen3-0.6B's and DeepSeek-MoE-16B's SMOKE models from
one JAX init (``transformer_params_from_numpy``): ``loss_fn``,
``loss_fn_chunked`` and ``forward_hidden`` (loss rtol 1e-5) and every
gradient leaf (atol 1e-5, rtol 1e-4), with and without remat, the chunked
CE equal to the naive one; one train cell step (``build_cell(...,
smoke=True)``) from JAX's parameters and optimizer state after one JAX
step (``opt_state_from_numpy``) on a numpy batch: loss, parameters and
moments against JAX's, with 1 microbatch and with 2 (f32 accumulation, the
policy forced on both packages' cells).  JAX results are computed once per
worker, one jit a case.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as jax_moe_cfg
from repro.configs import qwen3_0_6b as jax_qwen
from repro.kernels.flash_attention import ref as JR
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.optimizer import init_opt_state as jax_init_opt
from repro_torch.configs.registry import get_arch
from repro_torch.interop import (opt_state_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.kernels.flash_attention import grad as flash_grad
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train.tree import leaves

B, S, CHUNK = 2, 16, 4
JAX_CFGS = {"qwen3-0.6b": jax_qwen.SMOKE,
            "deepseek-moe-16b": jax_moe_cfg.SMOKE}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch CPU ops on one thread: the suite's worker processes would
    otherwise oversubscribe the cores (``test_torch_mixed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# cross-entropy


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jax.jit(JL.cross_entropy_loss)(
        logits, labels, None if mask is None else jnp.asarray(mask))
    got = TL.cross_entropy_loss(_t(logits), _t(labels),
                                None if mask is None else _t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # bf16 logits are taken in f32
    got16 = TL.cross_entropy_loss(_t(logits).bfloat16(), _t(labels))
    want16 = jax.jit(JL.cross_entropy_loss)(
        jnp.asarray(logits, jnp.bfloat16), labels)
    np.testing.assert_allclose(got16.numpy(), np.asarray(want16), rtol=1e-6)


# ---------------------------------------------------------------------------
# attention's gradient

ATTN_CASES = [(g, c, d) for g in (1, 2) for c in (True, False)
              for d in (16, 32, 128)]


@functools.lru_cache(maxsize=None)
def _attn_inputs(group, d, lq=12, lk=20, hkv=2, b=2):
    rng = np.random.default_rng(group * 1000 + d)
    q = rng.standard_normal((b, hkv * group, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, dout


@functools.lru_cache(maxsize=None)
def _jax_attn_grads(group, causal, d):
    q, k, v, dout = _attn_inputs(group, d)

    def f(q_, k_, v_):
        out = JR.attention_ref(q_, k_, v_, causal=causal)
        return jnp.sum(out * dout)

    return tuple(np.asarray(x) for x in
                 jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v))


def _padded_attention(q, k, v, causal):
    """The transformer's path: zero-pad the head dim to the kernel's next
    width, the autograd Function on contiguous tensors, cut the output."""
    d = q.shape[-1]
    width = next(w for w in (32, 64, 128) if w >= d)
    pad = (lambda t: torch.nn.functional.pad(t, (0, width - d)))
    out = flash_grad.flash_attention(pad(q).contiguous(), pad(k).contiguous(),
                                     pad(v).contiguous(), causal=causal,
                                     sm_scale=d ** -0.5)
    return out[..., :d]


@pytest.mark.parametrize("group,causal,d", ATTN_CASES)
def test_attention_grad_matches_jax(group, causal, d, monkeypatch):
    q, k, v, dout = _attn_inputs(group, d)
    want = _jax_attn_grads(group, causal, d)
    # the Function's backward, through padding and a strided dout
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = _padded_attention(qt, kt, vt, causal)
    calls = flash_ref.attention_ref.calls
    got = torch.autograd.grad(out, (qt, kt, vt), _t(dout))
    assert flash_ref.attention_ref.calls == calls   # no plain call
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    # attention_grad itself, in pieces of 5 query rows
    monkeypatch.setattr(flash_grad, "PIECE_ELEMENTS",
                        5 * q.shape[0] * q.shape[1] * k.shape[2])
    qc, kc, vc = (_t(x) for x in (q, k, v))
    out = flash_ref.attention_ref(qc, kc, vc, causal=causal)
    for g, w in zip(flash_grad.attention_grad(qc, kc, vc, out, _t(dout),
                                              causal), want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


def test_attention_grad_keeps_dtypes():
    q, k, v, dout = (_t(x).bfloat16() for x in _attn_inputs(2, 32))
    out = flash_ref.attention_ref(q, k, v)
    dq, dk, dv = flash_grad.attention_grad(q, k, v, out, dout)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape


# ---------------------------------------------------------------------------
# the models' loss and gradients


def _batch(vocab, shape=(B, S), seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": rng.integers(0, vocab, shape).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_model(arch_id):
    """JAX's SMOKE weights, a batch, and in one jit: loss_fn's (loss,
    grads) and forward_hidden's (x, aux).  The port's chunked loss is held
    against the same: chunking changes no value (``repro``'s own tests
    hold its chunked loss to its naive one)."""
    cfg = JAX_CFGS[arch_id]
    params = jax.jit(functools.partial(JT.init_params, cfg))(
        jax.random.PRNGKey(0))
    batch = _batch(cfg.vocab)

    def run(p, b):
        loss = jax.value_and_grad(functools.partial(JT.loss_fn, cfg))(p, b)
        return loss, JT.forward_hidden(cfg, p, b["tokens"])

    return _np_tree(params), batch, _np_tree(jax.jit(run)(params, batch))


def _port_cfg(arch_id, **kw):
    return dataclasses.replace(get_arch(arch_id).smoke, **kw)


def _assert_grads(got, want):
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    n = 0
    for path, w in flat_w.items():
        g = got
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(leaves(got))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch_id", list(JAX_CFGS))
def test_loss_and_grads_match_jax(arch_id, remat):
    params_np, batch, ((want_loss, want_grads), hidden) = _jax_model(arch_id)
    cfg = _port_cfg(arch_id, remat=remat)
    params = transformer_params_from_numpy(params_np, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    calls = flash_ref.attention_ref.calls
    x, aux = TT.forward_hidden(cfg, params, tb["tokens"])
    np.testing.assert_allclose(x.detach().numpy(), hidden[0], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(hidden[1]), rtol=1e-5,
                               atol=1e-7)
    for fn in (TT.loss_fn, functools.partial(TT.loss_fn_chunked,
                                             chunk=CHUNK)):
        got_loss, got_grads = TS.loss_and_grads(
            lambda p, b: fn(cfg, p, b), params, tb)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
        _assert_grads(got_grads, want_grads)
    # one wrapper call a layer a pass (the remat recompute a pass more);
    # the backward makes no plain call
    passes = 1 + 2 * (1 + remat)
    assert flash_ref.attention_ref.calls - calls == cfg.n_layers * passes


def test_ce_chunk_config_takes_the_chunked_loss(monkeypatch):
    params_np, batch, ((want_loss, _), _) = _jax_model("qwen3-0.6b")
    cfg = _port_cfg("qwen3-0.6b", ce_chunk=CHUNK)
    params = transformer_params_from_numpy(params_np, device="cpu")
    chunks = []
    chunk_loss = TT._chunk_loss
    monkeypatch.setattr(TT, "_chunk_loss", lambda x, *a: (
        chunks.append(tuple(x.shape)), chunk_loss(x, *a))[1])
    got = TT.loss_fn(cfg, params, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want_loss), rtol=1e-5)
    assert chunks == [(B, CHUNK, cfg.d_model)] * (S // CHUNK)


# ---------------------------------------------------------------------------
# one train cell step


@functools.lru_cache(maxsize=None)
def _jax_cell_steps(arch_id, n_micro):
    """JAX's cell (SMOKE; with ``n_micro`` > 1 the policy forced to
    ``(n_micro, 0, "float32")``): params and optimizer state after one
    step, and the second step's (params, opt_state, loss), with the
    batches."""
    policy = JS.train_policy_for
    if n_micro > 1:
        JS.train_policy_for = lambda *a, **k: (n_micro, 0, "float32")
    try:
        cell = JS.build_cell(arch_id, "train_4k", smoke=True)
    finally:
        JS.train_policy_for = policy
    cfg = JAX_CFGS[arch_id]
    params, state = jax.jit(lambda key: (lambda p: (p, jax_init_opt(
        p, cell.opt_cfg)))(cell.param_init(key)))(jax.random.PRNGKey(1))
    shape = (n_micro, 8 // n_micro, S) if n_micro > 1 else (8, S)
    batches = [_batch(cfg.vocab, shape, seed) for seed in (1, 2)]
    fn = jax.jit(cell.fn)
    p1, s1, _ = fn(params, state, batches[0])
    out = fn(p1, s1, batches[1])
    return _np_tree(p1), _np_tree(s1), batches[1], _np_tree(out)


@pytest.mark.parametrize("arch_id,n_micro", [("qwen3-0.6b", 1),
                                             ("qwen3-0.6b", 2)])
def test_cell_step_matches_jax(arch_id, n_micro, monkeypatch):
    p1, s1, batch, (p2, s2, loss) = _jax_cell_steps(arch_id, n_micro)
    if n_micro > 1:         # the policy forced as on the JAX side
        monkeypatch.setattr(TS, "train_policy_for",
                            lambda *a, **k: (n_micro, 0, "float32"))
    cell = TS.build_cell(arch_id, "train_4k", smoke=True)
    assert cell.n_micro == n_micro and cell.kind == "train"
    params = transformer_params_from_numpy(p1, device="cpu")
    state = opt_state_from_numpy(s1, device="cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    new_p, new_s, got_loss = cell.fn(params, state,
                                     {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    _assert_close_tree(new_p, p2, atol=1e-5, rtol=0)
    # the moments carry the gradients at full precision
    _assert_close_tree(new_s["m"], s2["m"], atol=1e-7, rtol=1e-4)
    _assert_close_tree(new_s["v"], s2["v"], atol=1e-10, rtol=1e-4)
    assert int(new_s["step"]) == int(s2["step"]) == 2
    # the update itself, not only the parameters near their old values
    _assert_close_tree(_sub(new_p, params), _sub_np(p2, p1), atol=1e-7,
                       rtol=1e-3)


def _sub(a, b):
    if isinstance(a, dict):
        return {k: _sub(a[k], b[k]) for k in a}
    return a - b


def _sub_np(a, b):
    return jax.tree.map(lambda x, y: x - y, a, b)


def _assert_close_tree(got, want, **tol):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_allclose(g.numpy(), w, **tol,
                                   err_msg=jax.tree_util.keystr(path))

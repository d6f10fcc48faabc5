"""Decoder-only transformer (GQA, qk_norm, RoPE, SwiGLU, optional MoE)
(counterpart of ``repro.models.transformer``).

Parameters are a plain dict with the JAX package's names and the stacked
``[L, ...]`` leading axis, so JAX weights map onto it one to one
(``repro_torch.interop.transformer_params_from_numpy``).  The JAX
``lax.scan`` over layers is a Python loop here over views of the stacked
leaves, unbound once a call (a view selected per layer would write a
full-size zero gradient per layer in the backward).  The serving half
(``prefill``, ``decode_step``, ``prefill_chunked``) runs under
``torch.inference_mode()``; ``forward``, ``forward_hidden``, ``loss_fn``
and ``loss_fn_chunked`` carry gradients.  With ``cfg.remat``, while grad
is enabled, each layer runs under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint``) and each CE chunk of ``loss_fn_chunked`` too, so the
backward holds one chunk's ``[B, chunk, V]`` logits at a time.

Attention without a cache (``forward``, ``prefill``) goes through
:func:`repro_torch.kernels.flash_attention.grad.flash_attention` for every
``attn_impl``: the JAX package's three impls compute one function.  Its
forward is the wrapper ``ops.flash_attention``, which runs the CUDA kernel
on a CUDA tensor and its plain version on a CPU tensor; its backward is
``grad.attention_grad``.  Attention against the KV cache (``decode_step``)
is plain PyTorch, as the JAX package leaves it to XLA.  The cache is updated in
place: ``decode_step`` writes its keys and values into the cache it is
given and returns that same dict.

A MoE layer (``cfg.moe``) runs :func:`repro_torch.models.moe.apply_moe`
on the layer's ``[B * L, D]`` tokens, so its expert capacity is per call:
per prompt in ``prefill``, per chunk in ``prefill_chunked``, per step in
``decode_step``, as in the JAX package.

"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels.flash_attention import grad as flash_grad
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (cross_entropy_loss, dense_init,
                                       rmsnorm, rope, swiglu)

ATTN_IMPLS = ("naive", "flash_jnp", "pallas")
MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: Optional[moe_lib.MoEConfig] = None
    attn_impl: str = "flash_jnp"
    attn_block_k: int = 512
    dtype: str = "bfloat16"
    remat: bool = True                    # checkpoint layers under grad
    tie_embeddings: bool = True
    ce_chunk: int = 0
    act_shard: tuple | None = None        # no effect on one device

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")
        if not isinstance(getattr(torch, self.dtype, None), torch.dtype):
            raise ValueError(f"dtype {self.dtype!r} is not a torch dtype")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * dh * d
        if self.moe is not None:
            ffn = d * self.moe.n_routed  # router
            ffn += 3 * self.moe.n_routed * d * self.moe.d_ff
            ffn += 3 * self.moe.n_shared * d * self.moe.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d


def _dt(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceSpec = None) -> dict:
    """Random weights as the JAX package draws them (normal times the same
    scales, ones for the norms), from ``generator``, on ``device``.  A MoE
    model's ``layers["moe"]`` is a dict of ``[L, ...]`` leaves, as JAX's
    ``vmap(init_moe)`` gives, drawn layer by layer into the stack (a whole
    f32 draw of DeepSeek-MoE-16B's experts would take 20.7 GB)."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    d, dh, L = cfg.d_model, cfg.head_dim, cfg.n_layers

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=dev, dtype=dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layer = {
        "wq": normal((L, d, cfg.n_heads * dh), d ** -0.5),
        "wk": normal((L, d, cfg.n_kv_heads * dh), d ** -0.5),
        "wv": normal((L, d, cfg.n_kv_heads * dh), d ** -0.5),
        "wo": normal((L, cfg.n_heads * dh, d), (cfg.n_heads * dh) ** -0.5),
        "ln_attn": ones((L, d)),
        "ln_ffn": ones((L, d)),
    }
    if cfg.qk_norm:
        layer["q_norm"] = ones((L, dh))
        layer["k_norm"] = ones((L, dh))
    if cfg.moe is None:
        layer["w1"] = normal((L, d, cfg.d_ff), d ** -0.5)
        layer["w3"] = normal((L, d, cfg.d_ff), d ** -0.5)
        layer["w2"] = normal((L, cfg.d_ff, d), cfg.d_ff ** -0.5)
    else:
        stack: dict = {}
        for i in range(L):
            p = moe_lib.init_moe(d, cfg.moe, dt, generator, dev)
            for name, w in p.items():
                if name not in stack:
                    stack[name] = torch.empty((L,) + tuple(w.shape),
                                              dtype=w.dtype, device=dev)
                stack[name][i] = w
            del p
        layer["moe"] = stack
    params = {"embed": normal((cfg.vocab, d), 0.02), "ln_f": ones((d,)),
              "layers": layer}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(d, cfg.vocab, dt, generator, dev)
    return params


def _layers(params) -> list[dict]:
    """Each layer's weights: views of the stacked leaves, nested dicts
    (``moe``) included, from one ``unbind`` a leaf (whose backward stacks
    the layers' gradients in one write)."""
    def split(node):
        if isinstance(node, dict):
            parts = {name: split(w) for name, w in node.items()}
            n = len(next(iter(parts.values())))
            return [{name: p[i] for name, p in parts.items()}
                    for i in range(n)]
        return node.unbind(0)
    return split(params["layers"])


def _unembed(params, x):
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["embed"].T


def _qkv(cfg: TransformerConfig, lp, x, positions):
    """x: [B, L, D] -> q [B, Hq, L, Dh], k and v [B, Hkv, L, Dh], roped."""
    b, l, _ = x.shape
    dh = cfg.head_dim
    q = (x @ lp["wq"]).reshape(b, l, cfg.n_heads, dh)
    k = (x @ lp["wk"]).reshape(b, l, cfg.n_kv_heads, dh)
    v = (x @ lp["wv"]).reshape(b, l, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"])
        k = rmsnorm(k, lp["k_norm"])
    q = rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = rope(k.transpose(1, 2), positions, cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _self_attention(cfg: TransformerConfig, q, k, v):
    """Causal attention of the sequence on itself: [B, L, Hq * Dh].

    A head dim the kernel lacks (16 in three SMOKE configs) is zero-padded
    to its next width: zero columns add nothing to a score and give zero
    output columns, which are cut off."""
    b, _, l, dh = q.shape
    width = next((w for w in flash_ops.HEAD_DIMS if w >= dh), dh)
    if width != dh:
        q, k, v = (F.pad(t, (0, width - dh)) for t in (q, k, v))
    out = flash_grad.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True,
                                     sm_scale=dh ** -0.5)
    return out[..., :dh].transpose(1, 2).reshape(b, l, cfg.n_heads * dh)


def _attention(cfg: TransformerConfig, lp, x, positions, kv_cache=None,
               cache_pos: int | None = None):
    """x: [B, L, D]. Returns (out, new_kv) — new_kv when caching."""
    b, l, _ = x.shape
    dh = cfg.head_dim
    q, k, v = _qkv(cfg, lp, x, positions)
    if kv_cache is None:
        return _self_attention(cfg, q, k, v) @ lp["wo"], None
    # decode/chunk path: l queries against the cache, with the per-query
    # position mask of the JAX package (l > 1 = a prefill chunk)
    ck, cv = kv_cache                                  # [B, Hkv, S, Dh]
    s = ck.shape[2]
    if not 0 <= cache_pos <= s - l:
        raise ValueError(f"{l} tokens at position {cache_pos} overrun a "
                         f"cache of {s}")
    ck[:, :, cache_pos:cache_pos + l] = k.to(ck.dtype)
    cv[:, :, cache_pos:cache_pos + l] = v.to(cv.dtype)
    group = cfg.n_heads // cfg.n_kv_heads
    # the grouped-head reshape makes row g * l + i the query of head
    # kv * group + g at chunk index i, so the positions are tiled
    qg = q.reshape(b, cfg.n_kv_heads, group * l, dh)
    scores = torch.einsum("bhqd,bhsd->bhqs", qg.float(),
                          ck.float()) * dh ** -0.5
    q_pos = (cache_pos + torch.arange(l, device=x.device)).repeat(group)
    ok = torch.arange(s, device=x.device)[None, :] <= q_pos[:, None]
    scores = torch.where(ok, scores, MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bhsd->bhqd", p, cv.float())
    out = out.reshape(b, cfg.n_heads, l, dh).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, l, cfg.n_heads * dh)
    return out @ lp["wo"], (ck, cv)


def _ffn(cfg: TransformerConfig, lp, x):
    """The FFN half of a layer on x [B, L, D]: (out, aux), aux the MoE
    load-balance loss (an f32 scalar) or None for a dense layer.  MoE
    routes the flattened [B * L, D] tokens."""
    hn = rmsnorm(x, lp["ln_ffn"])
    if cfg.moe is None:
        return swiglu(hn, lp["w1"], lp["w3"], lp["w2"]), None
    b, l, d = hn.shape
    f, aux = moe_lib.apply_moe(lp["moe"], hn.reshape(b * l, d), cfg.moe)
    return f.reshape(b, l, d), aux


def _layer_fn(cfg: TransformerConfig, x, lp, positions):
    """One layer on the residual stream x [B, L, D]: (x, aux), aux as
    :func:`_ffn` gives it."""
    h, _ = _attention(cfg, lp, rmsnorm(x, lp["ln_attn"]), positions)
    x = x + h
    f, aux = _ffn(cfg, lp, x)
    return x + f, aux


def _remat(cfg: TransformerConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def forward_hidden(cfg: TransformerConfig, params, tokens: torch.Tensor):
    """Forward without the unembed projection: (the final-normed hidden
    states [B, L, D], aux_loss): the layers' MoE load-balance losses
    summed, 0 for a dense model."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(cfg)
    for lp in _layers(params):
        if remat:
            x, layer_aux = checkpoint(_layer_fn, cfg, x, lp, positions,
                                      use_reentrant=False)
        else:
            x, layer_aux = _layer_fn(cfg, x, lp, positions)
        if layer_aux is not None:
            aux = aux + layer_aux
    return rmsnorm(x, params["ln_f"]), aux


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor):
    """tokens: int[B, L] -> (logits [B, L, V], aux_loss)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return _unembed(params, x), aux


def loss_fn(cfg: TransformerConfig, params, batch) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]`` against
    ``batch["labels"]`` plus the MoE aux loss: an f32 scalar.  A config
    with ``ce_chunk`` takes :func:`loss_fn_chunked`."""
    if cfg.ce_chunk:
        return loss_fn_chunked(cfg, params, batch, cfg.ce_chunk)
    logits, aux = forward(cfg, params, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"]) + aux


def _chunk_loss(x, labels, unemb):
    return cross_entropy_loss(x @ unemb, labels)


def loss_fn_chunked(cfg: TransformerConfig, params, batch,
                    chunk: int) -> torch.Tensor:
    """CE over ``max(S // chunk, 1)`` sequence chunks, the mean of their
    means: the unembed and CE run on ``[B, S / n_chunks, V]`` logits at a
    time, never ``[B, S, V]`` (vocab 152k >> d_model makes them the
    largest temporary of small-model training)."""
    x, aux = forward_hidden(cfg, params, batch["tokens"])
    b, s, d = x.shape
    unemb = params["unembed"] if "unembed" in params else params["embed"].T
    n_chunks = max(s // chunk, 1)
    xc = x.reshape(b, n_chunks, s // n_chunks, d)
    lc = batch["labels"].reshape(b, n_chunks, s // n_chunks)
    remat = _remat(cfg)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        if remat:
            total = total + checkpoint(_chunk_loss, xc[:, i], lc[:, i],
                                       unemb, use_reentrant=False)
        else:
            total = total + _chunk_loss(xc[:, i], lc[:, i], unemb)
    return total / n_chunks + aux


# ---------------------------------------------------------------------------
# Serving (prefill + decode with KV cache)


@torch.inference_mode()
def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor,
            cache_len: int | None = None):
    """Prefill: run the prompt, return (last-token logits [B, V], cache).

    Only the final position's logits are computed; the cache holds each
    layer's roped keys and values for positions 0 .. S-1, zeros after.
    """
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, cache_len, cfg.head_dim)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(_layers(params)):
        q, k, v = _qkv(cfg, lp, rmsnorm(x, lp["ln_attn"]), positions)
        x = x + _self_attention(cfg, q, k, v) @ lp["wo"]
        ks[i, :, :, :s] = k
        vs[i, :, :, :s] = v
        x = x + _ffn(cfg, lp, x)[0]
    logits = _unembed(params, rmsnorm(x[:, -1], params["ln_f"]))
    return logits, {"k": ks, "v": vs}


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               dtype: torch.dtype | None = None,
               device: DeviceSpec = None) -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len, cfg.head_dim)
    dt = dtype or _dt(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


@torch.inference_mode()
def decode_step(cfg: TransformerConfig, params, cache, tokens: torch.Tensor,
                pos: int):
    """One decode step (or one prefill chunk). tokens: int[B, L]; pos: the
    chunk's start position in the cache (an int, so no device read).

    Each layer writes its keys and values into ``cache`` at ``pos`` (in
    place) and attends to the whole cache with an exact per-query position
    mask.  Returns (logits [B, L, V], cache).
    """
    pos = int(pos)
    x = params["embed"][tokens]                   # [B, L, D]
    positions = pos + torch.arange(tokens.shape[1], device=x.device)
    for i, lp in enumerate(_layers(params)):
        h, _ = _attention(cfg, lp, rmsnorm(x, lp["ln_attn"]), positions,
                          kv_cache=(cache["k"][i], cache["v"][i]),
                          cache_pos=pos)
        x = x + h
        x = x + _ffn(cfg, lp, x)[0]
    return _unembed(params, rmsnorm(x, params["ln_f"])), cache


@torch.inference_mode()
def prefill_chunked(cfg: TransformerConfig, params, tokens: torch.Tensor,
                    chunk: int, cache_len: int | None = None):
    """Sarathi-style chunked prefill: the prompt in ``chunk``-token pieces,
    each a ``decode_step`` against the cache so far (so a MoE layer's
    capacity is per chunk).  Returns (last-token logits [B, V], cache)."""
    b, s = tokens.shape
    if s % chunk:
        raise ValueError(f"prompt of {s} tokens is not a multiple of the "
                         f"chunk {chunk}; pad it")
    cache = init_cache(cfg, b, cache_len or s, device=tokens.device)
    for start in range(0, s, chunk):
        logits, cache = decode_step(cfg, params, cache,
                                    tokens[:, start:start + chunk], start)
    return logits[:, -1], cache

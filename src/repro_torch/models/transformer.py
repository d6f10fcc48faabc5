"""Decoder-only transformer (GQA, qk_norm, RoPE, SwiGLU), the serving half
of ``repro.models.transformer``.

Parameters are a plain dict with the JAX package's names and the stacked
``[L, ...]`` leading axis, so JAX weights map onto it one to one
(``repro_torch.interop.transformer_params_from_numpy``).  The JAX
``lax.scan`` over layers is a Python loop here, run under
``torch.inference_mode()``.

Attention without a cache (``forward``, ``prefill``) goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` for every
``attn_impl``: the JAX package's three impls compute one function, and the
wrapper runs the CUDA kernel on a CUDA tensor and its plain version on a
CPU tensor.  Attention against the KV cache (``decode_step``) is plain
PyTorch, as the JAX package leaves it to XLA.  The cache is updated in
place: ``decode_step`` writes its keys and values into the cache it is
given and returns that same dict.

Not ported yet (ROADMAP.md): MoE layers, training (``loss_fn``,
``loss_fn_chunked``, ``forward_hidden``) and ``prefill_chunked``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import rmsnorm, rope, swiglu

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
    moe: Optional[Any] = None
    attn_impl: str = "flash_jnp"
    attn_block_k: int = 512
    dtype: str = "bfloat16"
    remat: bool = True                    # no effect in inference
    tie_embeddings: bool = True
    ce_chunk: int = 0
    act_shard: tuple | None = None        # no effect on one device

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                f"{self.name}: MoE layers are not ported yet (ROADMAP.md "
                "queue 1, the ML stack)")
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
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d


def _dt(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceSpec = None) -> dict:
    """Random weights as the JAX package draws them (normal times the same
    scales, ones for the norms), from ``generator``, on ``device``."""
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
    layer["w1"] = normal((L, d, cfg.d_ff), d ** -0.5)
    layer["w3"] = normal((L, d, cfg.d_ff), d ** -0.5)
    layer["w2"] = normal((L, cfg.d_ff, d), cfg.d_ff ** -0.5)
    params = {"embed": normal((cfg.vocab, d), 0.02), "ln_f": ones((d,)),
              "layers": layer}
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab), d ** -0.5)
    return params


def _layer(params, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


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
    """Causal attention of the sequence on itself: [B, L, Hq * Dh]."""
    b, _, l, dh = q.shape
    out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    return out.transpose(1, 2).reshape(b, l, cfg.n_heads * dh)


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


def _ffn(lp, x):
    return swiglu(rmsnorm(x, lp["ln_ffn"]), lp["w1"], lp["w3"], lp["w2"])


@torch.inference_mode()
def forward(cfg: TransformerConfig, params, tokens: torch.Tensor):
    """tokens: int[B, L] -> (logits [B, L, V], aux_loss), aux 0 for a dense
    model."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h, _ = _attention(cfg, lp, rmsnorm(x, lp["ln_attn"]), positions)
        x = x + h
        x = x + _ffn(lp, x)
    logits = _unembed(params, rmsnorm(x, params["ln_f"]))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


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
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, rmsnorm(x, lp["ln_attn"]), positions)
        x = x + _self_attention(cfg, q, k, v) @ lp["wo"]
        ks[i, :, :, :s] = k
        vs[i, :, :, :s] = v
        x = x + _ffn(lp, x)
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
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h, _ = _attention(cfg, lp, rmsnorm(x, lp["ln_attn"]), positions,
                          kv_cache=(cache["k"][i], cache["v"][i]),
                          cache_pos=pos)
        x = x + h
        x = x + _ffn(lp, x)
    return _unembed(params, rmsnorm(x, params["ln_f"])), cache

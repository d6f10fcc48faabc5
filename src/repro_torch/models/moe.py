"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``):
DeepSeekMoE-style shared and fine-grained routed experts, top-k softmax
routing, sort-based capacity dispatch.

Token-to-expert assignments are sorted by expert id (a stable sort), each
gets its position within its expert from the sorted prefix, and the tokens
are scattered into an ``[E, C, D]`` buffer; the expert FFNs run as batched
products (``torch.bmm``, as the JAX package leaves its einsums to XLA);
tokens past an expert's capacity are dropped.  Every shape is static and
nothing reads the device, so a call makes no device sync.

Where the JAX package relies on JAX semantics the port spells them out:
``jax.lax.top_k`` breaks ties to the lower index (a stable descending sort
here); ``.at[].set(mode="drop")`` writes the dropped entries to a spare
row; the gather of the outputs clamps its index; the combine's
``segment_sum`` over unsorted token ids is an ``index_add_``, whose order
of addition on the card is not fixed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff: int               # per-expert hidden dim (fine-grained)
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def init_moe(d_model: int, cfg: MoEConfig, dtype: torch.dtype,
             generator: torch.Generator, device: torch.device) -> dict:
    """One layer's weights, drawn as the JAX package draws them (normal
    times the same scales, in f32, then cast); the router stays f32."""
    def experts(d_in, d_out):
        x = torch.randn((cfg.n_routed, d_in, d_out), generator=generator,
                        device=generator.device)
        return (x * d_in ** -0.5).to(device=device, dtype=dtype)

    p = {"router": dense_init(d_model, cfg.n_routed, torch.float32,
                              generator, device),
         "w1": experts(d_model, cfg.d_ff),
         "w3": experts(d_model, cfg.d_ff),
         "w2": experts(cfg.d_ff, d_model)}
    if cfg.n_shared:
        f = cfg.d_ff * cfg.n_shared
        p["shared_w1"] = dense_init(d_model, f, dtype, generator, device)
        p["shared_w3"] = dense_init(d_model, f, dtype, generator, device)
        p["shared_w2"] = dense_init(f, d_model, dtype, generator, device)
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert holds for ``n_tokens`` flattened tokens: the JAX
    package's host formula, Python's ``round`` included (decode at batch 4
    of DeepSeek-MoE gets 1 slot, and drops by design)."""
    return int(max(1, round(n_tokens * cfg.top_k / cfg.n_routed
                            * cfg.capacity_factor)))


class Dispatch(NamedTuple):
    """The routing of ``T`` tokens: ``probs`` [T, E] f32; ``gate`` and
    ``expert`` [T, K], the top-k renormalised gates and their expert ids;
    over the T * K assignments in stable expert order, ``order`` (each
    one's flat index into [T, K]), ``slot`` (expert * capacity + position
    in its expert) and ``keep`` (position < capacity)."""
    probs: torch.Tensor
    gate: torch.Tensor
    expert: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(params, x: torch.Tensor, cfg: MoEConfig) -> Dispatch:
    t = x.shape[0]
    e, k = cfg.n_routed, cfg.top_k
    probs = torch.softmax(x.float() @ params["router"], dim=-1)   # [T, E]
    # top-k with ties to the lower index: a stable descending sort
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :k], expert[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    cap = capacity(t, cfg)
    e_flat = expert.reshape(-1)                                   # [T*K]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device, dtype=sorted_e.dtype))
    pos = torch.arange(t * k, device=x.device) - starts[sorted_e]
    return Dispatch(probs, gate, expert, order, sorted_e * cap + pos,
                    pos < cap, cap)


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig):
    """x: [T, D] (flattened tokens). Returns (y [T, D] in x's dtype, the
    Switch-style load-balance loss, an f32 scalar)."""
    t, d = x.shape
    e, k = cfg.n_routed, cfg.top_k
    r = route(params, x, cfg)
    # the aux loss: one-hot density of each token's first expert
    density = torch.zeros(e, device=x.device).index_add_(
        0, r.expert[:, 0], torch.ones(t, device=x.device)) / t
    aux = torch.sum(density * r.probs.mean(0)) * e * cfg.router_aux_weight
    # dispatch: kept assignments to their slots, the dropped ones to a
    # spare last row
    n_slots = e * r.capacity
    tok = r.order // k
    buf = x.new_zeros((n_slots + 1, d))
    buf[torch.where(r.keep, r.slot, n_slots)] = x[tok]
    xb = buf[:n_slots].view(e, r.capacity, d)
    # the expert FFNs (swiglu), batched over experts
    h = F.silu(torch.bmm(xb, params["w1"])) * torch.bmm(xb, params["w3"])
    yb = torch.bmm(h, params["w2"]).reshape(n_slots, d)
    # combine: each assignment's output times its gate (0 where dropped)
    y_tok = yb[r.slot.clamp(0, n_slots - 1)]
    g = r.gate.reshape(-1)[r.order] * r.keep
    y = x.new_zeros((t, d)).index_add_(0, tok,
                                       y_tok * g[:, None].to(y_tok.dtype))
    if cfg.n_shared:
        y = y + swiglu(x, params["shared_w1"], params["shared_w3"],
                       params["shared_w2"])
    return y.to(x.dtype), aux

"""Optimizers (counterpart of ``repro.train.optimizer``): AdamW and a
memory-factored variant, over dict trees of tensors.

The factored mode (Adafactor-style row and column second moments, with an
optional bf16 first moment or none at all, ``beta1 == 0``) is what lets the
largest configs fit: full AdamW keeps f32 ``m`` and ``v`` beside each
weight.  The math is the JAX package's, in f32, leaf by leaf; the state is
``{"m": tree, "v": tree, "step": int32 scalar}`` with the same names and
shapes (a factored ``v`` leaf is ``{"vr", "vc"}``), so a checkpoint of
either package restores in the other.  ``scan_update`` streams each
stacked leaf (``ndim >= 3``) through the update one ``[L]`` slice at a
time, so the f32 temporaries shrink by its leading axis; it changes no
value.  Nothing here reads the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    factored: bool = False        # Adafactor-style second moment
    m_dtype: str = "float32"      # "bfloat16" to halve first-moment memory
    scan_update: bool = False     # stream the update over the layer-stack
                                  # axis (ndim>=3 leaves): peak fp32 temps
                                  # shrink by n_layers
    warmup_steps: int = 100
    schedule: str = "cosine"      # "cosine" | "constant"
    total_steps: int = 10_000


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor): linear
    warmup, then cosine decay to 0 at ``total_steps`` (or constant); an
    f32 tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def _use_factored(p: torch.Tensor, cfg: OptConfig) -> bool:
    return cfg.factored and p.dim() >= 2


def init_opt_state(params: Any, cfg: OptConfig) -> dict:
    """Zero moments beside ``params`` (on their devices) and step 0."""
    mdt = getattr(torch, cfg.m_dtype)

    def init_m(p):
        # beta1 == 0 (pure Adafactor): no first moment is stored at all
        if cfg.beta1 == 0.0:
            return torch.zeros((), dtype=mdt, device=p.device)
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    def init_v(p):
        if _use_factored(p, cfg):
            return {"vr": torch.zeros(p.shape[:-1], device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      device=p.device)}
        return torch.zeros(p.shape, device=p.device)

    first = leaves(params)[0]
    return {"m": tree_map(init_m, params), "v": tree_map(init_v, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(grads: Any) -> torch.Tensor:
    """The f32 2-norm of every gradient leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: OptConfig
                  ) -> tuple[Any, dict]:
    """One step: new ``(params, state)``; the inputs are not modified."""
    step = state["step"]
    lr = schedule_lr(cfg, step)
    if cfg.grad_clip:
        gn = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gn, 1e-9),
                           max=1.0)
    else:
        clip = 1.0
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** (step.float() + 1)
    bc2 = 1.0 - b2 ** (step.float() + 1)

    def upd(p, g, m, v):
        g = g.float() * clip
        if b1 == 0.0:
            m_eff, m_store = g, m          # momentum-free (pure Adafactor)
        else:
            m_eff = b1 * m.float() + (1 - b1) * g
            m_store = m_eff.to(m.dtype)
        if isinstance(v, dict):                       # factored second moment
            g2 = g * g + 1e-30
            vr = b2 * v["vr"] + (1 - b2) * torch.mean(g2, dim=-1)
            vc = b2 * v["vc"] + (1 - b2) * torch.mean(g2, dim=-2)
            v_new = {"vr": vr, "vc": vc}
            # rank-1 reconstruction (Adafactor): vr vc / mean(vr)
            denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True),
                                    1e-30)
            v_hat = (vr[..., :, None] * vc[..., None, :]) / denom[..., None]
        else:
            v_new = b2 * v + (1 - b2) * g * g
            v_hat = v_new
        update = (m_eff / bc1) / (torch.sqrt(v_hat / bc2) + cfg.eps)
        pf = p.float()
        p_new = pf - lr * (update + cfg.weight_decay * pf)
        return p_new.to(p.dtype), m_store, v_new

    def upd_maybe_scanned(p, g, m, v):
        if not (cfg.scan_update and p.dim() >= 3 and p.shape[0] > 1):
            return upd(p, g, m, v)
        # one layer slice at a time: the f32 temporaries shrink by shape[0]
        p_new = torch.empty_like(p)
        m_new = m if b1 == 0.0 else torch.empty_like(m)
        v_new = tree_map(torch.empty_like, v)
        for i in range(p.shape[0]):
            v_i = tree_map(lambda x: x[i], v)
            pn, mn, vn = upd(p[i], g[i], m if b1 == 0.0 else m[i], v_i)
            p_new[i] = pn
            if b1 != 0.0:
                m_new[i] = mn
            tree_map(lambda dst, src: dst[i].copy_(src), v_new, vn)
        return p_new, m_new, v_new

    out = tree_map(lambda p, g, m, v: upd_maybe_scanned(p, g, m, v),
                   params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step + 1}

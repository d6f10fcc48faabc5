"""Shared NN layers (counterpart of ``repro.models.layers``), with the JAX
package's dtype rules: ``rmsnorm`` normalises in f32, casts back, then
scales in the input's dtype; ``rope`` rotates in f32 (a bf16 input times
f32 cos/sin promotes) and casts back at the end."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: [..., L, D] (D even); positions: [L] or [..., L]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # [..., L, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast over head axes: x is [..., H, L, D] or [..., L, D]
    while cos.dim() < x.dim():
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w1, w3, w2):
    """LLaMA-style gated FFN: (silu(x@w1) * (x@w3)) @ w2."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2

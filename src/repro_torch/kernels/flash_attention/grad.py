"""The gradient of attention, around the flash-attention kernel.

The TPU kernel has no backward: the JAX package trains through
``attention_flash_jnp`` (the default ``attn_impl``), which
``jax.value_and_grad`` differentiates as jnp ops outside any Pallas
kernel.  Here the forward is the kernel (``ops.flash_attention``, looked up
on the module at each call, so a wrapper put there sees every launch) and
the backward, :func:`attention_grad`, is the closed form in PyTorch ops:
with P = softmax(S), S = scale Q Kᵀ masked,

    dV = Pᵀ dO,   dP = dO Vᵀ,   dS = P ∘ (dP − rowsum(dO ∘ O)),
    dQ = scale dS K,   dK = scale dSᵀ Q,

dK and dV summed over each GQA group.  The f32 scores are recomputed over
pieces of query rows (the whole ``[4, 16, 4096, 4096]`` of a Qwen3-0.6B
microbatch would take 4.3 GB), each piece reading only the keys its causal
mask keeps.  It never calls the plain version ``ref.attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops

MASK_VALUE = -1e30
# f32 elements of one piece's scores (1 GiB): its P, dP and dS are as large
PIECE_ELEMENTS = 1 << 28


def attention_grad(q, k, v, out, dout, causal: bool = True,
                   sm_scale: float | None = None):
    """``(dq, dk, dv)`` of attention (queries at the end of the keys, query
    head h on key/value head ``h // (Hq // Hkv)``) at ``dout``, the
    gradient of its output ``out``; q [B, Hq, Lq, D], k and v [B, Hkv, Lk,
    D], each gradient in its input's dtype.  Computed in f32."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    # head h = kv * group + g: the grouped view reads K/V once a group
    qg = q.float().reshape(b, hkv, group, lq, d)
    dog = dout.float().reshape(b, hkv, group, lq, d)
    delta = (dog * out.float().reshape(b, hkv, group, lq, d)).sum(-1)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    step = max(1, PIECE_ELEMENTS // (b * hq * lk))
    keys = torch.arange(lk, device=q.device)
    for lo in range(0, lq, step):
        hi = min(lo + step, lq)
        # the keys any row of the piece keeps: up to its last row's
        n_k = min(lk, hi + lk - lq) if causal else lk
        kp, vp = kf[:, :, :n_k], vf[:, :, :n_k]
        qp, dop = qg[:, :, :, lo:hi], dog[:, :, :, lo:hi]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qp, kp) * sm_scale
        if causal:
            rows = torch.arange(lo, hi, device=q.device) + (lk - lq)
            s = torch.where(keys[:n_k][None, :] <= rows[:, None], s,
                            MASK_VALUE)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :, :n_k] += torch.einsum("bhgqk,bhgqd->bhkd", p, dop)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dop, vp)
        ds = p.mul_(dp.sub_(delta[:, :, :, lo:hi, None]))
        del dp
        dq[:, :, :, lo:hi] = torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                          kp) * sm_scale
        dk[:, :, :n_k] += torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                       qp) * sm_scale
        del ds
    return (dq.reshape(b, hq, lq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Forward on the kernel, backward by :func:`attention_grad` from the
    saved q, k, v and output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out = ops.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_grad(q, k, v, out, dout, ctx.causal,
                                    ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """``ops.flash_attention`` with a gradient: the same checks, launch and
    output, and ``attention_grad`` in the backward."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale)

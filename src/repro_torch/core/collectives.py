"""The collectives of multi-device mining, over a ``torch.distributed``
process group (the port's counterpart of ``shard_map``'s ``psum``,
``pmax`` and ``all_gather`` in ``repro.core``).

One code path, keyed on the group's backend: an ``nccl`` group runs the
collective on the tensors where they lie (one card a rank); a ``gloo``
group, which the CPU tests use and which lets several ranks share one
card, runs it on host copies, made explicitly and copied back to the
tensor's device.  The tensors merged here are small (counts, pattern maps,
pattern tables and FSM's packed domain bitmaps), so the copies are too.
``group=None`` means no collective: every function is then the identity
of one rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def world(group) -> tuple[int, int]:
    """``(rank, world_size)`` of this process in ``group``; ``(0, 1)`` for
    ``group=None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _on_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """A new tensor: ``t`` reduced over the group by ``op`` (``"sum"`` or
    ``"max"``), on ``t``'s device."""
    if group is None:
        return t.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = t.to("cpu", copy=True) if _on_host(group) else t.clone()
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (all of one shape and dtype), in rank order, on
    ``t``'s device."""
    if group is None:
        return [t]
    _, n = world(group)
    src = t.to("cpu", copy=True) if _on_host(group) else t.contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return [o.to(t.device) for o in outs]


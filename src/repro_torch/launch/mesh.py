"""Process groups for multi-device mining (counterpart of
``repro.launch.mesh``).

A JAX mesh is one controller over many devices; the port is SPMD instead:
one process per rank, each calling the same function (``mine_sharded``)
with its own device, over a ``torch.distributed`` process group.  The
transport is chosen by the caller, never swapped behind its back:

* ``nccl`` — CUDA ranks, one card each (rank ``r`` on ``cuda:r``); the
  collectives run on the cards.  Asking for more ranks than there are
  cards raises (NCCL refuses two ranks on one card).
* ``gloo`` — ranks on the CPU (``device="cpu"``), or several ranks that
  share cards (``device="cuda"``: rank ``r`` on ``cuda:r % count``); the
  collectives run on host copies (:mod:`repro_torch.core.collectives`).

:func:`init_group` joins one rank to a group through a ``FileStore``;
:func:`spawn` starts ``world_size`` ranks with ``torch.multiprocessing``
(start method ``spawn``, never ``fork`` after CUDA) and returns rank 0's
result.  Nothing here touches a device or a group at import time.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable

import torch

BACKENDS = ("nccl", "gloo")
# How long a rank waits for the others at a collective before it fails.
_TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(backend: str, rank: int, world_size: int,
                device: str = "cuda") -> torch.device:
    """The device of ``rank`` in a group of ``world_size`` over
    ``backend``; raises where the transport cannot serve it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    kind = torch.device(device).type
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("nccl runs CUDA ranks; use gloo for ranks on "
                             "the CPU")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"nccl needs one card a rank: {world_size} ranks, {cards} "
                "cards; use gloo for ranks that share a card")
        return torch.device("cuda", rank)
    if kind == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    return torch.device("cuda", rank % cards)


def init_group(store_path: str, rank: int, world_size: int,
               backend: str = "nccl", device: str = "cuda"):
    """Join this process to a group of ``world_size`` ranks as ``rank``,
    meeting the others through the ``FileStore`` at ``store_path`` (a file
    that does not exist yet, one per group).  Returns ``(group,
    device)``: the default group and this rank's device, which is also
    made the current CUDA device."""
    dev = rank_device(backend, rank, world_size, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import torch.distributed as dist
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=_TIMEOUT)
    return dist.group.WORLD, dev


def close_group() -> None:
    """Leave the default group (every rank calls it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               device: str, store_path: str, result_path: str,
               args: tuple) -> None:
    # The ranks share the host's cores: one thread each keeps them from
    # oversubscribing it.
    torch.set_num_threads(1)
    group, dev = init_group(store_path, rank, world_size, backend, device)
    try:
        out = fn(rank, group, dev, *args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        close_group()


def spawn(fn: Callable, world_size: int, backend: str = "nccl",
          device: str = "cuda", args: tuple = ()) -> Any:
    """Run ``fn(rank, group, device, *args)`` on ``world_size`` new
    processes, one a rank, and return rank 0's result.

    ``fn`` must be importable by name (a module-level function), and its
    result picklable.  Each rank runs its host work on one CPU thread.  A
    rank that raises stops the others, and the error is raised here.  The
    backend's limits are checked before any process starts.
    """
    for rank in range(world_size):
        rank_device(backend, rank, world_size, device)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        store = os.path.join(tmp, "store")
        result = os.path.join(tmp, "result.pkl")
        mp.start_processes(_rank_main, nprocs=world_size, join=True,
                           start_method="spawn",
                           args=(fn, world_size, backend, device, store,
                                 result, tuple(args)))
        with open(result, "rb") as f:
            return pickle.load(f)

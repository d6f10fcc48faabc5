"""Checkpoint and restart (counterpart of ``repro.train.checkpoint``), in
the JAX package's on-disk format.

A tree (dicts, lists and tuples of tensors) is flattened to arrays keyed
by its path, dict keys and sequence indices joined by ``/`` (so
``(params, opt_state)`` gives ``0/embed``, ``1/m/layers/wq``,
``1/v/layers/wq/vr`` and ``1/step``), bf16 written as its ``uint16`` bits,
into ``ckpt_<step:08d>.npz`` beside a JSON manifest (step, tree structure,
keys, ``extra``), each written to a temporary file and renamed into place.
A checkpoint written by either package restores in the other.  The
arrays are full tensors, whatever device wrote them: restore puts each
leaf on its template's device.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.train.tree import (leaves_with_paths, structure,
                                    tree_map_with_path)

_SEP = "/"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:           # npz cannot hold bf16: its bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: dict | None = None) -> str:
    """Write ``tree`` as step ``step``'s checkpoint; returns its path."""
    os.makedirs(directory, exist_ok=True)
    flat = {_key(path): _array(leaf)
            for path, leaf in leaves_with_paths(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    meta = {"step": step, "treedef": f"PyTreeDef({structure(tree)})",
            "keys": sorted(flat), "extra": extra or {}}
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(mpath + ".tmp", mpath)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".json")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any, step: int | None = None
                       ) -> tuple[Any, int, dict]:
    """Restore into the structure of ``like`` (its leaves give each
    tensor's dtype and device): ``(tree, step, extra)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(directory, f"ckpt_{step:08d}.json")) as f:
        meta = json.load(f)
    tree = tree_map_with_path(
        lambda path, leaf: _tensor(flat[_key(path)], leaf), like)
    return tree, step, meta["extra"]


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device)

"""Carry state across from the JAX package.

For mining, what carries across is the input graph and the capacity plans
its executor recorded.  ``graph_from_arrays`` takes the numpy arrays of a
``repro.graph.csr.CSRGraph`` (labels too); ``plan_from_json`` and
``plan_to_json`` move a :class:`MiningPlan` in the JAX package's JSON
schema, vertex plans and FSM's edge plans with their filter capacities
alike, so a plan recorded by the JAX executor replays in the port and
back.  For the transformer, ``transformer_params_from_numpy`` takes the
JAX parameter tree as numpy arrays, bf16 leaves bit for bit.  Nothing here
imports the JAX package: the exchange is numpy arrays and JSON text.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.plan import MiningPlan
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.graph.csr import CSRGraph


def graph_from_arrays(row_ptr, col_idx, labels=None,
                      device: DeviceSpec = None) -> CSRGraph:
    """A port CSRGraph from the row_ptr / col_idx arrays of a JAX one."""
    dev = resolve_device(device)
    rp = np.asarray(row_ptr)
    ci = np.asarray(col_idx)
    if rp.ndim != 1 or ci.ndim != 1 or rp.shape[0] < 1:
        raise ValueError("row_ptr and col_idx must be 1-D arrays")
    if int(rp[-1]) != ci.shape[0]:
        raise ValueError(f"row_ptr[-1]={int(rp[-1])} != len(col_idx)="
                         f"{ci.shape[0]}")
    lab: Optional[torch.Tensor] = None
    if labels is not None:
        lab = torch.from_numpy(np.array(labels, dtype=np.int32)).to(dev)
    return CSRGraph(
        row_ptr=torch.from_numpy(rp.astype(np.int32)).to(dev),
        col_idx=torch.from_numpy(ci.astype(np.int32)).to(dev),
        n_vertices=int(rp.shape[0] - 1), n_edges=int(ci.shape[0]),
        labels=lab)


def _tensor(arr, dev: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")        # a writable contiguous copy
    if arr.dtype.name == "bfloat16":
        # numpy knows bf16 only through ml_dtypes, which torch does not
        # read: carry the bits
        arr = arr.view(np.uint16)
        return torch.from_numpy(arr).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def transformer_params_from_numpy(tree, device: DeviceSpec = None) -> dict:
    """The port's transformer parameters from the JAX ones as numpy arrays
    (a nested dict, e.g. ``jax.tree.map(np.asarray, params)``), with the
    same names, shapes and dtypes; bf16 leaves keep their bits."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dev)
    return convert(tree)


def plan_from_json(text: str) -> MiningPlan:
    """A plan recorded by either package (``MiningPlan.to_json``)."""
    return MiningPlan.from_json(text)


def plan_to_json(plan: MiningPlan) -> str:
    """JSON the JAX package's ``MiningPlan.from_json`` reads."""
    return plan.to_json()

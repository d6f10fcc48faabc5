"""Architecture registry: ``--arch <id>`` resolution for the launchers
(counterpart of ``repro.configs.registry``).

Every id of the JAX package resolves here: the LM, GNN and recsys
families.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from repro_torch.configs.shapes import FAMILY_SHAPES

ARCH_IDS = [
    "qwen3-0.6b", "command-r-plus-104b", "yi-34b", "deepseek-moe-16b",
    "kimi-k2-1t-a32b",
    "equiformer-v2", "graphsage-reddit", "gat-cora", "nequip",
    "dien",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    config: Any
    smoke: Any
    shapes: dict


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return ArchSpec(arch_id=arch_id, family=mod.FAMILY, config=mod.CONFIG,
                    smoke=mod.SMOKE, shapes=FAMILY_SHAPES[mod.FAMILY])


def list_archs() -> list[str]:
    return list(ARCH_IDS)

"""Architecture registry: ``--arch <id>`` resolution for the launchers
(counterpart of ``repro.configs.registry``).

Every id of the JAX package is known here; the LM and recsys ids resolve.
The GNN ids raise ``NotImplementedError``: ROADMAP.md queue 1 lists them
with the rest of the ML stack.
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

_PORTED = ["qwen3-0.6b", "command-r-plus-104b", "yi-34b", "deepseek-moe-16b",
           "kimi-k2-1t-a32b", "dien"]
_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in _PORTED}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    config: Any
    smoke: Any
    shapes: dict


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; ported: {list(_MODULES)} "
            "(ROADMAP.md queue 1, the ML stack)")
    mod = importlib.import_module(_MODULES[arch_id])
    return ArchSpec(arch_id=arch_id, family=mod.FAMILY, config=mod.CONFIG,
                    smoke=mod.SMOKE, shapes=FAMILY_SHAPES[mod.FAMILY])


def list_archs() -> list[str]:
    return list(ARCH_IDS)

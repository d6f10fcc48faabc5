"""Phase-backend registry (counterpart of ``repro.core.phases``).

Built-ins:

  * ``"torch-ref"`` — every ported phase in plain PyTorch, on any device.
  * ``"cuda"``      — vertex EXTEND on the hand-written CUDA kernels
    (two-pass scan compaction on a concurrent grid), plain PyTorch for
    the rest.  On CPU tensors its kernel wrappers run their plain
    versions.
  * ``"cuda-1p"``   — ``cuda`` with the single-pass pruned extend
    (decoupled look-back compaction on a concurrent grid).
"""
from __future__ import annotations

from typing import Callable, Union

from repro_torch.core.phases.base import PhaseBackend
from repro_torch.core.phases.cuda import CudaBackend, CudaLookbackBackend
from repro_torch.core.phases.reference import ReferenceBackend

_REGISTRY: dict[str, Callable[[], PhaseBackend]] = {}
_INSTANCES: dict[str, PhaseBackend] = {}

BackendSpec = Union[str, PhaseBackend, None]

GRID_CONTRACTS = ("any", "sequential", "concurrent")


def register_backend(name: str,
                     factory: Callable[[], PhaseBackend]) -> None:
    """Register a backend factory under ``name`` (overwrites)."""
    gc = getattr(factory, "grid_contract", None)
    if isinstance(factory, type) and gc not in GRID_CONTRACTS:
        raise ValueError(f"backend {name!r} declares grid_contract={gc!r}; "
                         f"expected one of {list(GRID_CONTRACTS)}")
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(spec: BackendSpec = None) -> PhaseBackend:
    """Resolve a backend name (or pass an instance through).  ``None`` is
    the ``cuda`` backend, the port's main path."""
    if spec is None:
        spec = "cuda"
    if isinstance(spec, PhaseBackend):
        return spec
    if spec not in _REGISTRY:
        raise KeyError(f"unknown phase backend {spec!r}; "
                       f"available: {available_backends()}")
    if spec not in _INSTANCES:
        _INSTANCES[spec] = _REGISTRY[spec]()
    return _INSTANCES[spec]


register_backend("torch-ref", ReferenceBackend)
register_backend("cuda", CudaBackend)
register_backend("cuda-1p", CudaLookbackBackend)

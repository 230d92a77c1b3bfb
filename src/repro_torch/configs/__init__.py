"""Config registry of the port: ``get_arch(name)`` for the two PINN
architectures ("pinn-mlp", "pinn-pde")."""

from __future__ import annotations

from . import pinn_mlp, pinn_pde
from .record import ArchConfig

_REGISTRY = {m.CONFIG.name: m.CONFIG for m in (pinn_mlp, pinn_pde)}


def registry() -> dict[str, ArchConfig]:
    return dict(_REGISTRY)


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]

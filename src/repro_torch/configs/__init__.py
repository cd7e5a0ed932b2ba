"""Config registry: ``get_config(arch_id)`` / ``ARCHS``. Holds the archs
this port serves; the reference's other families join with their slices."""
from __future__ import annotations

from repro_torch.configs.base import (EncDecConfig, GatingDropoutConfig,
                                      ModelConfig, MoEConfig, PagedKVConfig,
                                      TrainConfig, reduced)
from repro_torch.configs.zcode_m3 import CONFIG as _ZCODE_BASE
from repro_torch.configs.zcode_m3 import CONFIG_BIG as _ZCODE_BIG

_REGISTRY = {c.arch_id: c for c in (_ZCODE_BASE, _ZCODE_BIG)}

ARCHS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


__all__ = ["ARCHS", "EncDecConfig", "GatingDropoutConfig", "ModelConfig",
           "MoEConfig", "PagedKVConfig", "TrainConfig", "get_config",
           "reduced"]

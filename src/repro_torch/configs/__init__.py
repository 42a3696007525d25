"""Architecture configs for the 10 assigned LM-family architectures —
the port's own copy of ``repro.configs`` (pure Python, the same values)."""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, InputShape, cells_for_arch

__all__ = [
    "ModelConfig",
    "ARCHS",
    "get_config",
    "get_smoke_config",
    "SHAPES",
    "InputShape",
    "cells_for_arch",
]

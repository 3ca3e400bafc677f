"""Architecture registry: ``--arch <id>`` resolution (port of
``repro/configs/__init__.py``). It lists every architecture of the
reference."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, smoke_reduce

_ARCH_MODULES = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

ARCH_NAMES = tuple(_ARCH_MODULES)

# (arch, shape) combos excluded from long_500k (the reference's DESIGN.md
# section 5): pure full-attention architectures with no claimed
# sub-quadratic variant.
LONG_CONTEXT_SKIPS = frozenset(
    {"qwen1.5-4b", "command-r-plus-104b", "qwen2-vl-7b", "deepseek-v2-236b",
     "seamless-m4t-large-v2"}
)


def supports_shape(arch: str, shape: str) -> bool:
    if shape == "long_500k" and arch in LONG_CONTEXT_SKIPS:
        return False
    return True


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_arch_config(name: str) -> ArchConfig:
    return _module(name).get_config()


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).get_smoke_config()


__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_NAMES",
    "LONG_CONTEXT_SKIPS",
    "get_arch_config",
    "get_smoke_config",
    "smoke_reduce",
    "supports_shape",
]

"""Architecture registry: ``--arch <id>`` resolution (port of
``repro/configs/__init__.py``).

It lists only the architectures whose modules the port has. Asking for one
of the reference's other architectures raises ``NotImplementedError`` naming
the ROADMAP item that will port it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, smoke_reduce

_ARCH_MODULES = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}

# the reference's other architectures, with what each still needs
NOT_PORTED = {
    "mixtral-8x22b": "ROADMAP A11 (MoE)",
    "gemma2-9b": "ROADMAP A11 (gemma2 pair_lg layers)",
    "deepseek-v2-236b": "ROADMAP A11 (MLA, MoE, dense prologue)",
    "jamba-1.5-large-398b": "ROADMAP A11 (jamba hybrid, MoE)",
    "qwen1.5-4b": "ROADMAP A11 (its config and QKV-bias parity)",
    "qwen2-vl-7b": "ROADMAP A11 (M-RoPE, vision stub)",
    "seamless-m4t-large-v2": "ROADMAP A11 (encoder-decoder)",
    "command-r-plus-104b": "ROADMAP A11 (its config, tied embeddings)",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: {NOT_PORTED[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_ARCH_MODULES)}")
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
    "NOT_PORTED",
    "get_arch_config",
    "get_smoke_config",
    "smoke_reduce",
]

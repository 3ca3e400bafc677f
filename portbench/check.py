"""What decides ``correct``: the program's outputs of a sample of the
window's requests against the configuration's plain fp32 reference, run on
the same weights and prompts once the window has closed.

The numbers compared, and the sample's size, are the request kind's
(``kinds/<kind>.py``: ``numbers``, ``SAMPLE``). Its control
(``control_record``) is the reference itself computed with every linear
layer's operands in float8 e4m3 (per-row and per-column scales), put in
the program's place: the precision below the bf16 the configurations
state.
"""
from __future__ import annotations

import importlib

import torch

from portbench.reference.common import F32


def reference(config: dict):
    """The configuration's reference module (``reference/<name>.py``)."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def rel(a: torch.Tensor, b: torch.Tensor, dim=None) -> torch.Tensor:
    """||a - b|| / ||b||, over ``dim`` (all when None)."""
    a, b = a.to(F32), b.to(F32)
    if dim is None:
        return (a - b).norm() / b.norm().clamp(min=1e-30)
    return (a - b).norm(dim=dim) / b.norm(dim=dim).clamp(min=1e-30)


def worst(readings: list) -> dict:
    """The widest reading of each number over a sample's requests."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, compared)``: every number that has a limit within it,
    and at least one compared; ``compared`` maps each number to its value
    and its limit (None where it has none)."""
    compared = {k: {"value": v, "limit": limits.get(k)}
                for k, v in found.items()}
    held = [v <= limits[k] for k, v in found.items()
            if limits.get(k) is not None]
    return bool(held) and all(held), compared

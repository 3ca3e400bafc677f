"""The weights of a run, drawn from its seed on the run's device in the
program's layout, in the dtype they are served in.

One draw for each kind of initialisation and dtype (normal in bf16, uniform
in fp32, ...): every leaf is a view into one of a few flat buffers, scaled
in place. The leaves and their initialisations come from the
configuration's reference (``param_spec``).
"""
from __future__ import annotations

import math

import torch

from portbench import seeds

NORMAL = ("normal", "one_plus")
UNIFORM = ("A_log", "dt_bias")


def _finish(t: torch.Tensor, init: tuple) -> None:
    """Turn a leaf's standard draw into its initialisation, in place."""
    kind = init[0]
    if kind == "normal":
        t.mul_(init[1])
    elif kind == "one_plus":
        t.mul_(init[1]).add_(1.0)
    elif kind == "const":
        t.fill_(init[1])
    elif kind == "A_log":  # log of U(lo, hi)
        lo, hi = init[1:]
        t.mul_(hi - lo).add_(lo).log_()
    elif kind == "dt_bias":  # softplus^-1 of exp(U(log lo, log hi))
        lo, hi = math.log(init[1]), math.log(init[2])
        dt = t.mul_(hi - lo).add_(lo).exp_()
        t.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown initialisation {init!r}")


def make(spec: list, seed: int, device) -> tuple[dict, int]:
    """``(params, count)``: the nested dict of leaves that ``spec`` lists
    (``(path, shape, dtype, init)``) and the number of parameters."""
    gen = torch.Generator(device=device).manual_seed(seeds.sub(seed, "weights"))
    groups: dict = {}
    for path, shape, dtype, init in spec:
        kind = "normal" if init[0] in NORMAL else \
            "uniform" if init[0] in UNIFORM else "none"
        groups.setdefault((kind, dtype), []).append((path, shape, init))
    params: dict = {}
    count = 0
    for (kind, dtype), leaves in sorted(groups.items()):
        dt = getattr(torch, dtype)
        n = sum(math.prod(shape) for _, shape, _ in leaves)
        if kind == "normal":
            flat = torch.randn(n, generator=gen, dtype=dt, device=device)
        elif kind == "uniform":
            flat = torch.rand(n, generator=gen, dtype=dt, device=device)
        else:
            flat = torch.empty(n, dtype=dt, device=device)
        at = 0
        for path, shape, init in leaves:
            size = math.prod(shape)
            leaf = flat[at:at + size].view(shape)
            at += size
            _finish(leaf, init)
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        count += n
    return params, count

"""Arithmetic over parameter dicts (the port's pytrees).

A model is a plain ``dict[str, Tensor]``. Its leaves are always visited in
sorted key order, which is the order ``jax.tree_util`` gives a dict, so flat
vectors and hashes line up with the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

Params = Dict[str, torch.Tensor]


def tree_weighted_mean(trees: Sequence[Params], weights) -> Params:
    """Normalized weighted average (paper Eqs. 3/4) of identically keyed
    dicts; ``weights`` has one entry per tree."""
    first = trees[0]
    dev = next(iter(first.values())).device
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = w / torch.sum(w)
    out = {}
    for k in sorted(first):
        stacked = torch.stack([t[k].to(torch.float32) for t in trees])
        out[k] = torch.tensordot(w, stacked, dims=1).to(first[k].dtype)
    return out


def tree_flatten_concat(a: Params):
    """One 1-D fp32 vector of all leaves (sorted keys) plus the spec that
    :func:`tree_unflatten_concat` needs to rebuild the dict."""
    keys = sorted(a)
    spec = (keys, [tuple(a[k].shape) for k in keys], [a[k].dtype for k in keys])
    flat = torch.cat([a[k].reshape(-1).to(torch.float32) for k in keys])
    return flat, spec


def tree_unflatten_concat(flat: torch.Tensor, spec) -> Params:
    keys, shapes, dtypes = spec
    out, ofs = {}, 0
    for k, shp, dt in zip(keys, shapes, dtypes):
        n = math.prod(shp)
        out[k] = flat[ofs: ofs + n].reshape(shp).to(dt)
        ofs += n
    return out

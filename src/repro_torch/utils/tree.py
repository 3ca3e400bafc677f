"""Arithmetic over parameter dicts (the port's pytrees).

A model is a plain ``dict[str, Tensor]``. Its leaves are always visited in
sorted key order, which is the order ``jax.tree_util`` gives a dict, so flat
vectors and hashes line up with the reference's. :func:`tree_leaves` and
:func:`tree_map` walk the nested dicts, lists and NamedTuples of the MARL
controller's parameters in the same order.
"""
from __future__ import annotations

import math
import functools
from typing import Dict, Sequence

import torch

Params = Dict[str, torch.Tensor]


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_cast(a, dtype):
    """Floating leaves cast to ``dtype``; integer and bool leaves kept."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)


def tree_dot(a, b) -> torch.Tensor:
    """Sum over leaves of ``vdot(x, y)``, a 0-dim tensor."""
    return functools.reduce(torch.add, [
        torch.vdot(x.reshape(-1), y.reshape(-1))
        for x, y in zip(tree_leaves(a), tree_leaves(b))])


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_size(a) -> int:
    """Total number of elements."""
    return int(sum(x.numel() for x in tree_leaves(a)))


def tree_bytes(a) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(a)))


def tree_stack(trees: Sequence):
    """A list of same-structured trees as one tree with a leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, n: int) -> list:
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


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


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    """The tensor leaves of a nest of dicts, lists, tuples and NamedTuples,
    in ``jax.tree_util``'s order: dict keys sorted, sequences in order.
    ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the same-structured
    ``rest``, in :func:`tree_leaves`' order; the structure (dict keys, list,
    tuple or NamedTuple type) is kept and ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if _is_namedtuple(tree):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_unflatten_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves``, given in
    :func:`tree_leaves`' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)

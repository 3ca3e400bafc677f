"""Hierarchical aggregation (paper Eqs. 3-5), port of the host-level half of
``repro/core/hierarchy.py``.

    Eq. 3  flat FedAvg over all twins,
    Eq. 4  per-BS aggregation over its own twins,
    Eq. 5  unweighted MBS average over BS aggregates.

Models are parameter dicts. The stacked forms take dicts whose leaves carry
a leading twin axis and group them through the segment-reduce dispatch, so
on the card Eq. 4 launches the hand kernel once for the weights and once per
leaf. The mesh-level ``intra_pod_mean`` / ``cross_pod_mean`` average a
tree over the ranks of a ``torch.distributed`` group.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.sharding import group_sum
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fedavg_reduce import stack_rows
from repro_torch.kernels.segment_reduce import segment_reduce
from repro_torch.utils.tree import (tree_flatten_concat, tree_map,
                                    tree_scale, tree_unflatten_concat,
                                    tree_weighted_mean)


def _device_of(tree) -> torch.device:
    return next(iter(tree.values())).device


def _col(w: torch.Tensor, ndim: int) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (ndim - 1))


def flat_fedavg(models: Sequence, data_sizes):
    """Eq. 3 (normalized): data-weighted average of N model dicts."""
    return tree_weighted_mean(models, data_sizes)


def bs_aggregate(models: Sequence, data_sizes):
    """Eq. 4: one BS aggregates the models of the K_i twins it hosts."""
    return tree_weighted_mean(models, data_sizes)


def global_aggregate(bs_models: Sequence, bs_data: Optional[Sequence] = None,
                     *, weighted_global: bool = False):
    """Eq. 5: MBS average of BS aggregates (unweighted per the paper), or
    data-weighted when ``weighted_global`` (== flat FedAvg exactly)."""
    if weighted_global:
        if bs_data is None:
            raise ValueError("weighted_global needs bs_data")
        return tree_weighted_mean(bs_models, bs_data)
    return tree_weighted_mean(bs_models, [1.0] * len(bs_models))


def hierarchical_fedavg(models: Sequence, data_sizes, assoc, n_bs: int, *,
                        weighted_global: bool = False):
    """Two-tier aggregation (Eqs. 4-5) of a host list of N twin models
    grouped by ``assoc`` (N,) -> BS in [0, n_bs): the small-N reference."""
    assoc = np.asarray(assoc)
    data_sizes = torch.as_tensor(data_sizes, dtype=torch.float32,
                                 device=_device_of(models[0]))
    bs_models, bs_data = [], []
    for j in range(n_bs):
        idx = np.nonzero(assoc == j)[0]
        if idx.size == 0:
            continue
        sizes = data_sizes[torch.as_tensor(idx, device=data_sizes.device)]
        bs_models.append(bs_aggregate([models[i] for i in idx], sizes))
        bs_data.append(torch.sum(sizes))
    return global_aggregate(bs_models, torch.stack(bs_data),
                            weighted_global=weighted_global)


def bs_aggregate_stacked(stacked, data_sizes, assoc, n_bs: int, *,
                         backend: str = "auto") -> tuple:
    """Eq. 4 for stacked twin models, on the device.

    Args:
        stacked: dict whose leaves carry a leading twin axis (N, ...).
        data_sizes: (N,) per-twin data weights D_j.
        assoc: (N,) int twin->BS map in [0, n_bs).
        n_bs: M.
        backend: segment-reduction backend.

    Returns:
        ``(per_bs, bs_weights)``: ``per_bs`` mirrors ``stacked`` with
        leading axis M (BS i's data-weighted model average, zeros for empty
        BSs); ``bs_weights`` (M,) is the total data per BS.
    """
    dev = _device_of(stacked)
    w = torch.as_tensor(data_sizes, dtype=torch.float32, device=dev)
    assoc = torch.as_tensor(assoc, device=dev)
    bs_w = segment_reduce(w, assoc, n_bs, backend=backend)  # (M,)
    safe_w = torch.where(bs_w > 0.0, bs_w, torch.ones_like(bs_w))
    per_bs = {}
    for k in sorted(stacked):
        x = stacked[k]
        summed = segment_reduce(x * _col(w, x.ndim), assoc, n_bs,
                                backend=backend)
        per_bs[k] = summed / _col(safe_w, x.ndim)
    return per_bs, bs_w


def global_aggregate_stacked(per_bs_tree, bs_w, accept=None, *,
                             weighted_global: bool = False):
    """Eq. 5 over stacked per-BS aggregates (leading axis M), on the device.

    ``bs_w`` (M,) marks occupied BSs (> 0); ``accept`` (M,) bool optionally
    restricts the mean to chain-verified BSs. Unweighted by default,
    data-weighted with ``weighted_global``. Rejected or empty rows enter as
    exact zeros; with nothing accepted the result is all zeros.
    """
    dev = _device_of(per_bs_tree)
    bs_w = torch.as_tensor(bs_w, dtype=torch.float32, device=dev)
    acc = bs_w > 0.0
    if accept is not None:
        acc = acc & torch.as_tensor(accept, dtype=torch.bool, device=dev)
    w = torch.where(acc, bs_w if weighted_global else torch.ones_like(bs_w),
                    torch.zeros_like(bs_w))
    tot = torch.clamp(torch.sum(w), min=1e-12)
    return {k: torch.sum(x * _col(w, x.ndim), dim=0) / tot
            for k, x in per_bs_tree.items()}


def hierarchical_fedavg_stacked(stacked, data_sizes, assoc, n_bs: int, *,
                                weighted_global: bool = False,
                                backend: str = "auto"):
    """Two-tier aggregation (Eqs. 4-5) over stacked twin models; empty BSs
    are excluded from the Eq. 5 mean. Returns one model dict."""
    dev = _device_of(stacked)
    w = torch.as_tensor(data_sizes, dtype=torch.float32, device=dev)
    if weighted_global:
        # data-weighted outer mean == flat FedAvg exactly
        tot = torch.clamp(torch.sum(w), min=1e-12)
        return {k: torch.sum(x * _col(w, x.ndim), dim=0) / tot
                for k, x in stacked.items()}
    per_bs, bs_w = bs_aggregate_stacked(stacked, w, assoc, n_bs,
                                        backend=backend)
    occupied = bs_w > 0.0
    n_occ = torch.clamp(torch.sum(occupied.to(torch.float32)), min=1.0)
    return {k: torch.sum(torch.where(_col(occupied, x.ndim), x,
                                     torch.zeros_like(x)), dim=0) / n_occ
            for k, x in per_bs.items()}


def fedavg_flat_kernel(models: Sequence, data_sizes):
    """Eq. 3 through the FedAvg reduce kernel (flat parameter streaming),
    on a stack laid out by the kernel's own :func:`stack_rows`."""
    flats, spec = [], None
    for m in models:
        f, spec = tree_flatten_concat(m)
        flats.append(f)
    stacked = stack_rows(flats)
    weights = torch.as_tensor(data_sizes, dtype=torch.float32,
                              device=flats[0].device)
    return tree_unflatten_concat(kops.fedavg_reduce(stacked, weights), spec)


# ---------------------------------------------------------------------------
# mesh-level (the distributed trainer)
# ---------------------------------------------------------------------------


def _group_mean(tree, group):
    n = dist.get_world_size(group)
    return tree_scale(tree_map(lambda x: group_sum(x, group), tree), 1.0 / n)


def intra_pod_mean(tree, group=None):
    """Eq. 4 on a mesh: the mean of ``tree`` over the ranks of ``group``,
    the intra-pod data ranks (default: the world); one SUM all-reduce a
    leaf."""
    return _group_mean(tree, group)


def cross_pod_mean(tree, group=None):
    """Eq. 5 on a mesh: the mean of ``tree`` over the ranks of ``group``,
    one rank per pod (default: the world); the local-SGD trainer calls it
    every H steps."""
    return _group_mean(tree, group)

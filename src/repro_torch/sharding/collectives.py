"""Collectives of the LM mesh: the expert-parallel all-to-all, the
model-axis reduction of the expert products and the aux loss's mean, each
an autograd Function, and the host staging of CUDA tensors on gloo.

Gloo ranks sharing one card hand gloo CUDA tensors. Its plain collectives
take them, but DTensor's functional collectives (``_c10d_functional``) on
gloo with CUDA tensors end the process (SIGSEGV, torch 2.11 on the H100).
:func:`stage_functional_collectives` therefore registers CUDA kernels for
those ops that copy the tensor to the host, run gloo's collective there and
copy the result back; the mesh's own collectives below stage the same way.
Every staged call adds to :data:`HOST_STAGED` (calls and bytes a rank
sends through the host), per op.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

HOST_STAGED = collections.Counter()
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def reset_counts():
    HOST_STAGED.clear()


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _count(op: str, x: torch.Tensor):
    HOST_STAGED[f"{op}_calls"] += 1
    HOST_STAGED[f"{op}_bytes"] += x.numel() * x.element_size()
    HOST_STAGED["calls"] += 1
    HOST_STAGED["bytes"] += x.numel() * x.element_size()


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True).contiguous()


def _all_reduce_into(h: torch.Tensor, op: str, group):
    if op == "avg":
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
        h /= dist.get_world_size(group)
    else:
        dist.all_reduce(h, op=_REDUCE_OPS[op], group=group)


# ---------------------------------------------------------------------------
# DTensor's functional collectives, host-staged
# ---------------------------------------------------------------------------


def _pg(group_name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name)


def _fc_all_gather(input, group_size, group_name):
    _count("all_gather", input)
    h = _host(input)
    out = h.new_empty((group_size * h.shape[0], *h.shape[1:]))
    dist.all_gather_into_tensor(out, h, group=_pg(group_name))
    return out.to(input.device)


def _fc_all_reduce(input, reduce_op, group_name):
    _count("all_reduce", input)
    h = _host(input)
    _all_reduce_into(h, reduce_op.lower(), _pg(group_name))
    return h.to(input.device)


def _fc_reduce_scatter(input, reduce_op, group_size, group_name):
    _count("reduce_scatter", input)
    h, op, pg = _host(input), reduce_op.lower(), _pg(group_name)
    if op not in ("sum", "avg"):
        _all_reduce_into(h, op, pg)
        return h.chunk(group_size)[dist.get_rank(pg)].to(input.device,
                                                         copy=True)
    out = h.new_empty((h.shape[0] // group_size, *h.shape[1:]))
    dist.reduce_scatter_tensor(out, h, group=pg)
    if op == "avg":
        out /= group_size
    return out.to(input.device)


def _fc_all_to_all(input, output_split_sizes, input_split_sizes, group_name):
    _count("all_to_all", input)
    h = _host(input)
    pg = _pg(group_name)
    n = dist.get_world_size(pg)
    outs = list(output_split_sizes) or [h.shape[0] // n] * n
    out = h.new_empty((sum(outs), *h.shape[1:]))
    dist.all_to_all_single(out, h, outs, list(input_split_sizes) or None,
                           group=pg)
    return out.to(input.device)


def _fc_broadcast(input, src, group_name):
    _count("broadcast", input)
    h = _host(input)
    dist.broadcast(h, group=_pg(group_name), group_src=src)
    return h.to(input.device)


_LIB = None


def stage_functional_collectives():
    """Route ``_c10d_functional``'s collectives on CUDA tensors through
    the host (for a process whose groups are all gloo). Idempotent."""
    global _LIB
    if _LIB is not None:
        return
    import warnings

    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "overriding a previous kernel"
        lib.impl("all_gather_into_tensor", _fc_all_gather, "CUDA")
        lib.impl("all_reduce", _fc_all_reduce, "CUDA")
        lib.impl("reduce_scatter_tensor", _fc_reduce_scatter, "CUDA")
        lib.impl("all_to_all_single", _fc_all_to_all, "CUDA")
        lib.impl("broadcast", _fc_broadcast, "CUDA")
    _LIB = lib


# ---------------------------------------------------------------------------
# the mesh's own collectives (autograd Functions)
# ---------------------------------------------------------------------------


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all over dim 0: chunk j of ``x`` goes to rank j of
    ``group``; chunk j of the result came from rank j."""
    x = x.contiguous()
    if _staged(x, group):
        _count("all_to_all", x)
        h = _host(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    if _staged(x, group):
        _count("all_reduce", x)
        h = _host(x)
        dist.all_reduce(h, group=group)
        return h.to(x.device)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the group
    (the input of a product whose other operand the group splits)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward (partial products to the whole); the
    cotangent of the replicated sum passes through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    """Mean over the group of a value each rank computed from its own data;
    the replicated mean's cotangent is 1/n of each rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return _sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_to_all(x, group):
    """Differentiable tiled all-to-all over dim 0 (its own inverse)."""
    return _AllToAll.apply(x, group)


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def pmean(x, group):
    return _Mean.apply(x, group)

"""Activation sharding constraints (port of ``repro/sharding/act.py``).

The reference pins activations at layer boundaries with
``with_sharding_constraint``, guarded by divisibility, and the calls are
no-ops outside an ``activation_mesh`` context, so one-device runs are
unaffected. The port is SPMD: one process a shard, the mesh a
``DeviceMesh`` (``launch/mesh.py``) and a sharded array a
``torch.distributed.tensor.DTensor``, the analogue of a GSPMD array.
:func:`constrain` is a ``redistribute`` to the resolved placements (a plain
tensor is first taken as replicated), :func:`unshard` a ``redistribute``
that replicates the FSDP dims. Outside a context both return their input
unchanged.

Inside :func:`activation_mesh` plain tensors that meet DTensors (positions,
masks) count as replicated (DTensor's ``implicit_replication``). The hand
kernels meet DTensors through :func:`on_local_shards`: each rank's call
sees its own batch rows and heads, as a Pallas call sees one shard.

The state is thread-local, as the reference's.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from repro_torch.sharding.specs import P, spec_placements

_STATE = threading.local()


def _current():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def activation_mesh(mesh, layout: str = "2d"):
    """layout: "2d" (FSDP x TP) or "dp" (pure data parallel: the batch
    sharded over every mesh axis, no tensor parallelism); "decode" makes
    :func:`unshard` a no-op."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = (_current(), getattr(_STATE, "layout", "2d"))
    _STATE.mesh = mesh
    _STATE.layout = layout
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.mesh, _STATE.layout = prev


def current_layout() -> str:
    return getattr(_STATE, "layout", "2d")


@contextlib.contextmanager
def manual_axes(axes):
    """Mark axes as manual (each rank holds its own block, as in a
    ``shard_map`` region): :func:`constrain` and :func:`unshard` drop any
    part naming them."""
    prev = getattr(_STATE, "manual", frozenset())
    _STATE.manual = frozenset(axes)
    try:
        yield
    finally:
        _STATE.manual = prev


def _manual() -> frozenset:
    return getattr(_STATE, "manual", frozenset())


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def batch_axes(mesh=None, layout: Optional[str] = None):
    mesh = mesh or _current()
    layout = layout or current_layout()
    if layout == "dp":
        return tuple(mesh.axis_names) if mesh is not None else "data"
    if mesh is not None and "pod" in mesh.axis_names:
        return ("pod", "data")
    return "data"


def resolve(mesh, shape, parts, layout: str = "2d") -> P:
    """The spec ``constrain`` applies to an array of ``shape`` on ``mesh``:
    "batch" is the (pod?, data) composite axis (every axis in "dp"),
    "model" is dropped in "dp", manual axes are dropped, and an axis that
    does not divide its dim is dropped (replicated) rather than refused."""
    resolved = []
    for dim, part in zip(shape, parts):
        if part is None:
            resolved.append(None)
            continue
        if part == "model" and layout == "dp":
            resolved.append(None)  # pure DP: no tensor parallelism
            continue
        if part == "data" and layout == "dp":
            part = batch_axes(mesh, layout)  # the EP axis widens to all data
        ax = batch_axes(mesh, layout) if part == "batch" else part
        if ax == "pod" and "pod" not in mesh.axis_names:
            resolved.append(None)
            continue
        manual = _manual()
        if manual:
            ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
            ax_t = tuple(a for a in ax_t if a not in manual)
            if not ax_t:
                resolved.append(None)
                continue
            ax = ax_t[0] if len(ax_t) == 1 else ax_t
        resolved.append(ax if dim % _axis_size(mesh, ax) == 0 else None)
    resolved += [None] * (len(shape) - len(resolved))
    return P(*resolved)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as
    replicated (every rank holds the same global values)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh.device_mesh,
                              [Replicate()] * len(mesh.axis_names),
                              run_check=False)


def constrain(x, *parts):
    """``x`` redistributed to ``resolve(parts)``'s placements (the
    reference's ``with_sharding_constraint`` with divisibility guards).
    Use "batch" for the (pod?, data) composite axis. The identity outside
    an ``activation_mesh`` context."""
    mesh = _current()
    if mesh is None or x is None:
        return x
    spec = resolve(mesh, tuple(x.shape), parts, current_layout())
    return as_dtensor(x, mesh).redistribute(mesh.device_mesh,
                                            spec_placements(spec, mesh))


def placed_like(new, old):
    """``new`` redistributed to ``old``'s placements where both are
    DTensors (a no-op when they agree, and off a mesh)."""
    from torch.distributed.tensor import DTensor

    if isinstance(new, DTensor) and isinstance(old, DTensor) \
            and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


def align(x, ref, dims: dict):
    """``x`` split as ``ref`` on the dims they share (``dims`` maps a dim
    of ``ref`` to the dim of ``x`` that matches it) and whole on every
    other mesh axis; the identity unless both are DTensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)):
        return x
    pls = [Shard(dims[pl.dim]) if pl.is_shard() and pl.dim in dims
           else Replicate() for pl in ref.placements]
    return x.redistribute(x.device_mesh, pls)


def write_seq(dst, src, at: int) -> None:
    """``dst[:, at:at + n] = src`` in place (``src`` of n positions along
    dim 1). Where mesh axes split ``dst``'s dim 1 (MLA's decode caches),
    DTensor would slice a replicated copy and the write would be lost: the
    rank whose block holds ``at`` writes into its own block instead."""
    from torch.distributed.tensor import DTensor, Replicate

    if not (isinstance(dst, DTensor)
            and any(pl.is_shard() and pl.dim == 1 for pl in dst.placements)):
        dst[:, at:at + src.shape[1]] = src.to(dst.dtype)
        return
    mesh = dst.device_mesh
    coord = mesh.get_coordinate()
    start, size = 0, dst.shape[1]
    for i, pl in enumerate(dst.placements):  # mesh order, the first major
        if pl.is_shard() and pl.dim == 1:
            size //= mesh.size(i)
            start += coord[i] * size
    src = as_dtensor(src, _current()) if not isinstance(src, DTensor) \
        else src
    src = src.redistribute(mesh, [
        Replicate() if pl.is_shard() and pl.dim == 1 else pl
        for pl in dst.placements]).to_local()
    lo, hi = max(at, start), min(at + src.shape[1], start + size)
    if lo < hi:
        dst.to_local()[:, lo - start:hi - start] = \
            src[:, lo - at:hi - at].to(dst.dtype)


def split_dim(x, dim: int, sizes):
    """``x`` with ``dim`` split into ``sizes``, on any mesh.

    DTensor refuses to unflatten a dim that mesh axes split unless they
    also split the new leading dim (a head count). A DTensor whose ``dim``
    is split over axes whose product does not divide ``sizes[0]`` is
    therefore first replicated on that dim; the reference reshapes and lets
    GSPMD reshard to its constraint, which drops such an axis too
    (:func:`resolve`)."""
    from torch.distributed.tensor import DTensor, Replicate

    dim %= x.ndim
    if isinstance(x, DTensor):
        split = [i for i, pl in enumerate(x.placements)
                 if pl.is_shard() and pl.dim == dim]
        if sizes[0] % math.prod(x.device_mesh.size(i) for i in split):
            pls = [Replicate() if i in split else pl
                   for i, pl in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, pls)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def split_heads(x, n_heads: int, head_dim: int):
    """``x`` (..., n_heads * head_dim) as (..., n_heads, head_dim), on any
    mesh (:func:`split_dim`)."""
    return split_dim(x, -1, (n_heads, head_dim))


class _MergeHeads(torch.autograd.Function):
    """(..., n_heads, head_dim) -> (..., n_heads * head_dim), whose
    backward splits the cotangent by :func:`split_heads` (a plain view's
    backward would unflatten a cotangent split over more ranks than the
    head count)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        ctx.heads = tuple(x.shape[-2:])
        last = x.ndim - 1
        if any(pl.is_shard() and pl.dim == last for pl in x.placements):
            # the card's DTensor (torch 2.11) refuses to merge a split dim
            # into the one before it
            x = x.redistribute(x.device_mesh, [
                Replicate() if pl.is_shard() and pl.dim == last else pl
                for pl in x.placements])
        return x.flatten(-2)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, *ctx.heads)


def merge_heads(x):
    """``x`` (..., n_heads, head_dim) as (..., n_heads * head_dim); on a
    mesh its cotangent is split back by :func:`split_heads`."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _MergeHeads.apply(x)
    return x.flatten(-2)


def fsdp_size() -> int:
    """Size of the fsdp (data [x pod]) axis group, or 0 with no mesh
    context."""
    mesh = _current()
    if mesh is None:
        return 0
    return _axis_size(mesh, batch_axes(mesh, layout="2d"))


def ep_enabled(n_experts: int) -> bool:
    """Expert parallelism applies when the fsdp axis divides the expert
    count."""
    n = fsdp_size()
    return n > 0 and n_experts % n == 0


def unshard(w, *parts):
    """FSDP weight gather at the point of use (ZeRO-3): weights are stored
    fully sharded (``sharding/specs.py``); inside a layer the FSDP axes are
    gathered, so no product contracts over an fsdp-sharded dim. ``parts``
    give the retained (TP) sharding, e.g. (None, "model") for an
    in-projection. A no-op in the "decode" layout (one-token steps keep
    weights in their storage sharding) and outside ``activation_mesh``."""
    if current_layout() == "decode":
        return w
    return constrain(w, *parts)


def row_parallel(x, w):
    """``x @ w`` for an out-projection ``w`` (its contracting dim over
    "model", gathered over the FSDP axes by :func:`unshard`). Each rank's
    product is a partial sum; it is summed here over "model", the result's
    batch kept split, where GSPMD sums the reference's. Left unsummed, the
    partial sums would reach the next norm and products, which DTensor then
    runs whole on every model rank."""
    return constrain(x @ unshard(w, "model", None), "batch", None, None)


# ---------------------------------------------------------------------------
# kernels on local shards
# ---------------------------------------------------------------------------


class _ContiguousGrad(torch.autograd.Function):
    """Identity; the cotangent leaves contiguous (a DTensor's backward
    views need a contiguous block)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_local_shards(fn, args, roles, out_roles, **kw):
    """Run ``fn(*local_args, **kw)`` on each rank's block when ``args[0]``
    is a DTensor, else ``fn(*args, **kw)`` as it is.

    ``roles[i]`` maps a logical axis ("b" batch rows, "h" heads or
    channels, "g" grouped-query key/value heads) to the dim of ``args[i]``
    that carries it, and ``out_roles`` does so for the result. A mesh axis
    that shards ``args[0]``'s "b" or "h" dim splits every argument's dim of
    that role; every other axis is replicated. A "g" dim splits as "h" when
    its head count divides over the head axes; when instead the head axes'
    ranks divide over its heads (8 key/value heads, 16 ranks), each rank
    takes the one key/value head its query heads attend to. Otherwise, or
    if some argument's head count does not split, the heads are replicated
    for all (the kernel then runs on them whole). The result is a DTensor
    with ``out_roles``' placements; each rank's call is its own kernel
    launch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args, **kw)
    dmesh = lead.device_mesh
    role_of = {d: r for r, d in roles[0].items()}
    axis_role = [role_of.get(pl.dim) if pl.is_shard() else None
                 for pl in lead.placements]
    head_axes = [i for i, r in enumerate(axis_role) if r == "h"]
    n_heads = math.prod(dmesh.size(i) for i in head_axes)
    grouped = [n_heads > 1 and "g" in rl and a.shape[rl["g"]] % n_heads > 0
               for a, rl in zip(args, roles)]
    if any("h" in rl and a.shape[rl["h"]] % n_heads
           for a, rl in zip(args, roles)) or any(
            g and n_heads % a.shape[rl["g"]]
            for g, a, rl in zip(grouped, args, roles)):
        axis_role = [None if r == "h" else r for r in axis_role]
        grouped = [False] * len(args)
    # this rank's place among the head axes' ranks (the first axis major)
    coord = dmesh.get_coordinate()
    head_pos = 0
    for i in head_axes:
        head_pos = head_pos * dmesh.size(i) + coord[i]

    def placements(rl, group=False):
        rl = rl if group or "g" not in rl else {**rl, "h": rl["g"]}
        return [Shard(rl[r]) if r in rl else Replicate() for r in axis_role]

    def grad_placements(rl, group=False):
        # an argument whole on an axis that splits the work (A over the
        # batch, B and C over the heads, a key/value head over the ranks
        # of its query heads) gets a partial cotangent there
        rl = rl if group or "g" not in rl else {**rl, "h": rl["g"]}
        return [Shard(rl[r]) if r in rl else
                Partial() if r is not None else Replicate()
                for r in axis_role]

    local = []
    for a, rl, group in zip(args, roles, grouped):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, dmesh, [Replicate()] * dmesh.ndim,
                                   run_check=False)
        t = _ContiguousGrad.apply(
            a.redistribute(dmesh, placements(rl, group)).to_local(
                grad_placements=grad_placements(rl, group)))
        if group:
            d = rl["g"]
            t = t.narrow(d, head_pos * a.shape[d] // n_heads, 1).contiguous()
        local.append(t)
    # a contiguous block: the autograd views of a DTensor need one
    out = fn(*local, **kw).contiguous()
    return DTensor.from_local(out, dmesh, placements(out_roles),
                              run_check=False)

"""Twin-axis sharding of the DTWN simulation core (port of
``repro/core/sharding.py``).

The reference distributes the twin population over a 1-D device mesh and
traces per-shard code under ``shard_map`` inside a :func:`twin_scope`. The
port is SPMD: one process per shard (``repro_torch.launch.mesh``), every
rank calling the same entry point with the same global inputs. A
:class:`TwinSharding` wraps the rank's :class:`~repro_torch.launch.mesh.
TwinMesh`; its :meth:`~TwinSharding.scope` marks code as running on this
rank's twin block, and there the ``twin_*`` helpers are masked local
reductions plus an all-reduce over the mesh's process group, and
``segment_reduce(..., backend="auto")`` resolves to the ``"sharded"``
backend (the local reduce, then one all-reduce of the (M, K) sums). Outside
a scope every helper is the identity or a plain reduction, so the
single-device callers run unchanged.

Layout: a global twin array of length N is padded to ``n_shards *
ceil(N / n_shards)`` and rank r holds rows ``[r * n_local, (r + 1) *
n_local)``. Padding rows carry ``assoc = M`` (dropped by every segment
backend) and zero payloads; the scope's mask keeps them out of pooled
statistics. Global draws are made in full on every rank and each rank
takes its block (:func:`localize`), so the sharded paths see the draws of
the single-device ones.

Collectives are ``all_reduce`` only (SUM, MAX, MIN: the reference's
``psum``/``pmean``/``pmax``/``pmin``), which gloo also runs on CUDA tensors.
A gather of twin rows is a masked local gather and a SUM; bool rows travel
as int32. :data:`ALL_REDUCE` counts the calls and bytes.

Gradients: the SUM all-reduce is differentiable, and its backward
all-reduces the cotangent. A replicated parameter's gradient on one rank is
then its replicated part plus ``n_shards`` times its own twin block's share,
and the mean over ranks is the exact single-device gradient. JAX's ``psum``
transposes differently, which is why the reference's :func:`pmean_in_scope`
only stamps a value there; here it is a real average over the mesh and is
required wherever a gradient of replicated parameters leaves a scope
(``core.marl.ddpg``). ``stamp_replicated`` (for JAX's replication checker)
is the identity; :func:`assert_replicated` checks instead that replicated
leaves are bitwise equal on every rank.

One shard is the no-op fast path of every ``sharded_*`` entry point: the
plain function runs, with no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import latency
from repro_torch.kernels.segment_reduce import (TWIN_AXIS,
                                                register_twin_axis_hook,
                                                register_twin_reduce_hook)
from repro_torch.launch.mesh import TwinMesh, make_twin_mesh
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "TWIN_AXIS", "PartitionSpec", "P", "TwinScope", "TwinSharding",
    "ALL_REDUCE", "in_scope", "twin_scope", "twin_indices", "mask_twins",
    "local_twin_count", "global_twin_count", "group_sum", "psum", "pmax",
    "pmin", "twin_sum", "twin_count", "twin_mean", "twin_max", "twin_min",
    "twin_std", "twin_softmax_pool", "pmean_in_scope", "stamp_replicated",
    "assert_replicated", "slice_local", "localize", "twin_gather",
    "twin_scatter_rows", "model_buffer_specs", "unshard_tree",
    "sharded_t_cmp", "sharded_t_local_agg", "sharded_t_broadcast",
    "sharded_round_time", "sharded_round_time_per_bs", "sharded_total_time",
]


# ---------------------------------------------------------------------------
# partition specs: which leaves are twin-blocked, on which axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, init=False)
class PartitionSpec:
    """``P()`` a replicated leaf, ``P("twin")`` one blocked on axis 0,
    ``P(None, "twin")`` on axis 1: the reference's ``PartitionSpec`` for a
    1-D twin mesh. A leaf of the tree helpers (not a sequence)."""
    axes: tuple

    def __init__(self, *axes):
        object.__setattr__(self, "axes", tuple(axes))

    @property
    def twin_axis(self) -> Optional[int]:
        """The blocked axis, or None for a replicated leaf."""
        return (self.axes.index(TWIN_AXIS) if TWIN_AXIS in self.axes
                else None)


P = PartitionSpec


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


class _Count:
    """All-reduce calls made by this rank and the bytes they reduced."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def reset(self):
        self.calls = 0
        self.bytes = 0


ALL_REDUCE = _Count()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _all_reduce_now(x: torch.Tensor, op: str, group) -> torch.Tensor:
    wire = x.to(torch.int32) if x.dtype == torch.bool else x
    out = wire.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    ALL_REDUCE.calls += 1
    ALL_REDUCE.bytes += out.numel() * out.element_size()
    return out.to(torch.bool) if x.dtype == torch.bool else out


class _AllReduce(torch.autograd.Function):
    """All-reduce over the twin group. SUM is differentiable (its backward
    all-reduces the cotangent: the module docstring's convention); MAX and
    MIN are not. ``vmap`` reduces the batched tensor in one call, since the
    reduction is elementwise."""

    @staticmethod
    def forward(x, op, group):
        return _all_reduce_now(x, op, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op, ctx.group = inputs[1], inputs[2]
        if ctx.op != "sum":
            ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, "sum", ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, op, group):
        return _AllReduce.apply(x, op, group), in_dims[0]


# ---------------------------------------------------------------------------
# the scope
# ---------------------------------------------------------------------------


class TwinScope(NamedTuple):
    """Facts about the twin region: mesh ``axis`` name, true twin count
    ``n_global``, per-shard block ``n_local = ceil(N / n_shards)``,
    ``n_shards``, this ``rank`` and the process ``group`` (None: no mesh)."""
    axis: str
    n_global: int
    n_local: int
    n_shards: int
    rank: Optional[int] = None
    group: Any = None

    @property
    def exact(self) -> bool:
        """True when N divides evenly: no padding rows exist anywhere."""
        return self.n_local * self.n_shards == self.n_global


_STATE = threading.local()


def in_scope() -> Optional[TwinScope]:
    """The active :class:`TwinScope`, or None outside any twin region."""
    return getattr(_STATE, "scope", None)


@contextlib.contextmanager
def twin_scope(n_global: int, n_local: int, n_shards: int,
               axis: str = TWIN_AXIS, *, rank: Optional[int] = None,
               group=None):
    """Mark the enclosed code as running on one rank's twin block. Prefer
    :meth:`TwinSharding.scope`, which fills in the sizes, rank and group."""
    prev = in_scope()
    _STATE.scope = TwinScope(axis=axis, n_global=n_global, n_local=n_local,
                             n_shards=n_shards, rank=rank, group=group)
    try:
        yield _STATE.scope
    finally:
        _STATE.scope = prev


def _require_scope() -> TwinScope:
    s = in_scope()
    if s is None:
        raise RuntimeError("this helper requires an active twin_scope")
    return s


def _require_mesh(what: str) -> TwinScope:
    s = _require_scope()
    if s.n_shards > 1 and (s.group is None or s.rank is None):
        raise RuntimeError(
            f"{what} inside a twin scope with no twin mesh: enter the scope "
            f"with TwinSharding.scope over launch.mesh.make_twin_mesh")
    return s


def _reduce(x, op: str, what: str):
    s = _require_mesh(what)
    x = torch.as_tensor(x)
    if s.n_shards == 1:
        return x
    return _AllReduce.apply(x, op, s.group)


def group_sum(x, group=None):
    """SUM all-reduce of ``x`` over ``group`` (default: the world), outside
    any scope; differentiable like :func:`psum`."""
    return _AllReduce.apply(torch.as_tensor(x), "sum", group)


def psum(x):
    """SUM all-reduce over the active scope's mesh (differentiable)."""
    return _reduce(x, "sum", "psum")


def pmax(x):
    """MAX all-reduce over the active scope's mesh (no gradient)."""
    return _reduce(x, "max", "pmax")


def pmin(x):
    """MIN all-reduce over the active scope's mesh (no gradient)."""
    return _reduce(x, "min", "pmin")


# `segment_reduce(..., backend="auto")` and the segment extremes see the
# scope and its all-reduce without the kernel layer importing upward
register_twin_axis_hook(
    lambda: in_scope().axis if in_scope() is not None else None)
register_twin_reduce_hook(
    lambda x, op: _reduce(x, op, f"the sharded segment {op}"))


def twin_indices(device=None) -> torch.Tensor:
    """Global twin ids of this rank's block, (n_local,) int64."""
    s = _require_mesh("twin_indices")
    start = 0 if s.n_shards == 1 else s.rank * s.n_local
    return start + torch.arange(s.n_local, device=device)


def _mask(device) -> Optional[torch.Tensor]:
    """(n_local,) bool validity mask of this rank, or None when N divides
    the mesh (every row real)."""
    s = _require_mesh("the twin padding mask")
    if s.exact:
        return None
    return twin_indices(device) < s.n_global


def _axis(x, axis: int) -> int:
    return axis % x.ndim


def _bcast(mask, ndim: int, axis: int):
    shape = [1] * ndim
    shape[axis] = mask.shape[0]
    return mask.reshape(shape)


def mask_twins(x, fill, *, axis: int = 0):
    """Overwrite padding rows of a local twin array (twin dimension at
    ``axis``) with ``fill``: the identity outside a scope or when N divides
    the mesh."""
    if in_scope() is None:
        return x
    x = torch.as_tensor(x)
    m = _mask(x.device)
    if m is None:
        return x
    return torch.where(_bcast(m, x.ndim, _axis(x, axis)), x,
                       torch.as_tensor(fill, dtype=x.dtype, device=x.device))


def local_twin_count(default: int) -> int:
    """Per-shard twin block size inside a scope, else ``default``."""
    s = in_scope()
    return s.n_local if s is not None else default


def global_twin_count(default: int) -> int:
    """True global N inside a scope, else ``default``."""
    s = in_scope()
    return s.n_global if s is not None else default


# ---------------------------------------------------------------------------
# population reductions: masked local op + all-reduce; plain torch otherwise
# ---------------------------------------------------------------------------


def twin_sum(x, axis: int = 0):
    """Sum over the twin axis: the masked local sum and a SUM all-reduce
    in a scope."""
    x = torch.as_tensor(x)
    if in_scope() is None:
        return torch.sum(x, dim=axis)
    return psum(torch.sum(mask_twins(x, 0, axis=axis), dim=axis))


def twin_count(mask, axis: int = 0) -> torch.Tensor:
    """Count of True rows of a boolean twin mask (padding excluded),
    int32."""
    return twin_sum(torch.as_tensor(mask).to(torch.int32),
                    axis=axis).to(torch.int32)


def twin_mean(x, axis: int = 0):
    """Mean over the twin axis (masked sum / true N in a scope)."""
    x = torch.as_tensor(x)
    s = in_scope()
    if s is None:
        return torch.mean(x, dim=axis)
    return twin_sum(x, axis=axis) / s.n_global


def twin_max(x, axis: int = 0):
    """Max over the twin axis (MAX all-reduce of masked local maxima)."""
    x = torch.as_tensor(x)
    if in_scope() is None:
        return torch.amax(x, dim=axis)
    return pmax(torch.amax(mask_twins(x, float("-inf"), axis=axis),
                           dim=axis))


def twin_min(x, axis: int = 0):
    """Min over the twin axis (MIN all-reduce of masked local minima)."""
    x = torch.as_tensor(x)
    if in_scope() is None:
        return torch.amin(x, dim=axis)
    return pmin(torch.amin(mask_twins(x, float("inf"), axis=axis), dim=axis))


def twin_std(x, axis: int = 0):
    """Population std (ddof=0) over the twin axis, from the all-reduced
    moments E[x^2] - E[x]^2 in a scope."""
    x = torch.as_tensor(x)
    if in_scope() is None:
        return torch.std(x, dim=axis, correction=0)
    m = twin_mean(x, axis=axis)
    m2 = twin_mean(x * x, axis=axis)
    return torch.sqrt(torch.clamp(m2 - m * m, min=0.0))


def twin_softmax_pool(logits, feats):
    """Attention pooling ``softmax(logits) @ feats`` over the twin axis:
    logits (N,), feats (N, F) -> (F,). In a scope: the MAX all-reduced
    shift (detached, as the reference's ``stop_gradient``), masked
    exponentials and SUM all-reduced numerator and denominator."""
    logits = torch.as_tensor(logits)
    if in_scope() is None:
        return torch.softmax(logits, dim=0) @ feats
    local_max = torch.amax(mask_twins(logits, float("-inf")))
    shift = pmax(local_max.detach())
    e = torch.exp(logits - shift)
    m = _mask(logits.device)
    if m is not None:
        e = e * m
    den = psum(torch.sum(e))
    num = psum(e @ feats)
    return num / torch.clamp(den, min=1e-30)


def pmean_in_scope(tree):
    """The mean over the mesh of a tree of gradients (one SUM all-reduce
    of all leaves, divided by ``n_shards``); no-op outside a scope.

    Required, not a stamp: a rank's gradient of replicated parameters holds
    ``n_shards`` times its own twin block's share (the SUM all-reduce's
    backward all-reduces the cotangent), and the rank mean is the exact
    single-device gradient (module docstring)."""
    s = in_scope()
    if s is None:
        return tree
    leaves = tree_leaves(tree)
    if s.n_shards == 1 or not leaves:
        return tree
    flat = psum(torch.cat([g.reshape(-1) for g in leaves])) / s.n_shards
    parts = iter(torch.split(flat, [g.numel() for g in leaves]))
    return tree_map(lambda g: next(parts).reshape(g.shape), tree)


def stamp_replicated(tree):
    """The identity: the reference tags replicated leaves for JAX's
    replication checker, which torch does not have. See
    :func:`assert_replicated`."""
    return tree


def assert_replicated(tree, ts: Optional["TwinSharding"] = None) -> None:
    """Raise unless every leaf of ``tree`` is bitwise equal on every rank of
    the active scope's mesh (or ``ts``'s): a MAX and a MIN all-reduce of the
    leaves, as float64 (exact for fp32, bool and small ints), must both
    equal the local values. Host numbers among the leaves (a replay's
    pointer) are checked too."""
    s = in_scope()
    group = s.group if s is not None else None
    n = s.n_shards if s is not None else 1
    if ts is not None:
        group, n = ts.group, ts.n_shards
    leaves = tree_leaves(tree)
    if n == 1 or not leaves:
        return
    if group is None:
        raise RuntimeError("assert_replicated needs a twin mesh")
    dev = next((x.device for x in leaves if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    flat = torch.cat([torch.as_tensor(x, device=dev).detach().reshape(-1)
                      .to(torch.float64) for x in leaves])
    hi = _all_reduce_now(flat, "max", group)
    lo = _all_reduce_now(flat, "min", group)
    if not (torch.equal(hi, flat) and torch.equal(lo, flat)):
        bad = int(torch.sum((hi != flat) | (lo != flat)))
        raise AssertionError(f"{bad} of {flat.numel()} replicated values "
                             f"differ between ranks")


# ---------------------------------------------------------------------------
# one rank's block of a globally drawn array
# ---------------------------------------------------------------------------


def slice_local(x, *, axis: int = 0, fill=None):
    """This rank's block of a *global* twin array, (..., n_local, ...).

    ``x`` has at most ``n_shards * n_local`` rows at ``axis`` (the true N,
    or the padded extent); missing rows are zeros, then padding rows are
    overwritten with ``fill`` when it is given (``M`` for association ids).
    Every rank draws the full array and takes its block, so the sharded
    paths see the single-device draws. The block is a new tensor, never a
    view of ``x``: the serve loop writes its state in place."""
    s = _require_mesh("slice_local")
    x = torch.as_tensor(x)
    ax = _axis(x, axis)
    total = s.n_local * s.n_shards
    if x.shape[ax] > total:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} exceeds the "
                         f"scope's padded twin count {total}")
    start = 0 if s.n_shards == 1 else s.rank * s.n_local
    take = max(min(s.n_local, x.shape[ax] - start), 0)
    out = x.narrow(ax, min(start, x.shape[ax]), take)
    if take < s.n_local:
        shape = list(x.shape)
        shape[ax] = s.n_local - take
        out = torch.cat([out, torch.zeros(shape, dtype=x.dtype,
                                          device=x.device)], dim=ax)
    else:
        out = out.clone()
    if fill is not None:
        out = mask_twins(out, fill, axis=ax)
    return out


def localize(x, *, axis: int = 0, fill=None):
    """:func:`slice_local` inside a scope, the identity outside."""
    if in_scope() is None:
        return x
    return slice_local(x, axis=axis, fill=fill)


# ---------------------------------------------------------------------------
# global-id row access on twin buffers: the streamed-FL scatter/gather
# ---------------------------------------------------------------------------


def twin_gather(x, idx, *, fill=0):
    """Rows ``idx`` (global twin ids, any shape) of a twin array ``x``.

    Outside a scope: ``jnp.take(..., mode="fill")``'s law, which the
    reference calls: an id in ``[-N, 0)`` counts from the end (so ``-1`` is
    the last row), and ids outside ``[-N, N)`` return ``fill``. In a scope
    (the reference's law there): ids outside ``[0, N)`` return ``fill``;
    each rank gathers the rows it owns, zeros elsewhere, and a SUM
    all-reduce gives every rank the owners' rows."""
    x = torch.as_tensor(x)
    idx = torch.as_tensor(idx, device=x.device).to(torch.int64)
    s = in_scope()
    if s is None:
        n = x.shape[0]
        wrapped = torch.where(idx < 0, idx + n, idx)
        ok = (wrapped >= 0) & (wrapped < n)
        vals = x[torch.where(ok, wrapped, 0)]
        shape = ok.shape + (1,) * (vals.ndim - ok.ndim)
        return torch.where(ok.reshape(shape), vals,
                           torch.full((), fill, dtype=x.dtype,
                                      device=x.device))
    s = _require_mesh("twin_gather")
    li = idx - (0 if s.n_shards == 1 else s.rank * s.n_local)
    own = (li >= 0) & (li < s.n_local) & (idx >= 0) & (idx < s.n_global)
    vals = x[torch.clamp(li, 0, s.n_local - 1)]
    shape = own.shape + (1,) * (vals.ndim - own.ndim)
    picked = torch.where(own.reshape(shape), vals,
                         torch.zeros((), dtype=x.dtype, device=x.device))
    out = psum(picked)
    miss = (idx < 0) | (idx >= s.n_global)
    return torch.where(miss.reshape(shape),
                       torch.full((), fill, dtype=x.dtype, device=x.device),
                       out)


def _scatter_rows(x, idx, rows):
    n, k = x.shape[0], idx.shape[0]
    ok = (idx >= 0) & (idx < n)
    # owner[r]: the last kept position k writing row r (-1: none); slot n
    # collects the dropped ids
    owner = torch.full((n + 1,), -1, dtype=torch.int64, device=x.device)
    owner.scatter_reduce_(0, torch.where(ok, idx, n),
                          torch.arange(k, device=x.device), reduce="amax")
    owner = owner[:n]
    free = torch.argmax((owner < 0).to(torch.int8))  # first unwritten row
    target = torch.where(ok, idx, free)
    src = owner[target]
    vals = torch.where((src >= 0).reshape((k,) + (1,) * (x.ndim - 1)),
                       rows[torch.clamp(src, min=0)], x[target])
    return x.index_copy_(0, target, vals)


def twin_scatter_rows(x, idx, rows):
    """Write ``rows`` (K, ...) at global twin ids ``idx`` (K,) into ``x``, in
    place, and return ``x``; ids outside ``[0, N)`` are dropped, and in a
    scope so are the ids another rank owns, so each rank writes only its
    own rows. Duplicate ids are not supported.

    Only the K addressed rows are written (``index_copy_``) and nothing is
    read back to the host, so the call neither copies the buffer nor waits
    for the card. A dropped id is sent to a row that no kept id writes (the
    first one, found on the device) and writes that row's own value back;
    when every row is kept-written it joins the first row's writer with the
    same value. So every row is written with one value, whatever order the
    writes land in.
    """
    x = torch.as_tensor(x)
    idx = torch.as_tensor(idx, device=x.device).to(torch.int64)
    rows = torch.as_tensor(rows, dtype=x.dtype, device=x.device)
    s = in_scope()
    if s is not None:
        s = _require_mesh("twin_scatter_rows")
        li = idx - (0 if s.n_shards == 1 else s.rank * s.n_local)
        own = (li >= 0) & (li < s.n_local) & (idx < s.n_global)
        idx = torch.where(own, li, -1)
    return _scatter_rows(x, idx, rows)


def model_buffer_specs(tree):
    """Specs of a ``(capacity, ...)``-leading model buffer tree (the
    streamed-FL twin buffers): every leaf blocked on its leading axis."""
    return tree_map(lambda _: P(TWIN_AXIS), tree)


def unshard_tree(tree, specs, n: int):
    """The global arrays (true extent ``n``) of a tree of this rank's
    blocks: each blocked leaf is placed at the rank's offset in a zero
    array and SUM all-reduced (bool as int32), then unpadded; replicated
    leaves pass through. Needs a scope; every rank gets the whole arrays."""
    s = _require_mesh("unshard_tree")

    def one(x, spec):
        if x is None or spec.twin_axis is None:
            return x
        ax = _axis(x, spec.twin_axis)
        if s.n_shards == 1:
            return x.narrow(ax, 0, n)
        shape = list(x.shape)
        shape[ax] = s.n_local * s.n_shards
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(ax, s.rank * s.n_local, s.n_local).copy_(x)
        return psum(full).narrow(ax, 0, n)

    return _map_specs(one, tree, specs)


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree whose ``specs`` may stop at a subtree
    (a spec there covers every leaf below it)."""
    if isinstance(specs, PartitionSpec):
        return tree_map(lambda x: fn(x, specs), tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    items = [_map_specs(fn, *xs) for xs in zip(tree, specs)]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(
        items)


# ---------------------------------------------------------------------------
# TwinSharding: the mesh handle, padding, per-rank seeds and the scope
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwinSharding:
    """One rank's handle on a twin mesh
    (:func:`repro_torch.launch.mesh.make_twin_mesh`). Every ``sharded_*``
    entry point takes one; ``n_shards == 1`` is the no-op fast path."""
    mesh: TwinMesh

    @classmethod
    def make(cls, n_shards: Optional[int] = None, *,
             backend: Optional[str] = None, device=None) -> "TwinSharding":
        """The mesh over ``n_shards`` ranks (default: the world)."""
        return cls(mesh=make_twin_mesh(n_shards, backend=backend,
                                       device=device))

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def group(self):
        return self.mesh.group

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def local_n(self, n: int) -> int:
        """Per-shard block size ``ceil(n / n_shards)``."""
        return -(-n // self.n_shards)

    def padded_n(self, n: int) -> int:
        """Smallest multiple of ``n_shards`` covering ``n``."""
        return self.local_n(n) * self.n_shards

    def twin_spec(self, axis: int = 0, ndim: int = 1) -> PartitionSpec:
        """The spec blocking dimension ``axis`` of an ``ndim``-array."""
        return P(*[TWIN_AXIS if i == axis else None for i in range(ndim)])

    def pad_twin(self, x, *, axis: int = 0, fill=0):
        """A global twin array padded to :meth:`padded_n` with ``fill``."""
        x = torch.as_tensor(x)
        ax = _axis(x, axis)
        pad = self.padded_n(x.shape[ax]) - x.shape[ax]
        if pad == 0:
            return x
        shape = list(x.shape)
        shape[ax] = pad
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                        device=x.device)], dim=ax)

    def unpad_twin(self, x, n: int, *, axis: int = 0):
        """Padding rows stripped back to the true extent ``n``."""
        return torch.as_tensor(x).narrow(axis, 0, n)

    def shard_keys(self, seed: int) -> torch.Tensor:
        """Independent per-rank seeds, (n_shards,) int64, for sampling where
        parity with the single-device path is not required (the
        parity-exact way is the full draw and :func:`slice_local`)."""
        words = np.random.SeedSequence(seed).generate_state(
            self.n_shards, dtype=np.uint64)
        return torch.from_numpy((words >> np.uint64(1)).astype(np.int64))

    @staticmethod
    def take_shard_key(keys) -> torch.Tensor:
        """This rank's seed out of a :meth:`shard_keys` stack (needs a
        scope)."""
        s = _require_mesh("take_shard_key")
        return torch.as_tensor(keys)[0 if s.n_shards == 1 else s.rank]

    def scope(self, n_global: int):
        """The :func:`twin_scope` of this rank's block of ``n_global``
        twins."""
        return twin_scope(n_global, self.local_n(n_global), self.n_shards,
                          rank=self.rank, group=self.group)


# ---------------------------------------------------------------------------
# sharded latency model: Eqs. 12-17 over the mesh
# ---------------------------------------------------------------------------
#
# Each wrapper takes the global (N,) inputs, slices this rank's block under
# the scope and runs the unchanged latency function, whose segment sums then
# take the "sharded" backend. Outputs ((M,) or scalar) are replicated.


def _shard_call(ts: TwinSharding, fn, kinds: str, fills, *args):
    """Run ``fn(*args)`` over ``ts``: ``kinds[i]`` is ``"t"`` for a global
    twin array (N,)-leading (this rank's block is sliced, padding rows set
    to ``fills[i]``) or ``"r"`` for a replicated one. The first ``"t"``
    argument defines N. The result is replicated."""
    if ts.n_shards == 1:
        return fn(*args)
    n = next(torch.as_tensor(a).shape[0]
             for a, k in zip(args, kinds) if k == "t")
    with ts.scope(n):
        local = [slice_local(a, fill=f) if k == "t" else a
                 for a, k, f in zip(args, kinds, fills)]
        return fn(*local)


def sharded_t_cmp(ts: TwinSharding, params: latency.LatencyParams, assoc, b,
                  data_sizes, freqs) -> torch.Tensor:
    """Eq. 12 over the mesh: assoc/b/data_sizes global (N,), freqs (M,).
    Returns the replicated (M,) per-BS compute time."""
    m = freqs.shape[0]
    return _shard_call(ts, functools.partial(latency.t_cmp, params), "tttr",
                       (m, 0, 0, None), assoc, b, data_sizes, freqs)


def sharded_t_local_agg(ts: TwinSharding, params: latency.LatencyParams,
                        assoc, freqs) -> torch.Tensor:
    """Eq. 14 over the mesh, (M,) replicated."""
    m = freqs.shape[0]
    return _shard_call(ts, functools.partial(latency.t_local_agg, params),
                       "tr", (m, None), assoc, freqs)


def sharded_t_broadcast(ts: TwinSharding, params: latency.LatencyParams,
                        assoc, uplink, n_bs: int) -> torch.Tensor:
    """Eq. 15 over the mesh, (M,) replicated."""
    def fn(a, u):
        return latency.t_broadcast(params, a, u, n_bs)

    return _shard_call(ts, fn, "tr", (n_bs, None), assoc, uplink)


def sharded_round_time(ts: TwinSharding, params: latency.LatencyParams,
                       assoc, b, data_sizes, freqs, uplink, downlink,
                       consensus=None) -> torch.Tensor:
    """Eq. 17 system round time over the mesh (0-dim, replicated): one
    (M,)-sized all-reduce per per-BS sum; ``consensus`` swaps the Eq. 16
    constant for the PBFT term, computed on replicated (M,) rates."""
    m = freqs.shape[0]
    return _shard_call(
        ts, functools.partial(latency.round_time, params,
                              consensus=consensus),
        "tttrrr", (m, 0, 0, None, None, None),
        assoc, b, data_sizes, freqs, uplink, downlink)


def sharded_round_time_per_bs(ts: TwinSharding,
                              params: latency.LatencyParams, assoc, b,
                              data_sizes, freqs, uplink, downlink,
                              consensus=None) -> torch.Tensor:
    """Per-BS T_i (the MARL reward term) over the mesh, (M,) replicated."""
    m = freqs.shape[0]
    return _shard_call(
        ts, functools.partial(latency.round_time_per_bs, params,
                              consensus=consensus), "tttrrr",
        (m, 0, 0, None, None, None), assoc, b, data_sizes, freqs, uplink,
        downlink)


def sharded_total_time(ts: TwinSharding, params: latency.LatencyParams,
                       assoc, b, data_sizes, freqs, uplink, downlink,
                       consensus=None) -> torch.Tensor:
    """Problem (18) objective over the mesh (0-dim, replicated)."""
    m = freqs.shape[0]
    return _shard_call(
        ts, functools.partial(latency.total_time, params,
                              consensus=consensus),
        "tttrrr", (m, 0, 0, None, None, None),
        assoc, b, data_sizes, freqs, uplink, downlink)

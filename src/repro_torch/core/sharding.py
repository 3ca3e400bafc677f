"""Twin-axis scope of the DTWN simulation core: the scope half of
``repro/core/sharding.py``.

The reference distributes the twin population over a 1-D device mesh and
traces per-shard code inside a :func:`twin_scope`. Its ``twin_*`` helpers
are masked local reductions plus a collective inside a scope, and plain
reductions outside one. This module ports the scope itself and every helper's
out-of-scope form, which is the identity or a plain reduction, so the
single-device callers (faults, migration, the FL client) run unchanged.

Inside a scope each helper that needs the shard index or a collective
(``twin_indices``, the padding mask, ``psum``/``pmax``/``pmin``/``pmean``)
raises ``NotImplementedError``: the mesh half (``TwinSharding``, the
``sharded_*`` entry points, the ``"sharded"`` segment backend) is ROADMAP
A10, and a scope must never quietly give the single-device answer.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.segment_reduce import TWIN_AXIS, register_twin_axis_hook

__all__ = [
    "TWIN_AXIS", "TwinScope", "in_scope", "twin_scope", "twin_indices",
    "mask_twins", "local_twin_count", "global_twin_count", "twin_sum",
    "twin_count", "twin_mean", "twin_max", "twin_min", "twin_std",
    "twin_softmax_pool", "pmean_in_scope", "stamp_replicated", "slice_local",
    "localize", "twin_gather", "twin_scatter_rows",
]


class TwinScope(NamedTuple):
    """Static facts about the twin region: mesh ``axis`` name, true twin
    count ``n_global``, per-shard block ``n_local = ceil(N / n_shards)``
    and ``n_shards``."""
    axis: str
    n_global: int
    n_local: int
    n_shards: int

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
               axis: str = TWIN_AXIS):
    """Mark the enclosed code as running per shard inside a twin region."""
    prev = in_scope()
    _STATE.scope = TwinScope(axis=axis, n_global=n_global, n_local=n_local,
                             n_shards=n_shards)
    try:
        yield _STATE.scope
    finally:
        _STATE.scope = prev


# `segment_reduce(..., backend="auto")` and the segment extremes see the
# scope without the kernel layer importing upward
register_twin_axis_hook(
    lambda: in_scope().axis if in_scope() is not None else None)


def _require_scope() -> TwinScope:
    s = in_scope()
    if s is None:
        raise RuntimeError("this helper requires an active twin_scope")
    return s


def _sharded(what: str):
    return NotImplementedError(
        f"{what} inside a twin scope needs the twin mesh, which is not "
        f"ported yet (ROADMAP A10)")


def twin_indices() -> torch.Tensor:
    """Global twin ids of this shard's block; needs the shard index."""
    _require_scope()
    raise _sharded("twin_indices")


def _mask():
    _require_scope()
    raise _sharded("the twin padding mask")


def mask_twins(x, fill, *, axis: int = 0):
    """Overwrite padding rows of a local twin array with ``fill``: the
    identity outside a scope."""
    if in_scope() is None:
        return x
    return _mask()


def local_twin_count(default: int) -> int:
    """Per-shard twin block size inside a scope, else ``default``."""
    s = in_scope()
    return s.n_local if s is not None else default


def global_twin_count(default: int) -> int:
    """True global N inside a scope, else ``default``."""
    s = in_scope()
    return s.n_global if s is not None else default


def twin_sum(x, axis: int = 0):
    """Sum over the twin axis (``psum`` of the masked local sums in a
    scope)."""
    if in_scope() is not None:
        raise _sharded("twin_sum")
    return torch.sum(torch.as_tensor(x), dim=axis)


def twin_count(mask, axis: int = 0) -> torch.Tensor:
    """Count of True rows of a boolean twin mask, int32."""
    return twin_sum(torch.as_tensor(mask).to(torch.int32),
                    axis=axis).to(torch.int32)


def twin_mean(x, axis: int = 0):
    """Mean over the twin axis (masked sum / true N in a scope)."""
    if in_scope() is not None:
        raise _sharded("twin_mean")
    return torch.mean(torch.as_tensor(x), dim=axis)


def twin_max(x, axis: int = 0):
    """Max over the twin axis (``pmax`` of masked local maxima in a scope)."""
    if in_scope() is not None:
        raise _sharded("twin_max")
    return torch.amax(torch.as_tensor(x), dim=axis)


def twin_min(x, axis: int = 0):
    """Min over the twin axis (``pmin`` of masked local minima in a scope)."""
    if in_scope() is not None:
        raise _sharded("twin_min")
    return torch.amin(torch.as_tensor(x), dim=axis)


def twin_std(x, axis: int = 0):
    """Population std (ddof=0) over the twin axis."""
    if in_scope() is not None:
        raise _sharded("twin_std")
    return torch.std(torch.as_tensor(x), dim=axis, correction=0)


def twin_softmax_pool(logits, feats):
    """Attention pooling ``softmax(logits) @ feats`` over the twin axis:
    logits (N,), feats (N, F) -> (F,)."""
    if in_scope() is not None:
        raise _sharded("twin_softmax_pool")
    return torch.softmax(torch.as_tensor(logits), dim=0) @ feats


def pmean_in_scope(tree):
    """Stamp replicated-in-fact gradients with ``pmean``; no-op outside a
    scope."""
    if in_scope() is None:
        return tree
    raise _sharded("pmean_in_scope")


def stamp_replicated(tree):
    """Tag replicated-in-fact leaves as replicated (``pmean``/``pmax``);
    no-op outside a scope."""
    if in_scope() is None:
        return tree
    raise _sharded("stamp_replicated")


def slice_local(x, *, axis: int = 0, fill=None):
    """This shard's block of a global twin array; needs a scope and the
    shard index."""
    _require_scope()
    raise _sharded("slice_local")


def localize(x, *, axis: int = 0, fill=None):
    """:func:`slice_local` inside a scope, the identity outside."""
    if in_scope() is None:
        return x
    return slice_local(x, axis=axis, fill=fill)


def twin_gather(x, idx, *, fill=0):
    """Rows ``idx`` (global twin ids, any shape) of a twin array ``x``.

    ``jnp.take(..., mode="fill")``'s law, which the reference calls: an id
    in ``[-N, 0)`` counts from the end (so ``-1`` is the last row), and ids
    outside ``[-N, N)`` return ``fill``.
    """
    if in_scope() is not None:
        raise _sharded("twin_gather")
    x = torch.as_tensor(x)
    idx = torch.as_tensor(idx, device=x.device).to(torch.int64)
    n = x.shape[0]
    wrapped = torch.where(idx < 0, idx + n, idx)
    ok = (wrapped >= 0) & (wrapped < n)
    vals = x[torch.where(ok, wrapped, 0)]
    shape = ok.shape + (1,) * (vals.ndim - ok.ndim)
    return torch.where(ok.reshape(shape), vals,
                       torch.full((), fill, dtype=x.dtype, device=x.device))


def twin_scatter_rows(x, idx, rows):
    """Write ``rows`` (K, ...) at global twin ids ``idx`` (K,) into ``x``, in
    place, and return ``x``; ids outside ``[0, N)`` are dropped. Duplicate
    ids are not supported.

    Only the K addressed rows are written (``index_copy_``) and nothing is
    read back to the host, so the call neither copies the buffer nor waits
    for the card. A dropped id is sent to a row that no kept id writes (the
    first one, found on the device) and writes that row's own value back;
    when every row is kept-written it joins the first row's writer with the
    same value. So every row is written with one value, whatever order the
    writes land in.
    """
    if in_scope() is not None:
        raise _sharded("twin_scatter_rows")
    x = torch.as_tensor(x)
    idx = torch.as_tensor(idx, device=x.device).to(torch.int64)
    rows = torch.as_tensor(rows, dtype=x.dtype, device=x.device)
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

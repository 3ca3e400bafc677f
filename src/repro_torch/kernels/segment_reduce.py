"""Segment reductions for the DTWN hot path (port of
``repro/kernels/segment_reduce.py``).

Every per-BS quantity of the latency model (Eqs. 12-17) and of the Eq. 4
aggregation is a *segment reduction*: per-twin values summed by the
association vector ``assoc: (N,) int`` into ``M`` base-station bins. The
strategy is a backend behind one dispatch, as in the reference:

``"kernel"``
    The hand-written Hopper kernel (``csrc/segment_reduce.cu``), which
    replaces the reference's Pallas kernel (``"pallas"`` there). On a CUDA
    tensor it launches the kernel or raises; on a CPU tensor it runs the
    kernel's plain version :func:`_seg_tiled_plain`, the reference's tiled
    lowering ``_seg_tiled_ref`` in PyTorch.
``"segment_sum"``
    ``Tensor.index_add_`` scatter-add.
``"sort"``
    Stable argsort, exclusive cumsum, then differences at the segment
    boundaries found with ``searchsorted``.
``"onehot"``
    The dense ``(N, M)`` one-hot contraction: the parity oracle.
``"sharded"``
    The twin-mesh composition: inside a ``repro_torch.core.sharding`` twin
    scope each rank reduces its own twin block with the backend
    ``resolve_backend`` picks for the block (the hand kernel on the card),
    then one SUM all-reduce over the mesh combines the (M, K) sums, and
    every rank holds the global result. ``"auto"`` resolves to it inside a
    scope, so the latency, env and association code shards unchanged.

``resolve_backend`` picks the hand kernel for every CUDA tensor, as the
reference's TPU dispatch picks Pallas whatever M is. The kernel's
shared-memory accumulators hold at most ``MAX_SEGMENTS`` segments, so a
larger M runs as one launch per window of at most ``MAX_SEGMENTS`` segment
ids (:func:`_segment_windows`). On the CPU it keeps the reference's CPU
rules. The reference's thresholds were measured on XLA-CPU and are not a
statement about the card.

Conventions: ``assoc`` ids outside ``[0, M)`` are dropped by every backend;
``values`` is ``(N,)`` or ``(N, ...)`` and trailing dims are flattened to a
lane axis K and restored on return; sums are fp32 whatever the input dtype.

Every backend is differentiable in ``values``. The ``"kernel"`` backend is a
``torch.autograd.Function`` whose backward is a plain gather,
``grad_values[j] = grad_out[assoc[j]]`` (zero for dropped ids): the
reference has no backward kernel either, XLA differentiates around its
Pallas call. :func:`segment_reduce_grouped` reduces G independent
(values, assoc) rows at once, for the batched encodes of the MARL trainer
that the reference ``vmap``s.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import CudaKernel, stream_ptr

BACKENDS = ("auto", "kernel", "sort", "segment_sum", "onehot", "sharded")

# CPU dispatch constants, kept from the reference (measured there on
# XLA-CPU): dense one-hot while the (N, M) fp32 mask stays under this many
# bytes, then the tiled kernel lowering while M stays at or under
# _TILED_MAX_SEGMENTS, scatter-add beyond that.
_ONEHOT_BYTES_BUDGET = 64 * 2**20
_TILED_MAX_SEGMENTS = 32

# Twin-axis tile of the plain tiled version (the reference's _PALLAS_BLOCK).
_TILE = 1024

# Mesh axis name of the twin dimension, named here so the kernel layer needs
# no upward import.
TWIN_AXIS = "twin"

# Hooks registered by repro_torch.core.sharding: the scope probe, a
# zero-arg callable returning the active twin-axis name inside a twin scope
# (else None), and the scope's all-reduce ``fn(x, op)`` with op "sum",
# "max" or "min".
_TWIN_AXIS_HOOK = None
_TWIN_REDUCE_HOOK = None


def register_twin_axis_hook(fn) -> None:
    """Install the scope probe ``fn() -> str | None``."""
    global _TWIN_AXIS_HOOK
    _TWIN_AXIS_HOOK = fn


def register_twin_reduce_hook(fn) -> None:
    """Install the scope's all-reduce ``fn(x, op) -> Tensor``."""
    global _TWIN_REDUCE_HOOK
    _TWIN_REDUCE_HOOK = fn


def _active_twin_axis():
    return _TWIN_AXIS_HOOK() if _TWIN_AXIS_HOOK is not None else None


def _twin_reduce(x, op: str):
    return _TWIN_REDUCE_HOOK(x, op)


# The kernel keeps kThreads * M fp32 accumulators in shared memory, so it
# takes at most (227 KiB - 4 KiB of staged ids) / (256 * 4 B) segments
# (``seg_reduce_max_segments`` in csrc/segment_reduce.cu); chip_smoke.py
# holds this copy to the library's. The grouped call packs at most
# MAX_SEGMENTS // M groups into one launch; a larger M is cut into windows.
MAX_SEGMENTS = (227 * 1024 - 1024 * 4) // (256 * 4)

KERNEL = CudaKernel("segment_reduce.cu", {
    "seg_reduce_f32": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)),
    "seg_reduce_tiles": (ctypes.c_longlong,
                         (ctypes.c_longlong, ctypes.c_longlong)),
    "seg_reduce_max_segments": (ctypes.c_int, ()),
})


def resolve_backend(n: int, num_segments: int, *, platform=None) -> str:
    """Pick a concrete backend from shape and platform.

    ``"cuda"`` -> always the hand kernel (windowed past ``MAX_SEGMENTS``).
    ``"cpu"`` -> the reference's CPU rules:
    dense one-hot while the (N, M) mask fits ``_ONEHOT_BYTES_BUDGET``, then
    the kernel's tiled plain version while M <= ``_TILED_MAX_SEGMENTS``,
    scatter-add beyond that. ``platform=None`` means ``"cuda"`` when a card
    is present, else ``"cpu"``.
    """
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform == "cuda":
        return "kernel"
    if platform != "cpu":
        raise ValueError(f"no segment-reduce dispatch for platform "
                         f"{platform!r}")
    if n * max(num_segments, 1) * 4 <= _ONEHOT_BYTES_BUDGET:
        return "onehot"
    if num_segments <= _TILED_MAX_SEGMENTS:
        return "kernel"
    return "segment_sum"


# ---------------------------------------------------------------------------
# backends: values (N, K) fp32, assoc (N,) int32 -> (M, K) fp32
# ---------------------------------------------------------------------------


def _seg_segment_sum(values, assoc, num_segments: int):
    # out-of-range ids go to a spare row M that is dropped (no host sync)
    valid = (assoc >= 0) & (assoc < num_segments)
    ids = torch.where(valid, assoc, num_segments).long()
    out = torch.zeros((num_segments + 1, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    return out.index_add_(0, ids, values)[:num_segments]


def sort_groups(assoc, num_segments: int):
    """Contiguous-grouping primitive of the ``"sort"`` backend.

    Returns ``(order, bounds)``: ``order`` (N,) int32 is the stable argsort
    of ``assoc`` and ``bounds`` (M+1,) int32 marks where segment m occupies
    sorted positions ``[bounds[m], bounds[m+1])``. Ids below 0 sort before
    ``bounds[0]`` and ids >= M after ``bounds[M]``, so they fall outside
    every segment.
    """
    assoc = torch.as_tensor(assoc).long()
    order = torch.argsort(assoc, stable=True)
    bounds = torch.searchsorted(
        assoc[order].contiguous(),
        torch.arange(num_segments + 1, device=assoc.device), side="left")
    return order.int(), bounds.int()


def _seg_sorted(values, assoc, num_segments: int):
    order, bounds = sort_groups(assoc, num_segments)
    sv = values[order.long()]
    csum = torch.cat([torch.zeros_like(sv[:1]), torch.cumsum(sv, dim=0)])
    return csum[bounds[1:].long()] - csum[bounds[:-1].long()]


def _seg_onehot(values, assoc, num_segments: int):
    """Dense (N, M) one-hot contraction, the parity oracle. O(N*M) memory."""
    ids = torch.arange(num_segments, device=assoc.device)
    onehot = (assoc[:, None] == ids[None, :]).to(values.dtype)
    return onehot.T @ values


def _seg_tiled_plain(values, assoc, num_segments: int, *, block: int = _TILE):
    """Plain version of the kernel: the reference's tiled lowering
    (``_seg_tiled_ref``). Twins stream through in ``block``-row tiles; each
    tile's (block, M) membership mask is contracted with the tile into an
    (M, K) fp32 accumulator. Padding ids equal M and add nothing."""
    n, k = values.shape
    block = min(block, max(n, 1))
    pad = (-n) % block
    ap = torch.nn.functional.pad(assoc.int(), (0, pad), value=num_segments)
    vp = torch.nn.functional.pad(values, (0, 0, 0, pad))
    nb = (n + pad) // block
    ids = torch.arange(num_segments, device=values.device, dtype=torch.int32)
    acc = torch.zeros((num_segments, k), dtype=torch.float32,
                      device=values.device)
    for a_t, v_t in zip(ap.view(nb, block), vp.view(nb, block, k)):
        mask = (a_t[:, None] == ids[None, :]).to(torch.float32)
        acc = acc + mask.T @ v_t
    return acc


def _segment_windows(reduce, values, assoc, num_segments: int, cap: int):
    """``reduce(values, ids, m)`` over windows of at most ``cap`` segments:
    window ``lo`` reduces ``assoc - lo`` into its ``m = min(cap, M - lo)``
    rows (ids outside the window fall outside ``[0, m)`` and are dropped),
    and the windows' rows are stacked in order. One call when M <= cap."""
    if num_segments <= cap:
        return reduce(values, assoc, num_segments)
    return torch.cat([reduce(values, assoc - lo, min(cap, num_segments - lo))
                      for lo in range(0, num_segments, cap)])


def _seg_kernel_forward(values, assoc, num_segments: int):
    """The forward of the ``"kernel"`` backend: a CUDA tensor launches the
    hand kernel on the current stream, once per window of at most
    ``MAX_SEGMENTS`` segments, a CPU tensor runs :func:`_seg_tiled_plain`.
    Any other device, dtype or layout raises."""
    if values.device.type == "cpu" and assoc.device.type == "cpu":
        return _seg_tiled_plain(values, assoc, num_segments)
    if values.device.type != "cuda" or assoc.device != values.device:
        raise ValueError(f"segment kernel needs values and assoc on one CUDA "
                         f"device, got {values.device} and {assoc.device}")
    if values.dtype != torch.float32 or assoc.dtype != torch.int32:
        raise TypeError(f"segment kernel takes fp32 values and int32 assoc, "
                        f"got {values.dtype} and {assoc.dtype}")
    if values.ndim != 2 or assoc.ndim != 1 or values.shape[0] != assoc.shape[0]:
        raise ValueError(f"segment kernel takes values (N, K) and assoc (N,), "
                         f"got {tuple(values.shape)} and {tuple(assoc.shape)}")
    if not (values.is_contiguous() and assoc.is_contiguous()):
        raise ValueError("segment kernel takes contiguous values and assoc")
    n, k = values.shape
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    if n == 0 or k == 0:
        return torch.zeros((num_segments, k), dtype=torch.float32,
                           device=values.device)
    lib = KERNEL.lib()
    tiles = lib.seg_reduce_tiles(n, k)

    def launch(values, ids, m):
        out = torch.empty((m, k), dtype=torch.float32, device=values.device)
        scratch = (torch.empty((tiles, m, k), dtype=torch.float32,
                               device=values.device) if tiles > 1 else None)
        rc = lib.seg_reduce_f32(values.data_ptr(), ids.data_ptr(),
                                out.data_ptr(),
                                None if scratch is None
                                else scratch.data_ptr(),
                                n, k, m, stream_ptr())
        KERNEL.launches += 1
        KERNEL.check(rc, "segment_reduce kernel")
        return out

    return _segment_windows(launch, values, assoc, num_segments,
                            lib.seg_reduce_max_segments())


class _SegmentReduceKernel(torch.autograd.Function):
    """The ``"kernel"`` backend with its gradient. Forward: the hand kernel
    (or its plain version on the CPU). Backward: a plain gather of the
    output gradient at each twin's segment, masked to zero for ids outside
    ``[0, M)``; it launches no kernel, as the reference's Pallas call has no
    backward kernel."""

    @staticmethod
    def forward(ctx, values, assoc, num_segments):
        ctx.save_for_backward(assoc)
        ctx.num_segments = num_segments
        return _seg_kernel_forward(values, assoc, num_segments)

    @staticmethod
    def backward(ctx, grad_out):
        (assoc,) = ctx.saved_tensors
        m = ctx.num_segments
        valid = (assoc >= 0) & (assoc < m)
        rows = torch.index_select(grad_out, 0,
                                  torch.clamp(assoc, 0, m - 1).long())
        return torch.where(valid[:, None], rows, 0.0), None, None


def segment_reduce_kernel(values, assoc, num_segments: int):
    """The ``"kernel"`` backend on ``values`` (N, K) fp32, ``assoc`` (N,)
    int32 -> (M, K) fp32, differentiable in ``values``.

    A CUDA tensor launches the hand kernel (``csrc/segment_reduce.cu``) on
    the current stream; a CPU tensor runs :func:`_seg_tiled_plain`. Any
    other device, dtype or layout raises: there is no fallback. The
    gradient is the gather of :class:`_SegmentReduceKernel`.
    """
    return _SegmentReduceKernel.apply(values, assoc, num_segments)


_IMPLS = {
    "kernel": segment_reduce_kernel,
    "segment_sum": _seg_segment_sum,
    "sort": _seg_sorted,
    "onehot": _seg_onehot,
}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _check_backend(backend: str) -> bool:
    """Validate ``backend``; True when the call takes the ``"sharded"``
    composition (named, or ``"auto"`` inside a twin scope)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    in_scope = _active_twin_axis() is not None
    if backend == "sharded" and not in_scope:
        raise ValueError("the sharded segment backend runs only inside a "
                         "twin scope (core.sharding.TwinSharding.scope)")
    return backend == "sharded" or (backend == "auto" and in_scope)


def _check_shapes(values, assoc):
    if assoc.ndim != 1:
        raise ValueError(f"assoc must be (N,), got shape {tuple(assoc.shape)}")
    if values.ndim == 0 or values.shape[0] != assoc.shape[0]:
        raise ValueError(
            f"values leading axis {tuple(values.shape)} must match assoc "
            f"{tuple(assoc.shape)}")


def segment_reduce(values, assoc, num_segments: int, *,
                   backend: str = "auto") -> torch.Tensor:
    """Sum per-twin ``values`` grouped by BS: out[m] = sum_{j: assoc[j]==m}.

    Args:
        values: (N,) or (N, ...) tensor, any real dtype.
        assoc: (N,) integer tensor of segment ids on the same device; ids
            outside [0, num_segments) are dropped.
        num_segments: M, the number of output bins.
        backend: one of ``BACKENDS``; ``"auto"`` resolves from N, M and the
            tensor's device through :func:`resolve_backend`, or to
            ``"sharded"`` inside a twin scope.

    Returns:
        (M,) or (M, ...) fp32 sums on ``values``' device; under
        ``"sharded"`` ``values`` is this rank's twin block and the result
        the global sum, on every rank.
    """
    sharded = _check_backend(backend)
    values = torch.as_tensor(values)
    assoc = torch.as_tensor(assoc, device=values.device)
    _check_shapes(values, assoc)
    n = assoc.shape[0]
    tail = tuple(values.shape[1:])
    if n == 0:
        out = torch.zeros((num_segments,) + tail, dtype=torch.float32,
                          device=values.device)
    else:
        if backend in ("auto", "sharded"):
            backend = resolve_backend(n, num_segments,
                                      platform=values.device.type)
        flat = values.to(torch.float32).reshape(n, -1).contiguous()
        out = _IMPLS[backend](flat, assoc.to(torch.int32).contiguous(),
                              num_segments).reshape((num_segments,) + tail)
    return _twin_reduce(out, "sum") if sharded else out


def segment_reduce_grouped(values, assoc, num_segments: int, *,
                           backend: str = "auto") -> torch.Tensor:
    """G independent segment sums at once: ``values`` (G, N) or (G, N, ...)
    and ``assoc`` (G, N) -> (G, M) or (G, M, ...) fp32, with
    ``out[g] = segment_reduce(values[g], assoc[g], M)``.

    Group g's ids are offset by ``g * M`` (dropped ids stay dropped), so
    one reduction over G*N twins into G*M segments computes every group.
    The ``"kernel"`` backend launches once per run of at most
    ``MAX_SEGMENTS // M`` contiguous groups (a group of more segments is a
    call of its own, windowed); the other backends take all G in one call.
    Differentiable in ``values`` like :func:`segment_reduce`.
    Inside a twin scope ``values`` and ``assoc`` are this rank's twin
    blocks and one SUM all-reduce of the (G, M, ...) result follows.
    """
    sharded = _check_backend(backend)
    values = torch.as_tensor(values)
    assoc = torch.as_tensor(assoc, device=values.device)
    if assoc.ndim != 2 or tuple(values.shape[:2]) != tuple(assoc.shape):
        raise ValueError(f"grouped segment reduce takes values (G, N, ...) "
                         f"and assoc (G, N), got {tuple(values.shape)} and "
                         f"{tuple(assoc.shape)}")
    g, n = assoc.shape
    tail = tuple(values.shape[2:])
    m = num_segments
    if g == 0 or n == 0:
        out = torch.zeros((g, m) + tail, dtype=torch.float32,
                          device=values.device)
        return _twin_reduce(out, "sum") if sharded else out
    if backend in ("auto", "sharded"):
        backend = resolve_backend(g * n, g * m, platform=values.device.type)
    per_call = max(MAX_SEGMENTS // m, 1) if backend == "kernel" else g
    flat = values.to(torch.float32).reshape(g, n, -1)
    assoc = assoc.to(torch.int32)
    valid = (assoc >= 0) & (assoc < m)
    local = torch.arange(g, dtype=torch.int32, device=values.device) % per_call
    ids = torch.where(valid, assoc + local[:, None] * m, -1)
    outs = []
    for g0 in range(0, g, per_call):
        g1 = min(g0 + per_call, g)
        out = _IMPLS[backend](flat[g0:g1].reshape((g1 - g0) * n, -1)
                              .contiguous(),
                              ids[g0:g1].reshape(-1).contiguous(),
                              (g1 - g0) * m)
        outs.append(out.reshape(g1 - g0, m, -1))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    out = out.reshape((g, m) + tail)
    return _twin_reduce(out, "sum") if sharded else out


def segment_count_grouped(assoc, num_segments: int, *,
                          backend: str = "auto") -> torch.Tensor:
    """Per-group occupancy histograms, (G, M) fp32, through
    :func:`segment_reduce_grouped`."""
    assoc = torch.as_tensor(assoc)
    return segment_reduce_grouped(
        torch.ones(assoc.shape, dtype=torch.float32, device=assoc.device),
        assoc, num_segments, backend=backend)


def segment_count(assoc, num_segments: int, *, backend: str = "auto"
                  ) -> torch.Tensor:
    """Occupancy histogram out[m] = #{j : assoc[j] == m}, (M,) fp32: the
    K_i twins-per-BS count of Eqs. 14-15, through the same dispatch."""
    assoc = torch.as_tensor(assoc)
    return segment_reduce(
        torch.ones(assoc.shape, dtype=torch.float32, device=assoc.device),
        assoc, num_segments, backend=backend)


def _segment_extreme(values, assoc, num_segments: int, *, largest: bool):
    values = torch.as_tensor(values)
    assoc = torch.as_tensor(assoc, device=values.device)
    _check_shapes(values, assoc)
    n = assoc.shape[0]
    tail = tuple(values.shape[1:])
    fill = float("-inf") if largest else float("inf")
    flat = values.to(torch.float32).reshape(n, math.prod(tail))
    out = torch.full((num_segments, flat.shape[1]), fill, dtype=torch.float32,
                     device=values.device)
    if n > 0:
        valid = (assoc >= 0) & (assoc < num_segments)
        ids = torch.where(valid, assoc, 0).long()
        flat = torch.where(valid[:, None], flat, fill)
        out.scatter_reduce_(0, ids[:, None].expand_as(flat), flat,
                            reduce="amax" if largest else "amin")
    out = out.reshape((num_segments,) + tail)
    if _active_twin_axis() is not None:  # the reference's pmax/pmin
        out = _twin_reduce(out, "max" if largest else "min")
    return out


def segment_max(values, assoc, num_segments: int) -> torch.Tensor:
    """Per-segment maximum, fp32; out-of-range ids dropped, empty segments
    -inf. Inside a twin scope the ranks' maxima combine with one MAX
    all-reduce."""
    return _segment_extreme(values, assoc, num_segments, largest=True)


def segment_min(values, assoc, num_segments: int) -> torch.Tensor:
    """Per-segment minimum; mirror of :func:`segment_max` (empty: +inf)."""
    return _segment_extreme(values, assoc, num_segments, largest=False)


def segment_median(values, assoc, num_segments: int) -> torch.Tensor:
    """Per-segment median with numpy semantics (middle-two average), fp32.

    The reference's lexsort (segment id first, value second) becomes two
    stable sorts: by value, then by id. Each segment is then a contiguous
    value-sorted slice and two gathers pick its middle elements.
    Out-of-range ids are dropped; empty segments return 0. It has no
    collective: inside a twin scope it takes replicated data (the consensus
    gate's per-BS losses), as in the reference.
    """
    v = torch.as_tensor(values, dtype=torch.float32)
    a = torch.as_tensor(assoc, device=v.device).long()
    if v.shape[0] == 0:
        return torch.zeros((num_segments,), dtype=torch.float32, device=v.device)
    by_value = torch.argsort(v, stable=True)
    order = by_value[torch.argsort(a[by_value], stable=True)]
    sa, sv = a[order], v[order]
    bounds = torch.searchsorted(
        sa.contiguous(), torch.arange(num_segments + 1, device=v.device),
        side="left")
    cnt = bounds[1:] - bounds[:-1]
    c = torch.clamp(cnt, min=1)
    last = v.shape[0] - 1
    lo = torch.clamp(bounds[:-1] + (c - 1) // 2, 0, last)
    hi = torch.clamp(bounds[:-1] + c // 2, 0, last)
    med = 0.5 * (sv[lo] + sv[hi])
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def segment_std(values, assoc, num_segments: int, *, backend: str = "auto"
                ) -> torch.Tensor:
    """Per-segment population std (ddof=0) from two moment sums; empty
    segments return 0."""
    v = torch.as_tensor(values).to(torch.float32)
    s1 = segment_reduce(v, assoc, num_segments, backend=backend)
    s2 = segment_reduce(v * v, assoc, num_segments, backend=backend)
    cnt = segment_count(torch.as_tensor(assoc, device=v.device), num_segments,
                        backend=backend)
    cnt = cnt.reshape((num_segments,) + (1,) * (s1.ndim - 1))
    c = torch.clamp(cnt, min=1.0)
    mean = s1 / c
    return torch.sqrt(torch.clamp(s2 / c - mean * mean, min=0.0))

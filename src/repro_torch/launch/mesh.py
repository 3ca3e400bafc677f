"""Device meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``): the twin mesh of the DTWN simulation core and the
LM meshes of the trainer and the sharded forward.

The reference's meshes are one JAX program over a device mesh. Here they
are SPMD: one process per shard, every rank calling the same entry point
with the same global inputs, and each mesh axis a ``torch.distributed``
process group. The backend is named, never switched:

``"nccl"``
    One card per rank: rank r runs on ``cuda:r``. A mesh with more ranks
    than cards is refused.
``"gloo"``
    CPU tensors, and CUDA tensors when several ranks share one card (its
    ``all_reduce`` and ``broadcast`` take CUDA tensors, through the host).
``"fake"``
    The dry run's (``launch/dryrun.py``) process group: one process posing
    as rank 0 of a world of any size, whose collectives do nothing. It is
    admitted off CUDA only.

:func:`make_twin_mesh` is the 1-D ``"twin"`` mesh. :func:`make_production_mesh`
((16, 16) ``("data", "model")``; (2, 16, 16) with ``"pod"``) and
:func:`make_debug_mesh` ((n // 2, 2); (2, n // 4, 2)) are the LM meshes, an
:class:`LMMesh` each: a ``DeviceMesh`` whose dim names are the reference's
axis names (DTensor's placements, ``repro_torch.sharding``) and a process
group for each axis and for the (pod, data) FSDP composite. A mesh whose
shape does not match the world is refused, as ``jax.make_mesh`` refuses
one that does not match the devices.

:func:`spawn_ranks` starts the ranks of one mesh with
``torch.multiprocessing.spawn`` (the spawn start method, never fork), a
``FileStore`` in a temporary directory (no fixed port) and returns each
rank's result; :func:`spawn_twin_ranks` and :func:`spawn_lm_ranks` give it
their mesh. A kernel is built once by the caller before the spawn; the
ranks only load the built library.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.utils.device import default_device

__all__ = ["TwinMesh", "LMMesh", "DIST_BACKENDS", "default_dist_backend",
           "PEAK_FLOPS_BF16", "PEAK_FLOPS_TF32", "PEAK_FLOPS_FP32", "HBM_BW",
           "NVLINK_BW_PER_GPU", "NIC_BW_PER_GPU", "NODE_GPUS", "link_bw",
           "make_twin_mesh", "make_production_mesh", "make_debug_mesh",
           "check_backend", "check_world", "debug_mesh_shape",
           "production_mesh_shape",
           "spawn_ranks", "spawn_twin_ranks", "spawn_lm_ranks"]

DIST_BACKENDS = ("nccl", "gloo", "fake")

# NVIDIA H100 SXM5 constants for the roofline model (per GPU). Peaks: the
# H100 data sheet's dense (no sparsity) rates, bf16 and tf32 on the tensor
# cores, fp32 on the CUDA cores; HBM3 bandwidth 3.35 TB/s.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
PEAK_FLOPS_TF32 = 495e12      # FLOP/s
PEAK_FLOPS_FP32 = 67e12       # FLOP/s
HBM_BW = 3.35e12              # bytes/s
# Links: within one HGX H100 node (8 GPUs) NVLink 4 gives a GPU 900 GB/s,
# 450 GB/s each way (data sheet); across nodes a DGX H100 gives each GPU
# one 400 Gb/s ConnectX-7 NIC, 50 GB/s each way (DGX H100 user guide).
NVLINK_BW_PER_GPU = 450e9     # bytes/s, one direction
NIC_BW_PER_GPU = 50e9         # bytes/s, one direction
NODE_GPUS = 8


def link_bw(n_ranks: int) -> float:
    """A GPU's link bandwidth (bytes/s one way) on a mesh of ``n_ranks``:
    NVLink inside one node of :data:`NODE_GPUS`, its NIC beyond."""
    return NVLINK_BW_PER_GPU if n_ranks <= NODE_GPUS else NIC_BW_PER_GPU


@dataclasses.dataclass(frozen=True)
class TwinMesh:
    """One rank's view of the twin mesh: ``n_shards`` ranks, this ``rank``,
    the process ``group`` (None for one shard), the collective ``backend``
    and the ``device`` the rank computes on."""
    n_shards: int
    rank: int
    group: Any
    backend: Optional[str]
    device: torch.device


def default_dist_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, n_shards: int, device: torch.device):
    """Refuse an unknown backend, nccl off CUDA, fake on CUDA, and nccl
    with more ranks than cards."""
    if backend not in DIST_BACKENDS:
        raise ValueError(f"dist backend must be one of {DIST_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "fake" and device.type == "cuda":
        raise ValueError("the fake backend (the dry run's mesh) runs off "
                         "CUDA only")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an nccl mesh runs on CUDA devices; use "
                             "gloo on the CPU")
        if n_shards > torch.cuda.device_count():
            raise ValueError(
                f"an nccl mesh needs one card per rank: {n_shards} "
                f"ranks, {torch.cuda.device_count()} card(s); use gloo to "
                f"put several ranks on one card")


def _rank_device(backend: str, device: torch.device, rank: int):
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    index = 0 if device.index is None else device.index
    return torch.device("cuda", (index + rank) % torch.cuda.device_count())


def make_twin_mesh(n_shards: Optional[int] = None, *,
                   backend: Optional[str] = None, device=None) -> TwinMesh:
    """This rank's 1-D twin mesh over ``n_shards`` ranks (default: the
    initialised world, or one shard). One shard needs no process group;
    more need ``torch.distributed`` initialised with exactly ``n_shards``
    ranks on ``backend`` (default: :func:`default_dist_backend` of
    ``device``, itself ``cuda`` by default)."""
    dev = default_device(device)
    if n_shards is None:
        n_shards = dist.get_world_size() if dist.is_initialized() else 1
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards == 1:
        return TwinMesh(1, 0, None, backend, dev)
    backend = backend or default_dist_backend(dev)
    check_backend(backend, n_shards, dev)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a twin mesh of {n_shards} shards needs torch.distributed "
            f"initialised with {n_shards} ranks (start them with "
            f"spawn_twin_ranks)")
    if dist.get_world_size() != n_shards:
        raise ValueError(f"the twin mesh takes the whole world: "
                         f"{n_shards} shards, world size "
                         f"{dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    rank = dist.get_rank()
    return TwinMesh(n_shards, rank, dist.group.WORLD, backend,
                    _rank_device(backend, dev, rank))


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(rank, n_shards, backend, device, tmp):
    fn, args, mesh_fn, mesh_kw = torch.load(os.path.join(tmp, "call.pt"),
                                            weights_only=False)
    # the ranks share the host's cores: oversubscribed intra-op threads
    # stall every collective
    torch.set_num_threads(max(1, torch.get_num_threads() // n_shards))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_device(backend, dev, rank))
    store = dist.FileStore(os.path.join(tmp, "store"), n_shards)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=n_shards)
    try:
        mesh = mesh_fn(n_shards, backend=backend, device=device, **mesh_kw)
        out = fn(mesh, *args)
        torch.save(_to_cpu(out), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n_shards: int, *, mesh_fn, mesh_kw=None,
                backend: Optional[str] = None, device=None,
                args=()) -> list:
    """Run ``fn(mesh, *args)`` on ``n_shards`` new ranks, ``mesh`` being
    ``mesh_fn(n_shards, backend=, device=, **mesh_kw)`` on each, and return
    their results, rank by rank (tensors moved to the CPU).

    ``fn`` and ``mesh_fn`` must be importable by name (module-level
    functions). The ranks rendezvous through a ``FileStore`` in a temporary
    directory. Each rank reads its own copy of ``fn`` and ``args`` from a
    file there (never shared memory, so a rank's in-place writes stay its
    own) and takes its share of the host's intra-op threads. A rank that
    raises fails the call: ``torch.multiprocessing.spawn`` ends the other
    ranks and raises in the caller. ``backend`` defaults to
    :func:`default_dist_backend` of ``device`` (``cuda`` by default)."""
    dev = default_device(device)
    backend = backend or default_dist_backend(dev)
    check_backend(backend, n_shards, dev)
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        torch.save((fn, tuple(args), mesh_fn, dict(mesh_kw or {})),
                   os.path.join(tmp, "call.pt"))
        torch.multiprocessing.spawn(
            _rank_main, args=(n_shards, backend, str(dev), tmp),
            nprocs=n_shards, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_shards)]


def spawn_twin_ranks(fn, n_shards: int, *, backend: Optional[str] = None,
                     device=None, args=()) -> list:
    """:func:`spawn_ranks` on a twin mesh of ``n_shards`` ranks."""
    return spawn_ranks(fn, n_shards, mesh_fn=make_twin_mesh,
                       backend=backend, device=device, args=args)


def spawn_lm_ranks(fn, n_ranks: int, *, multi_pod: bool = False,
                   production: bool = False, backend: Optional[str] = None,
                   device=None, args=()) -> list:
    """:func:`spawn_ranks` on an LM mesh: :func:`make_debug_mesh` of
    ``n_ranks`` ranks, or :func:`make_production_mesh` with
    ``production``."""
    if production:
        return spawn_ranks(fn, n_ranks, mesh_fn=_production_mesh_of,
                           mesh_kw={"multi_pod": multi_pod}, backend=backend,
                           device=device, args=args)
    return spawn_ranks(fn, n_ranks, mesh_fn=make_debug_mesh,
                       mesh_kw={"multi_pod": multi_pod}, backend=backend,
                       device=device, args=args)


# ---------------------------------------------------------------------------
# LM meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """One rank's view of an LM mesh: the ``axis_names`` and their
    ``sizes`` (ranks laid out row-major, as ``jax.make_mesh`` lays out
    devices), this ``rank`` and its ``coords``, the ``device_mesh`` DTensor
    places on, this rank's process ``groups`` (keyed by a tuple of axis
    names: each axis, and ("pod", "data") with a pod axis), the collective
    ``backend`` and the ``device`` the rank computes on."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    device_mesh: Any
    groups: Dict[Tuple[str, ...], Any]
    backend: str
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axes):
        """This rank's process group over ``axes`` (a name or a tuple)."""
        return self.groups[(axes,) if isinstance(axes, str) else tuple(axes)]


def _axis_groups(sizes, axis_names, axes):
    """Every group of ranks that differ only in ``axes`` (row-major rank
    order), in one fixed order."""
    import itertools

    idx = [axis_names.index(a) for a in axes]
    rest = [i for i in range(len(sizes)) if i not in idx]
    groups = []
    for fixed in itertools.product(*(range(sizes[i]) for i in rest)):
        ranks = []
        for free in itertools.product(*(range(sizes[i]) for i in idx)):
            c = [0] * len(sizes)
            for i, v in zip(rest, fixed):
                c[i] = v
            for i, v in zip(idx, free):
                c[i] = v
            r = 0
            for i, v in enumerate(c):
                r = r * sizes[i] + v
            ranks.append(r)
        groups.append(ranks)
    return groups


def check_world(sizes, axis_names, world: int):
    """Refuse a mesh whose shape does not take exactly ``world`` ranks."""
    n = math.prod(sizes)
    if world != n:
        raise ValueError(f"a mesh of shape {tuple(sizes)} over "
                         f"{tuple(axis_names)} needs {n} ranks, the world "
                         f"has {world}")


def make_lm_mesh(sizes, axis_names, *, backend: Optional[str] = None,
                 device=None) -> LMMesh:
    """This rank's LM mesh of ``sizes`` over ``axis_names``, which must take
    the whole initialised world (``torch.distributed`` with exactly
    ``prod(sizes)`` ranks on ``backend``)."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes, axis_names = tuple(sizes), tuple(axis_names)
    n = math.prod(sizes)
    check_world(sizes, axis_names,
                dist.get_world_size() if dist.is_initialized() else 1)
    dev = default_device(device)
    backend = backend or default_dist_backend(dev)
    check_backend(backend, n, dev)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    rank = dist.get_rank()
    coords, r = [], rank
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    rank_dev = _rank_device(backend, dev, rank)
    if backend == "gloo" and rank_dev.type == "cuda":
        from repro_torch.sharding.collectives import \
            stage_functional_collectives

        stage_functional_collectives()
    dmesh = DeviceMesh(rank_dev.type,
                       torch.arange(n).reshape(sizes),
                       mesh_dim_names=axis_names)
    groups = {(a,): dmesh.get_group(a) for a in axis_names}
    if "pod" in axis_names:  # every rank creates every group, in one order
        for ranks in _axis_groups(sizes, axis_names, ("pod", "data")):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[("pod", "data")] = g
    return LMMesh(axis_names, sizes, rank, coords, dmesh, groups, backend,
                  rank_dev)


def make_production_mesh(*, multi_pod: bool = False, backend=None,
                         device=None) -> LMMesh:
    """(16, 16) ``("data", "model")``, 256 ranks; ``multi_pod``: (2, 16, 16)
    ``("pod", "data", "model")``, 512 ranks. Any other world is refused."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return make_lm_mesh(shape, axes, backend=backend, device=device)


def production_mesh_shape(*, multi_pod: bool = False):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _production_mesh_of(n_ranks, *, multi_pod=False, backend=None,
                        device=None):
    return make_production_mesh(multi_pod=multi_pod, backend=backend,
                                device=device)


def debug_mesh_shape(n_devices: int, *, multi_pod: bool = False):
    """The reference's small mesh: (n // 2, 2) ``("data", "model")``, or
    (2, n // 4, 2) ``("pod", "data", "model")``."""
    if multi_pod:
        return (2, n_devices // 4, 2), ("pod", "data", "model")
    return (n_devices // 2, 2), ("data", "model")


def make_debug_mesh(n_devices: Optional[int] = None, *,
                    multi_pod: bool = False, backend=None,
                    device=None) -> LMMesh:
    """A small mesh over the world (default: all its ranks); tests use 4
    or 8 CPU ranks."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    shape, axes = debug_mesh_shape(n, multi_pod=multi_pod)
    return make_lm_mesh(shape, axes, backend=backend, device=device)

"""The twin mesh of the DTWN simulation core over ``torch.distributed``
(port of ``make_twin_mesh`` in ``repro/launch/mesh.py``).

The reference's twin mesh is one JAX program over a 1-D device mesh with the
axis ``"twin"``. Here it is SPMD: one process per shard, every rank calling
the same entry point with the same global inputs, and the twin axis a
``torch.distributed`` process group. The backend is named, never switched:

``"nccl"``
    One card per rank: rank r runs on ``cuda:r``. A mesh with more shards
    than cards is refused.
``"gloo"``
    CPU tensors, and CUDA tensors when several ranks share one card (its
    ``all_reduce`` and ``broadcast`` take CUDA tensors, through the host).

:func:`spawn_twin_ranks` starts the ranks of one mesh with
``torch.multiprocessing.spawn`` (the spawn start method, never fork), a
``FileStore`` in a temporary directory (no fixed port) and returns each
rank's result. A kernel is built once by the caller before the spawn; the
ranks only load the built library. The reference's LM meshes
(``make_production_mesh``, ``make_debug_mesh``) are not ported.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.utils.device import default_device

__all__ = ["TwinMesh", "DIST_BACKENDS", "default_dist_backend",
           "make_twin_mesh", "spawn_twin_ranks"]

DIST_BACKENDS = ("nccl", "gloo")


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


def _check_backend(backend: str, n_shards: int, device: torch.device):
    if backend not in DIST_BACKENDS:
        raise ValueError(f"dist backend must be one of {DIST_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl twin mesh runs on CUDA devices; use "
                             "gloo on the CPU")
        if n_shards > torch.cuda.device_count():
            raise ValueError(
                f"the nccl twin mesh needs one card per rank: {n_shards} "
                f"shards, {torch.cuda.device_count()} card(s); use gloo to "
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
    _check_backend(backend, n_shards, dev)
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
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
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
        mesh = make_twin_mesh(n_shards, backend=backend, device=device)
        out = fn(mesh, *args)
        torch.save(_to_cpu(out), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_twin_ranks(fn, n_shards: int, *, backend: Optional[str] = None,
                     device=None, args=()) -> list:
    """Run ``fn(mesh, *args)`` on ``n_shards`` new ranks of one twin mesh
    and return their results, rank by rank (tensors moved to the CPU).

    ``fn`` must be importable by name (a module-level function). The ranks
    rendezvous through a ``FileStore`` in a temporary directory. Each rank
    reads its own copy of ``fn`` and ``args`` from a file there (never
    shared memory, so a rank's in-place writes stay its own) and takes its
    share of the host's intra-op threads. A rank that
    raises fails the call: ``torch.multiprocessing.spawn`` ends the other
    ranks and raises in the caller. ``backend`` defaults to
    :func:`default_dist_backend` of ``device`` (``cuda`` by default)."""
    dev = default_device(device)
    backend = backend or default_dist_backend(dev)
    _check_backend(backend, n_shards, dev)
    with tempfile.TemporaryDirectory(prefix="twin_mesh_") as tmp:
        torch.save((fn, tuple(args)), os.path.join(tmp, "call.pt"))
        torch.multiprocessing.spawn(
            _rank_main, args=(n_shards, backend, str(dev), tmp),
            nprocs=n_shards, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_shards)]

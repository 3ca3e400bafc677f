"""Twin migration between FL rounds, port of ``repro/core/migration.py``.

The association vector ``assoc: (N,) int`` evolves across rounds with a
Markov mobility kernel (each twin moves with probability ``p_move``; its
destination is biased toward BSs near its current one on the BS ring) and
a load-aware pull (destinations penalised by their normalised data load,
from the segment-reduce dispatch). A step is one Gumbel-argmax per twin over
the M destination logits plus a Bernoulli move mask. The draws, a (N,)
uniform and a (N, M) Gumbel per step, come in as arguments: torch cannot
repeat ``jax.random``.

:func:`bs_segments` hands out the per-BS segment boundaries of the sort
backend's contiguous grouping, which Krum's cohort sizes read
(``repro_torch.core.faults``). Inside a twin scope the step takes the
GLOBAL draws and slices this rank's block, so ``sharded_migration_step``
sees the single-device realization.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import latency, sharding
from repro_torch.kernels.segment_reduce import segment_reduce, sort_groups


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Knobs of the migration step: ``p_move`` per-twin per-round move
    probability; ``locality`` how fast destination logits fall off with
    ring distance (0 = uniform teleport); ``load_weight`` the penalty on a
    destination's normalised data load (0 = pure mobility)."""
    p_move: float = 0.1
    locality: float = 1.0
    load_weight: float = 1.0


def ring_distance(n_bs: int, device=None) -> torch.Tensor:
    """(M, M) normalised ring distance between BSs, in [0, 1]."""
    i = torch.arange(n_bs, device=device)
    d = torch.abs(i[:, None] - i[None, :])
    d = torch.minimum(d, n_bs - d).to(torch.float32)
    return d / max(n_bs // 2, 1)


def bs_segments(assoc, n_bs: int):
    """Per-BS segment boundaries of the association, from the sort
    backend's contiguous grouping: ``(order, bounds)`` with BS m's twins at
    sorted positions ``[bounds[m], bounds[m+1])``."""
    return sort_groups(torch.as_tensor(assoc), n_bs)


def migration_step(mcfg: MigrationConfig, move_u, gumbel, assoc, data_sizes,
                   n_bs: int, *, backend: str = "auto") -> torch.Tensor:
    """One between-round migration: ``assoc (N,) -> assoc' (N,)`` int32.

    Destination logits of a twin on BS i are
    ``-locality * ring_distance(i, m) - load_weight * load_m / mean(load)``;
    the destination is ``argmax(logits + gumbel)`` and the twin moves where
    its uniform ``move_u`` is below ``p_move``. ``move_u`` (N,) and
    ``gumbel`` (N, M) are the step's draws. A batch of scenarios takes
    ``assoc``, ``data_sizes`` and ``move_u`` (S, N) and ``gumbel`` (S, N, M)
    and returns (S, N); its per-BS loads are one grouped segment sum.
    """
    assoc = torch.as_tensor(assoc)
    dev = assoc.device
    loads = latency.bs_sum(torch.as_tensor(data_sizes, dtype=torch.float32,
                                           device=dev),
                           assoc, n_bs, backend=backend)
    load_pen = loads / torch.clamp(torch.mean(loads, dim=-1, keepdim=True),
                                   min=1e-12)
    # clip padding ids (== n_bs) for the gather
    ring = ring_distance(n_bs, dev)[torch.clamp(assoc.long(), 0, n_bs - 1)]
    logits = (-mcfg.locality * ring
              - mcfg.load_weight * load_pen[..., None, :])
    move = sharding.localize(
        torch.as_tensor(move_u, device=dev) < mcfg.p_move, axis=-1,
        fill=False)
    g = sharding.localize(torch.as_tensor(gumbel, device=dev), axis=-2)
    choice = torch.argmax(logits + g, dim=-1).to(torch.int32)
    out = torch.where(move, choice, assoc.to(torch.int32))
    return sharding.mask_twins(out, n_bs, axis=-1)


def migration_rate(old, new) -> torch.Tensor:
    """Fraction of twins that changed BS, 0-dim fp32; (S,) for a batch of
    associations (S, N)."""
    old, new = torch.as_tensor(old), torch.as_tensor(new)
    moved = sharding.mask_twins(old != new, False, axis=-1)
    n = sharding.global_twin_count(old.shape[-1])
    return sharding.twin_sum(moved.to(torch.float32), axis=-1) / n


def migration_flows(old, new, n_bs: int, *,
                    backend: str = "auto") -> torch.Tensor:
    """(M, M) flow matrix: ``flows[i, j]`` twins moved from BS i to j this
    round (the diagonal: stayers), through the segment-reduce dispatch on
    the pair ids ``old * M + new``; ids >= M*M drop out."""
    old = torch.as_tensor(old)
    pair = old.long() * n_bs + torch.as_tensor(new, device=old.device).long()
    counts = segment_reduce(torch.ones(old.shape, dtype=torch.float32,
                                       device=old.device),
                            pair, n_bs * n_bs, backend=backend)
    return counts.reshape(n_bs, n_bs)


def sharded_migration_step(ts, mcfg: MigrationConfig, move_u, gumbel, assoc,
                           data_sizes, n_bs: int) -> torch.Tensor:
    """:func:`migration_step` over a twin mesh: global (N,) ``assoc`` and
    ``data_sizes`` and the global draws, of which this rank takes its
    block; returns this rank's (n_local,) block of the new association
    (padding rows keep the out-of-range id ``n_bs``). Rows never cross
    ranks: the only collective is the (M,) load all-reduce. ``n_shards ==
    1`` is the no-op fast path."""
    if ts.n_shards == 1:
        return migration_step(mcfg, move_u, gumbel, assoc, data_sizes, n_bs)
    assoc = torch.as_tensor(assoc)
    with ts.scope(assoc.shape[0]):
        return migration_step(mcfg, move_u, gumbel,
                              sharding.slice_local(assoc, fill=n_bs),
                              sharding.slice_local(data_sizes, fill=0.0),
                              n_bs)


def evolve_association(mcfg: MigrationConfig, move_u, gumbel, assoc,
                       data_sizes, n_bs: int) -> tuple:
    """Roll the migration chain one round per row of the draws, ``move_u``
    (R, N) and ``gumbel`` (R, N, M). Returns ``(final_assoc (N,),
    trajectory (R, N), rates (R,))``: round r's association and the
    fraction of twins that moved into it."""
    a = torch.as_tensor(assoc).to(torch.int32)
    traj, rates = [], []
    for u, g in zip(move_u, gumbel):
        a2 = migration_step(mcfg, u, g, a, data_sizes, n_bs)
        traj.append(a2)
        rates.append(migration_rate(a, a2))
        a = a2
    return a, torch.stack(traj), torch.stack(rates)

"""The port's own copy of ``repro/fl/partition.py``, kept verbatim (numpy only) so it
returns the same arrays as the reference without importing it.

Dataset partitioning across end users (paper Section V: 100 users, IID).

Also provides Dirichlet non-IID partitioning (standard FL benchmark
practice) and ``scenario_partition`` — the bridge that carves the dataset
according to a *scenario population*: the heavy-tailed twin data sizes D_j a
``repro.core.scenario.ScenarioBatch`` row draws (plus its Dirichlet
label-skew alpha), so the FL substrate trains on the same population the
latency/association core simulates.

Invariants shared by every partitioner (property-tested in
``tests/test_heterogeneity.py``): the returned shards are disjoint, their
union covers ``[0, n_samples)`` exactly, every user owns at least one
sample, and the output is a deterministic function of the seed.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _counts_from_sizes(data_sizes: np.ndarray, n_samples: int) -> np.ndarray:
    """Integer per-user sample counts proportional to ``data_sizes``, summing
    to exactly ``n_samples`` with a min-1 guard (largest-remainder rounding;
    deficits/surpluses are settled against the largest users first)."""
    w = np.asarray(data_sizes, np.float64)
    n_users = w.size
    if n_samples < n_users:
        raise ValueError(f"need n_samples >= n_users for non-empty shards "
                         f"(got {n_samples} < {n_users})")
    w = np.maximum(w, 1e-12)
    ideal = w / w.sum() * n_samples
    counts = np.maximum(np.floor(ideal).astype(np.int64), 1)
    # settle the remainder: hand leftover samples to (or claw back from)
    # the users with the largest ideal shares — deterministic, keeps >= 1
    order = np.argsort(-ideal, kind="stable")
    diff = n_samples - int(counts.sum())
    i = 0
    while diff != 0:
        u = order[i % n_users]
        if diff > 0:
            counts[u] += 1
            diff -= 1
        elif counts[u] > 1:
            counts[u] -= 1
            diff += 1
        i += 1
    return counts


def iid_partition(n_samples: int, n_users: int, seed: int = 0,
                  uneven: bool = True) -> List[np.ndarray]:
    """Shuffle and split. ``uneven`` draws user shares ~ Dirichlet(5) over
    sizes (the paper's twins have heterogeneous data sizes D_i)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n_samples)
    if uneven:
        shares = rng.dirichlet(np.full(n_users, 5.0))
        counts = np.maximum((shares * n_samples).astype(int), 1)
        counts[-1] = n_samples - counts[:-1].sum()
        counts = np.maximum(counts, 1)
    else:
        counts = np.full(n_users, n_samples // n_users)
    out, ofs = [], 0
    for c in counts:
        out.append(idx[ofs : ofs + c])
        ofs += c
    return out


def dirichlet_partition(labels: np.ndarray, n_users: int, alpha: float = 0.5,
                        seed: int = 0) -> List[np.ndarray]:
    """Label-skew non-IID: per-class Dirichlet(alpha) allocation.

    Small-alpha draws concentrate whole classes onto few users and can
    leave a user with zero samples; the min-1 guard below moves one sample
    from the largest user to each empty one (regression-tested at
    alpha=0.05, n_users=100), matching the guarantee ``iid_partition``
    already made.
    """
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels)
    if labels.shape[0] < n_users:
        raise ValueError(f"need n_samples >= n_users for non-empty shards "
                         f"(got {labels.shape[0]} < {n_users})")
    n_classes = int(labels.max()) + 1
    user_idx: List[list] = [[] for _ in range(n_users)]
    for c in range(n_classes):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        shares = rng.dirichlet(np.full(n_users, alpha))
        cuts = (np.cumsum(shares) * idx.size).astype(int)[:-1]
        for u, part in enumerate(np.split(idx, cuts)):
            user_idx[u].extend(part.tolist())
    # min-1 guard: donate one sample from the currently-largest user to
    # every empty one (deterministic — no RNG involved)
    for u in range(n_users):
        if not user_idx[u]:
            donor = max(range(n_users), key=lambda v: len(user_idx[v]))
            user_idx[u].append(user_idx[donor].pop())
    return [np.asarray(sorted(u), dtype=np.int64) for u in user_idx]


def scenario_partition(n_samples: int, data_sizes, labels=None,
                       alpha: Optional[float] = None,
                       seed: int = 0) -> List[np.ndarray]:
    """Carve ``[0, n_samples)`` according to a scenario population.

    Args:
        n_samples: total dataset size to partition.
        data_sizes: (n_users,) target twin data sizes D_j — typically one
            ``ScenarioBatch`` row's population (``scenario.population_row``);
            shard sizes are proportional to it (largest-remainder rounding,
            min 1 sample each).
        labels: (n_samples,) integer class labels; required when ``alpha``
            is given.
        alpha: optional Dirichlet label-skew concentration. ``None`` fills
            each quota with uniformly shuffled samples (size heterogeneity
            only); small alpha gives each user a Dirichlet(alpha) class
            preference and fills its quota class-by-class from per-class
            pools (size heterogeneity x label skew).

    Returns:
        List of ``n_users`` disjoint int64 index arrays covering
        ``[0, n_samples)`` exactly, every user non-empty, deterministic in
        ``seed``. The per-user *counts* depend only on ``data_sizes`` (not
        on ``alpha``), so the same scenario row drives both the latency
        core (via D_j) and local training (via these shards) with one
        population.
    """
    rng = np.random.RandomState(seed)
    data_sizes = np.asarray(data_sizes, np.float64)
    n_users = data_sizes.size
    counts = _counts_from_sizes(data_sizes, n_samples)

    if alpha is None:
        idx = rng.permutation(n_samples)
        out, ofs = [], 0
        for c in counts:
            out.append(np.sort(idx[ofs : ofs + c]).astype(np.int64))
            ofs += c
        return out

    if labels is None:
        raise ValueError("scenario_partition needs labels when alpha is set")
    labels = np.asarray(labels)
    if labels.shape[0] != n_samples:
        raise ValueError(f"labels shape {labels.shape} != ({n_samples},)")
    n_classes = int(labels.max()) + 1
    pools = [list(rng.permutation(np.nonzero(labels == c)[0]))
             for c in range(n_classes)]
    prefs = rng.dirichlet(np.full(n_classes, alpha), size=n_users)  # (U, C)
    user_idx: List[list] = [[] for _ in range(n_users)]
    # pass 1: each user spreads its quota over classes proportionally to
    # its Dirichlet preference row (largest-remainder rounding) — large
    # alpha therefore approaches IID, small alpha concentrates on the few
    # classes the draw favored — taking at most what each pool still holds
    for u in rng.permutation(n_users):
        need = int(counts[u])
        ideal = prefs[u] * need
        want = np.floor(ideal).astype(np.int64)
        for c in np.argsort(-(ideal - want), kind="stable")[
                : need - int(want.sum())]:
            want[c] += 1
        for c in np.argsort(-prefs[u], kind="stable"):
            take = min(int(want[c]), need, len(pools[c]))
            if take:
                user_idx[u].extend(pools[c][:take])
                del pools[c][:take]
                need -= take
            if need == 0:
                break
    # pass 2: preferred classes can be exhausted by earlier users — fill
    # any remaining deficit from whatever pools still hold samples
    leftovers = [i for pool in pools for i in pool]
    for u in range(n_users):
        deficit = int(counts[u]) - len(user_idx[u])
        if deficit > 0:
            user_idx[u].extend(leftovers[:deficit])
            del leftovers[:deficit]
    assert not leftovers, "scenario_partition: unassigned samples remain"
    return [np.asarray(sorted(u), dtype=np.int64) for u in user_idx]

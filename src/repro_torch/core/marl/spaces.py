"""Structured agent-environment spaces of the edge-association MDP (port of
``repro/core/marl/spaces.py``).

``Observation``
    ``bs_feats (M, G)``: the dynamic per-BS state (CPU frequency, twin count
    K_i/N, data-load share, the C uplink channel gains, distance, and two
    chain columns under consensus). ``twin_feats (N, F)``: the static
    per-twin features (D_j / data_max and D_j / mean(D)).
``Action``
    ``scores (M, N)`` association scores (argmax over the BS axis decodes
    to the (18b)-feasible association), ``b_ctl (M,)`` batch control (18d),
    ``tau (M, C)`` bandwidth bids (18c). Per-agent slices drop the M axis.

Three codecs bridge the structure to fixed-size vectors: ``flatten_obs``
(the O(N) vector of the flat oracle policy), ``compact_obs`` (bs_feats plus
pooled twin statistics, N-independent: what the critic and the replay see)
and ``encode_action`` (the (M, E) joint-action summary, E = 5 + C, of one
joint action or of a batch over leading axes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import sharding
from repro_torch.kernels.segment_reduce import (segment_count_grouped,
                                                segment_reduce_grouped)

# feature layout constants
TWIN_FEAT_DIM = 2       # F: [D_j / data_max, D_j / mean(D)]
N_POOLS = 4             # mean / max / min / std per twin-feature column
BS_EXTRA_FEATS = 4      # freq, K_i/N, load share, distance (+ C gains)
CONSENSUS_FEATS = 2     # chain accept rate, stake share (consensus configs)
ENC_EXTRA = 5           # hard count, soft count, win-score mean, load, b
_SOFT_TEMP = 4.0        # softmax sharpness for the soft-occupancy feature


class Observation(NamedTuple):
    """Structured MDP state (paper Section IV-A, blockchain-shared)."""
    bs_feats: torch.Tensor    # (M, G) dynamic per-BS features
    twin_feats: torch.Tensor  # (N, F) static per-twin features


class Action(NamedTuple):
    """Structured joint action; per-agent slices drop the leading M axis."""
    scores: torch.Tensor      # (M, N) association scores in [-1, 1]
    b_ctl: torch.Tensor       # (M,) batch controls in [-1, 1]
    tau: torch.Tensor         # (M, C) bandwidth bid logits in [-1, 1]


class SpaceSpec(NamedTuple):
    """Static dimensions derived from an EnvConfig."""
    n_twins: int        # N
    n_bs: int           # M
    n_subchannels: int  # C
    twin_f: int         # F, per-twin feature dim
    bs_f: int           # G, per-BS feature dim
    pooled: int         # P = N_POOLS * F
    compact_dim: int    # M*G + P  (critic state / replay row)
    flat_obs_dim: int   # M*G + N*F (flat-policy input, O(N))
    flat_act_dim: int   # N + 1 + C (legacy per-agent action vector)
    enc_dim: int        # E, per-agent action-encoding width


def space_spec(cfg) -> SpaceSpec:
    """Dimensions of every interface tensor for ``cfg: EnvConfig``; ``bs_f``
    widens by :data:`CONSENSUS_FEATS` when the config carries consensus."""
    m, n, c = cfg.n_bs, cfg.n_twins, cfg.wl.n_subchannels
    g = BS_EXTRA_FEATS + c
    if getattr(cfg, "consensus", None) is not None:
        g += CONSENSUS_FEATS
    pooled = N_POOLS * TWIN_FEAT_DIM
    return SpaceSpec(
        n_twins=n, n_bs=m, n_subchannels=c,
        twin_f=TWIN_FEAT_DIM, bs_f=g, pooled=pooled,
        compact_dim=m * g + pooled,
        flat_obs_dim=m * g + n * TWIN_FEAT_DIM,
        flat_act_dim=n + 1 + c,
        enc_dim=ENC_EXTRA + c,
    )


# ---------------------------------------------------------------------------
# observation codecs
# ---------------------------------------------------------------------------


def flatten_obs(obs: Observation) -> torch.Tensor:
    """Observation -> (M*G + N*F,) legacy flat vector (the flat oracle's
    input)."""
    return torch.cat([obs.bs_feats.reshape(-1), obs.twin_feats.reshape(-1)])


def pool_twins(twin_feats: torch.Tensor) -> torch.Tensor:
    """(N, F) -> (N_POOLS*F,) permutation-invariant population summary:
    per-column mean/max/min/std."""
    return torch.cat([
        sharding.twin_mean(twin_feats, 0), sharding.twin_max(twin_feats, 0),
        sharding.twin_min(twin_feats, 0), sharding.twin_std(twin_feats, 0)])


def compact_obs(obs: Observation) -> torch.Tensor:
    """Observation -> (compact_dim,) N-independent state summary: flattened
    bs_feats plus pooled twin statistics (what a replay row stores)."""
    return torch.cat([obs.bs_feats.reshape(-1), pool_twins(obs.twin_feats)])


def obs_from_compact(cfg, row: torch.Tensor,
                     twin_feats: torch.Tensor) -> Observation:
    """Rebuild the Observation from a compact row and the static twin
    feature matrix. Exact: bs_feats round-trips through the row."""
    spec = space_spec(cfg)
    bs = row[: spec.n_bs * spec.bs_f].reshape(spec.n_bs, spec.bs_f)
    return Observation(bs_feats=bs, twin_feats=twin_feats)


# ---------------------------------------------------------------------------
# action codecs
# ---------------------------------------------------------------------------


def flatten_action(a: Action) -> torch.Tensor:
    """Action -> (..., M, N+1+C) legacy flat layout [scores | b | tau]."""
    return torch.cat([a.scores, a.b_ctl[..., None], a.tau], dim=-1)


def unflatten_action(cfg, v: torch.Tensor) -> Action:
    """(..., M, N+1+C) legacy flat layout -> Action."""
    n = cfg.n_twins
    return Action(scores=v[..., :n], b_ctl=v[..., n], tau=v[..., n + 1:])


def zeros_action(cfg, device=None) -> Action:
    """All-zero joint Action: the OU-noise initial state."""
    spec = space_spec(cfg)
    n = sharding.local_twin_count(spec.n_twins)
    return Action(
        scores=torch.zeros((spec.n_bs, n), device=device),
        b_ctl=torch.zeros((spec.n_bs,), device=device),
        tau=torch.zeros((spec.n_bs, spec.n_subchannels), device=device))


def clip_action(a: Action, lo: float = -1.0, hi: float = 1.0) -> Action:
    """Elementwise clip of every Action leaf (after exploration noise)."""
    return Action(*(torch.clamp(x, lo, hi) for x in a))


def encode_action(cfg, a: Action, twin_feats: torch.Tensor) -> torch.Tensor:
    """Compact joint-action summary for the MADDPG critic, (M, E) with
    E = 5 + C, independent of N; over leading axes (``a.scores`` (..., M,
    N), ``a.b_ctl`` (..., M), ``a.tau`` (..., M, C)) it gives (..., M, E).

    Columns per BS agent i: 0. hard occupancy K_i/N of the decoded
    association (a segment count over ``argmax``, first index on ties);
    1. soft occupancy, mean_n softmax_i(scores * temp), the differentiable
    stand-in for column 0; 2. winning-score mean on BS i's twins (a segment
    sum of the per-twin max score; the gradient flows to the winning agent,
    split evenly among tied maxima); 3. data-load share of BS i; 4. the
    agent's raw batch control b_i; 5+ its raw bandwidth bids tau_i (C,).
    The G joint actions of the leading axes share ``twin_feats`` and go
    through one grouped segment call per statistic, three in all: the
    reference ``vmap``s a per-sample encode, which cannot see through a
    kernel launch.

    Inside a twin scope ``a.scores`` and ``twin_feats`` are this rank's
    (..., M, N_local) and (N_local, F) blocks: padding columns decode to
    the dropped id M and leave the soft occupancy's mean, the grouped
    segment calls all-reduce their (G, M) sums, N is the global count and
    the encoding is replicated, so the replay buffer needs no twin data.
    """
    lead = a.scores.shape[:-2]
    m, n_local = a.scores.shape[-2:]
    n = sharding.global_twin_count(n_local)
    scores = a.scores.reshape((-1, m, n_local))                # (G, M, N)
    g = scores.shape[0]
    assoc = sharding.mask_twins(                               # (G, N)
        torch.argmax(scores, dim=1).to(torch.int32), m, axis=-1)
    win = torch.amax(scores, dim=1)                            # (G, N)
    counts = segment_count_grouped(assoc, m)                   # (G, M)
    k_hard = counts / n
    k_soft = sharding.twin_mean(torch.softmax(scores * _SOFT_TEMP, dim=1),
                                axis=2)
    win_mean = segment_reduce_grouped(win, assoc, m) / torch.clamp(
        counts, min=1.0)
    d = twin_feats[:, 0]
    load = segment_reduce_grouped(d.expand(g, n_local), assoc, m) \
        / torch.clamp(sharding.twin_sum(d), min=1e-9)
    enc = torch.cat(
        [k_hard[..., None], k_soft[..., None], win_mean[..., None],
         load[..., None], a.b_ctl.reshape(g, m, 1),
         a.tau.reshape(g, m, -1)], dim=2)
    return enc.reshape(lead + enc.shape[1:])

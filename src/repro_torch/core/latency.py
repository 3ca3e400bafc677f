"""System latency model (paper Section III, Eqs. 11-18), port of
``repro/core/latency.py``.

One federated round (Eq. 17) =
    max_i T_cmp(i)   local twin training on BS i          (Eq. 12)
  + max_i T_pt(i)    transaction broadcast of local models (Eq. 15)
  + T_bv             block production + validation         (Eq. 16)

Total learning time (objective of Eq. 18) = T_round / (1 - theta_G).
Every per-BS sum goes through the segment-reduce dispatch, so on the card
Eqs. 12 and 15 each launch the hand kernel once. The per-twin arrays may
carry a leading scenario axis, ``(S, N)`` with ``(S, M)`` rates: the sums
then go through ``segment_reduce_grouped`` (one launch per run of at most
``MAX_SEGMENTS // M`` scenarios) and the round times are ``(S,)``.
``consensus=`` a ``repro_torch.core.consensus.ConsensusConfig`` swaps the
Eq. 16 constant for the PBFT consensus latency.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.segment_reduce import (segment_count,
                                                segment_count_grouped,
                                                segment_reduce,
                                                segment_reduce_grouped)


@dataclasses.dataclass(frozen=True)
class LatencyParams:
    cycles_per_sample: float = 2e7       # f^C in Eq. 12
    cycles_per_agg_byte: float = 1e3     # f_b in Eq. 13
    cycles_per_val_byte: float = 5e3     # f^v in Eq. 16
    model_size_bits: float = 1.6e6 * 32  # |w_g|: paper CNN ~1.6M fp32 params
    block_size_bits: float = 8e6         # S_B
    xi: float = 1.0                      # transmission time factor (Eq. 15)
    n_producers: int = 3                 # M_p
    theta_g: float = 0.7                 # global accuracy target
    b_min: float = 0.05
    b_max: float = 1.0


def twin_counts(assoc, n_bs: int, *, backend: str = "auto") -> torch.Tensor:
    """K_i: twins associated to each BS, (M,) fp32; (S, M) for a batch of
    associations (S, N)."""
    if torch.as_tensor(assoc).ndim == 2:
        return segment_count_grouped(assoc, n_bs, backend=backend)
    return segment_count(assoc, n_bs, backend=backend)


def bs_sum(values, assoc, n_bs: int, *, backend: str = "auto") -> torch.Tensor:
    """Per-BS sum of per-twin ``values`` (N,), (M,) fp32; (S, M) for
    ``values`` and ``assoc`` of shape (S, N)."""
    values = torch.as_tensor(values, dtype=torch.float32)
    if torch.as_tensor(assoc).ndim == 2:
        return segment_reduce_grouped(values, assoc, n_bs, backend=backend)
    return segment_reduce(values, assoc, n_bs, backend=backend)


def t_cmp(params: LatencyParams, assoc, b, data_sizes, freqs, *,
          backend: str = "auto") -> torch.Tensor:
    """Eq. 12: per-BS local twin-training time, (M,) seconds.
    assoc/b/data_sizes (N,) or (S, N); freqs (M,) Hz."""
    work = bs_sum(b * data_sizes, assoc, freqs.shape[-1], backend=backend)
    return work * params.cycles_per_sample / freqs


def t_local_agg(params: LatencyParams, assoc, freqs, *,
                backend: str = "auto") -> torch.Tensor:
    """Eq. 14: per-BS local aggregation time, (M,) seconds (the paper
    neglects it in Eq. 17)."""
    k_i = twin_counts(assoc, freqs.shape[0], backend=backend)
    bytes_ = params.model_size_bits / 8.0
    return k_i * bytes_ * params.cycles_per_agg_byte / freqs


def _log2_at_least_2(n: int) -> float:
    return math.log2(max(n, 2))


def t_broadcast(params: LatencyParams, assoc, uplink, n_bs: int, *,
                backend: str = "auto") -> torch.Tensor:
    """Eq. 15: xi * log2(M) * K_i * |w_g| / R_i^U per BS, (M,) seconds;
    (S, M) for associations (S, N) and uplinks (S, M)."""
    k_i = twin_counts(assoc, n_bs, backend=backend)
    return (params.xi * _log2_at_least_2(n_bs) * k_i * params.model_size_bits
            / torch.clamp(uplink, min=1.0))


# -- dense one-hot references --------------------------------------------------
# The numerical oracles of the segment-sum paths above: O(N*M) memory, small N
# only. tools/replint R001 allows `eye(M)[assoc]` only inside functions named
# *_onehot / *_oracle, so each carries the suffix.


def t_cmp_onehot(params: LatencyParams, assoc, b, data_sizes,
                 freqs) -> torch.Tensor:
    onehot = torch.eye(freqs.shape[0], device=freqs.device)[assoc]  # (N, M)
    work = torch.sum(onehot * (b * data_sizes)[:, None], dim=0)
    return work * params.cycles_per_sample / freqs


def t_local_agg_onehot(params: LatencyParams, assoc, freqs) -> torch.Tensor:
    k_i = torch.sum(torch.eye(freqs.shape[0], device=freqs.device)[assoc], dim=0)
    bytes_ = params.model_size_bits / 8.0
    return k_i * bytes_ * params.cycles_per_agg_byte / freqs


def t_broadcast_onehot(params: LatencyParams, assoc, uplink,
                       n_bs: int) -> torch.Tensor:
    k_i = torch.sum(torch.eye(n_bs, device=uplink.device)[assoc], dim=0)
    return (params.xi * _log2_at_least_2(n_bs) * k_i * params.model_size_bits
            / torch.clamp(uplink, min=1.0))


def round_time_onehot(params: LatencyParams, assoc, b, data_sizes, freqs,
                      uplink, downlink) -> torch.Tensor:
    """Eq. 17 via the dense one-hot reductions (reference path)."""
    cmp_ = t_cmp_onehot(params, assoc, b, data_sizes, freqs)
    bc = t_broadcast_onehot(params, assoc, uplink, freqs.shape[0])
    bv = t_block_validation(params, downlink, freqs)
    return torch.max(cmp_) + torch.max(bc) + bv


def t_block_validation(params: LatencyParams, downlink, freqs) -> torch.Tensor:
    """Eq. 16: block propagation among producers + slowest validation (the
    fixed consensus constant)."""
    prop = (params.xi * _log2_at_least_2(params.n_producers)
            * params.block_size_bits / torch.clamp(downlink, min=1.0))
    val = torch.amax(params.block_size_bits / 8.0
                     * params.cycles_per_val_byte / freqs, dim=-1)
    return torch.amax(prop, dim=-1) + val


def consensus_term(params: LatencyParams, downlink, freqs,
                   consensus=None) -> torch.Tensor:
    """The Eq. 17 block term: the Eq. 16 constant when ``consensus`` is
    None, else the PBFT model (flat or two-tier on ``n_groups``) of that
    ``ConsensusConfig``, priced from the same downlink rates. Imported
    lazily, as in the reference, so the two modules never import each other
    in a cycle."""
    if consensus is None:
        return t_block_validation(params, downlink, freqs)
    from repro_torch.core import consensus as consensus_mod

    return consensus_mod.consensus_time(params, consensus, downlink, freqs)


def round_time_per_bs(params: LatencyParams, assoc, b, data_sizes, freqs,
                      uplink, downlink, *, backend: str = "auto",
                      consensus=None) -> torch.Tensor:
    """Per-BS round time T_i (the MARL per-agent cost), (M,) seconds."""
    cmp_ = t_cmp(params, assoc, b, data_sizes, freqs, backend=backend)
    bc = t_broadcast(params, assoc, uplink, freqs.shape[0], backend=backend)
    bv = consensus_term(params, downlink, freqs, consensus)
    return cmp_ + bc + bv


def round_time(params: LatencyParams, assoc, b, data_sizes, freqs, uplink,
               downlink, *, backend: str = "auto",
               consensus=None) -> torch.Tensor:
    """Eq. 17: max-composed system round time T (0-dim, seconds).
    assoc/b/data_sizes (N,); freqs/uplink/downlink (M,). With a leading
    scenario axis (assoc/b/data_sizes (S, N), uplink/downlink (S, M)) the
    Eq. 16 term applies (``consensus`` must be None) and T is (S,)."""
    cmp_ = t_cmp(params, assoc, b, data_sizes, freqs, backend=backend)
    bc = t_broadcast(params, assoc, uplink, freqs.shape[0], backend=backend)
    bv = consensus_term(params, downlink, freqs, consensus)
    return torch.amax(cmp_, dim=-1) + torch.amax(bc, dim=-1) + bv


def global_rounds(theta_g: float) -> float:
    """Eq. 11 simplified (theta_L fixed): T(theta_G) = 1 / (1 - theta_G)."""
    return 1.0 / (1.0 - theta_g)


def total_time(params: LatencyParams, assoc, b, data_sizes, freqs, uplink,
               downlink, *, backend: str = "auto",
               consensus=None) -> torch.Tensor:
    """Objective of problem (18): convergence rounds x Eq. 17 round time."""
    return global_rounds(params.theta_g) * round_time(
        params, assoc, b, data_sizes, freqs, uplink, downlink,
        backend=backend, consensus=consensus)

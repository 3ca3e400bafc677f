"""Fault and adversary axis, port of ``repro/core/faults.py``: stragglers,
channel outages, poisoned twins, and the robust per-BS aggregation that
defends against them.

* **Stragglers**: each twin is slow in a round with probability
  ``straggler_rate``; a straggler's Eq. 12/13 work is inflated by a
  ``1 + Exp(1) * straggler_slowdown`` multiplier on its batch fraction.
* **Channel outages**: a two-state Gilbert-Elliott chain per BS (mean burst
  ``burst_len`` rounds, stationary bad probability ``outage_rate``) gates
  the uplink down to ``outage_floor`` of its rate while bad.
* **Malicious twins**: a Bernoulli(``malicious_frac``) per-twin mask; the FL
  layer turns flagged twins into label-flip or model-replacement attackers.

torch cannot repeat ``jax.random``, so every injector takes its draws as
tensors (uniforms, Exp(1) magnitudes); :func:`sample_fault_draws` makes one
round's draws from a ``torch.Generator`` on the CPU and moves them, so a
seed gives the same draws on every device.

Robust aggregation runs on stacked per-client update dicts through the
segment-reduction primitives: coordinate **trimmed mean** peels, per (BS,
coordinate), the ``2 * trim_k`` contributions farthest from the surviving
cohort mean; **Krum-lite** drops the ``f`` clients per BS with the largest
sum of distances to their nearest same-BS peers (cohort sizes from
``migration.bs_segments``). Both are weighted FedAvg exactly at knob 0.
On the card every segment sum launches the hand kernel; the extremes are
``scatter_reduce_``, as the reference computes them outside Pallas.

Inside a twin scope the injectors take the GLOBAL draws and slice this
rank's block (``sharding.localize``, the twin axis last), so a sharded
round sees the single-device realization; ``sharded_fault_draws`` and
``sharded_faulty_round_time`` run them over a twin mesh.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import NamedTuple

import torch

from repro_torch.core import comms, hierarchy, latency, migration, sharding
from repro_torch.kernels.segment_reduce import (segment_max, segment_min,
                                                segment_reduce, segment_std)

AGGREGATORS = ("fedavg", "trimmed_mean", "krum")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault and adversary knobs: ``straggler_rate`` per-twin per-round
    probability of being slow; ``straggler_slowdown`` the scale of the
    Exp(1) extra work; ``outage_rate`` stationary probability of a BS uplink
    in the bad state; ``burst_len`` mean bad dwell time in rounds (>= 1);
    ``outage_floor`` the share of the uplink rate a bad state keeps;
    ``malicious_frac`` per-twin probability of being an attacker."""
    straggler_rate: float = 0.1
    straggler_slowdown: float = 4.0
    outage_rate: float = 0.1
    burst_len: float = 3.0
    outage_floor: float = 0.05
    malicious_frac: float = 0.0


class FaultDraws(NamedTuple):
    """One round's random draws of :func:`faulty_round_time`:
    ``slow_u`` (N,) uniforms of the straggler mask, ``slow_exp`` (N,) Exp(1)
    straggler magnitudes, ``outage_u`` (M,) uniforms of the outage draw."""
    slow_u: torch.Tensor
    slow_exp: torch.Tensor
    outage_u: torch.Tensor


def sample_fault_draws(gen: torch.Generator, n: int, n_bs: int,
                       device=None) -> FaultDraws:
    """One round's :class:`FaultDraws` from ``gen``, in the field order,
    drawn on the CPU and moved to ``device``."""
    slow_u = torch.rand((n,), generator=gen)
    slow_exp = torch.empty((n,)).exponential_(generator=gen)
    outage_u = torch.rand((n_bs,), generator=gen)
    return FaultDraws(slow_u.to(device), slow_exp.to(device),
                      outage_u.to(device))


def _f32(x, device) -> torch.Tensor:
    """``x`` as fp32 on ``device``. A Python number is filled in on the
    device: a host-to-device copy would make the host wait for the card."""
    if isinstance(x, numbers.Real) and not isinstance(x, torch.Tensor):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# injectors: straggler slowdowns, Gilbert-Elliott outages, malicious masks
# ---------------------------------------------------------------------------


def straggler_slowdowns(fcfg: FaultConfig, slow_u, slow_exp, *,
                        rate=None) -> torch.Tensor:
    """Per-twin compute-work multipliers, (N,) fp32, all >= 1, from the
    mask uniforms ``slow_u`` (N,) and Exp(1) magnitudes ``slow_exp`` (N,).
    ``rate`` overrides ``fcfg.straggler_rate``."""
    rate = fcfg.straggler_rate if rate is None else rate
    slow_u = torch.as_tensor(slow_u)
    dev = slow_u.device
    is_slow = sharding.localize(slow_u < _f32(rate, dev), axis=-1,
                                fill=False)
    extra = sharding.localize(
        torch.as_tensor(slow_exp, device=dev) * fcfg.straggler_slowdown,
        axis=-1, fill=0.0)
    slow = 1.0 + torch.where(is_slow, extra, 0.0)
    return sharding.mask_twins(slow, 1.0, axis=-1)


def malicious_mask(fcfg: FaultConfig, u, *, frac=None) -> torch.Tensor:
    """Per-twin attacker flags, (N,) bool, from (N,) uniforms ``u``."""
    frac = fcfg.malicious_frac if frac is None else frac
    u = torch.as_tensor(u)
    mal = sharding.localize(u < _f32(frac, u.device), axis=-1, fill=False)
    return sharding.mask_twins(mal, False, axis=-1)


def fault_draws(fcfg: FaultConfig, slow_u, slow_exp, mal_u, *,
                straggler_rate=None, malicious_frac=None):
    """One round's per-twin fault realization: ``(slowdowns (N,) fp32,
    malicious (N,) bool)``."""
    return (straggler_slowdowns(fcfg, slow_u, slow_exp, rate=straggler_rate),
            malicious_mask(fcfg, mal_u, frac=malicious_frac))


def _stationary_bad(fcfg: FaultConfig, rate, device) -> torch.Tensor:
    rate = fcfg.outage_rate if rate is None else rate
    return torch.clamp(_f32(rate, device), 0.0, 0.95)


def ge_transition_probs(fcfg: FaultConfig, *, rate=None, device=None):
    """Gilbert-Elliott transition probabilities ``(p_gb, p_bg)``:
    ``p_bg = 1 / burst_len`` fixes the mean bad dwell time and
    ``p_gb = pi_b * p_bg / (1 - pi_b)`` makes the outage rate ``pi_b`` the
    stationary bad probability."""
    pi_b = _stationary_bad(fcfg, rate, device)
    p_bg = 1.0 / torch.clamp(_f32(fcfg.burst_len, device), min=1.0)
    p_gb = torch.clamp(pi_b * p_bg / (1.0 - pi_b), 0.0, 1.0)
    return p_gb, p_bg


def outage_draw(fcfg: FaultConfig, u, *, rate=None) -> torch.Tensor:
    """Stationary draw of the per-BS bad-state indicator, (M,) bool, from
    (M,) uniforms ``u``: the chain's marginal, used where no state is
    carried across rounds."""
    u = torch.as_tensor(u)
    return u < _stationary_bad(fcfg, rate, u.device)


def outage_step(fcfg: FaultConfig, u, bad, *, rate=None) -> torch.Tensor:
    """One Gilbert-Elliott transition ``bad (M,) -> bad' (M,)`` bool, from
    (M,) uniforms ``u``."""
    u = torch.as_tensor(u)
    p_gb, p_bg = ge_transition_probs(fcfg, rate=rate, device=u.device)
    bad = torch.as_tensor(bad, dtype=torch.bool, device=u.device)
    return torch.where(bad, u >= p_bg, u < p_gb)


def outage_gate(fcfg: FaultConfig, uplink, bad) -> torch.Tensor:
    """Apply the bad-state mask to the Eq. 7 uplink rates."""
    return comms.apply_outage(uplink, bad, fcfg.outage_floor)


# ---------------------------------------------------------------------------
# faulty round time: Eqs. 12-17 under stragglers and outages
# ---------------------------------------------------------------------------


def faulty_round_time(lp: latency.LatencyParams, fcfg: FaultConfig,
                      draws: FaultDraws, assoc, b, data_sizes, freqs, uplink,
                      downlink, *, straggler_rate=None, outage_rate=None,
                      outage_bad=None, consensus=None,
                      backend: str = "auto") -> torch.Tensor:
    """Eq. 17 round time with straggler-inflated work and outage-gated
    uplink, 0-dim fp32. ``outage_bad`` (M,) bool injects a carried chain
    state; otherwise the stationary marginal comes from
    ``draws.outage_u``. ``consensus`` swaps the Eq. 16 term for the PBFT
    model (``latency.consensus_term``)."""
    slow = straggler_slowdowns(fcfg, draws.slow_u, draws.slow_exp,
                               rate=straggler_rate)
    bad = (outage_draw(fcfg, draws.outage_u, rate=outage_rate)
           if outage_bad is None else outage_bad)
    up = outage_gate(fcfg, uplink, bad)
    b = torch.as_tensor(b, dtype=torch.float32, device=slow.device)
    return latency.round_time(lp, assoc, b * slow, data_sizes, freqs, up,
                              downlink, consensus=consensus, backend=backend)


def straggler_frac(slowdowns) -> torch.Tensor:
    """Fraction of twins slowed this round, 0-dim fp32; (S,) for a batch
    of scenarios (S, N)."""
    hit = sharding.mask_twins(torch.as_tensor(slowdowns) > 1.0, False,
                              axis=-1)
    return sharding.twin_mean(hit.to(torch.float32), axis=-1)


def sharded_fault_draws(ts, fcfg: FaultConfig, slow_u, slow_exp, mal_u, *,
                        straggler_rate=None, malicious_frac=None):
    """:func:`fault_draws` over a twin mesh from the global (N,) draws:
    this rank's blocks ``(slowdowns (n_local,), malicious (n_local,))``,
    padding rows holding the identities 1.0 and False. The blocks of the
    ranks, in rank order and unpadded, are the single-device draws;
    ``n_shards == 1`` is the no-op fast path."""
    if ts.n_shards == 1:
        return fault_draws(fcfg, slow_u, slow_exp, mal_u,
                           straggler_rate=straggler_rate,
                           malicious_frac=malicious_frac)
    with ts.scope(torch.as_tensor(slow_u).shape[-1]):
        return fault_draws(fcfg, slow_u, slow_exp, mal_u,
                           straggler_rate=straggler_rate,
                           malicious_frac=malicious_frac)


def sharded_faulty_round_time(ts, lp: latency.LatencyParams,
                              fcfg: FaultConfig, draws: FaultDraws, assoc, b,
                              data_sizes, freqs, uplink, downlink, *,
                              straggler_rate=None, outage_rate=None,
                              outage_bad=None, consensus=None
                              ) -> torch.Tensor:
    """:func:`faulty_round_time` over a twin mesh: global (N,) ``assoc``,
    ``b`` (or a scalar) and ``data_sizes``, of which this rank takes its
    block, (M,) inputs and the global draws; the result is a replicated
    0-dim tensor."""
    if ts.n_shards == 1:
        return faulty_round_time(lp, fcfg, draws, assoc, b, data_sizes, freqs,
                                 uplink, downlink,
                                 straggler_rate=straggler_rate,
                                 outage_rate=outage_rate,
                                 outage_bad=outage_bad, consensus=consensus)
    assoc = torch.as_tensor(assoc)
    n, m = assoc.shape[0], torch.as_tensor(freqs).shape[0]
    b = torch.as_tensor(b, dtype=torch.float32,
                        device=assoc.device).expand(n)
    with ts.scope(n):
        return faulty_round_time(
            lp, fcfg, draws, sharding.slice_local(assoc, fill=m),
            sharding.slice_local(b, fill=0.0),
            sharding.slice_local(data_sizes, fill=0.0), freqs, uplink,
            downlink, straggler_rate=straggler_rate, outage_rate=outage_rate,
            outage_bad=outage_bad, consensus=consensus)


# ---------------------------------------------------------------------------
# robust aggregation: coordinate trimmed mean and Krum-lite
# ---------------------------------------------------------------------------


def _stack_flat(stacked):
    """A stacked update dict (leaves (K, ...)) as per-leaf (K, D) fp32 views,
    leaves in sorted key order (the reference's tree order)."""
    flats = [stacked[key].to(torch.float32).reshape(
        stacked[key].shape[0], -1) for key in sorted(stacked)]
    return flats, flats[0].shape[0]


def _peel_extreme(keep, flat, assoc, assoc_c, eligible_rows, n_bs: int,
                  largest: bool):
    """Drop the single most extreme surviving contribution per (segment,
    coordinate), ties to the smallest client index (a second
    ``segment_min`` over candidate indices): exactly one row a pass per
    occupied coordinate."""
    fill = float("-inf") if largest else float("inf")
    masked = torch.where(keep, flat, fill)
    ext = (segment_max if largest else segment_min)(masked, assoc, n_bs)
    hit = (keep & eligible_rows & torch.isfinite(masked)
           & (masked == ext[assoc_c]))
    idx = torch.arange(flat.shape[0], dtype=torch.float32,
                       device=flat.device)[:, None]
    cand = torch.where(hit, idx, float(flat.shape[0]))
    first = segment_min(cand, assoc, n_bs)
    return keep & ~(hit & (idx == first[assoc_c]))


def trimmed_mean_aggregate(stacked, data_sizes, assoc, n_bs: int, *,
                           trim_k: int = 1, backend: str = "auto"):
    """Coordinate-wise trimmed weighted mean per BS over stacked updates.

    For every (BS, coordinate) the ``2 * trim_k`` surviving contributions
    farthest from the surviving cohort mean are peeled, one a pass, the
    centre re-estimated from the survivors each pass (index tie-break),
    before the Eq. 4 weighted mean. Pass ``q`` touches only cohorts with
    ``n > q + 2``, so two contributions always survive. ``trim_k == 0`` is
    ``hierarchy.bs_aggregate_stacked`` exactly.

    On the card this makes ``2 + n_leaves * (4 * trim_k + 2)`` segment
    kernel launches: the cohort counts, per leaf a centre numerator and
    denominator a pass and the weighted numerator and denominator, and
    ``bs_w``.

    Returns ``(per_bs, bs_w, survivor_frac)``: ``per_bs`` the dict with
    leading axis M, ``bs_w`` (M,) the untrimmed Eq. 4 weight sums,
    ``survivor_frac`` (K,) the share of each client's coordinates that
    survived.
    """
    flats, k = _stack_flat(stacked)
    dev = flats[0].device
    w = torch.as_tensor(data_sizes, dtype=torch.float32, device=dev)
    assoc = torch.as_tensor(assoc, device=dev)
    assoc_c = torch.clamp(assoc.long(), 0, n_bs - 1)
    cnt = segment_reduce(torch.ones((k,), dtype=torch.float32, device=dev),
                         assoc, n_bs, backend=backend)
    cnt_rows = cnt[assoc_c][:, None]  # (K, 1)

    kept = torch.zeros((k,), dtype=torch.float32, device=dev)
    total = 0.0
    out_flat = []
    for flat in flats:
        keep = torch.ones(flat.shape, dtype=torch.bool, device=dev)
        for q in range(2 * trim_k):
            eligible = cnt_rows > q + 2.0
            keepf = keep.to(torch.float32)
            c_num = segment_reduce(flat * keepf, assoc, n_bs, backend=backend)
            c_den = segment_reduce(keepf, assoc, n_bs, backend=backend)
            center = c_num / torch.where(c_den > 0, c_den, 1.0)
            dev_abs = torch.abs(flat - center[assoc_c])
            keep = _peel_extreme(keep, dev_abs, assoc, assoc_c, eligible,
                                 n_bs, largest=True)
        keepf = keep.to(torch.float32)
        num = segment_reduce(flat * (w[:, None] * keepf), assoc, n_bs,
                             backend=backend)
        den = segment_reduce(w[:, None].expand(flat.shape) * keepf, assoc,
                             n_bs, backend=backend)
        out_flat.append(num / torch.where(den > 0, den, 1.0))
        kept = kept + torch.sum(keepf, dim=1)
        total += flat.shape[1]

    per_bs = {key: o.reshape((n_bs,) + tuple(stacked[key].shape[1:]))
              for key, o in zip(sorted(stacked), out_flat)}
    bs_w = segment_reduce(w, assoc, n_bs, backend=backend)
    return per_bs, bs_w, kept / total


def krum_aggregate(stacked, data_sizes, assoc, n_bs: int, *,
                   krum_f: int = 1, backend: str = "auto"):
    """Krum-lite per-BS aggregation over stacked updates.

    Client i scores the sum of its ``q_i = n_i - f - 2`` smallest squared
    distances to same-BS peers (cross-BS pairs masked), with the cohort
    sizes ``n_i`` from ``migration.bs_segments``. Up to ``f`` worst-scoring
    clients a BS are dropped, pass ``p`` only in cohorts with ``n > p + 3``,
    and the survivors are Eq. 4 weighted-averaged. ``krum_f == 0`` is
    ``hierarchy.bs_aggregate_stacked`` exactly. The distances come from the
    Gram product ``flat @ flat.T`` (TF32 off keeps it fp32 on the card).

    Returns ``(per_bs, bs_w, survivor_frac)`` with ``bs_w`` the surviving
    Eq. 4 weight sums and ``survivor_frac`` (K,) in {0, 1}.
    """
    flats, k = _stack_flat(stacked)
    dev = flats[0].device
    w = torch.as_tensor(data_sizes, dtype=torch.float32, device=dev)
    assoc = torch.as_tensor(assoc, device=dev)
    assoc_c = torch.clamp(assoc.long(), 0, n_bs - 1)
    flat = flats[0] if len(flats) == 1 else torch.cat(flats, dim=1)

    # pairwise squared distances via the Gram matrix; only same-BS pairs
    sq = torch.sum(flat * flat, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T),
                     min=0.0)
    same = ((assoc[:, None] == assoc[None, :])
            & ~torch.eye(k, dtype=torch.bool, device=dev))
    d2 = torch.where(same, d2, float("inf"))

    # cohort sizes from the contiguous per-BS grouping (bs_segments)
    _, bounds = migration.bs_segments(assoc, n_bs)
    counts = (bounds[1:] - bounds[:-1]).to(torch.int64)  # (M,)
    cnt_i = counts[assoc_c]
    q_i = torch.clamp(cnt_i - krum_f - 2, 1, k)

    srt = torch.sort(d2, dim=1).values  # ascending, inf (cross-BS) last
    take = torch.arange(k, device=dev)[None, :] < q_i[:, None]
    score = torch.sum(torch.where(take & torch.isfinite(srt), srt, 0.0),
                      dim=1)

    keep = torch.ones((k,), dtype=torch.bool, device=dev)
    idx = torch.arange(k, device=dev)
    for p in range(krum_f):
        eligible = cnt_i > p + 3
        masked = torch.where(keep & eligible, score, float("-inf"))
        worst = segment_max(masked, assoc, n_bs)  # (M,)
        hit = (keep & eligible & torch.isfinite(masked)
               & (masked == worst[assoc_c]))
        cand = torch.where(hit, idx.to(torch.float32), float(k))
        first = segment_min(cand, assoc, n_bs)
        keep = keep & ~(hit & (idx == first[assoc_c].to(torch.int64)))

    w_eff = w * keep.to(torch.float32)
    per_bs, bs_w = hierarchy.bs_aggregate_stacked(stacked, w_eff, assoc,
                                                  n_bs, backend=backend)
    return per_bs, bs_w, keep.to(torch.float32)


def robust_bs_aggregate_stacked(stacked, data_sizes, assoc, n_bs: int, *,
                                aggregator: str = "fedavg", trim_k: int = 1,
                                krum_f: int = 1, backend: str = "auto"):
    """Aggregator dispatch for ``FLConfig.aggregator``: ``"fedavg"``
    (``hierarchy.bs_aggregate_stacked``), ``"trimmed_mean"`` or ``"krum"``.
    Always returns ``(per_bs, bs_w, survivor_frac)``."""
    if aggregator not in AGGREGATORS:
        raise ValueError(
            f"aggregator must be one of {AGGREGATORS}, got {aggregator!r}")
    if aggregator == "trimmed_mean":
        return trimmed_mean_aggregate(stacked, data_sizes, assoc, n_bs,
                                      trim_k=trim_k, backend=backend)
    if aggregator == "krum":
        return krum_aggregate(stacked, data_sizes, assoc, n_bs,
                              krum_f=krum_f, backend=backend)
    per_bs, bs_w = hierarchy.bs_aggregate_stacked(stacked, data_sizes, assoc,
                                                  n_bs, backend=backend)
    k = torch.as_tensor(assoc).shape[0]
    return per_bs, bs_w, torch.ones((k,), dtype=torch.float32,
                                    device=bs_w.device)


def update_dispersion(stacked, assoc, n_bs: int, *,
                      backend: str = "auto") -> torch.Tensor:
    """Per-BS std of client update norms, (M,) fp32: the cohort-dispersion
    meta the chain records beside each submitted model. Three segment sums
    (``segment_std``'s moments and counts)."""
    flats, _ = _stack_flat(stacked)
    sumsq = sum(torch.sum(f * f, dim=1) for f in flats)
    return segment_std(torch.sqrt(sumsq), assoc, n_bs, backend=backend)


def suspect_counts(survivor_frac, assoc, n_bs: int, *,
                   backend: str = "auto"):
    """Per-BS ``(n_clients, n_suspect)``, (M,) fp32 each, from a
    survivor-fraction vector: a client is suspect when the aggregator kept
    less than a quarter of the coordinates it kept for its cohort on
    average. Three segment sums."""
    survivor_frac = torch.as_tensor(survivor_frac)
    dev = survivor_frac.device
    assoc = torch.as_tensor(assoc, device=dev)
    ones = torch.ones(survivor_frac.shape, dtype=torch.float32, device=dev)
    n_clients = segment_reduce(ones, assoc, n_bs, backend=backend)
    total = segment_reduce(survivor_frac.to(torch.float32), assoc, n_bs,
                           backend=backend)
    mean = total / torch.clamp(n_clients, min=1.0)
    thresh = 0.25 * mean[torch.clamp(assoc.long(), 0, n_bs - 1)]
    n_suspect = segment_reduce((survivor_frac < thresh).to(torch.float32),
                               assoc, n_bs, backend=backend)
    return n_clients, n_suspect

"""Consensus core (paper Section II-C + Eqs. 16/17), port of
``repro/core/consensus.py``.

- :class:`ChainState`: the per-BS chain view as tensors (stakes, a rolling
  verdict/reward history, the block counter), advanced by
  :func:`apply_round`.
- :func:`elect_producers` and :func:`verify_metas`: the stake election and
  the vectorized quality gate, which the host ledger
  (``repro_torch.core.blockchain.DPoSChain``) delegates to.
- :func:`t_consensus`: the PBFT latency model that replaces the fixed
  Eq. 16 constant in the Eq. 17 round budget,
  ``(t_preprepare + t_validate + 2 * t_quorum(f)) * (1 + vt * p / (1 - p))``;
  at ``quorum_f=0`` and ``byzantine_frac=0`` it is Eq. 16 exactly.
  :func:`t_consensus_two_tier` is the committee topology (Tang et al.
  2024), :func:`consensus_time` dispatches on ``n_groups``.
- :func:`chain_round`: one simulated round of submissions. Its random draws
  (:func:`draw_byzantine`'s uniforms, :func:`submission_losses`' normals)
  come in as arguments, since torch cannot repeat ``jax.random``.
"""
from __future__ import annotations

import dataclasses
import math
import numbers
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.segment_reduce import segment_max, segment_median

_BYZ_LOSS_OFFSET = 2.0  # holdout-loss penalty a byzantine BS's update carries


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Static consensus knobs: PBFT fault budget ``quorum_f`` (quorum
    2f+1), byzantine BS fraction, prepare/commit header size, block-size
    override, view-change timeout, chain reward/tolerance/initial stake,
    verdict history depth and committee count."""
    quorum_f: int = 1
    byzantine_frac: float = 0.0
    header_bits: float = 2048.0
    block_size_bits: Optional[float] = None
    view_timeout: float = 1.0
    reward: float = 1.0
    tolerance: float = 0.5
    s_ini: float = 100.0
    history: int = 8
    n_groups: int = 1


class ChainState(NamedTuple):
    """Per-BS chain view as tensors.

    ``stakes`` (M,) fp32 training coins (Eq. 6 init + rewards);
    ``verdicts`` (H, M) fp32 rolling accept history (1 accepted, 0
    rejected, 1 for rounds a BS did not submit), written at ``round % H``;
    ``rewards`` (H, M) fp32 coins granted per round; ``round`` () int32
    blocks produced so far.
    """
    stakes: torch.Tensor
    verdicts: torch.Tensor
    rewards: torch.Tensor
    round: torch.Tensor


def chain_init(ccfg: ConsensusConfig, data_per_bs) -> ChainState:
    """Eq. 6: initial coins proportional to hosted twin data. A batch of
    chains, ``data_per_bs`` (S, M), gives every field a leading S axis."""
    d = torch.as_tensor(data_per_bs, dtype=torch.float32)
    total = torch.clamp(torch.sum(d, dim=-1, keepdim=True), min=1e-9)
    lead, m, dev = tuple(d.shape[:-1]), d.shape[-1], d.device
    return ChainState(
        stakes=ccfg.s_ini * d / total,
        verdicts=torch.ones(lead + (ccfg.history, m), dtype=torch.float32,
                            device=dev),
        rewards=torch.zeros(lead + (ccfg.history, m), dtype=torch.float32,
                            device=dev),
        round=torch.zeros(lead, dtype=torch.int32, device=dev),
    )


def elect_producers(stakes, n_producers: int) -> torch.Tensor:
    """Top-``n_producers`` BSs by stake, (n_producers,) int32.

    A stable argsort of ``-stakes`` (fp32): equal stakes are won by the
    smaller BS index, the host ledger's tie rule.
    """
    order = torch.argsort(-torch.as_tensor(stakes, dtype=torch.float32),
                          stable=True)
    return order[:n_producers].to(torch.int32)


def current_producer(state: ChainState, n_producers: int) -> torch.Tensor:
    """Round-robin over the elected set, as the host ledger rotates."""
    producers = elect_producers(state.stakes, n_producers)
    return _take(producers, torch.remainder(state.round, n_producers).long())


def verify_metas(losses, submitted, *, tolerance, n_clients=None,
                 n_suspect=None, group=None, n_groups: int = 1):
    """Vectorized quality gate over stacked per-BS submission metas.

    Accepted iff ``loss <= median(submitted losses) + tolerance`` and the
    cohort is not majority-suspect (``n_suspect * 2 > n_clients``), in
    fp32. The median is over the submitted subset only: non-submitters get
    an out-of-range segment id. ``group``/``n_groups`` gate per committee.
    All inputs (M,); returns (M,) bool (False for non-submitters). A batch
    of rounds, (S, M) losses and masks, gates every row on its own medians:
    row s's segments are offset by ``s * (n_groups + 1)`` in one median.
    """
    losses = torch.as_tensor(losses, dtype=torch.float32)
    dev = losses.device
    sub = torch.as_tensor(submitted, dtype=torch.bool, device=dev)
    m = losses.shape[-1]
    g = (torch.zeros((m,), dtype=torch.int64, device=dev)
         if group is None else torch.as_tensor(group, device=dev).long())
    seg = torch.where(sub, g, n_groups)
    if losses.ndim == 1:
        med = segment_median(losses, seg, n_groups)
    else:
        rows = losses.shape[0]
        off = torch.arange(rows, device=dev)[:, None] * (n_groups + 1)
        med = segment_median(losses.reshape(-1), (seg + off).reshape(-1),
                             rows * (n_groups + 1)).reshape(
                                 rows, n_groups + 1)[:, :n_groups]
    ok = losses <= torch.gather(
        med, -1, torch.clamp(g, 0, n_groups - 1).expand(
            losses.shape)) + tolerance
    if n_clients is None or n_suspect is None:
        suspect = torch.zeros(losses.shape, dtype=torch.bool, device=dev)
    else:
        suspect = (torch.as_tensor(n_suspect, dtype=torch.float32) * 2.0
                   > torch.as_tensor(n_clients, dtype=torch.float32))
    return sub & ok & ~suspect


def apply_round(ccfg: ConsensusConfig, state: ChainState, losses, submitted,
                *, n_clients=None, n_suspect=None, group=None):
    """One verify-and-reward step: verdicts -> coins -> history -> rotate,
    the host sequence ``verify_round(); produce_block()``. Returns
    ``(new_state, verdicts)`` with verdicts (M,) bool."""
    v = verify_metas(losses, submitted, tolerance=ccfg.tolerance,
                     n_clients=n_clients, n_suspect=n_suspect,
                     group=group, n_groups=max(ccfg.n_groups, 1))
    dev = state.stakes.device
    rew = torch.where(v, ccfg.reward, 0.0).to(torch.float32)
    slot = torch.remainder(state.round, ccfg.history)
    sub = torch.as_tensor(submitted, dtype=torch.bool, device=dev)
    # non-submitters keep the benign prior: no evidence is not a rejection
    hist_row = torch.where(sub, v, True).to(torch.float32)
    row = (torch.arange(ccfg.history, dtype=torch.int32, device=dev)
           == slot[..., None])[..., None]
    return ChainState(
        stakes=state.stakes + rew,
        verdicts=torch.where(row, hist_row[..., None, :], state.verdicts),
        rewards=torch.where(row, rew[..., None, :], state.rewards),
        round=state.round + 1,
    ), v


def accept_rate(state: ChainState) -> torch.Tensor:
    """(M,) mean accept verdict over the rolling history window."""
    return torch.mean(state.verdicts, dim=0)


def stake_share(state: ChainState) -> torch.Tensor:
    """(M,) per-BS share of total stake (sums to 1)."""
    return state.stakes / torch.clamp(torch.sum(state.stakes), min=1e-9)


# ---- PBFT consensus-latency model -------------------------------------------


def _override(value, default):
    return default if value is None else value


def _f32(x, device) -> torch.Tensor:
    """``x`` as fp32 on ``device``. A Python number is filled in on the
    device: a host-to-device copy would make the host wait for the card."""
    if isinstance(x, numbers.Real) and not isinstance(x, torch.Tensor):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _i64(x, device) -> torch.Tensor:
    """``x`` as int64 on ``device``, a Python number filled in there."""
    if isinstance(x, numbers.Integral) and not isinstance(x, torch.Tensor):
        return torch.full((), int(x), dtype=torch.int64, device=device)
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _take(sorted_, idx) -> torch.Tensor:
    """``sorted_[..., idx]`` for a 0-dim (or per-row) index tensor, by a
    gather: indexing with a 0-dim tensor reads it on the host."""
    return torch.gather(sorted_, -1, idx[..., None].expand(
        sorted_.shape[:-1] + (1,)))[..., 0]


def _log2_at_least_2(n) -> float:
    return math.log2(max(n, 2))


def t_consensus(params, ccfg: ConsensusConfig, downlink, freqs, *,
                quorum_f=None, byz_frac=None,
                block_size_bits=None) -> torch.Tensor:
    """PBFT consensus latency over the M BSs (0-dim, seconds).

    ``params`` is a ``latency.LatencyParams``. The keyword overrides take
    per-scenario values; the config supplies the defaults. Phases:
    pre-prepare (the Eq. 16 propagation term), validate (the Eq. 16
    validation term), two quorum waits, times the view-change factor. A
    batch of scenarios takes ``downlink`` (S, M) and (S,) overrides and
    gives (S,).
    """
    downlink = torch.as_tensor(downlink, dtype=torch.float32)
    freqs = torch.as_tensor(freqs, dtype=torch.float32,
                            device=downlink.device)
    m = downlink.shape[-1]
    sb = _override(block_size_bits,
                   _override(ccfg.block_size_bits, params.block_size_bits))
    if isinstance(sb, torch.Tensor):
        sb = sb[..., None]  # a row's block size against its M links
    safe_down = torch.clamp(downlink, min=1.0)
    pre = torch.amax(params.xi * _log2_at_least_2(params.n_producers)
                     * sb / safe_down, dim=-1)
    val = torch.amax(sb / 8.0 * params.cycles_per_val_byte / freqs, dim=-1)
    tq = _quorum_wait(params, ccfg, safe_down, m,
                      _override(quorum_f, ccfg.quorum_f))
    return (pre + val + 2.0 * tq) * _view_change_factor(
        ccfg, _override(byz_frac, ccfg.byzantine_frac), downlink.device)


def _quorum_wait(params, ccfg, safe_down, m, quorum_f) -> torch.Tensor:
    """Prepare/commit phase wait: (2f)-th smallest per-link header time."""
    msg = (params.xi * _log2_at_least_2(m)
           * _f32(ccfg.header_bits, safe_down.device) / safe_down)
    srt = torch.sort(msg, dim=-1).values
    need = torch.clamp(2 * _i64(quorum_f, msg.device), 0, m)
    kth = _take(srt, torch.clamp(need - 1, 0, m - 1))
    return torch.where(need > 0, kth, torch.zeros_like(kth))


def _view_change_factor(ccfg: ConsensusConfig, byz_frac,
                        device=None) -> torch.Tensor:
    """1 + view_timeout * E[failed views]; exactly 1 at byz_frac = 0."""
    p = torch.clamp(_f32(byz_frac, device), 0.0, 0.95)
    return 1.0 + ccfg.view_timeout * p / (1.0 - p)


def bs_groups(n_bs: int, n_groups: int, device=None) -> torch.Tensor:
    """(M,) int32 committee map: round-robin, the Eq. 4/5 grouping one
    level up."""
    return torch.arange(n_bs, dtype=torch.int32, device=device) % max(
        n_groups, 1)


def t_consensus_two_tier(params, ccfg: ConsensusConfig, downlink, freqs, *,
                         n_groups: Optional[int] = None, quorum_f=None,
                         byz_frac=None, block_size_bits=None) -> torch.Tensor:
    """Tang et al. 2024 multi-tier consensus latency (0-dim, seconds).

    Tier 1: the M BSs split into G committees (:func:`bs_groups`), each
    running PBFT on the full block in parallel; the slowest committee ends
    the tier. Tier 2: each committee's best-connected member runs PBFT with
    the other delegates over a checkpoint block of G headers. ``G=1`` is
    :func:`t_consensus` exactly. Per-committee maxima go through
    :func:`segment_max`.
    """
    g = max(_override(n_groups, ccfg.n_groups), 1)
    if g <= 1:
        return t_consensus(params, ccfg, downlink, freqs, quorum_f=quorum_f,
                           byz_frac=byz_frac, block_size_bits=block_size_bits)
    downlink = torch.as_tensor(downlink, dtype=torch.float32)
    dev = downlink.device
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=dev)
    m = downlink.shape[0]
    group = bs_groups(m, g, dev)
    sb = _override(block_size_bits,
                   _override(ccfg.block_size_bits, params.block_size_bits))
    f = _i64(_override(quorum_f, ccfg.quorum_f), dev)
    safe_down = torch.clamp(downlink, min=1.0)
    header = _f32(ccfg.header_bits, dev)

    # tier 1: intra-committee PBFT, all committees in parallel
    prop = params.xi * _log2_at_least_2(params.n_producers) * sb / safe_down
    val = sb / 8.0 * params.cycles_per_val_byte / freqs
    pre_g = segment_max(prop, group, g)
    val_g = segment_max(val, group, g)
    msg = (params.xi * _log2_at_least_2(math.ceil(m / g)) * header
           / safe_down)
    # per-committee (2f)-th smallest member header time, f clipped feasible
    mask = group[None, :] == torch.arange(g, dtype=torch.int32,
                                          device=dev)[:, None]
    sizes = torch.sum(mask.to(torch.int64), dim=1)
    srt = torch.sort(torch.where(mask, msg[None, :], math.inf), dim=1).values
    f_g = torch.minimum(f, torch.div(sizes - 1, 2, rounding_mode="floor"))
    need = torch.clamp(2 * f_g, 0, m)
    kth = torch.gather(srt, 1, torch.clamp(need - 1, 0, m - 1)[:, None])[:, 0]
    tq_g = torch.where(need > 0, kth, torch.zeros_like(kth))
    tier1 = torch.max(pre_g + val_g + 2.0 * tq_g)

    # tier 2: checkpoint PBFT over the G delegates (each committee's
    # best-connected member); the checkpoint block carries a digest a group
    lead_down = torch.clamp(segment_max(safe_down, group, g), min=1.0)
    lead_freq = torch.clamp(segment_max(freqs, group, g), min=1.0)
    cp_bits = header * g
    pre2 = torch.max(params.xi * _log2_at_least_2(min(params.n_producers, g))
                     * cp_bits / lead_down)
    val2 = torch.max(cp_bits / 8.0 * params.cycles_per_val_byte / lead_freq)
    msg2 = params.xi * _log2_at_least_2(g) * header / lead_down
    srt2 = torch.sort(msg2).values
    f2 = torch.clamp(f, max=(g - 1) // 2)
    need2 = torch.clamp(2 * f2, 0, g)
    kth2 = _take(srt2, torch.clamp(need2 - 1, 0, g - 1))
    tq2 = torch.where(need2 > 0, kth2, torch.zeros_like(kth2))
    tier2 = pre2 + val2 + 2.0 * tq2

    return (tier1 + tier2) * _view_change_factor(
        ccfg, _override(byz_frac, ccfg.byzantine_frac), dev)


def consensus_time(params, ccfg: ConsensusConfig, downlink, freqs, *,
                   quorum_f=None, byz_frac=None,
                   block_size_bits=None) -> torch.Tensor:
    """Flat or two-tier PBFT latency, on ``ccfg.n_groups``."""
    fn = t_consensus_two_tier if ccfg.n_groups > 1 else t_consensus
    return fn(params, ccfg, downlink, freqs, quorum_f=quorum_f,
              byz_frac=byz_frac, block_size_bits=block_size_bits)


# ---- per-round chain simulation (scenario / env bodies) ---------------------


def draw_byzantine(u, byz_frac) -> torch.Tensor:
    """(M,) bool byzantine-BS mask from (M,) uniforms ``u``."""
    u = torch.as_tensor(u)
    return u < _f32(byz_frac, u.device)


def submission_losses(z, byz, base: float = 0.5,
                      noise: float = 0.1) -> torch.Tensor:
    """Per-BS holdout-loss proxy from (M,) standard normals ``z``: honest
    noise plus the byzantine offset. Stands in for FL holdout losses where
    the chain is simulated without training."""
    honest = base + noise * torch.as_tensor(z, dtype=torch.float32)
    byz = torch.as_tensor(byz, device=honest.device)
    return honest + torch.where(byz, _BYZ_LOSS_OFFSET, 0.0)


def chain_round(ccfg: ConsensusConfig, state: ChainState, z, byz,
                occupancy):
    """One round's submissions (losses from the normals ``z``), verified,
    and the chain advanced (a batch of chains: every argument with a
    leading S axis). ``occupancy`` (M,) per-BS twin counts: a BS
    with no twins submits nothing. Returns ``(new_state, verdicts,
    accept_frac)``, ``accept_frac`` the accepted share of submitters."""
    byz = torch.as_tensor(byz)
    losses = submission_losses(z, byz)
    submitted = torch.as_tensor(occupancy, dtype=torch.float32,
                                device=losses.device) > 0.0
    group = (bs_groups(byz.shape[-1], ccfg.n_groups, losses.device)
             if ccfg.n_groups > 1 else None)
    state2, v = apply_round(ccfg, state, losses, submitted, group=group)
    n_sub = torch.clamp(torch.sum(submitted.to(torch.float32), dim=-1),
                        min=1.0)
    accept_frac = torch.sum(v.to(torch.float32), dim=-1) / n_sub
    return state2, v, accept_frac


def honest_stake_share(state: ChainState, byz) -> torch.Tensor:
    """Share of total stake held by non-byzantine BSs (0-dim, in [0, 1])."""
    byz = torch.as_tensor(byz, device=state.stakes.device)
    honest = torch.where(byz, 0.0, state.stakes)
    return torch.sum(honest, dim=-1) / torch.clamp(
        torch.sum(state.stakes, dim=-1), min=1e-9)

"""Batched multi-scenario runner, port of ``repro/core/scenario.py``.

A scenario is a (channel seed, twin data population, data distribution
skew) triple, plus optional fault and consensus axes. Its twin data sizes
are drawn as

    D_j = data_min + (data_max - data_min) * U^skew,   U ~ Uniform(0, 1)

so ``skew=1`` is the paper's uniform population and larger skews give
heavy-tailed ones. The reference ``vmap``s one scenario's body over the
batch; a ctypes kernel launch cannot run under ``torch.func.vmap``, so the
runners here carry a leading scenario axis S through every twin-axis step:
the per-BS sums of a whole batch are grouped segment sums
(``segment_reduce_grouped``, at most ``MAX_SEGMENTS // M`` scenarios a
launch), and the greedy baseline loops over the N twins once with (S, M)
tensors; the chains of :func:`run_consensus` advance together. The body of
:func:`run_policy` (``env_step`` rollouts) loops over the scenarios.

torch cannot repeat ``jax.random``, so every draw is an argument: a
:class:`ScenarioDraws`. By default it is made on the run's device, for the
whole batch at once, by a counter-based :class:`RowStream`: a hash of the
row's ``seed``, a stream number that mirrors the reference's key folds (0
the realization, 1 the random association, 2 the rollout, 3 migration, 4
the outage init, 5 the fault rounds, 6 the byzantine mask, 7 the malicious
mask, 8 the chain submissions; the serve loop adds 11 churn and 12
dynamics) and the draw's index. As with the reference's per-row keys, a
row's draws do not depend on the batch around it, and every runner and the
serve loop read a row's draws from the same streams, so they score the
same realization. Per-round streams are drawn round after round, so a
shorter run draws a prefix of a longer one.

The twin-mesh runners (``run_*_sharded``) run the same batched bodies
under a rank's twin scope (``core.sharding``), with (S, N_local) twin
blocks: every rank makes the full draws and takes its block, so they score
the single-device realizations.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import association as assoc_mod
from repro_torch.core import comms, latency, migration, sharding
from repro_torch.core import consensus as consensus_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core.consensus import ConsensusConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.core.marl import env as env_mod
from repro_torch.core.marl.env import EnvConfig, EnvState, StepDraws
from repro_torch.core.migration import MigrationConfig
from repro_torch.kernels.segment_reduce import MAX_SEGMENTS
from repro_torch.utils.device import default_device

# draw streams of a scenario row (the reference's key folds)
FOLD_REALIZATION, FOLD_RANDOM, FOLD_ROLLOUT, FOLD_MIGRATION = 0, 1, 2, 3
FOLD_OUTAGE_INIT, FOLD_FAULTS, FOLD_BYZANTINE, FOLD_MALICIOUS = 4, 5, 6, 7
FOLD_CHAIN, FOLD_CHURN, FOLD_DYNAMICS = 8, 11, 12


class ScenarioBatch(NamedTuple):
    """Per-scenario parameters; every field has leading axis (S,).

    ``seed`` (S,) int64 seeds the row's draw streams (the reference's
    per-row PRNG key); ``skew`` shapes the D_j tail; ``alpha`` is the
    Dirichlet label skew the FL substrate partitions with (the label-blind
    runners ignore it). The fault and consensus axes are None when absent:
    the runners then take their config's scalars.
    """
    seed: torch.Tensor
    data_min: torch.Tensor
    data_max: torch.Tensor
    skew: torch.Tensor
    alpha: Optional[torch.Tensor] = None
    straggler: Optional[torch.Tensor] = None
    outage: Optional[torch.Tensor] = None
    malicious: Optional[torch.Tensor] = None
    byzantine: Optional[torch.Tensor] = None
    quorum: Optional[torch.Tensor] = None
    block_size: Optional[torch.Tensor] = None


def make_batch(seed: int, n_scenarios: int, *, data_min=(100.0, 400.0),
               data_max=(500.0, 1500.0), skew=(1.0, 4.0),
               alpha=(0.1, 10.0), straggler=None, outage=None,
               malicious=None, byzantine=None, quorum=None,
               block_size=None) -> ScenarioBatch:
    """Sample a scenario batch on the CPU: row seeds plus per-scenario
    population ranges, uniform in each ``(lo, hi)``. ``alpha`` is drawn
    log-uniformly (``None`` omits the axis: IID labels). The optional fault
    and consensus axes are omitted when None. The seeds and the three
    population axes come from stream 0 of ``seed``, alpha from stream 4 and
    each optional axis from its own stream (5-10), so adding an axis never
    changes the others."""
    s = n_scenarios
    seeds, dmin, dmax, skw = RowStream(seed, 0, "cpu").draw(
        [(2**31, (s,)), ("uniform", (s,)), ("uniform", (s,)),
         ("uniform", (s,))])

    def span(u, lo, hi):
        return lo + u * (hi - lo)

    def axis(stream, rng):
        return (None if rng is None else
                span(RowStream(seed, stream, "cpu").draw(
                    [("uniform", (s,))])[0], *rng))

    log_a = axis(4, None if alpha is None else (math.log(alpha[0]),
                                                math.log(alpha[1])))
    return ScenarioBatch(
        seed=seeds, data_min=span(dmin, *data_min),
        data_max=span(dmax, *data_max), skew=span(skw, *skew),
        alpha=None if log_a is None else torch.exp(log_a),
        straggler=axis(5, straggler), outage=axis(6, outage),
        malicious=axis(7, malicious), byzantine=axis(8, byzantine),
        quorum=axis(9, quorum), block_size=axis(10, block_size))


def batch_to(batch: ScenarioBatch, device) -> ScenarioBatch:
    """The batch's float axes as fp32 tensors on ``device`` (the int64
    seeds stay where they are: a :class:`RowStream` moves them)."""
    return ScenarioBatch(*(
        x if x is None or name == "seed"
        else torch.as_tensor(x, dtype=torch.float32).to(device)
        for name, x in zip(ScenarioBatch._fields, batch)))


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (two xor-shift-multiply rounds) of int64
    tensors holding values below 2**32; every product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _unit(words):
    """fp32 uniforms in (0, 1) from 32-bit words: 24 bits, centred in their
    cell, so neither end is reached."""
    return ((words >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


class RowStream:
    """Stream ``fold`` of the scenario rows ``seeds`` ((S,) or 0-dim int64),
    drawn on ``device``.

    Word k of a row is a hash of (row seed, fold, k), so a row's draws
    depend on neither the batch it sits in nor the device (integer and
    uniform draws are the same bits on the CPU and a card), a batch draws
    all its rows in one pass, and each :meth:`draw` continues the row's
    stream where the last one stopped.
    """

    def __init__(self, seeds, fold: int, device):
        s = torch.as_tensor(seeds, dtype=torch.int64).to(device)
        k1 = _mix32((s & _M32) ^ _mix32(((s >> 32) & _M32) ^ fold))
        self.shape = tuple(s.shape)
        self.k1 = k1[..., None]
        self.k2 = _mix32(k1 ^ 0x5BD1E995)[..., None]
        self.offset = 0

    def _words(self, n: int):
        c = torch.arange(self.offset, self.offset + n, device=self.k1.device)
        self.offset += n
        return _mix32(_mix32((c & _M32) ^ self.k1)
                      ^ (((c >> 32) + self.k2) & _M32))

    def draw(self, fields, n_rounds: Optional[int] = None):
        """One tensor per ``(kind, shape)`` field, from consecutive words:
        kind ``"uniform"``, ``"exponential"`` (Exp(1)), ``"gumbel"``,
        ``"normal"`` (Box-Muller, two words a value) or an int m (int64 in
        [0, m)). Each has the seeds' shape + ``shape``; with ``n_rounds``
        every round draws all fields in turn and they gain a round axis
        after the seeds' (a shorter run draws a prefix of a longer one)."""
        sizes = [math.prod(shape) * (2 if kind == "normal" else 1)
                 for kind, shape in fields]
        r = 1 if n_rounds is None else n_rounds
        words = self._words(r * sum(sizes)).reshape(
            self.shape + (r, sum(sizes)))
        out = []
        for (kind, shape), w in zip(fields, torch.split(words, sizes, -1)):
            if isinstance(kind, int):
                v = w % kind
            elif kind == "normal":
                u1, u2 = _unit(w).chunk(2, dim=-1)
                v = (torch.sqrt(-2.0 * torch.log(u1))
                     * torch.cos((2.0 * math.pi) * u2))
            else:
                v = _unit(w)
                if kind in ("exponential", "gumbel"):
                    v = -torch.log(v)
                if kind == "gumbel":
                    v = -torch.log(v)
            v = v.reshape(v.shape[:-1] + tuple(shape))
            out.append(v if n_rounds is not None
                       else v.select(len(self.shape), 0))
        return tuple(out)


class ScenarioDraws(NamedTuple):
    """Draws of the runners, leading axis (S,); per-round fields (S, R, ...).

    ``data_u`` (N,) uniforms of the population, ``up``/``down`` (M, C)
    Exp(1) channel gains and ``dist_u`` (M,) uniforms of the distances
    (stream 0); ``rand_assoc`` (N,) the random baseline (1); ``steps`` the
    rollout's ``env.StepDraws`` (2); ``move_u`` (R, N) and ``gumbel`` (R, N,
    M) of migration (3); ``outage0_u`` (M,) of the outage init (4);
    ``slow_u``/``slow_exp`` (R, N) and ``outage_u`` (R, M) of the fault
    rounds (5); ``byz_u`` (M,) of the byzantine mask (6); ``mal_u`` (N,) of
    the malicious mask (7); ``sub_z`` (R, M) normals of the chain rounds
    (8). Fields a runner does not read may be None.
    """
    data_u: Optional[torch.Tensor] = None
    up: Optional[torch.Tensor] = None
    down: Optional[torch.Tensor] = None
    dist_u: Optional[torch.Tensor] = None
    rand_assoc: Optional[torch.Tensor] = None
    steps: Optional[StepDraws] = None
    move_u: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    outage0_u: Optional[torch.Tensor] = None
    slow_u: Optional[torch.Tensor] = None
    slow_exp: Optional[torch.Tensor] = None
    outage_u: Optional[torch.Tensor] = None
    byz_u: Optional[torch.Tensor] = None
    mal_u: Optional[torch.Tensor] = None
    sub_z: Optional[torch.Tensor] = None


def draw_fields(stream: RowStream, fields, n_rounds=None) -> dict:
    """:meth:`RowStream.draw` of named ``(name, kind, shape)`` fields, as a
    dict."""
    return dict(zip((f[0] for f in fields),
                    stream.draw([f[1:] for f in fields], n_rounds)))


def make_draws(cfg: EnvConfig, seeds, parts, n_rounds: int = 0,
               device=None) -> dict:
    """The draws of the named ``parts`` for the scenario rows ``seeds``
    ((S,) or 0-dim), made on ``device`` (default ``cuda``), as a dict of
    :class:`ScenarioDraws` fields with the seeds' leading shape. The parts,
    each from its own :class:`RowStream`: ``"realization"``, ``"random"``,
    ``"rollout"``, ``"migration"``, ``"outage_init"``, ``"faults"``,
    ``"byzantine"``, ``"malicious"``, ``"chain"``; the per-round ones draw
    ``n_rounds`` rounds."""
    n, m, c = cfg.n_twins, cfg.n_bs, cfg.wl.n_subchannels
    dev = default_device(device)
    per_row = {
        "realization": (FOLD_REALIZATION, [
            ("data_u", "uniform", (n,)), ("up", "exponential", (m, c)),
            ("down", "exponential", (m, c)), ("dist_u", "uniform", (m,))]),
        "random": (FOLD_RANDOM, [("rand_assoc", m, (n,))]),
        "outage_init": (FOLD_OUTAGE_INIT, [("outage0_u", "uniform", (m,))]),
        "byzantine": (FOLD_BYZANTINE, [("byz_u", "uniform", (m,))]),
        "malicious": (FOLD_MALICIOUS, [("mal_u", "uniform", (n,))]),
    }
    per_round = {
        "migration": (FOLD_MIGRATION, [("move_u", "uniform", (n,)),
                                       ("gumbel", "gumbel", (n, m))]),
        "faults": (FOLD_FAULTS, [("slow_u", "uniform", (n,)),
                                 ("slow_exp", "exponential", (n,)),
                                 ("outage_u", "uniform", (m,))]),
        "chain": (FOLD_CHAIN, [("sub_z", "normal", (m,))]),
    }
    d = {}
    for part in parts:
        if part == "rollout":
            d["steps"] = StepDraws(**draw_fields(
                RowStream(seeds, FOLD_ROLLOUT, dev), env_mod.step_fields(cfg),
                n_rounds))
        elif part in per_round:
            fold, fields = per_round[part]
            d.update(draw_fields(RowStream(seeds, fold, dev), fields,
                                 n_rounds))
        else:
            fold, fields = per_row[part]
            d.update(draw_fields(RowStream(seeds, fold, dev), fields))
    return d


def draws_to(x, device):
    """A draws tuple (a nest of NamedTuples of tensors and None) moved to
    ``device``."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(draws_to(v, device) for v in x))
    return x.to(device)


def scenario_draws(batch: ScenarioBatch, cfg: EnvConfig, parts,
                   n_rounds: int = 0, device=None) -> ScenarioDraws:
    """The batch's :class:`ScenarioDraws` of the named ``parts``, every row
    from its own streams (:func:`make_draws`), made on ``device`` (default
    ``cuda``) in one pass a part."""
    return ScenarioDraws(**make_draws(cfg, batch.seed, parts, n_rounds,
                                      device))


def take_row(draws, i):
    """Row ``i`` of a batched draws tuple (a nest of NamedTuples)."""
    if draws is None:
        return None
    if isinstance(draws, tuple):
        return type(draws)(*(take_row(v, i) for v in draws))
    return draws[i]


# ---------------------------------------------------------------------------
# the realization
# ---------------------------------------------------------------------------


def sample_population(data_u, data_min, data_max, skew) -> torch.Tensor:
    """Twin data sizes D_j from uniforms ``data_u`` (N,) or (S, N) and the
    knobs (0-dim or (S,)): ``skew=1`` is the paper's uniform population."""
    def col(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=data_u.device)[..., None]

    return col(data_min) + (col(data_max) - col(data_min)) \
        * data_u ** col(skew)


def scenario_env(cfg: EnvConfig, draws: ScenarioDraws, data_min, data_max,
                 skew, *, chain: bool = False) -> EnvState:
    """The env realization of one scenario (draws without the scenario
    axis, 0-dim knobs) or of a batch (leading axis S everywhere): the
    population, channels and distances from the realization draws, the
    paper's round-robin association. ``chain=True`` adds the Eq. 6 chain
    view (``cfg.consensus`` must be set; single scenario only). Inside a
    twin scope the draws are global and the twin fields this rank's block
    (padding rows ``data=0``, ``assoc=n_bs``)."""
    dev = draws.data_u.device
    data = sharding.mask_twins(
        sample_population(sharding.localize(draws.data_u, axis=-1),
                          data_min, data_max, skew), 0.0, axis=-1)
    assoc = sharding.localize(
        assoc_mod.average_association(cfg.n_twins, cfg.n_bs,
                                      dev).to(torch.int32), fill=cfg.n_bs)
    assoc = assoc.expand(data.shape).contiguous()
    wl = cfg.wl
    view = None
    if chain and cfg.consensus is not None:
        view = consensus_mod.chain_init(
            cfg.consensus, latency.bs_sum(data, assoc, cfg.n_bs))
    return EnvState(freqs=env_mod.bs_frequencies(cfg, dev), data_sizes=data,
                    h_up=draws.up, h_down=draws.down,
                    dist=wl.min_dist_m + draws.dist_u * (wl.max_dist_m
                                                         - wl.min_dist_m),
                    assoc=assoc, t=0, chain=view)


def _setup(cfg, batch, draws, parts, n_rounds, device):
    """Device, the batch's knobs on it, the draws (made there when None)
    and the batch's realization with uniform bandwidth and b = 0.5."""
    dev = default_device(device)
    draws = (scenario_draws(batch, cfg, parts, n_rounds, dev) if draws is None
             else draws_to(draws, dev))
    knobs = batch_to(batch, dev)
    st = scenario_env(cfg, draws, knobs.data_min, knobs.data_max, knobs.skew)
    uni_tau = torch.full((cfg.n_bs, cfg.wl.n_subchannels), 1.0 / cfg.n_bs,
                         device=dev)
    up = comms.uplink_rate(cfg.wl, uni_tau, st.h_up, st.dist)
    down = comms.downlink_rate(cfg.wl, st.h_down, st.dist)
    b = torch.full(st.data_sizes.shape, 0.5, device=dev)
    return knobs, draws, st, up, down, b


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------


def run_baselines(cfg: EnvConfig, batch: ScenarioBatch,
                  draws: Optional[ScenarioDraws] = None, *,
                  device=None) -> dict:
    """Eq. 17 round time of the random/average/greedy association policies
    for every scenario in the batch.

    Returns a dict of (S,) tensors (plus ``greedy_bs_loads`` (S, M)): round
    times per policy, the greedy policy's load-imbalance diagnostic and the
    scenario's total data. Reads the realization and random-association
    draws. 8 grouped segment calls (three round times, the greedy loads).
    ``device`` defaults to ``cuda``.
    """
    _, draws, st, up, down, b = _setup(cfg, batch, draws,
                                       ("realization", "random"), 0, device)

    def rt(assoc):
        return latency.round_time(cfg.lat, assoc, b, st.data_sizes, st.freqs,
                                  up, down)

    greedy = assoc_mod.greedy_association(cfg.lat, st.data_sizes, st.freqs,
                                          up)
    t_random = rt(draws.rand_assoc.to(torch.int32))
    t_average = rt(st.assoc)
    t_greedy = rt(greedy)
    load = assoc_mod.bs_loads(greedy, st.data_sizes, cfg.n_bs)
    return {"random": t_random, "average": t_average, "greedy": t_greedy,
            "greedy_imbalance": load["imbalance"],
            "greedy_bs_loads": load["loads"],
            "total_data": torch.sum(st.data_sizes, dim=-1)}


def run_migration(cfg: EnvConfig, mcfg: MigrationConfig,
                  batch: ScenarioBatch, n_rounds: int = 10,
                  draws: Optional[ScenarioDraws] = None, *,
                  device=None) -> dict:
    """Migration as a scenario axis: every scenario evolves its round-robin
    association ``n_rounds`` rounds under ``mcfg`` and scores Eq. 17 each
    round. Returns (S, n_rounds) ``round_times``, ``migration_rates`` and
    the load ``imbalance``. 5 grouped segment calls a round (the
    migration loads, the round time, the load diagnostic)."""
    _, draws, st, up, down, b = _setup(cfg, batch, draws,
                                       ("realization", "migration"),
                                       n_rounds, device)
    assoc = st.assoc
    times, rates, imbalance = [], [], []
    for r in range(n_rounds):
        assoc2 = migration.migration_step(mcfg, draws.move_u[:, r],
                                          draws.gumbel[:, r], assoc,
                                          st.data_sizes, cfg.n_bs)
        times.append(latency.round_time(cfg.lat, assoc2, b, st.data_sizes,
                                        st.freqs, up, down))
        rates.append(migration.migration_rate(assoc, assoc2))
        imbalance.append(assoc_mod.bs_loads(assoc2, st.data_sizes,
                                            cfg.n_bs)["imbalance"])
        assoc = assoc2
    return {"round_times": torch.stack(times, dim=1),
            "migration_rates": torch.stack(rates, dim=1),
            "imbalance": torch.stack(imbalance, dim=1)}


def _batch_rates(batch: ScenarioBatch, fcfg: FaultConfig):
    """Per-scenario straggler/outage rates: the batch's fault axes when
    present, else the FaultConfig scalars broadcast over the batch."""
    s, dev = batch.data_min.shape[0], batch.data_min.device
    s_rate = (torch.full((s,), fcfg.straggler_rate, device=dev)
              if batch.straggler is None else batch.straggler)
    o_rate = (torch.full((s,), fcfg.outage_rate, device=dev)
              if batch.outage is None else batch.outage)
    return s_rate, o_rate


def run_faults(cfg: EnvConfig, fcfg: FaultConfig, batch: ScenarioBatch,
               n_rounds: int = 10, draws: Optional[ScenarioDraws] = None, *,
               device=None) -> dict:
    """Faults as a scenario axis: every scenario runs ``n_rounds`` rounds
    under straggler slowdowns and a Gilbert-Elliott outage chain (rates
    from the batch's fault axes when present, else ``fcfg``). Returns
    (S, n_rounds) ``round_times``, ``straggler_frac`` and ``outage_frac``.
    With all rates zero this is the ``average`` baseline every round. 2
    grouped segment calls a round."""
    knobs, draws, st, up, down, b = _setup(
        cfg, batch, draws, ("realization", "outage_init", "faults"),
        n_rounds, device)
    s_rate, o_rate = (x[:, None] for x in _batch_rates(knobs, fcfg))
    bad = faults_mod.outage_draw(fcfg, draws.outage0_u, rate=o_rate)
    times, s_frac, o_frac = [], [], []
    for r in range(n_rounds):
        slow = faults_mod.straggler_slowdowns(fcfg, draws.slow_u[:, r],
                                              draws.slow_exp[:, r],
                                              rate=s_rate)
        bad = faults_mod.outage_step(fcfg, draws.outage_u[:, r], bad,
                                     rate=o_rate)
        up_eff = faults_mod.outage_gate(fcfg, up, bad)
        times.append(latency.round_time(cfg.lat, st.assoc, b * slow,
                                        st.data_sizes, st.freqs, up_eff,
                                        down))
        s_frac.append(faults_mod.straggler_frac(slow))
        o_frac.append(torch.mean(bad.to(torch.float32), dim=-1))
    return {"round_times": torch.stack(times, dim=1),
            "straggler_frac": torch.stack(s_frac, dim=1),
            "outage_frac": torch.stack(o_frac, dim=1)}


def _batch_consensus(batch: ScenarioBatch, ccfg: ConsensusConfig,
                     lat: latency.LatencyParams):
    """Per-scenario consensus knobs: the batch's axes when present, else
    the ConsensusConfig / LatencyParams scalars broadcast over the batch."""
    s, dev = batch.data_min.shape[0], batch.data_min.device
    byz = (torch.full((s,), ccfg.byzantine_frac, device=dev)
           if batch.byzantine is None else batch.byzantine)
    qf = (torch.full((s,), float(ccfg.quorum_f), device=dev)
          if batch.quorum is None else batch.quorum)
    default_sb = (lat.block_size_bits if ccfg.block_size_bits is None
                  else ccfg.block_size_bits)
    sb = (torch.full((s,), default_sb, device=dev)
          if batch.block_size is None else batch.block_size)
    return byz, qf, sb


def run_consensus(cfg: EnvConfig, ccfg: ConsensusConfig,
                  batch: ScenarioBatch, n_rounds: int = 10,
                  draws: Optional[ScenarioDraws] = None, *,
                  device=None) -> dict:
    """Consensus as a scenario axis: every scenario advances a chain
    ``n_rounds`` blocks while the PBFT model prices Eq. 17's block phase
    from its own downlink rates (byzantine fraction, quorum f and block size
    from the batch's axes when present, else ``ccfg``). Returns (S,
    n_rounds) ``round_times`` and ``accept_frac``, and (S,)
    ``consensus_time``, ``legacy_block_time`` (Eq. 16) and
    ``honest_stake_share``. The twin-axis sums are 4 grouped segment calls
    (Eqs. 12 and 15, occupancy, the Eq. 6 stakes); the chains of all
    scenarios advance together (a leading S axis), and the two-tier PBFT
    term (``ccfg.n_groups > 1``) loops over the scenarios."""
    knobs, draws, st, up, down, b = _setup(
        cfg, batch, draws, ("realization", "byzantine", "chain"), n_rounds,
        device)
    m = cfg.n_bs
    cmp_bc = (torch.amax(latency.t_cmp(cfg.lat, st.assoc, b, st.data_sizes,
                                       st.freqs), dim=-1)
              + torch.amax(latency.t_broadcast(cfg.lat, st.assoc, up, m),
                           dim=-1))
    occ = latency.twin_counts(st.assoc, m)
    data_per_bs = latency.bs_sum(st.data_sizes, st.assoc, m)
    byz_frac, qf, sb = _batch_consensus(knobs, ccfg, cfg.lat)
    qf = torch.round(qf).to(torch.int32)
    if ccfg.n_groups > 1:
        t_cons = torch.stack([consensus_mod.consensus_time(
            cfg.lat, ccfg, down[s], st.freqs, quorum_f=qf[s],
            byz_frac=byz_frac[s], block_size_bits=sb[s])
            for s in range(down.shape[0])])
    else:
        t_cons = consensus_mod.consensus_time(
            cfg.lat, ccfg, down, st.freqs, quorum_f=qf, byz_frac=byz_frac,
            block_size_bits=sb)
    byz = consensus_mod.draw_byzantine(draws.byz_u, byz_frac[:, None])
    state = consensus_mod.chain_init(ccfg, data_per_bs)
    accept = []
    for r in range(n_rounds):
        state, _, a = consensus_mod.chain_round(ccfg, state,
                                                draws.sub_z[:, r], byz, occ)
        accept.append(a)
    return {"round_times": (cmp_bc + t_cons)[:, None].expand(-1, n_rounds),
            "consensus_time": t_cons,
            "legacy_block_time": latency.t_block_validation(cfg.lat, down,
                                                            st.freqs),
            "accept_frac": torch.stack(accept, dim=1),
            "honest_stake_share": consensus_mod.honest_stake_share(state,
                                                                   byz)}


def run_policy(cfg: EnvConfig, agent, batch: ScenarioBatch,
               n_steps: int = 10, policy: str = "factorized",
               draws: Optional[ScenarioDraws] = None, *,
               device=None) -> dict:
    """Evaluate one trained MADDPG policy across the batch: a deterministic
    rollout of ``n_steps`` env steps on every scenario's realization (the
    one :func:`run_baselines` scores), looping over the scenarios. Returns
    (S,) ``mean_system_time`` and ``final_system_time``. ``agent`` lives on
    the run's device."""
    from repro_torch.core.marl.ddpg import act

    dev = default_device(device)
    draws = (scenario_draws(batch, cfg, ("realization", "rollout"), n_steps,
                            dev) if draws is None else draws_to(draws, dev))
    knobs = batch_to(batch, dev)
    mean_t, final_t = [], []
    with torch.no_grad():
        for s in range(knobs.data_min.shape[0]):
            st = scenario_env(cfg, take_row(draws, s), knobs.data_min[s],
                              knobs.data_max[s], knobs.skew[s], chain=True)
            obs = env_mod.observe(cfg, st)
            times = []
            for r in range(n_steps):
                a = act(cfg, agent, obs, policy=policy)
                st, _, info = env_mod.env_step(
                    cfg, st, a, take_row(take_row(draws.steps, s), r))
                obs = env_mod.observe(cfg, st)
                times.append(info["system_time"])
            times = torch.stack(times)
            mean_t.append(torch.mean(times))
            final_t.append(times[-1])
    return {"mean_system_time": torch.stack(mean_t),
            "final_system_time": torch.stack(final_t)}


def scenario_launches(runner: str, cfg: EnvConfig, n_scenarios: int,
                      n_rounds: int = 10) -> int:
    """Segment-kernel launches of one runner call on the card, as the code
    makes them. A grouped call is ``ceil(S / (MAX_SEGMENTS // M))``
    launches: :func:`run_baselines` makes 8 such calls, :func:`run_faults`
    2 a round, :func:`run_migration` 5 a round, :func:`run_consensus` 4.
    :func:`run_policy` loops: a scenario's first observe (2) and, under
    consensus, its chain stakes (1); a step's Eqs. 12 and 15 twice (4), the
    next observe (2), migration's loads and the chain's occupancy (1 each)
    when set. ``n_rounds`` is the policy's steps for ``"policy"``."""
    groups = -(-n_scenarios // max(MAX_SEGMENTS // cfg.n_bs, 1))
    if runner == "policy":
        chain = int(cfg.consensus is not None)
        per_step = 6 + int(cfg.migration is not None) + chain
        return n_scenarios * (2 + chain + n_rounds * per_step)
    calls = {"baselines": 8, "faults": 2 * n_rounds,
             "migration": 5 * n_rounds, "consensus": 4}
    return calls[runner] * groups


# ---------------------------------------------------------------------------
# host row bridges and the serve loop's knobs
# ---------------------------------------------------------------------------


def _row_uniforms(batch: ScenarioBatch, i: int, fold: int, n: int):
    """The first ``n`` uniforms of stream ``fold`` of row ``i``, on the
    CPU: the ``data_u``/``mal_u`` its runners draw on any device."""
    return RowStream(batch.seed[i], fold, "cpu").draw([("uniform", (n,))])[0]


def population_row(batch: ScenarioBatch, i: int, n_twins: int, *,
                   data_u=None):
    """Host view of scenario row ``i``'s twin population, the bridge to the
    FL substrate: ``(data_sizes (n_twins,) np.float32, alpha float |
    None)``, the D_j realization every runner scores for this row at the
    same ``n_twins`` (its uniforms: ``data_u``, by default the first draw
    of the row's realization stream)."""
    if data_u is None:
        data_u = _row_uniforms(batch, i, FOLD_REALIZATION, n_twins)
    data_u = torch.as_tensor(data_u, dtype=torch.float32).cpu()
    d = sample_population(data_u, batch.data_min[i], batch.data_max[i],
                          batch.skew[i])
    alpha = None if batch.alpha is None else float(batch.alpha[i])
    return d.numpy().astype(np.float32), alpha


def fault_row(batch: ScenarioBatch, i: int, n_twins: int, *, mal_u=None):
    """Host view of scenario row ``i``'s fault axes: ``(malicious (n_twins,)
    np.bool | None, straggler_rate float | None, outage_rate float |
    None)``, None wherever the batch carries no such axis. The malicious
    mask compares the row's stream-7 uniforms (or ``mal_u``) with the
    row's malicious fraction."""
    mal = None
    if batch.malicious is not None:
        if mal_u is None:
            mal_u = _row_uniforms(batch, i, FOLD_MALICIOUS, n_twins)
        mal_u = torch.as_tensor(mal_u, dtype=torch.float32).cpu()
        mal = (mal_u < torch.as_tensor(batch.malicious[i],
                                       dtype=torch.float32)).numpy()
    s_rate = None if batch.straggler is None else float(batch.straggler[i])
    o_rate = None if batch.outage is None else float(batch.outage[i])
    return mal, s_rate, o_rate


def consensus_row(batch: ScenarioBatch, i: int):
    """Host view of scenario row ``i``'s consensus axes: ``(byzantine_frac,
    quorum_f int, block_size_bits)``, None wherever the batch carries no
    such axis."""
    byz = None if batch.byzantine is None else float(batch.byzantine[i])
    qf = None if batch.quorum is None else int(round(float(batch.quorum[i])))
    sb = None if batch.block_size is None else float(batch.block_size[i])
    return byz, qf, sb


class StreamKnobs(NamedTuple):
    """Per-round scenario knobs of the serve loop (``repro_torch.core.
    serve``): every field (S,) fp32, with the fallbacks the batch runners
    apply, so a streamed round prices the knobs the runner scores for the
    same row."""
    data_min: torch.Tensor
    data_max: torch.Tensor
    skew: torch.Tensor
    straggler: torch.Tensor
    outage: torch.Tensor
    byzantine: torch.Tensor
    quorum: torch.Tensor
    block_size: torch.Tensor


def stream_knobs(batch: ScenarioBatch, *, fcfg: FaultConfig = None,
                 ccfg: ConsensusConfig = None,
                 lat: latency.LatencyParams = None) -> StreamKnobs:
    """The :class:`StreamKnobs` of a batch, on the batch's device: fault
    knobs fall back to ``fcfg``'s scalars as :func:`run_faults` does (zero
    without a FaultConfig), consensus knobs to ``ccfg``/``lat`` as
    :func:`run_consensus` does. Index a row with :func:`knob_row`."""
    batch = batch_to(batch, batch.data_min.device)
    zeros = torch.zeros_like(batch.data_min)
    if fcfg is not None:
        s_rate, o_rate = _batch_rates(batch, fcfg)
    else:
        s_rate = zeros if batch.straggler is None else batch.straggler
        o_rate = zeros if batch.outage is None else batch.outage
    if ccfg is not None:
        lat = latency.LatencyParams() if lat is None else lat
        byz, qf, sb = _batch_consensus(batch, ccfg, lat)
    else:
        byz = zeros if batch.byzantine is None else batch.byzantine
        qf = zeros if batch.quorum is None else batch.quorum
        sb = zeros if batch.block_size is None else batch.block_size
    return StreamKnobs(data_min=batch.data_min, data_max=batch.data_max,
                       skew=batch.skew, straggler=s_rate, outage=o_rate,
                       byzantine=byz, quorum=qf, block_size=sb)


def knob_row(knobs: StreamKnobs, i: int) -> StreamKnobs:
    """Scenario row ``i``'s 0-dim knob tensors out of a (S,) knob stack."""
    return StreamKnobs(*(x[i] for x in knobs))


# ---------------------------------------------------------------------------
# twin-mesh runners
# ---------------------------------------------------------------------------


def _baselines_lite(cfg: EnvConfig, batch: ScenarioBatch,
                    draws: Optional[ScenarioDraws] = None, *,
                    device=None) -> dict:
    """The shardable part of :func:`run_baselines`: the random and average
    round times and the average association's load diagnostics. The greedy
    baseline is left out, as in the reference: it assigns twins one at a
    time against accumulated loads, an O(N)-deep chain a twin mesh cannot
    split. Under a twin scope the twin arrays are (S, N_local) blocks and
    every returned value is replicated."""
    _, draws, st, up, down, b = _setup(cfg, batch, draws,
                                       ("realization", "random"), 0, device)

    def rt(assoc):
        return latency.round_time(cfg.lat, assoc, b, st.data_sizes, st.freqs,
                                  up, down)

    rnd = sharding.localize(draws.rand_assoc.to(torch.int32), axis=-1,
                            fill=cfg.n_bs)
    load = assoc_mod.bs_loads(st.assoc, st.data_sizes, cfg.n_bs)
    return {"random": rt(rnd), "average": rt(st.assoc),
            "average_imbalance": load["imbalance"],
            "average_bs_loads": load["loads"],
            "total_data": sharding.twin_sum(st.data_sizes, axis=-1)}


def _sharded_runner(ts, cfg: EnvConfig, body, *args, **kw) -> dict:
    """``body(cfg, *args, device=ts.device, **kw)``, a batched runner, on
    this rank's twin block of every scenario: under the scope of
    ``cfg.n_twins`` twins, where its draws are sliced and its per-BS sums
    all-reduced. ``n_shards == 1`` runs the body with no scope (the no-op
    fast path). The results are replicated."""
    kw.setdefault("device", ts.device)
    if ts.n_shards == 1:
        return body(cfg, *args, **kw)
    with ts.scope(cfg.n_twins):
        return body(cfg, *args, **kw)


def run_baselines_sharded(ts, cfg: EnvConfig, batch: ScenarioBatch,
                          draws: Optional[ScenarioDraws] = None) -> dict:
    """The random and average baselines of :func:`run_baselines` with each
    scenario's population sharded over a twin mesh: replicated (S,)
    ``random``, ``average``, ``average_imbalance``, ``total_data`` and (S,
    M) ``average_bs_loads``; the greedy baseline is omitted
    (:func:`_baselines_lite`)."""
    return _sharded_runner(ts, cfg, _baselines_lite, batch, draws)


def run_migration_sharded(ts, cfg: EnvConfig, mcfg: MigrationConfig,
                          batch: ScenarioBatch, n_rounds: int = 10,
                          draws: Optional[ScenarioDraws] = None) -> dict:
    """:func:`run_migration` over a twin mesh; rows never cross ranks, the
    results are replicated."""
    return _sharded_runner(ts, cfg, run_migration, mcfg, batch, n_rounds,
                           draws)


def run_faults_sharded(ts, cfg: EnvConfig, fcfg: FaultConfig,
                       batch: ScenarioBatch, n_rounds: int = 10,
                       draws: Optional[ScenarioDraws] = None) -> dict:
    """:func:`run_faults` over a twin mesh; the results are replicated."""
    return _sharded_runner(ts, cfg, run_faults, fcfg, batch, n_rounds, draws)


def run_consensus_sharded(ts, cfg: EnvConfig, ccfg: ConsensusConfig,
                          batch: ScenarioBatch, n_rounds: int = 10,
                          draws: Optional[ScenarioDraws] = None) -> dict:
    """:func:`run_consensus` over a twin mesh; the results are
    replicated."""
    return _sharded_runner(ts, cfg, run_consensus, ccfg, batch, n_rounds,
                           draws)

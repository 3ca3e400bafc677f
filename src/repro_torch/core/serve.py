"""Always-on DTWN service: streaming rounds over a live twin population,
port of ``repro/core/serve.py``.

* **Device-resident state written in place.** :class:`ServeState` (the env
  realization, the active mask, the outage chain, the byzantine mask, the
  optional MADDPG agent with its replay, the optional FL state) is
  allocated once by :func:`serve_init` (and ``fl.stream.fl_init``); every
  round writes its twin-axis tensors in place, so the device memory the
  stream holds is flat from the second round on. The reference donates its
  state to ``jit`` for the same effect. A state handed to the round step is
  consumed: it is the state the step returns.
* **Population churn.** The twin axis is a fixed-capacity buffer with an
  ``active`` mask. :func:`admit` / :func:`evict` rewrite rows and the mask
  without reshaping: an evicted row gets the padding convention
  (``data=0``, ``assoc=n_bs``), so it drops out of every segment sum and
  Eq. 4 weight.
* **Overlapped rounds.** No round reads anything back to the host:
  :func:`serve_rounds` with ``overlap=True`` queues round t+1 while round t
  runs on the card, and the metrics are read once at the end
  (:func:`stack_metrics`). ``overlap=False`` synchronises after every round
  and gives the same bits.
* **Online scenario streaming.** Per-round knobs are
  ``scenario.StreamKnobs`` rows.

torch cannot repeat ``jax.random``, so a round's draws are an argument, a
:class:`RoundDraws`: made up front for the whole stream
(:func:`stream_draws`) from the scenario row's streams that the batch
runners read (3 migration, 5 faults, 8 chain; 11 churn and 12 dynamics are
the service's own), so at a fixed full population with churn off K
streamed rounds reproduce ``scenario.run_faults`` / ``run_migration`` /
``run_consensus`` on the same row.

Over a twin mesh (``make_serve_init`` / ``make_round_step`` /
``serve_rounds`` with a ``core.sharding.TwinSharding``) every rank holds its
block of the twin-axis leaves (:func:`serve_specs`), runs the round under
its twin scope on the global draws (each rank slices its block) and writes
its state in place; the M-sized leaves, the agent and the replay stay
replicated.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import association as assoc_mod
from repro_torch.core import comms, latency, migration, scenario, sharding
from repro_torch.core import consensus as consensus_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core.marl import env as env_mod
from repro_torch.core.marl.env import EnvConfig, EnvState, StepDraws
from repro_torch.core.scenario import ScenarioDraws, StreamKnobs
from repro_torch.core.sharding import TWIN_AXIS, P
from repro_torch.utils.device import default_device

__all__ = [
    "ServeConfig", "ServeState", "RoundDraws", "stream_draws", "round_draws",
    "serve_init", "make_serve_init", "attach_policy", "admit", "evict",
    "churn_step", "make_round_step", "serve_rounds", "serve_specs",
    "stack_metrics", "serve_launches",
]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving knobs.

    ``capacity``   twin-buffer capacity; must equal ``EnvConfig.n_twins``.
    ``join_rate``  per-round probability an empty slot admits a twin.
    ``leave_rate`` per-round probability a live twin departs.
    ``policy``     policy name for MARL-driven association (needs
                   ``ServeState.agent``); None streams the round-robin
                   association (plus optional migration).
    ``evolve_channels`` advance channel/frequency dynamics each round.
    ``fl``         a ``fl.stream.FLServeConfig`` to stream the FL workload
                   through the round (needs a per-round ``FLPlan``).
    """
    capacity: int
    join_rate: float = 0.0
    leave_rate: float = 0.0
    policy: Optional[str] = None
    evolve_channels: bool = False
    fl: Optional[Any] = None

    @property
    def churns(self) -> bool:
        return self.join_rate > 0.0 or self.leave_rate > 0.0


class ServeState(NamedTuple):
    """The device-resident state of one serving stream. Twin-axis tensors
    (``env.data_sizes``/``env.assoc``/``active``) are (capacity,); inactive
    rows carry ``data=0, assoc=n_bs``. ``round`` counts rounds on the host.
    """
    env: EnvState
    active: torch.Tensor     # (capacity,) bool
    bad: torch.Tensor        # (M,) bool Gilbert-Elliott channel state
    byz: torch.Tensor        # (M,) bool stationary byzantine mask
    agent: Any = None        # MADDPGState (policy mode)
    buf: Any = None          # marl.replay.Replay (policy mode)
    fl: Any = None           # fl.stream.FLState (streamed FL)
    round: int = 0


class RoundDraws(NamedTuple):
    """One round's draws; a stream stack has a leading (n_rounds,) axis.

    Migration (stream 3): ``move_u`` (N,), ``gumbel`` (N, M). Faults (5):
    ``slow_u``/``slow_exp`` (N,), ``outage_u`` (M,). Chain (8): ``sub_z``
    (M,). Churn (11): ``leave_u``/``join_u``/``new_data_u`` (N,) uniforms and
    ``new_assoc`` (N,) int64. Dynamics (12): ``jitter`` (M,), ``up``/``down``
    (M, C). A field the configs do not use is None.
    """
    move_u: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    slow_u: Optional[torch.Tensor] = None
    slow_exp: Optional[torch.Tensor] = None
    outage_u: Optional[torch.Tensor] = None
    sub_z: Optional[torch.Tensor] = None
    leave_u: Optional[torch.Tensor] = None
    join_u: Optional[torch.Tensor] = None
    new_data_u: Optional[torch.Tensor] = None
    new_assoc: Optional[torch.Tensor] = None
    jitter: Optional[torch.Tensor] = None
    up: Optional[torch.Tensor] = None
    down: Optional[torch.Tensor] = None


def stream_draws(cfg: EnvConfig, scfg: ServeConfig, seed, n_rounds: int,
                 device=None) -> RoundDraws:
    """The draws of ``n_rounds`` of serving the scenario row ``seed``, made
    on ``device`` (default ``cuda``) round after round from the row's
    streams, before the rounds run."""
    parts = tuple(p for p, on in (("migration", cfg.migration),
                                  ("faults", cfg.faults),
                                  ("chain", cfg.consensus))
                  if on is not None)
    dev = default_device(device)
    seed = torch.as_tensor(seed, dtype=torch.int64)
    d = scenario.make_draws(cfg, seed, parts, n_rounds, dev)
    n, m, c = cfg.n_twins, cfg.n_bs, cfg.wl.n_subchannels
    if scfg.churns:
        d.update(scenario.draw_fields(
            scenario.RowStream(seed, scenario.FOLD_CHURN, dev),
            [("leave_u", "uniform", (n,)), ("join_u", "uniform", (n,)),
             ("new_data_u", "uniform", (n,)), ("new_assoc", m, (n,))],
            n_rounds))
    if scfg.evolve_channels:
        d.update(scenario.draw_fields(
            scenario.RowStream(seed, scenario.FOLD_DYNAMICS, dev),
            [("jitter", "normal", (m,)), ("up", "exponential", (m, c)),
             ("down", "exponential", (m, c))], n_rounds))
    return RoundDraws(**d)


def round_draws(draws: RoundDraws, t: int) -> RoundDraws:
    """Round ``t``'s draws out of a :func:`stream_draws` stack (views)."""
    return RoundDraws(*(None if x is None else x[t] for x in draws))


# ---------------------------------------------------------------------------
# churn: admit / evict on capacity-managed padded buffers
# ---------------------------------------------------------------------------


def evict(active, data_sizes, assoc, leave, n_bs: int):
    """Depart ``leave & active`` twins: returns ``(active', data', assoc')``
    with departed rows given the padding convention (``data=0``,
    ``assoc=n_bs``). Pure and shape-preserving."""
    leave = torch.as_tensor(leave, dtype=torch.bool,
                            device=active.device) & active
    return (active & ~leave, torch.where(leave, 0.0, data_sizes),
            torch.where(leave, n_bs, assoc))


def admit(active, data_sizes, assoc, join, new_data, new_assoc):
    """Admit ``join & ~active`` twins into empty slots: each admitted row
    takes its ``new_data``/``new_assoc`` entry (scored from the next
    round). Pure and shape-preserving."""
    join = torch.as_tensor(join, dtype=torch.bool,
                           device=active.device) & ~active
    return (active | join, torch.where(join, new_data, data_sizes),
            torch.where(join, new_assoc.to(assoc.dtype), assoc))


def churn_step(cfg: EnvConfig, scfg: ServeConfig, draws: RoundDraws, active,
               data_sizes, assoc, row: StreamKnobs):
    """One round of churn from the round's churn draws: Bernoulli departures
    over live twins, Bernoulli admissions into empty slots, admitted
    populations drawn with the round's knobs (``scenario.sample_population``'s
    law) and a uniform-random association. Returns ``(active', data',
    assoc', n_joined, n_left)``, the counts 0-dim int32 tensors. Inside a
    twin scope the draws are global and this rank takes its block (padding
    rows never leave, join or count)."""
    leave_u = sharding.localize(draws.leave_u, fill=1.0)
    join_u = sharding.localize(draws.join_u, fill=1.0)
    leave = active & (leave_u < scfg.leave_rate)
    join = ~active & (join_u < scfg.join_rate)
    new_data = scenario.sample_population(
        sharding.localize(draws.new_data_u, fill=0.0), row.data_min,
        row.data_max, row.skew)
    new_assoc = sharding.localize(draws.new_assoc, fill=cfg.n_bs)
    active2, data2, assoc2 = evict(active, data_sizes, assoc, leave,
                                   cfg.n_bs)
    active2, data2, assoc2 = admit(active2, data2, assoc2, join, new_data,
                                   new_assoc)
    return (active2, data2, assoc2, sharding.twin_count(join),
            sharding.twin_count(leave))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _knobs_on(row: StreamKnobs, dev) -> StreamKnobs:
    return StreamKnobs(*(torch.as_tensor(x, dtype=torch.float32).to(dev)
                         for x in row))


def serve_init(cfg: EnvConfig, scfg: ServeConfig, row: StreamKnobs, *,
               seed=0, draws: Optional[ScenarioDraws] = None,
               n_live: Optional[int] = None, device=None) -> ServeState:
    """Fresh serving state of one scenario row: the realization
    ``scenario.run_*`` score for the row (population, channels, round-robin
    association, chain stakes), the first ``n_live`` slots active (default
    all), the outage chain's stationary init and the byzantine mask.
    ``draws`` (a ``ScenarioDraws`` without the scenario axis: the
    realization, ``outage0_u`` and ``byz_u``) replaces the row ``seed``'s
    streams. ``device`` defaults to ``cuda``. Attach an agent for policy
    mode with :func:`attach_policy`. Inside a twin scope the twin leaves
    are this rank's block of the same realization."""
    if scfg.capacity != cfg.n_twins:
        raise ValueError(f"ServeConfig.capacity ({scfg.capacity}) must equal"
                         f" EnvConfig.n_twins ({cfg.n_twins}): the twin"
                         f" buffer is the twin axis")
    dev = default_device(device)
    if draws is None:
        draws = ScenarioDraws(**scenario.make_draws(
            cfg, torch.as_tensor(seed, dtype=torch.int64),
            ("realization", "outage_init", "byzantine"), device=dev))
    draws = scenario.draws_to(draws, dev)
    row = _knobs_on(row, dev)
    st = scenario.scenario_env(cfg, draws, row.data_min, row.data_max,
                               row.skew)
    n, m = cfg.n_twins, cfg.n_bs
    n_live = n if n_live is None else n_live
    active = sharding.localize(torch.arange(n, device=dev) < n_live,
                               fill=False)
    data = torch.where(active, st.data_sizes, 0.0)
    assoc = torch.where(active, st.assoc, m)
    chain = (None if cfg.consensus is None else consensus_mod.chain_init(
        cfg.consensus, latency.bs_sum(data, assoc, m)))
    bad = (faults_mod.outage_draw(cfg.faults, draws.outage0_u,
                                  rate=row.outage)
           if cfg.faults is not None
           else torch.zeros((m,), dtype=torch.bool, device=dev))
    byz = (consensus_mod.draw_byzantine(draws.byz_u, row.byzantine)
           if cfg.consensus is not None
           else torch.zeros((m,), dtype=torch.bool, device=dev))
    env = st._replace(data_sizes=data, assoc=assoc, chain=chain,
                      h_up=st.h_up.clone(), h_down=st.h_down.clone())
    return ServeState(env=env, active=active, bad=bad, byz=byz, round=0)


def attach_policy(cfg: EnvConfig, state: ServeState, gen: torch.Generator,
                  *, dcfg=None, replay_capacity: int = 4096) -> ServeState:
    """Attach a fresh MADDPG agent (drawn from ``gen``, moved to the state's
    device) and an empty replay buffer to a serving state (policy mode).
    Both are M-sized, whatever the population."""
    from repro_torch.core.marl import replay, spaces
    from repro_torch.core.marl.ddpg import DDPGConfig, maddpg_init
    from repro_torch.utils.tree import tree_map

    dcfg = dcfg or DDPGConfig()
    spec = spaces.space_spec(cfg)
    dev = state.active.device
    agent = tree_map(lambda x: x.to(dev), maddpg_init(cfg, dcfg, gen))
    return state._replace(
        agent=agent,
        buf=replay.replay_init(replay_capacity, spec.compact_dim, spec.n_bs,
                               spec.enc_dim, device=dev))


def make_serve_init(cfg: EnvConfig, scfg: ServeConfig, ts=None,
                    n_live: Optional[int] = None):
    """:func:`serve_init` with ``cfg``, ``scfg`` and ``n_live`` bound:
    ``fn(row, **kw) -> ServeState``. With a multi-shard ``ts`` the state is
    built under the rank's twin scope on the mesh's device (twin leaves
    blocked per :func:`serve_specs`)."""
    if ts is None or ts.n_shards == 1:
        return functools.partial(serve_init, cfg, scfg, n_live=n_live)

    def init(row, **kw):
        kw.setdefault("device", ts.device)
        with ts.scope(cfg.n_twins):
            return serve_init(cfg, scfg, row, n_live=n_live, **kw)

    return init


def serve_specs(cfg: EnvConfig, scfg: Optional[ServeConfig] = None):
    """Which ServeState leaves are twin-blocked: the env's per
    ``marl.env.env_specs``, the active mask and, with streamed FL, the
    model buffers (``fl.stream.fl_specs``); the fault chain, the byzantine
    mask, the agent, the replay and the round counter are replicated."""
    if scfg is not None and scfg.fl is not None:
        from repro_torch.fl.stream import fl_specs

        fl = fl_specs(scfg.fl)
    else:
        fl = P()
    return ServeState(env=env_mod.env_specs(cfg), active=P(TWIN_AXIS),
                      bad=P(), byz=P(), agent=P(), buf=P(), fl=fl,
                      round=P())


# ---------------------------------------------------------------------------
# the round step
# ---------------------------------------------------------------------------


def _round_step(cfg: EnvConfig, scfg: ServeConfig, state: ServeState,
                draws: RoundDraws, row: StreamKnobs, plan=None):
    """One streamed round: association (+ migration) -> faults -> Eq. 17
    scoring -> chain round -> FL round (``scfg.fl``; ``plan`` is the
    round's ``FLPlan`` row) -> churn -> (optional) dynamics; then the state
    is written in place. Reads nothing back to the host. Returns
    ``(state', metrics)``, ``state'`` holding ``state``'s tensors."""
    st = state.env
    m = cfg.n_bs
    active = state.active
    dev = active.device

    # --- association and controls for this round ---
    if scfg.policy is not None:
        from repro_torch.core.marl.ddpg import act

        obs = env_mod.observe(cfg, st)
        a = act(cfg, state.agent, obs, policy=scfg.policy)
        assoc_cmd, b, tau = env_mod.decode_actions(cfg, a)
        assoc_cmd = torch.where(active, assoc_cmd, m)
        b = torch.where(active, b, 0.0)
    else:
        obs = a = None
        assoc_cmd = st.assoc
        b = torch.where(active, 0.5, 0.0)
        tau = torch.full((m, cfg.wl.n_subchannels), 1.0 / m, device=dev)
    up = comms.uplink_rate(cfg.wl, tau, st.h_up, st.dist)
    down = comms.downlink_rate(cfg.wl, st.h_down, st.dist)

    # --- migration (stream 3; run_migration's body) ---
    if cfg.migration is not None:
        assoc = migration.migration_step(cfg.migration, draws.move_u,
                                         draws.gumbel, assoc_cmd,
                                         st.data_sizes, m)
        # the kernel migrates every row; inactive rows back out of range
        assoc = torch.where(active, assoc, m)
    else:
        assoc = assoc_cmd

    # --- faults (stream 5; run_faults's body) ---
    if cfg.faults is not None:
        slow = faults_mod.straggler_slowdowns(cfg.faults, draws.slow_u,
                                              draws.slow_exp,
                                              rate=row.straggler)
        bad = faults_mod.outage_step(cfg.faults, draws.outage_u, state.bad,
                                     rate=row.outage)
        up_eff = faults_mod.outage_gate(cfg.faults, up, bad)
        b_eff = b * slow
    else:
        slow, bad, up_eff, b_eff = None, state.bad, up, b

    # --- Eq. 17: the max + max + block composition of the runners ---
    cmp_max = torch.amax(latency.t_cmp(cfg.lat, assoc, b_eff, st.data_sizes,
                                       st.freqs))
    bc_max = torch.amax(latency.t_broadcast(cfg.lat, assoc, up_eff, m))
    if cfg.consensus is not None:
        qf = torch.round(row.quorum).to(torch.int32)
        t_block = consensus_mod.consensus_time(
            cfg.lat, cfg.consensus, down, st.freqs, quorum_f=qf,
            byz_frac=row.byzantine, block_size_bits=row.block_size)
    else:
        t_block = latency.t_block_validation(cfg.lat, down, st.freqs)
    t_round = cmp_max + bc_max + t_block

    # --- chain round (stream 8; run_consensus's body) ---
    chain = st.chain
    accept = None
    if cfg.consensus is not None:
        occ = latency.twin_counts(assoc, m)
        chain, _, accept = consensus_mod.chain_round(
            cfg.consensus, st.chain, draws.sub_z, state.byz, occ)

    # --- streamed FL round: trains the pre-churn population with the
    # post-migration association, the state the latency terms priced ---
    fl_metrics = {}
    if scfg.fl is not None:
        from repro_torch.fl import stream as fl_stream

        _, fl_metrics = fl_stream.fl_round(
            scfg.fl, state.fl, plan, active=active, data_sizes=st.data_sizes,
            assoc=assoc, n_bs=m)

    # --- churn (stream 11: churn-off serving reads the runners' draws and
    # nothing else) ---
    data, assoc_next, active2 = st.data_sizes, assoc, active
    n_joined = n_left = torch.zeros((), dtype=torch.int32, device=dev)
    if scfg.churns:
        active2, data, assoc_next, n_joined, n_left = churn_step(
            cfg, scfg, draws, active, st.data_sizes, assoc, row)
        if scfg.fl is not None:
            from repro_torch.fl import stream as fl_stream

            # admitted rows warm-start from the round's new global model,
            # evicted rows go to padding
            fl_stream.fl_churn_update(state.fl, active2 & ~active,
                                      active & ~active2)

    metrics = {"round_time": t_round, "n_active": sharding.twin_count(active2),
               "n_joined": n_joined, "n_left": n_left}
    metrics.update(fl_metrics)
    if cfg.faults is not None:
        metrics["straggler_frac"] = faults_mod.straggler_frac(slow)
        metrics["outage_frac"] = torch.mean(bad.to(torch.float32))
    if cfg.migration is not None:
        load = assoc_mod.bs_loads(assoc, st.data_sizes, m)
        metrics["migration_rate"] = migration.migration_rate(assoc_cmd, assoc)
        metrics["imbalance"] = load["imbalance"]
    if cfg.consensus is not None:
        metrics["accept_frac"] = accept
        metrics["consensus_time"] = t_block
        metrics["honest_stake_share"] = consensus_mod.honest_stake_share(
            chain, state.byz)

    # --- write the state in place (after every read of the old one) ---
    st.data_sizes.copy_(data)
    st.assoc.copy_(assoc_next)
    state.active.copy_(active2)
    state.bad.copy_(bad)
    if chain is not None:
        for old, new in zip(st.chain, chain):
            old.copy_(new)
    if scfg.evolve_channels:
        evolved = env_mod.env_evolve(cfg, st, StepDraws(
            jitter=draws.jitter, up=draws.up, down=draws.down))
        for name in ("freqs", "h_up", "h_down"):
            getattr(st, name).copy_(getattr(evolved, name))
    env2 = st._replace(t=st.t + 1)
    state2 = state._replace(env=env2, round=state.round + 1)

    # --- replay (policy mode): a departed twin adds nothing to the row ---
    if scfg.policy is not None and state.buf is not None:
        from repro_torch.core.marl import replay, spaces

        reward = (-t_round).expand(m) * cfg.reward_scale
        enc = spaces.encode_action(cfg, a, obs.twin_feats)
        s2 = spaces.compact_obs(env_mod.observe(cfg, env2))
        state2 = state2._replace(buf=replay.replay_add(
            state.buf, spaces.compact_obs(obs), enc, reward, s2))
    return state2, metrics


def make_round_step(cfg: EnvConfig, scfg: ServeConfig, ts=None):
    """The streaming step ``fn(state, draws, row, plan=None) -> (state',
    metrics)``; it writes ``state`` in place. With a multi-shard ``ts`` the
    step runs under the rank's twin scope: ``state`` in the rank's layout,
    the round's draws global, the metrics replicated."""
    if ts is None or ts.n_shards == 1:
        return functools.partial(_round_step, cfg, scfg)

    def step(state, draws, row, plan=None):
        with ts.scope(cfg.n_twins):
            return _round_step(cfg, scfg, state, draws, row, plan)

    return step


# ---------------------------------------------------------------------------
# the stream loop
# ---------------------------------------------------------------------------


def _row_t(rows: StreamKnobs, t: int) -> StreamKnobs:
    """Round ``t``'s knob row: a leading stream axis is consumed one row a
    round, 0-dim knobs serve every round."""
    return StreamKnobs(*(x[t] if x.ndim else x for x in rows))


def serve_rounds(cfg: EnvConfig, scfg: ServeConfig, state: ServeState,
                 draws: RoundDraws, rows: StreamKnobs, *, n_rounds=None,
                 step=None, overlap: bool = True, ts=None, plan=None):
    """Stream rounds from ``state``: ``n_rounds`` (default the leading
    length of ``draws``).

    ``overlap=True`` (the service) reads nothing back to the host inside
    the loop: the host queues round t+1 while round t runs, each round's
    metrics go into device buffers allocated after the first round, and
    nothing is read until :func:`stack_metrics`. ``overlap=False``
    synchronises after every round; the results are the same bits.
    ``plan`` is the stream's ``FLPlan`` (needed when ``scfg.fl`` is set),
    one row a round. ``draws``, ``rows`` and ``plan`` should already be on
    the state's device: what is not is copied there first. Returns
    ``(state, metrics)``, metrics (n_rounds, ...) device tensors."""
    if step is None:
        step = make_round_step(cfg, scfg, ts)
    if scfg.fl is not None and plan is None:
        raise ValueError("ServeConfig.fl is set: serve_rounds needs the "
                         "stream's FLPlan (see fl.stream.stream_fl_plan)")
    dev = state.active.device
    if n_rounds is None:
        lens = [x.shape[0] for x in draws if x is not None]
        if not lens:
            raise ValueError("these draws are empty (no option reads a "
                             "draw): pass n_rounds")
        n_rounds = lens[0]
    draws = RoundDraws(*(None if x is None else x.to(dev) for x in draws))
    rows = _knobs_on(rows, dev)
    if plan is not None:
        from repro_torch.fl import stream as fl_stream

        plan = fl_stream.FLPlan(*(x.to(dev) for x in plan))
    out = None
    for t in range(n_rounds):
        plan_t = None if plan is None else type(plan)(*(x[t] for x in plan))
        state, m = step(state, round_draws(draws, t), _row_t(rows, t),
                        *(() if plan_t is None else (plan_t,)))
        if out is None:
            out = {k: torch.empty((n_rounds,) + tuple(v.shape),
                                  dtype=v.dtype, device=v.device)
                   for k, v in m.items()}
        for k, v in m.items():
            out[k][t].copy_(v)
        if not overlap and dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return state, out


def stack_metrics(metrics) -> dict:
    """Read a :func:`serve_rounds` metrics dict back to the host, as numpy
    arrays (this waits for the card)."""
    return {k: v.cpu().numpy() for k, v in metrics.items()}


def serve_launches(cfg: EnvConfig, scfg: ServeConfig, n_rounds: int, *,
                   n_leaves: int = 0) -> int:
    """Segment-kernel launches of ``n_rounds`` streamed rounds on the card,
    as the code makes them: a round's Eqs. 12 and 15 (2); migration's
    loads and load diagnostic (3); the chain's occupancy (1); the FedAvg
    Eq. 4 over the capacity axis (the weights and each of the model's
    ``n_leaves`` leaves); in policy mode the observe before the action and
    after the round (2 each) and the replay row's encode (3). Robust FL
    aggregators are not counted here (nor :func:`serve_init`'s chain stakes,
    1 under consensus)."""
    per_round = 2
    per_round += 3 * int(cfg.migration is not None)
    per_round += int(cfg.consensus is not None)
    if scfg.fl is not None:
        if scfg.fl.aggregator != "fedavg":
            raise ValueError("serve_launches counts the FedAvg Eq. 4 only")
        per_round += 1 + n_leaves
    if scfg.policy is not None:
        per_round += 2 + 2 + 3
    return n_rounds * per_round

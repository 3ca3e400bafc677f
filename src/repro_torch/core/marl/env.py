"""DTWN edge-association environment, the MDP of paper Section IV-A (port of
``repro/core/marl/env.py``).

State s(t) = (f^C, K, D, h): BS CPU frequencies, twins-per-BS counts, twin
data sizes, channel gains, exposed as the structured ``spaces.Observation``.
Action a_i(t) = (K_i, b_i, tau_i) per BS agent, the structured
``spaces.Action``; joint actions are projected onto the feasible set of
problem (18): argmax association (18b), softmax bandwidth (18c), clipped
batch (18d). Reward R_i = -T_i(t) (Eq. 19), or the shared -max_i T_i
(Eq. 17). Channels follow Gauss-Markov fading and CPU frequencies jitter
around their nominal values; ``env_soft_reset`` restarts the dynamics at an
episode boundary and keeps the twin population.

torch cannot repeat ``jax.random``, so every draw is an argument:
``ResetDraws`` for ``env_reset`` and ``env_soft_reset``, ``StepDraws`` for
``env_evolve`` and ``env_step``. ``sample_reset_draws`` and
``sample_step_draws`` make them from a ``torch.Generator``, in a fixed
order, on the generator's device. The step counter ``EnvState.t`` is a host
int: it counts up by one and is reset at the episode boundary, so the
trainer never asks the device for it. Every per-BS sum goes through the
segment-reduce dispatch (the hand kernel on the card).

Inside a twin scope (``core.sharding``) the twin-indexed fields are this
rank's block: a reset slices the global draws, padding rows carry
``data=0`` and ``assoc=n_bs``, and every per-BS sum all-reduces. The
``sharded_*`` entry points run the functions above over a twin mesh;
:func:`env_specs` names the twin-blocked leaves.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import association as assoc_mod
from repro_torch.core import comms, latency, sharding
from repro_torch.core import consensus as consensus_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import migration as migration_mod
from repro_torch.core.marl import spaces
from repro_torch.core.marl.spaces import Action, Observation
from repro_torch.core.sharding import TWIN_AXIS, P
from repro_torch.kernels.segment_reduce import segment_count, segment_reduce


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    n_twins: int = 100
    n_bs: int = 5
    wireless: comms.WirelessConfig = dataclasses.field(
        default_factory=lambda: comms.WirelessConfig())
    lat: latency.LatencyParams = dataclasses.field(
        default_factory=lambda: latency.LatencyParams())
    # paper Section V: five BSs at these max CPU frequencies (GHz)
    bs_freqs_ghz: Tuple[float, ...] = (2.6, 1.8, 3.6, 2.4, 2.4)
    data_min: float = 200.0   # samples per twin
    data_max: float = 800.0
    freq_jitter: float = 0.05
    episode_len: int = 50
    reward_scale: float = 0.02  # keeps |R| ~ O(1) so Q targets stay tame
    shared_reward: bool = True  # every agent shares -max_i T_i (Eqs. 17/19)
    # between-round twin migration: the decoded association is perturbed
    # each step before latency accounting (None: static twins)
    migration: Optional[migration_mod.MigrationConfig] = None
    # stragglers inflate the Eq. 12/13 work and a stationary outage draw
    # gates the Eq. 7 uplink before latency accounting (None: no faults)
    faults: Optional[faults_mod.FaultConfig] = None
    # one chain round a step, the PBFT block term in Eq. 17 and two chain
    # columns in the observation (None: the Eq. 16 constant, no chain)
    consensus: Optional[consensus_mod.ConsensusConfig] = None

    @property
    def wl(self) -> comms.WirelessConfig:
        """Wireless config with n_bs synced to the env's BS count; every
        channel, distance and rate goes through it."""
        if self.wireless.n_bs == self.n_bs:
            return self.wireless
        return dataclasses.replace(self.wireless, n_bs=self.n_bs)

    @property
    def action_dim(self) -> int:
        # per agent: N association scores + 1 batch control + C bandwidth bids
        return self.n_twins + 1 + self.wireless.n_subchannels

    @property
    def state_dim(self) -> int:
        """Width of the legacy flat observation (``observe_flat``), O(N)."""
        return spaces.space_spec(self).flat_obs_dim


class EnvState(NamedTuple):
    freqs: torch.Tensor       # (M,) Hz
    data_sizes: torch.Tensor  # (N,)
    h_up: torch.Tensor        # (M, C)
    h_down: torch.Tensor      # (M, C)
    dist: torch.Tensor        # (M,)
    assoc: torch.Tensor       # (N,) int32 current association
    t: int                    # step counter (host)
    # the chain view (consensus.ChainState) when cfg.consensus is set
    chain: Optional[consensus_mod.ChainState] = None


class ResetDraws(NamedTuple):
    """Draws of a reset: Exp(1) channel gains ``up`` and ``down`` (M, C),
    uniforms ``dist_u`` (M,) of the distances and, for ``env_reset`` only,
    uniforms ``data_u`` (N,) of the twin data sizes."""
    up: torch.Tensor
    down: torch.Tensor
    dist_u: torch.Tensor
    data_u: Optional[torch.Tensor] = None


class StepDraws(NamedTuple):
    """Draws of one ``env_step``: the dynamics (frequency jitter normals
    (M,), fresh Exp(1) channels ``up`` and ``down`` (M, C)); migration's
    move uniforms (N,) and Gumbels (N, M) when ``cfg.migration`` is set; the
    straggler uniforms and Exp(1) magnitudes (N,) and the outage uniforms
    (M,) when ``cfg.faults`` is set; the byzantine uniforms and submission
    normals (M,) when ``cfg.consensus`` is set. Unused fields are None."""
    jitter: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor
    move_u: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    slow_u: Optional[torch.Tensor] = None
    slow_exp: Optional[torch.Tensor] = None
    outage_u: Optional[torch.Tensor] = None
    byz_u: Optional[torch.Tensor] = None
    sub_z: Optional[torch.Tensor] = None


def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _exponential(gen, shape):
    return torch.empty(shape, device=gen.device).exponential_(generator=gen)


def sample_reset_draws(gen: torch.Generator, cfg: EnvConfig, *,
                       soft: bool = False) -> ResetDraws:
    """A reset's draws from ``gen`` on its device, in the order data (not
    for ``soft``), up, down, distances."""
    m, c = cfg.n_bs, cfg.wl.n_subchannels
    data_u = None if soft else _uniform(gen, (cfg.n_twins,))
    up = _exponential(gen, (m, c))
    down = _exponential(gen, (m, c))
    return ResetDraws(up=up, down=down, dist_u=_uniform(gen, (m,)),
                      data_u=data_u)


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _gumbel(gen, shape):
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(_uniform(gen, shape), min=tiny)))


_SAMPLERS = {"uniform": _uniform, "exponential": _exponential,
             "normal": _normal, "gumbel": _gumbel}


def step_fields(cfg: EnvConfig):
    """The ``(name, law, shape)`` of each :class:`StepDraws` field the
    config uses, in the field order; the law is ``"uniform"``,
    ``"exponential"`` (Exp(1)), ``"normal"`` or ``"gumbel"``."""
    n, m, c = cfg.n_twins, cfg.n_bs, cfg.wl.n_subchannels
    f = [("jitter", "normal", (m,)), ("up", "exponential", (m, c)),
         ("down", "exponential", (m, c))]
    if cfg.migration is not None:
        f += [("move_u", "uniform", (n,)), ("gumbel", "gumbel", (n, m))]
    if cfg.faults is not None:
        f += [("slow_u", "uniform", (n,)), ("slow_exp", "exponential", (n,)),
              ("outage_u", "uniform", (m,))]
    if cfg.consensus is not None:
        f += [("byz_u", "uniform", (m,)), ("sub_z", "normal", (m,))]
    return f


def sample_step_draws(gen: torch.Generator, cfg: EnvConfig) -> StepDraws:
    """One step's draws from ``gen`` on its device, in the field order of
    :class:`StepDraws`, drawing only the fields the config uses
    (:func:`step_fields`)."""
    return StepDraws(**{name: _SAMPLERS[law](gen, shape)
                        for name, law, shape in step_fields(cfg)})


def bs_frequencies(cfg, device=None) -> torch.Tensor:
    """Nominal BS CPU frequencies (Hz), (n_bs,) fp32. The frequency table is
    cycled when ``n_bs`` exceeds its length. A card gets it by an
    asynchronous copy from pinned memory, so an episode's reset does not
    wait for the work queued before it."""
    table = torch.as_tensor(cfg.bs_freqs_ghz, dtype=torch.float32)
    idx = torch.arange(cfg.n_bs) % table.shape[0]
    freqs = table[idx] * 1e9
    if device is not None and torch.device(device).type == "cuda":
        return freqs.pin_memory().to(device, non_blocking=True)
    return freqs.to(device)


def init_chain(cfg: EnvConfig, data_sizes, assoc):
    """Fresh chain view for a (population, association): Eq. 6 stakes from
    the hosted per-BS twin data (one segment sum). None without
    consensus."""
    if cfg.consensus is None:
        return None
    return consensus_mod.chain_init(
        cfg.consensus, latency.bs_sum(data_sizes, assoc, cfg.n_bs))


def observe(cfg: EnvConfig, st: EnvState) -> Observation:
    """Structured system state, shared by every agent (Section IV-A):
    ``bs_feats (M, 4+C)`` = [freq/3.6GHz, K_i/N, data-load share, h_up/2
    (C cols), dist/max_dist], plus [accept rate, stake share x M] under
    consensus; ``twin_feats (N, 2)`` = [D_j/data_max, D_j/mean(D)]. The K_i
    and load columns are two segment sums."""
    k_counts = segment_count(st.assoc, cfg.n_bs)
    d = st.data_sizes / cfg.data_max
    load = segment_reduce(d, st.assoc, cfg.n_bs) / torch.clamp(
        sharding.twin_sum(d), min=1e-9)
    cols = [
        (st.freqs / 3.6e9)[:, None],
        (k_counts / cfg.n_twins)[:, None],
        load[:, None],
        st.h_up / 2.0,
        (st.dist / cfg.wl.max_dist_m)[:, None],
    ]
    if cfg.consensus is not None:
        chain = (st.chain if st.chain is not None
                 else init_chain(cfg, st.data_sizes, st.assoc))
        cols.append(consensus_mod.accept_rate(chain)[:, None])
        # x M so a uniform stake distribution reads 1.0 in every row
        cols.append((consensus_mod.stake_share(chain) * cfg.n_bs)[:, None])
    bs_feats = torch.cat(cols, dim=1).to(torch.float32)
    twin_feats = torch.stack(
        [d, d * cfg.n_twins / torch.clamp(sharding.twin_sum(d), min=1e-9)],
        dim=1).to(torch.float32)
    return Observation(bs_feats=bs_feats, twin_feats=twin_feats)


def observe_flat(cfg: EnvConfig, st: EnvState) -> torch.Tensor:
    """Legacy flat observation, (state_dim,) fp32."""
    return spaces.flatten_obs(observe(cfg, st))


def _round_robin(cfg: EnvConfig, device) -> torch.Tensor:
    """The round-robin association, this rank's block inside a scope."""
    return sharding.localize(
        assoc_mod.average_association(cfg.n_twins, cfg.n_bs,
                                      device).to(torch.int32),
        fill=cfg.n_bs)


def _distances(cfg: EnvConfig, u) -> torch.Tensor:
    wl = cfg.wl
    return wl.min_dist_m + u * (wl.max_dist_m - wl.min_dist_m)


def env_reset(cfg: EnvConfig, draws: ResetDraws) -> EnvState:
    """Fresh env: a new twin population (data sizes uniform in
    [data_min, data_max]), channels and distances, round-robin
    association. Inside a twin scope ``draws.data_u`` is the global draw
    and the twin fields are this rank's block."""
    dev = draws.up.device
    data = sharding.localize(
        cfg.data_min + draws.data_u * (cfg.data_max - cfg.data_min),
        fill=0.0)
    assoc = _round_robin(cfg, dev)
    return EnvState(freqs=bs_frequencies(cfg, dev), data_sizes=data,
                    h_up=draws.up, h_down=draws.down,
                    dist=_distances(cfg, draws.dist_u), assoc=assoc, t=0,
                    chain=init_chain(cfg, data, assoc))


def env_soft_reset(cfg: EnvConfig, st: EnvState,
                   draws: ResetDraws) -> EnvState:
    """Episode boundary: fresh channels, distances, nominal frequencies,
    round-robin association, t=0 and a fresh chain view, KEEPING the twin
    population (the invariant the N-independent replay relies on).
    ``draws.data_u`` is not read."""
    dev = draws.up.device
    assoc = _round_robin(cfg, dev)
    return EnvState(freqs=bs_frequencies(cfg, dev), data_sizes=st.data_sizes,
                    h_up=draws.up, h_down=draws.down,
                    dist=_distances(cfg, draws.dist_u), assoc=assoc, t=0,
                    chain=init_chain(cfg, st.data_sizes, assoc))


def env_evolve(cfg: EnvConfig, st: EnvState, draws: StepDraws) -> EnvState:
    """Action-free dynamics: advance the Gauss-Markov channels with the
    fresh draws and jitter the CPU frequencies, as ``env_step`` does;
    population, association, distances and chain are untouched. Only the
    dynamics fields of ``draws`` are read."""
    freqs = st.freqs * (1.0 + cfg.freq_jitter * draws.jitter)
    return st._replace(
        freqs=torch.clamp(freqs, 0.5e9, 4.0e9),
        h_up=comms.evolve_channel(cfg.wl, st.h_up, draws.up),
        h_down=comms.evolve_channel(cfg.wl, st.h_down, draws.down))


def _b_for_assoc(cfg: EnvConfig, actions: Action, assoc) -> torch.Tensor:
    """Each twin takes its BS's projected (18d) batch control, (N,);
    out-of-range ids are clipped for the gather."""
    return assoc_mod.project_batch(cfg.lat, actions.b_ctl)[
        torch.clamp(assoc.long(), 0, cfg.n_bs - 1)]


def decode_actions(cfg: EnvConfig, actions: Union[Action, torch.Tensor]):
    """Project a joint action (a ``spaces.Action`` or the legacy flat
    (M, N+1+C) layout) onto the feasible set of problem (18). Returns
    ``(assoc (N,) int32, b (N,), tau (M, C))``."""
    if not isinstance(actions, Action):
        actions = spaces.unflatten_action(cfg, actions)
    assoc = sharding.mask_twins(
        assoc_mod.assoc_from_scores(actions.scores), cfg.n_bs)
    b = _b_for_assoc(cfg, actions, assoc)
    # softmax over the BS axis: each sub-channel's time shares sum to 1
    tau = assoc_mod.project_bandwidth(actions.tau * 4.0)
    return assoc, b, tau


def compare_with_baselines(cfg: EnvConfig, st: EnvState, actions,
                           n_random: int = 8, rand_assoc=None) -> dict:
    """Eq. 17 round time of the decoded joint ``actions`` against the
    paper's average and random association baselines on the state ``st``.
    ``rand_assoc`` (n_random, N) holds the random baseline's associations;
    by default they are drawn from ``torch.Generator().manual_seed(0)``.
    Returns 0-dim tensors and the decoded assoc."""
    assoc_p, b_p, tau_p = decode_actions(cfg, actions)
    dev = st.freqs.device
    up_p = comms.uplink_rate(cfg.wl, tau_p, st.h_up, st.dist)
    down = comms.downlink_rate(cfg.wl, st.h_down, st.dist)
    uni_tau = torch.full((cfg.n_bs, cfg.wl.n_subchannels), 1.0 / cfg.n_bs,
                         device=dev)
    up_u = comms.uplink_rate(cfg.wl, uni_tau, st.h_up, st.dist)
    b_mid = torch.full((cfg.n_twins,), 0.5, device=dev)

    def rt(assoc, b, up):
        return latency.round_time(cfg.lat, assoc, b, st.data_sizes,
                                  st.freqs, up, down)

    if rand_assoc is None:
        gen = torch.Generator().manual_seed(0)
        rand_assoc = torch.stack([
            assoc_mod.random_association(gen, cfg.n_twins, cfg.n_bs)
            for _ in range(n_random)])
    rand_assoc = torch.as_tensor(rand_assoc, device=dev)
    t_rnd = torch.mean(torch.stack([rt(a, b_mid, up_u) for a in rand_assoc]))
    return {"marl": rt(assoc_p, b_p, up_p),
            "average": rt(_round_robin(cfg, dev), b_mid, up_u),
            "random": t_rnd, "assoc": assoc_p}


def migrate_assoc(cfg: EnvConfig, move_u, gumbel, assoc,
                  data_sizes) -> torch.Tensor:
    """The env's migration: one ``migration_step`` on the step's draws.
    Identity when ``cfg.migration`` is None."""
    if cfg.migration is None:
        return assoc
    return migration_mod.migration_step(cfg.migration, move_u, gumbel, assoc,
                                        data_sizes, cfg.n_bs)


def env_step(cfg: EnvConfig, st: EnvState, actions, draws: StepDraws):
    """Returns ``(next_state, per_agent_reward (M,), info)``. ``actions``
    is a ``spaces.Action`` (or the legacy flat layout).

    With ``cfg.migration`` the decoded association migrates one round before
    latency accounting (``info["migration_rate"]``); with ``cfg.faults``
    straggler slowdowns scale the work ``b`` (``info["b"]`` is the effective
    fraction) and an outage draw gates the uplink
    (``info["straggler_frac"]``, ``info["outage_frac"]``); with
    ``cfg.consensus`` the Eq. 17 block term is the PBFT model and one chain
    round runs (``info["consensus_time"]``, ``info["accept_frac"]``)."""
    if not isinstance(actions, Action):
        actions = spaces.unflatten_action(cfg, actions)
    assoc, b, tau = decode_actions(cfg, actions)
    commanded = assoc
    if cfg.migration is not None:
        assoc = migrate_assoc(cfg, draws.move_u, draws.gumbel, assoc,
                              st.data_sizes)
        # each twin uses the batch control of the BS it LANDED on
        b = _b_for_assoc(cfg, actions, assoc)
    slow = bad = None
    if cfg.faults is not None:
        slow = faults_mod.straggler_slowdowns(cfg.faults, draws.slow_u,
                                              draws.slow_exp)
        b = b * slow  # stragglers inflate the realized Eq. 12/13 work
        bad = faults_mod.outage_draw(cfg.faults, draws.outage_u)
    up = comms.uplink_rate(cfg.wl, tau, st.h_up, st.dist)
    if cfg.faults is not None:
        up = faults_mod.outage_gate(cfg.faults, up, bad)
    down = comms.downlink_rate(cfg.wl, st.h_down, st.dist)
    per_bs = latency.round_time_per_bs(cfg.lat, assoc, b, st.data_sizes,
                                       st.freqs, up, down,
                                       consensus=cfg.consensus)
    system_t = latency.round_time(cfg.lat, assoc, b, st.data_sizes, st.freqs,
                                  up, down, consensus=cfg.consensus)
    chain = accept_frac = None
    if cfg.consensus is not None:
        byz = consensus_mod.draw_byzantine(draws.byz_u,
                                           cfg.consensus.byzantine_frac)
        prev_chain = (st.chain if st.chain is not None
                      else init_chain(cfg, st.data_sizes, assoc))
        occ = segment_count(assoc, cfg.n_bs)
        chain, _, accept_frac = consensus_mod.chain_round(
            cfg.consensus, prev_chain, draws.sub_z, byz, occ)
    if cfg.shared_reward:
        # Eq. 17/19: the system cost is max_i T_i and every agent shares it
        reward = (-system_t).expand(cfg.n_bs) * cfg.reward_scale
    else:
        reward = -per_bs * cfg.reward_scale  # per-agent variant (ablation)

    nxt = env_evolve(cfg, st, draws)._replace(assoc=assoc, t=st.t + 1,
                                              chain=chain)
    info = {"system_time": system_t, "assoc": assoc, "b": b, "tau": tau,
            "uplink": up}
    if cfg.migration is not None:
        info["migration_rate"] = migration_mod.migration_rate(commanded,
                                                              assoc)
    if cfg.faults is not None:
        info["straggler_frac"] = faults_mod.straggler_frac(slow)
        info["outage_frac"] = torch.mean(bad.to(torch.float32))
    if cfg.consensus is not None:
        info["consensus_time"] = latency.consensus_term(
            cfg.lat, down, st.freqs, cfg.consensus)
        info["accept_frac"] = accept_frac
    return nxt, reward, info


# ---------------------------------------------------------------------------
# twin-axis sharded entry points (repro_torch.core.sharding)
# ---------------------------------------------------------------------------
#
# Each wrapper runs the unchanged function above under the rank's twin scope.
# States and observations come back in the rank's layout: twin-indexed leaves
# are (n_local,) blocks of the padded population, the rest replicated. Fresh
# inputs (draws, action scores) are global. One shard is the no-op fast path.


def env_specs(cfg: EnvConfig) -> EnvState:
    """Which EnvState leaves are twin-blocked (``P("twin")``) and which are
    replicated (``P()``); the chain view, when the config has one, is
    replicated (M-sized)."""
    chain = (None if cfg.consensus is None else consensus_mod.ChainState(
        *(P() for _ in consensus_mod.ChainState._fields)))
    return EnvState(freqs=P(), data_sizes=P(TWIN_AXIS), h_up=P(),
                    h_down=P(), dist=P(), assoc=P(TWIN_AXIS), t=P(),
                    chain=chain)


def sharded_env_reset(ts, cfg: EnvConfig, draws: ResetDraws) -> EnvState:
    """:func:`env_reset` over a twin mesh from the global draws: the twin
    fields are this rank's block of the single-device reset (padding rows
    ``data=0``, ``assoc=n_bs``), the rest replicated."""
    if ts.n_shards == 1:
        return env_reset(cfg, draws)
    with ts.scope(cfg.n_twins):
        return env_reset(cfg, draws)


def sharded_observe(ts, cfg: EnvConfig, st: EnvState) -> Observation:
    """:func:`observe` over a twin mesh on a state in the rank's layout:
    ``bs_feats`` replicated (all-reduced per-BS statistics),
    ``twin_feats`` the rank's block."""
    if ts.n_shards == 1:
        return observe(cfg, st)
    with ts.scope(cfg.n_twins):
        return observe(cfg, st)


def sharded_env_step(ts, cfg: EnvConfig, st: EnvState, actions: Action,
                     draws: StepDraws):
    """:func:`env_step` over a twin mesh: ``st`` in the rank's layout,
    ``actions`` the structured ``Action`` with the GLOBAL ``scores`` (M, N)
    (or padded), the global step draws. Rewards and the info scalars are
    replicated; ``info["assoc"]`` and ``info["b"]`` are the rank's
    blocks."""
    if ts.n_shards == 1:
        return env_step(cfg, st, actions, draws)
    if not isinstance(actions, Action):
        raise TypeError("sharded_env_step takes the structured spaces.Action "
                        "(the flat layout is single-device only)")
    with ts.scope(cfg.n_twins):
        actions = actions._replace(
            scores=sharding.slice_local(actions.scores, axis=-1))
        return env_step(cfg, st, actions, draws)

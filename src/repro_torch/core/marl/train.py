"""MADDPG training loop for the DTWN environment (port of
``repro/core/marl/train.py``).

The reference fuses each rollout-and-update step into one ``lax.scan`` body.
Here ``train`` is a loop over :func:`train_step`, which does the same work
in the same order: OU exploration noise on the structured action, the env
transition, the replay insert of ``(compact_obs, encode_action, r,
compact_obs')``, the MADDPG update once ``i >= warmup``, and the episode's
soft reset once the env's step counter reaches ``episode_len``. Both gates
are known on the host, and so is the counter, so the loop never waits for
the device: every draw is made on the device from one
``torch.Generator(device=...)`` (:func:`sample_train_draws`, a fixed order
each step), and the trace stays on the device until the end.
``train_host_loop`` is the same loop with a per-step callback.
``train_sharded`` runs the same loop on every rank of a twin mesh under the
rank's twin scope: every draw is made in full on every rank from one
generator and each rank takes its twin block, so the ranks see the
single-device draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sharding
from repro_torch.core.marl import env as env_mod
from repro_torch.core.marl import spaces
from repro_torch.core.marl.ddpg import (DDPGConfig, MADDPGState, act,
                                        maddpg_init, maddpg_update)
from repro_torch.core.marl.env import EnvConfig, EnvState
from repro_torch.core.marl.ou_noise import ou_normals, ou_step
from repro_torch.core.marl.replay import (Replay, replay_add, replay_init,
                                          replay_sample,
                                          replay_sample_prioritized,
                                          uniform_indices)
from repro_torch.core.marl.spaces import Action, Observation
from repro_torch.kernels.segment_reduce import MAX_SEGMENTS
from repro_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    warmup: int = 48            # env steps before the first gradient update
    replay_capacity: int = 2048
    sigma0: float = 0.3         # OU noise: linear decay sigma0 -> sigma_min
    sigma_min: float = 0.02
    prioritized: bool = False   # |reward|-proportional replay sampling


class TrainState(NamedTuple):
    env: EnvState
    obs: Observation
    agent: MADDPGState
    buf: Replay
    noise: Action               # OU state, same structure as the action


class TrainDraws(NamedTuple):
    """One training step's draws: the OU normals (an Action of normals), the
    env step's ``StepDraws``, the replay sample (row indices, or uniforms
    for the prioritized sampler) and the soft reset's ``ResetDraws``."""
    noise: Action
    env: env_mod.StepDraws
    sample: torch.Tensor
    reset: env_mod.ResetDraws


def sample_train_draws(gen: torch.Generator, cfg: EnvConfig,
                       dcfg: DDPGConfig, tcfg: TrainConfig,
                       ts: TrainState) -> TrainDraws:
    """Step ``ts``'s draws from ``gen`` on its device, in the field order of
    :class:`TrainDraws`. All are drawn every step, used or not, so the
    stream does not depend on the gates. The uniform sampler's indices
    cover the rows the buffer will hold after this step's insert. Inside a
    twin scope the OU score normals are drawn (M, N) in full and sliced to
    this rank's columns (the reference's ``_ou_step``)."""
    template = ts.noise
    if sharding.in_scope() is not None:
        template = template._replace(scores=torch.empty(
            (cfg.n_bs, cfg.n_twins), device="meta"))
    noise = ou_normals(gen, template)
    noise = noise._replace(scores=sharding.localize(noise.scores, axis=-1))
    step = env_mod.sample_step_draws(gen, cfg)
    if tcfg.prioritized:
        sample = torch.rand((dcfg.batch_size,), generator=gen,
                            device=gen.device)
    else:
        cap = ts.buf.state.shape[0]
        sample = uniform_indices(
            gen, ts.buf._replace(size=min(ts.buf.size + 1, cap)),
            dcfg.batch_size)
    reset = env_mod.sample_reset_draws(gen, cfg, soft=True)
    return TrainDraws(noise=noise, env=step, sample=sample, reset=reset)


def train_init(cfg: EnvConfig, dcfg: DDPGConfig, tcfg: TrainConfig,
               gen: torch.Generator) -> TrainState:
    """Fresh TrainState on ``gen``'s device, drawn from ``gen``: the env
    reset, then the stacked-agent MADDPG parameters; an empty compact
    replay and an all-zero OU noise Action."""
    dev = gen.device
    st = env_mod.env_reset(cfg, env_mod.sample_reset_draws(gen, cfg))
    spec = spaces.space_spec(cfg)
    return TrainState(
        env=st, obs=env_mod.observe(cfg, st),
        agent=maddpg_init(cfg, dcfg, gen),
        buf=replay_init(tcfg.replay_capacity, spec.compact_dim, cfg.n_bs,
                        spec.enc_dim, dev),
        noise=spaces.zeros_action(cfg, dev))


def _sigma(tcfg: TrainConfig, i: int) -> float:
    """The OU scale of step ``i``, in fp32 arithmetic as the reference's
    scan computes it."""
    frac = np.float32(i) / np.float32(max(tcfg.steps, 1))
    return float(np.maximum(np.float32(tcfg.sigma0) * (np.float32(1.0) - frac),
                            np.float32(tcfg.sigma_min)))


def _step(cfg, dcfg, tcfg, ts: TrainState, i: int, draws: TrainDraws):
    with torch.no_grad():
        noise = ou_step(ts.noise, draws.noise, sigma=_sigma(tcfg, i))
        joint = act(cfg, ts.agent, ts.obs, policy=dcfg.policy)
        a = spaces.clip_action(Action(*(x + n for x, n in zip(joint, noise))))
        env2, r, info = env_mod.env_step(cfg, ts.env, a, draws.env)
        obs2 = env_mod.observe(cfg, env2)
        twin_feats = ts.obs.twin_feats
        buf = replay_add(ts.buf, spaces.compact_obs(ts.obs),
                         spaces.encode_action(cfg, a, twin_feats), r,
                         spaces.compact_obs(obs2))
    agent = ts.agent
    zero = torch.zeros((), device=r.device)
    closs = aloss = zero
    if i >= tcfg.warmup:
        sampler = (replay_sample_prioritized if tcfg.prioritized
                   else replay_sample)
        agent, m = maddpg_update(cfg, dcfg, agent,
                                 sampler(buf, draws.sample, dcfg.batch_size),
                                 twin_feats)
        closs, aloss = m["critic_loss"], m["actor_loss"]
    # episode boundary: soft-reset the dynamics (same twin population); the
    # replay row above keeps the true pre-reset next state
    env_next, obs_next = env2, obs2
    if cfg.episode_len > 0 and env2.t >= cfg.episode_len:
        with torch.no_grad():
            env_next = env_mod.env_soft_reset(cfg, env2, draws.reset)
            obs_next = env_mod.observe(cfg, env_next)
    metrics = {"system_time": info["system_time"], "reward": torch.mean(r),
               "critic_loss": closs, "actor_loss": aloss}
    return (TrainState(env=env_next, obs=obs_next, agent=agent, buf=buf,
                       noise=noise), metrics, info)


def train_step(cfg: EnvConfig, dcfg: DDPGConfig, tcfg: TrainConfig,
               ts: TrainState, i: int, draws: TrainDraws) -> tuple:
    """One rollout-and-update step at step index ``i`` (the noise schedule
    and the warmup gate read it) with the step's ``draws``. Returns
    ``(next TrainState, metrics)``, metrics as 0-dim device tensors."""
    ts, metrics, _ = _step(cfg, dcfg, tcfg, ts, i, draws)
    return ts, metrics


def train(cfg: EnvConfig, dcfg: DDPGConfig, tcfg: TrainConfig,
          seed: int = 0, *, device=None, on_step=None) -> tuple:
    """Run ``tcfg.steps`` training steps from ``seed`` on ``device``
    (``cuda`` by default; it raises without a card). Returns ``(final
    TrainState, trace)`` with trace a dict of (steps,) device tensors:
    system_time, reward, critic_loss, actor_loss. ``on_step(i, info)``, if
    given, is called after every step with the env step's info dict."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ts = train_init(cfg, dcfg, tcfg, gen)
    trace = {k: [] for k in ("system_time", "reward", "critic_loss",
                             "actor_loss")}
    for i in range(tcfg.steps):
        draws = sample_train_draws(gen, cfg, dcfg, tcfg, ts)
        ts, metrics, info = _step(cfg, dcfg, tcfg, ts, i, draws)
        for k in trace:
            trace[k].append(metrics[k])
        if on_step is not None:
            on_step(i, info)
    empty = torch.zeros((0,), device=dev)
    return ts, {k: torch.stack(v) if v else empty for k, v in trace.items()}


def train_host_loop(cfg: EnvConfig, dcfg: DDPGConfig, tcfg: TrainConfig,
                    seed: int = 0, *, device=None,
                    on_step=None) -> TrainState:
    """:func:`train`'s loop with ``on_step(i, info)`` called after every env
    transition; returns the final TrainState."""
    return train(cfg, dcfg, tcfg, seed, device=device, on_step=on_step)[0]


def train_sharded(tsh, cfg: EnvConfig, dcfg: DDPGConfig, tcfg: TrainConfig,
                  seed: int = 0, *, on_step=None) -> tuple:
    """:func:`train` with the twin population sharded over a twin mesh, on
    the mesh's device.

    Each rank runs the whole loop under its twin scope: the env's twin
    block, its (N_local, F) twin features and the (M, N_local) score noise
    are the rank's; the MADDPG parameters, their optimizer state, the
    replay buffer and the generator are replicated (replay rows hold
    all-reduced (M, E) encodings and compact states, never twin data). The
    ranks meet only in M-sized all-reduces and the two gradient means of an
    update (``sharding.pmean_in_scope``). Every draw is the single-device
    draw, sliced.

    Only the ``"factorized"`` policy shards: the flat one's first layer
    scales with N. ``n_shards == 1`` is the no-op fast path, ``train``
    itself. Returns ``(TrainState, trace)`` like :func:`train`, the state's
    twin leaves in the rank's layout and the trace replicated."""
    if tsh.n_shards == 1:
        return train(cfg, dcfg, tcfg, seed, device=tsh.device,
                     on_step=on_step)
    if dcfg.policy != "factorized":
        raise ValueError(
            f"train_sharded supports the N-independent 'factorized' policy "
            f"only (got policy={dcfg.policy!r}: its parameters scale with "
            f"the twin count, so ranks cannot hold replicas)")
    with tsh.scope(cfg.n_twins):
        return train(cfg, dcfg, tcfg, seed, device=tsh.device,
                     on_step=on_step)


def marl_train_launches(cfg: EnvConfig, dcfg: DDPGConfig,
                        tcfg: TrainConfig) -> int:
    """Segment-kernel launches of one :func:`train` run, as the code makes
    them.

    Init: the reset's observe (2) and, under consensus, its chain stakes
    (1). Every step: the Eq. 12 and 15 sums of ``round_time_per_bs`` and of
    ``round_time`` (4), the next observe (2), the replay row's encode (3),
    migration's loads (1) and the chain round's occupancy (1) when set. An
    update (``i >= warmup``): 3 grouped calls over the B target actions and
    3 over the M*B actor-loss actions, each ``ceil(groups / (MAX_SEGMENTS
    // M))`` launches (``segment_reduce.MAX_SEGMENTS``). An episode
    boundary: the observe (2) and the chain stakes (1) under consensus. The
    backward launches nothing (a gather).
    """
    m, b = cfg.n_bs, dcfg.batch_size
    chain = int(cfg.consensus is not None)
    per_call = max(MAX_SEGMENTS // m, 1)
    update = 3 * (-(-b // per_call) + -(-(m * b) // per_call))
    per_step = 4 + 2 + 3 + int(cfg.migration is not None) + chain
    updates = max(tcfg.steps - tcfg.warmup, 0)
    resets = (tcfg.steps // cfg.episode_len) if cfg.episode_len > 0 else 0
    return (2 + chain + tcfg.steps * per_step + updates * update
            + resets * (2 + chain))

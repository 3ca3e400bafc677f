"""Multi-agent DDPG (MADDPG-style) for edge association, paper Section IV-B
(port of ``repro/core/marl/ddpg.py``).

Each BS agent i has an actor pi_i(s) and a critic Q_i(s, a_1..a_M); the
critics see the compact (M, E) encoding of the joint action. Updates follow
Eqs. 22-25: the deterministic policy gradient for the actors, TD(0) targets
from the target networks for the critics, polyak soft target updates.
Replay batches are ``(s_c, enc, r, s2_c)`` with compact states. The actor
update re-derives every agent's action from the sampled state with the
current policies and substitutes agent i's differentiable action.

Parameters are stacked with a leading agent axis; the policies are applied
with ``torch.func.vmap`` over agents and batch rows, and the encodes of a
batch go through ``spaces.encode_action`` (one grouped segment
call per statistic, whose backward carries the actor gradient to the
winning agent). The optimizer is written out (SGD with momentum after one
global-norm clip over every agent's gradients), as in the reference, so the
port stays close to it: no ``torch.optim``.

Inside a twin scope (the sharded trainer) both gradients go through
``sharding.pmean_in_scope`` where the reference stamps them: a rank's
gradient holds ``n_shards`` times its own twin block's share, and the mean
over the ranks is the single-device gradient (``core.sharding``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import sharding
from repro_torch.core.marl import networks as nets
from repro_torch.core.marl.spaces import (Action, Observation,
                                          encode_action, obs_from_compact,
                                          space_spec)
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    gamma: float = 0.9          # paper Fig. 7: gamma=0.9 performs best
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    polyak: float = 0.01        # beta in Eq. 24-25
    batch_size: int = 64
    hidden: tuple = (256, 256)
    noise_sigma: float = 0.2
    noise_theta: float = 0.15
    policy: str = "factorized"  # key into networks.POLICIES


class MADDPGState(NamedTuple):
    actor: object          # stacked (n_agents, ...) trees
    critic: object
    target_actor: object
    target_critic: object
    actor_opt: object      # SGD-with-momentum state
    critic_opt: object


def _clip_by_global_norm(grads, max_norm: float = 1.0):
    """One norm over every leaf of ``grads`` (all agents together)."""
    sq = sum(torch.sum(torch.square(g)) for g in grads)
    norm = torch.sqrt(sq + 1e-12)
    scale = torch.clamp(max_norm / norm, max=1.0)
    return [g * scale for g in grads]


def _opt_update(params, grads, mom, lr, beta=0.9):
    """Momentum SGD on ``params`` with ``grads`` (leaves in
    ``tree_leaves`` order) after the global-norm clip."""
    grads = _clip_by_global_norm(grads)
    new_mom = [beta * m + g for m, g in zip(tree_leaves(mom), grads)]
    new_params = [p - lr * m for p, m in zip(tree_leaves(params), new_mom)]
    return (tree_unflatten_like(params, new_params),
            tree_unflatten_like(mom, new_mom))


def maddpg_init(cfg, dcfg: DDPGConfig, gen: torch.Generator) -> MADDPGState:
    """Stacked-agent MADDPG parameters for ``cfg: EnvConfig``, drawn from
    ``gen`` on its device: per BS one actor of the configured policy, then
    its critic."""
    spec = space_spec(cfg)
    actors, critics = [], []
    for _ in range(spec.n_bs):
        actors.append(nets.policy_init(dcfg.policy, gen, cfg, dcfg.hidden))
        critics.append(nets.critic_init(gen, spec.compact_dim,
                                        spec.n_bs * spec.enc_dim,
                                        dcfg.hidden))

    def stack(trees):
        return tree_map(lambda *xs: torch.stack(xs), *trees)

    actor, critic = stack(actors), stack(critics)
    return MADDPGState(
        actor=actor, critic=critic,
        target_actor=tree_map(torch.clone, actor),
        target_critic=tree_map(torch.clone, critic),
        actor_opt=tree_map(torch.zeros_like, actor),
        critic_opt=tree_map(torch.zeros_like, critic))


def act(cfg, state: MADDPGState, obs: Observation, *,
        policy: str = "factorized") -> Action:
    """Joint structured action (Eq. 21 without noise): every agent's actor on
    the shared observation; leaves gain a leading M axis."""
    return torch.func.vmap(
        lambda p: nets.policy_apply(policy, cfg, p, obs))(state.actor)


def _act_rows(cfg, policy, actors, rows, twin_feats) -> Action:
    """Every agent's action on every compact row: leaves (M, B, ...)."""
    def one(p, row):
        return nets.policy_apply(policy, cfg, p,
                                 obs_from_compact(cfg, row, twin_feats))

    return torch.func.vmap(torch.func.vmap(one, in_dims=(None, 0)),
                           in_dims=(0, None))(actors, rows)


def _batch_major(a: Action) -> Action:
    """(M, B, ...) leaves -> (B, M, ...)."""
    return Action(*(x.transpose(0, 1) for x in a))


def _critics(critic, state_c, enc, enc_dim=None):
    """Every agent's critic: ``enc`` (B, M*E) shared, or (M, B, M*E) one
    per agent (``enc_dim=0``) -> Q (M, B)."""
    return torch.func.vmap(nets.critic_apply, in_dims=(0, None, enc_dim))(
        critic, state_c, enc)


def _requiring_grad(tree):
    return tree_map(lambda p: p.detach().requires_grad_(), tree)


def critic_loss_and_grads(cfg, dcfg: DDPGConfig, st: MADDPGState, batch,
                          twin_feats):
    """Eq. 23 TD losses of every critic, (M,), and their gradients (leaves
    of ``st.critic`` in ``tree_leaves`` order)."""
    s_c, enc, r, s2_c = batch
    B, M, E = enc.shape
    with torch.no_grad():
        a2 = _batch_major(_act_rows(cfg, dcfg.policy, st.target_actor, s2_c,
                                    twin_feats))
        e2 = encode_action(cfg, a2, twin_feats).reshape(B, M * E)
        y = r.T + dcfg.gamma * _critics(st.target_critic, s2_c, e2)  # (M, B)
    critic = _requiring_grad(st.critic)
    q = _critics(critic, s_c, enc.reshape(B, M * E))
    loss = torch.mean((q - y) ** 2, dim=1)
    return loss, torch.autograd.grad(loss.sum(), tree_leaves(critic))


def actor_loss_and_grads(cfg, dcfg: DDPGConfig, actor, critic, s_c,
                         twin_feats):
    """Eq. 22 losses -mean Q_i(s, pi_1(s)..pi_i(s)..pi_M(s)), (M,), with
    agent i's slot differentiable, and their gradients (leaves of ``actor``
    in ``tree_leaves`` order). The other agents' actions are detached and
    the M losses share no parameters, so one backward of their sum gives
    each agent its own gradient. The gradient reaches the winning agent
    through the grouped segment call's backward."""
    M, B = tree_leaves(actor)[0].shape[0], s_c.shape[0]
    with torch.no_grad():
        base = _batch_major(_act_rows(cfg, dcfg.policy, actor, s_c,
                                      twin_feats))            # (B, M_j, ...)
    actor = _requiring_grad(actor)
    mine = _act_rows(cfg, dcfg.policy, actor, s_c, twin_feats)  # (M_i, B, ...)
    sel = torch.eye(M, dtype=torch.bool, device=s_c.device)     # (i, j)
    joint = Action(
        scores=torch.where(sel[:, None, :, None], mine.scores[:, :, None],
                           base.scores[None]),
        b_ctl=torch.where(sel[:, None, :], mine.b_ctl[:, :, None],
                          base.b_ctl[None]),
        tau=torch.where(sel[:, None, :, None], mine.tau[:, :, None],
                        base.tau[None]))             # (M_i, B, M_j, ...)
    e = encode_action(cfg, joint, twin_feats)
    q = _critics(tree_map(torch.detach, critic), s_c,
                 e.reshape(M, B, -1), enc_dim=0)
    loss = -torch.mean(q, dim=1)
    return loss, torch.autograd.grad(loss.sum(), tree_leaves(actor))


def maddpg_update_impl(cfg, dcfg: DDPGConfig, st: MADDPGState, batch,
                       twin_feats) -> tuple:
    """One gradient step for all agents over a compact replay batch
    ``(s_c (B, compact_dim), enc (B, M, E), r (B, M), s2_c)``;
    ``twin_feats`` is the episode's static (N, F) matrix. The actor loss
    uses the just-updated critic. Returns ``(new_state, {"critic_loss",
    "actor_loss"})`` with 0-dim device tensors (no host sync)."""
    closs, cgrads = critic_loss_and_grads(cfg, dcfg, st, batch, twin_feats)
    cgrads = sharding.pmean_in_scope(list(cgrads))
    with torch.no_grad():
        critic, c_opt = _opt_update(st.critic, cgrads, st.critic_opt,
                                    dcfg.critic_lr)
    aloss, agrads = actor_loss_and_grads(cfg, dcfg, st.actor, critic,
                                         batch[0], twin_feats)
    agrads = sharding.pmean_in_scope(list(agrads))
    with torch.no_grad():
        actor, a_opt = _opt_update(st.actor, agrads, st.actor_opt,
                                   dcfg.actor_lr)
        beta = dcfg.polyak

        def soft(t, p):
            return tree_map(lambda tt, pp: (1.0 - beta) * tt + beta * pp,
                            t, p)

        new = MADDPGState(
            actor=actor, critic=critic,
            target_actor=soft(st.target_actor, actor),
            target_critic=soft(st.target_critic, critic),
            actor_opt=a_opt, critic_opt=c_opt)
    return new, {"critic_loss": torch.mean(closs.detach()),
                 "actor_loss": torch.mean(aloss.detach())}


# the reference jits ``maddpg_update_impl`` into ``maddpg_update``; the port
# runs eagerly, so the two names are one function
maddpg_update = maddpg_update_impl

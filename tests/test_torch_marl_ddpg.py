"""Parity of the port's MADDPG update (``repro_torch.core.marl.ddpg``) with
the reference on the CPU: one ``maddpg_update`` from the reference's own
``maddpg_init`` (bridged) on one replay batch, at the reference tests' size
(12 twins, 3 BSs, hidden (32, 32), batch 16), once with the global-norm
clip active (critic and actor gradient norms above 1) and once with it
idle (both below 1). New parameters, targets and momentum trees at rtol
1e-5 / atol 1e-6, losses at rtol 1e-5 (fp32 products summed in other
orders). Then the port's own behaviour: the critic loss falls over 25
updates on a fixed batch (the reference's test, seeded from a
``torch.Generator``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.marl import ddpg as j_ddpg
from repro.core.marl import env as j_env
from repro_torch import bridge
from repro_torch.core.marl import ddpg as t_ddpg
from repro_torch.core.marl import env as t_env
from repro_torch.core.marl import spaces as t_sp
from repro_torch.core.marl.ddpg import _act_rows, _batch_major, _critics
from repro_torch.utils.tree import tree_leaves
from torch_marl_helpers import KEY, SMALL, cfgs, t, tree_np

B, M = 16, 3


def _norm(grads) -> float:
    return float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))


def _setup(clip: bool):
    cj, ct = cfgs(**SMALL)
    dj = j_ddpg.DDPGConfig(batch_size=B, hidden=(32, 32))
    dt = t_ddpg.DDPGConfig(batch_size=B, hidden=(32, 32))
    st_j = j_ddpg.maddpg_init(cj, dj, KEY)
    if not clip:  # a flatter critic: small actor gradients
        def flat(c):
            return c[:-1] + [{"w": c[-1]["w"] * 0.1, "b": c[-1]["b"]}]
        st_j = st_j._replace(critic=flat(st_j.critic),
                             target_critic=flat(st_j.target_critic))
    st_t = bridge.maddpg_state_from_numpy(tree_np(st_j), "cpu")
    spec = t_sp.space_spec(ct)
    ks = jax.random.split(KEY, 5)
    s = jax.random.normal(ks[0], (B, spec.compact_dim)) * 0.1
    e = jax.random.uniform(ks[1], (B, M, spec.enc_dim), minval=-1, maxval=1)
    r = -jnp.abs(jax.random.normal(ks[2], (B, M)))
    s2 = jax.random.normal(ks[3], (B, spec.compact_dim)) * 0.1
    tf = j_env.observe(cj, j_env.env_reset(cj, ks[4])).twin_feats
    if not clip:
        # rewards at the critics' own TD targets, plus a little noise: small
        # TD errors, small critic gradients
        with torch.no_grad():
            a2 = _batch_major(_act_rows(ct, dt.policy, st_t.target_actor,
                                        t(s2), t(tf)))
            e2 = t_sp.encode_action(ct, a2, t(tf)).reshape(B, -1)
            q_t = _critics(st_t.target_critic, t(s2), e2)
            q = _critics(st_t.critic, t(s), t(e).reshape(B, -1))
        noise = np.random.RandomState(0).randn(B, M).astype(np.float32)
        r = jnp.asarray((q - dt.gamma * q_t).T.numpy() + 0.01 * noise)
    return cj, ct, dj, dt, st_j, st_t, (s, e, r, s2), tf


@pytest.mark.parametrize("clip", [True, False], ids=["clip_on", "clip_off"])
def test_maddpg_update_matches_reference(clip):
    cj, ct, dj, dt, st_j, st_t, batch, tf = _setup(clip)
    batch_t = tuple(map(t, batch))
    _, cg = t_ddpg.critic_loss_and_grads(ct, dt, st_t, batch_t, t(tf))
    _, ag = t_ddpg.actor_loss_and_grads(ct, dt, st_t.actor, st_t.critic,
                                        batch_t[0], t(tf))
    assert (_norm(cg) > 1.0) == clip and (_norm(ag) > 1.0) == clip
    new_j, m_j = j_ddpg.maddpg_update(cj, dj, st_j, batch, tf)
    new_t, m_t = t_ddpg.maddpg_update(ct, dt, st_t, batch_t, t(tf))
    for k in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5)
    for f in t_ddpg.MADDPGState._fields:
        leaves_j = jax.tree_util.tree_leaves(getattr(new_j, f))
        leaves_t = tree_leaves(getattr(new_t, f))
        assert len(leaves_j) == len(leaves_t)
        for a, b in zip(leaves_j, leaves_t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
    moved = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(new_t.actor), tree_leaves(st_t.actor))]
    assert max(moved) > 0.0


def test_critic_loss_falls_over_25_updates():
    _, ct = cfgs(**SMALL)
    spec = t_sp.space_spec(ct)
    dcfg = t_ddpg.DDPGConfig(batch_size=B, critic_lr=1e-2, actor_lr=1e-3,
                             hidden=(32, 32))
    gen = torch.Generator().manual_seed(7)
    agent = t_ddpg.maddpg_init(ct, dcfg, gen)
    s = torch.randn((B, spec.compact_dim), generator=gen) * 0.1
    e = torch.rand((B, M, spec.enc_dim), generator=gen) * 2 - 1
    r = -torch.abs(torch.randn((B, M), generator=gen))
    s2 = torch.randn((B, spec.compact_dim), generator=gen) * 0.1
    twin_feats = t_env.observe(ct, t_env.env_reset(
        ct, t_env.sample_reset_draws(gen, ct))).twin_feats
    losses = []
    for _ in range(25):
        agent, metrics = t_ddpg.maddpg_update(ct, dcfg, agent, (s, e, r, s2),
                                              twin_feats)
        losses.append(float(metrics["critic_loss"]))
    assert losses[-1] < losses[0], losses[:3] + losses[-3:]
    a = t_ddpg.act(ct, agent, t_sp.obs_from_compact(ct, s[0], twin_feats),
                   policy=dcfg.policy)
    assert a.scores.shape == (M, ct.n_twins)
    assert float(a.scores.abs().max()) <= 1.0 + 1e-6

"""Parity of the port's MARL networks, OU noise and replay with the
reference on the CPU, at the reference tests' size (12 twins, 3 BSs, hidden
(32, 32)). Parameters are the reference's own ``maddpg_init``, bridged
(``bridge.maddpg_state_from_numpy``); the noise gets the reference's
normals, the samplers its indices and uniforms. Tolerances: the policies,
critics and ``act`` at rtol 1e-6 (as ``tests/test_marl.py`` holds jit
against eager) with atol 1e-6 for outputs near 0; noise at rtol 1e-6;
replay rows exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.marl import ddpg as j_ddpg
from repro.core.marl import env as j_env
from repro.core.marl import networks as j_nets
from repro.core.marl import ou_noise as j_ou
from repro.core.marl import replay as j_rep
from repro.core.marl import spaces as j_sp
from repro_torch import bridge
from repro_torch.core.marl import ddpg as t_ddpg
from repro_torch.core.marl import env as t_env
from repro_torch.core.marl import networks as t_nets
from repro_torch.core.marl import ou_noise as t_ou
from repro_torch.core.marl import replay as t_rep
from repro_torch.core.marl import spaces as t_sp
from repro_torch.utils.tree import tree_leaves, tree_map
from torch_marl_helpers import (KEY, SMALL, cfgs, env_state, ou_draws, t,
                                tree_np)

TOL = dict(rtol=1e-6, atol=1e-6)


def _agents(policy, hidden=(32, 32)):
    cj, ct = cfgs(**SMALL)
    dj = j_ddpg.DDPGConfig(policy=policy, hidden=hidden)
    st_j = j_ddpg.maddpg_init(cj, dj, KEY)
    return cj, ct, dj, st_j, bridge.maddpg_state_from_numpy(tree_np(st_j),
                                                            "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("policy", ["flat", "factorized"])
def test_policy_apply_and_act_on_bridged_params(policy):
    cj, ct, dj, st_j, st_t = _agents(policy)
    env_j = j_env.env_reset(cj, KEY)
    obs_j, obs_t = j_env.observe(cj, env_j), t_env.observe(ct, env_state(env_j))
    for i in range(3):
        pj = jax.tree_util.tree_map(lambda x: x[i], st_j.actor)
        pt = tree_map(lambda x: x[i], st_t.actor)
        want = j_nets.policy_apply(policy, cj, pj, obs_j)
        got = t_nets.policy_apply(policy, ct, pt, obs_t)
        for g, w in zip(got, want):
            _close(g, w)
        assert t_nets.actor_param_count(pt) == j_nets.actor_param_count(pj)
    got = t_ddpg.act(ct, st_t, obs_t, policy=policy)
    want = j_ddpg.act(cj, st_j, obs_j, policy=policy)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_critic_apply_on_bridged_params():
    cj, ct, dj, st_j, st_t = _agents("factorized")
    spec = t_sp.space_spec(ct)
    rs = np.random.RandomState(0)
    s = rs.randn(5, spec.compact_dim).astype(np.float32)
    e = rs.uniform(-1, 1, (5, 3 * spec.enc_dim)).astype(np.float32)
    for i in range(3):
        cp_j = jax.tree_util.tree_map(lambda x: x[i], st_j.critic)
        cp_t = tree_map(lambda x: x[i], st_t.critic)
        want = jax.vmap(lambda o, je: j_nets.critic_apply(cp_j, o, je))(
            jnp.asarray(s), jnp.asarray(e))
        _close(t_nets.critic_apply(cp_t, t(s), t(e)), want)


def test_bridge_covers_every_leaf_and_policy_signature_error():
    for policy in ("flat", "factorized"):
        _, ct, _, st_j, st_t = _agents(policy)
        for f in t_ddpg.MADDPGState._fields:
            leaves_j = jax.tree_util.tree_leaves(getattr(st_j, f))
            leaves_t = tree_leaves(getattr(st_t, f))
            assert len(leaves_j) == len(leaves_t)
            for a, b in zip(leaves_j, leaves_t):
                assert torch.equal(b, t(a))
    obs = t_env.observe(ct, t_env.env_reset(ct, t_env.sample_reset_draws(
        torch.Generator().manual_seed(0), ct)))
    flat_params = tree_map(lambda x: x[0], _agents("flat")[4].actor)
    with pytest.raises(ValueError, match="'flat' actor"):
        t_nets.policy_apply("factorized", ct, flat_params, obs)
    with pytest.raises(ValueError, match="policy must be one of"):
        t_nets.policy_init("attention", torch.Generator(), ct)


def test_port_init_shapes_match_reference():
    """The port's own init (torch.Generator draws) has the reference's
    keys and shapes, for both policies."""
    for policy in ("flat", "factorized"):
        _, ct, _, st_j, _ = _agents(policy)
        mine = t_ddpg.maddpg_init(ct, t_ddpg.DDPGConfig(policy=policy,
                                                        hidden=(32, 32)),
                                  torch.Generator().manual_seed(0))
        assert ([tuple(x.shape) for x in tree_leaves(mine)]
                == [x.shape for x in jax.tree_util.tree_leaves(st_j)])


def test_ou_step_with_reference_normals():
    cj, ct = cfgs(**SMALL)
    state_j = j_sp.zeros_action(cj)
    state_t = t_sp.zeros_action(ct)
    for i in range(4):
        key = jax.random.fold_in(KEY, i)
        eps = ou_draws(state_j, key)
        state_j = j_ou.ou_step(state_j, key, sigma=0.3)
        state_t = t_ou.ou_step(state_t, eps, sigma=0.3)
        for g, w in zip(state_t, state_j):
            _close(g, w, dict(rtol=1e-6, atol=1e-7))
    x = t_ou.ou_init((4,), mu=0.0) + 10.0
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        x = t_ou.ou_step(x, gen, sigma=0.05)
    assert float(x.abs().max()) < 3.0


def _filled(cap, n_rows, rs):
    buf_j = j_rep.replay_init(cap, 3, 2, 5)
    buf_t = t_rep.replay_init(cap, 3, 2, 5)
    for i in range(n_rows):
        row = (np.full(3, i, np.float32), rs.randn(2, 5).astype(np.float32),
               (rs.rand(2) * (10.0 if i == 1 else 0.1)).astype(np.float32),
               rs.randn(3).astype(np.float32))
        buf_j = j_rep.replay_add(buf_j, *map(jnp.asarray, row))
        buf_t = t_rep.replay_add(buf_t, *map(t, row))
    return buf_j, buf_t


@pytest.mark.parametrize("cap,n_rows", [(4, 6), (8, 3), (8, 0)])
def test_replay_ring_and_samplers_with_reference_draws(cap, n_rows):
    buf_j, buf_t = _filled(cap, n_rows, np.random.RandomState(cap + n_rows))
    assert (buf_t.ptr, buf_t.size) == (int(buf_j.ptr), int(buf_j.size))
    for a, b in zip(buf_t[:4], buf_j[:4]):
        assert torch.equal(a, t(b))
    assert t_rep.replay_row_bytes(buf_t) == j_rep.replay_row_bytes(buf_j)
    key = jax.random.PRNGKey(cap)
    idx = jax.random.randint(key, (16,), 0, max(int(buf_j.size), 1))
    for a, b in zip(t_rep.replay_sample(buf_t, t(idx), 16),
                    j_rep.replay_sample(buf_j, key, 16)):
        assert torch.equal(a, t(b))
    u = jax.random.uniform(key, (64,))
    got = t_rep.replay_sample_prioritized(buf_t, t(u), 64)
    for a, b in zip(got, j_rep.replay_sample_prioritized(buf_j, key, 64)):
        assert torch.equal(a, t(b))
    if n_rows == 0:  # an empty buffer samples its last (all-zero) row
        assert not got[0].any()


def test_samplers_draw_from_a_generator():
    _, buf = _filled(8, 8, np.random.RandomState(0))
    gen = torch.Generator().manual_seed(1)
    s, e, r, s2 = t_rep.replay_sample(buf, gen, 256)
    assert s.shape == (256, 3) and e.shape == (256, 2, 5)
    hot = t_rep.replay_sample_prioritized(buf, gen, 256)[0]
    assert float((hot[:, 0] == 1.0).float().mean()) > 0.5

"""The MARL controller's twin-scope forms on gloo ranks on the CPU: the
compact action encoding and the pooled twin statistics (``spaces``) on 4
ranks against the reference single-device at rtol 1e-5, and one MADDPG
update on 3 ranks against the reference's single-device update.

The gradient convention: the scope's SUM all-reduce is differentiable and
its backward all-reduces the cotangent, so a rank's gradient of a
replicated parameter holds the replicated part plus ``n_shards`` times its
own twin block's share, and only the mean over the ranks
(``sharding.pmean_in_scope``, which ``ddpg.maddpg_update_impl`` applies) is
the single-device gradient. The test shows both halves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.marl import ddpg as j_ddpg
from repro.core.marl import env as j_env
from repro.core.marl import spaces as j_sp
from repro_torch import bridge
from repro_torch.core.marl import ddpg as t_ddpg
from repro_torch.core.marl import env as t_env
from repro_torch.core.marl import spaces as t_sp
from repro_torch.utils.tree import tree_leaves
from torch_sharding_helpers import encode_ranks, grad_ranks, spawn

N, M = 37, 5


def _inputs(lead=()):
    rs = np.random.RandomState(11)
    cfg = t_env.EnvConfig(n_twins=N, n_bs=M)
    c = cfg.wl.n_subchannels
    f = np.float32
    return (cfg, rs.uniform(-1, 1, lead + (M, N)).astype(f),
            rs.uniform(0.1, 2.0, (N, 2)).astype(f),
            rs.uniform(-1, 1, lead + (M,)).astype(f),
            rs.uniform(-1, 1, lead + (M, c)).astype(f))


@pytest.fixture(scope="module")
def encoded():
    cfg, sc, tf, b, tau = _inputs((3,))
    return spawn(encode_ranks, 4, cfg, torch.tensor(sc), torch.tensor(tf),
                 torch.tensor(b), torch.tensor(tau))


@pytest.mark.parametrize("row", range(3))
def test_encode_action_in_scope_matches_reference(row, encoded):
    """Three joint actions through the grouped segment calls at once (a
    leading axis), each against the reference's single-device encode."""
    cfg, sc, tf, b, tau = _inputs((3,))
    jc = j_env.EnvConfig(n_twins=N, n_bs=M)
    want = j_sp.encode_action(
        jc, j_sp.Action(jnp.asarray(sc[row]), jnp.asarray(b[row]),
                        jnp.asarray(tau[row])), jnp.asarray(tf))
    for r in encoded:
        assert torch.equal(r["enc"], encoded[0]["enc"])
        np.testing.assert_allclose(r["enc"][row].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_pool_twins_in_scope_matches_reference(encoded):
    _, _, tf, _, _ = _inputs((3,))
    want = j_sp.pool_twins(jnp.asarray(tf))
    for r in encoded:
        np.testing.assert_allclose(r["pool"].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


GEO = dict(n_twins=23, n_bs=3, bs_freqs_ghz=(2.6, 1.8, 3.6))


@pytest.fixture(scope="module")
def grads():
    """One update from the reference's ``maddpg_init`` (bridged) on a
    seeded batch: the reference's ``maddpg_update``, the port's
    single-device gradients, and the ranks'."""
    jc, cfg = j_env.EnvConfig(**GEO), t_env.EnvConfig(**GEO)
    dj = j_ddpg.DDPGConfig(batch_size=8, hidden=(32, 32))
    dcfg = t_ddpg.DDPGConfig(batch_size=8, hidden=(32, 32))
    st_j = j_ddpg.maddpg_init(jc, dj, jax.random.PRNGKey(0))
    agent = bridge.maddpg_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, st_j), "cpu")
    spec = t_sp.space_spec(cfg)
    rs = np.random.RandomState(3)
    f = np.float32
    b = dcfg.batch_size
    batch = (rs.uniform(0, 1, (b, spec.compact_dim)).astype(f),
             rs.uniform(-1, 1, (b, 3, spec.enc_dim)).astype(f),
             rs.uniform(-1, 0, (b, 3)).astype(f),
             rs.uniform(0, 1, (b, spec.compact_dim)).astype(f))
    tf = rs.uniform(0.1, 2.0, (23, 2)).astype(f)
    new_j, m_j = j_ddpg.maddpg_update(jc, dj, st_j, tuple(map(jnp.asarray,
                                                             batch)),
                                      jnp.asarray(tf))
    batch, tf = tuple(map(torch.tensor, batch)), torch.tensor(tf)
    _, cg = t_ddpg.critic_loss_and_grads(cfg, dcfg, agent, batch, tf)
    _, ag = t_ddpg.actor_loss_and_grads(cfg, dcfg, agent.actor, agent.critic,
                                        batch[0], tf)
    ranks = spawn(grad_ranks, 3, cfg, dcfg, agent, batch, tf)
    return {"critic": list(cg), "actor": list(ag),
            "reference": (new_j, m_j)}, ranks


@pytest.mark.parametrize("which", ["critic", "actor"])
def test_update_gradients_equal_single_device_after_pmean(which, grads):
    """Each rank's ``maddpg_update`` against the reference's single-device
    update: the new parameters and the momenta (after one step, the
    clipped mean gradients) at rtol 1e-5 / atol 1e-6, the losses at rtol
    1e-5, as ``test_torch_marl_ddpg.py`` holds the single-device update.
    Beside it, the mean gradients and the rank mean of the raw gradients
    against the port's single-device gradients."""
    single, ranks = grads
    new_j, m_j = single["reference"]
    for r in ranks:
        np.testing.assert_allclose(float(r["metrics"][which + "_loss"]),
                                   float(m_j[which + "_loss"]), rtol=1e-5)
        for f in (which, which + "_opt"):
            leaves_j = jax.tree_util.tree_leaves(getattr(new_j, f))
            leaves_t = tree_leaves(getattr(r["update"], f))
            assert len(leaves_j) == len(leaves_t)
            for a, b in zip(leaves_j, leaves_t):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-5, atol=1e-6, err_msg=f)
        for got, want in zip(r[which], single[which]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-6)
    # the rank mean of the raw gradients is the single-device gradient
    for i, want in enumerate(single[which]):
        mean = sum(r[which + "_raw"][i] for r in ranks) / len(ranks)
        np.testing.assert_allclose(mean.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_actor_gradient_without_pmean_is_not_the_single_device_one(grads):
    """A rank's own actor gradient holds 3x its block's share: without
    ``pmean_in_scope`` the sharded trainer would train on it."""
    single, ranks = grads
    for r in ranks:
        gaps = [float(torch.max(torch.abs(g - w)))
                for g, w in zip(r["actor_raw"], single["actor"])]
        assert max(gaps) > 1e-3, gaps
    # the critic's loss reads no twin data: every rank already has it
    for r in ranks:
        for g, w in zip(r["critic_raw"], single["critic"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-7)

"""The port's MARL trainer (``repro_torch.core.marl.train``) on the CPU.

Parity: 6 ``train_step``s from the reference's own ``train_init``
(bridged), crossing the warmup (3) and an episode boundary (``episode_len``
4), each fed the reference's draws of that step in its key-split order
(``split(key, 5)``: OU normals, env step, replay sample, soft reset). The
trace at rtol 1e-5 / atol 1e-6 (losses of fp32 products summed in other
orders), the final parameters, targets and momenta at rtol 1e-4 / atol
1e-5 (three updates compound the 1e-7 differences), replay rows at rtol
1e-5 / atol 1e-6, the decoded associations exactly.

Behaviour (the reference's tests, seeded from a ``torch.Generator``): a
60-step host loop stays finite and feasible; episode resets keep the
population; the prioritized flag runs; the FL round hook's shapes. The
segment kernel's launches in a run equal ``marl_train_launches``, the
count ``chip_smoke.py`` asserts on the card.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.marl import ddpg as j_ddpg
from repro_torch import bridge
from repro_torch.core import association as t_assoc
from repro_torch.core.marl import ddpg as t_ddpg
from repro_torch.core.marl import env as t_env
from repro_torch.core.marl.replay import Replay
from repro_torch.core.marl.spaces import Action, Observation
from repro_torch.utils.tree import tree_leaves
from torch_marl_helpers import (OPTIONS, SMALL, cfgs, env_state, ou_draws,
                                reset_draws, step_draws, t, tree_np)

# the packages re-export the function ``train``: import the modules by name
j_train = importlib.import_module("repro.core.marl.train")
t_train = importlib.import_module("repro_torch.core.marl.train")
sr = importlib.import_module("repro_torch.kernels.segment_reduce")
TOY = dict(n_twins=8, n_bs=2, bs_freqs_ghz=(3.6, 1.2))


def _bridge_train_state(ts_j) -> t_train.TrainState:
    buf = ts_j.buf
    return t_train.TrainState(
        env=env_state(ts_j.env),
        obs=Observation(t(ts_j.obs.bs_feats), t(ts_j.obs.twin_feats)),
        agent=bridge.maddpg_state_from_numpy(tree_np(ts_j.agent), "cpu"),
        buf=Replay(t(buf.state), t(buf.act_enc), t(buf.reward),
                   t(buf.next_state), int(buf.ptr), int(buf.size)),
        noise=Action(*map(t, ts_j.noise)))


def _reference_draws(cj, dj, tj, ts_j) -> t_train.TrainDraws:
    """The draws the reference's ``train_step`` makes from ``ts_j.key``."""
    _, k1, k2, k3, k4 = jax.random.split(ts_j.key, 5)
    if tj.prioritized:
        sample = jax.random.uniform(k3, (dj.batch_size,))
    else:
        size = min(int(ts_j.buf.size) + 1, tj.replay_capacity)
        sample = jax.random.randint(k3, (dj.batch_size,), 0, max(size, 1))
    return t_train.TrainDraws(noise=ou_draws(ts_j.noise, k1),
                              env=step_draws(cj, k2), sample=t(sample),
                              reset=reset_draws(cj, k4, soft=True))


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "prioritized"])
def test_train_steps_match_reference(prioritized):
    cj, ct = cfgs(episode_len=4, **SMALL)
    dj = j_ddpg.DDPGConfig(batch_size=8, hidden=(32, 32))
    dt = t_ddpg.DDPGConfig(batch_size=8, hidden=(32, 32))
    kw = dict(steps=6, warmup=3, replay_capacity=16, prioritized=prioritized)
    tj, tt = j_train.TrainConfig(**kw), t_train.TrainConfig(**kw)
    ts_j = j_train.train_init(cj, dj, tj, jax.random.PRNGKey(3))
    ts_t = _bridge_train_state(ts_j)
    step_j = jax.jit(functools.partial(j_train.train_step, cj, dj, tj))
    resets = 0
    for i in range(tt.steps):
        draws = _reference_draws(cj, dj, tj, ts_j)
        ts_j, m_j = step_j(ts_j, jnp.int32(i))
        ts_t, m_t = t_train.train_step(ct, dt, tt, ts_t, i, draws)
        for k in m_j:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(ts_t.env.assoc.numpy(),
                                      np.asarray(ts_j.env.assoc))
        assert ts_t.env.t == int(ts_j.env.t)
        resets += ts_t.env.t == 0
        assert (float(m_t["critic_loss"]) != 0.0) == (i >= tt.warmup)
    assert resets == 1
    assert (ts_t.buf.ptr, ts_t.buf.size) == (6, 6)
    for a, b in zip(ts_t.buf[:4], ts_j.buf[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip(tree_leaves(ts_t.agent),
                    jax.tree_util.tree_leaves(ts_j.agent)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    for a, b in zip(ts_t.noise, ts_j.noise):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_host_loop_stays_finite_and_feasible():
    ct = t_env.EnvConfig(**TOY)
    dcfg = t_ddpg.DDPGConfig(batch_size=32, gamma=0.9, hidden=(32, 32))
    tcfg = t_train.TrainConfig(steps=60, warmup=32, replay_capacity=256)
    seen = []
    ts = t_train.train_host_loop(ct, dcfg, tcfg, 1, device="cpu",
                                 on_step=lambda i, info: seen.append(
                                     (i, float(info["system_time"]))))
    assert [i for i, _ in seen] == list(range(60))
    assert all(np.isfinite(v) for _, v in seen)
    a = t_ddpg.act(ct, ts.agent, ts.obs, policy=dcfg.policy)
    assoc, b, tau = t_env.decode_actions(ct, a)
    checks = t_assoc.check_constraints(ct.lat, assoc, b, tau, ct.n_twins,
                                       ct.n_bs)
    assert all(checks.values()), checks
    assert ts.buf.size == tcfg.steps
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(ts.agent))


def test_episode_resets_keep_population():
    ct = t_env.EnvConfig(episode_len=10, **TOY)
    dcfg = t_ddpg.DDPGConfig(batch_size=8, hidden=(16, 16))
    tcfg = t_train.TrainConfig(steps=25, warmup=5, replay_capacity=64)
    ts, trace = t_train.train(ct, dcfg, tcfg, 0, device="cpu")
    # 25 steps with resets at t=10 and t=20 -> final env.t == 5
    assert ts.env.t == tcfg.steps % ct.episode_len
    gen = torch.Generator().manual_seed(0)
    st0 = t_env.env_reset(ct, t_env.sample_reset_draws(gen, ct))
    assert torch.equal(ts.env.data_sizes, st0.data_sizes)
    assert all(v.shape == (25,) for v in trace.values())
    assert bool(torch.isfinite(trace["system_time"]).all())


def test_prioritized_flag_runs():
    ct = t_env.EnvConfig(episode_len=0, **TOY)
    dcfg = t_ddpg.DDPGConfig(batch_size=8, hidden=(16, 16))
    tcfg = t_train.TrainConfig(steps=20, warmup=4, replay_capacity=32,
                               prioritized=True)
    ts, trace = t_train.train(ct, dcfg, tcfg, 2, device="cpu")
    assert bool(torch.isfinite(trace["critic_loss"]).all())
    assert float(trace["critic_loss"][tcfg.warmup:].abs().max()) > 0.0
    assert float(trace["critic_loss"][:tcfg.warmup].abs().max()) == 0.0


def test_fl_marl_actions_hook_shapes():
    from repro_torch.fl import DTWNSystem, FLConfig

    rng = np.random.RandomState(0)
    n = 64
    data = ((rng.rand(n, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, n)),
            (rng.rand(16, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, 16)), "synthetic")
    system = DTWNSystem(FLConfig(n_users=10, n_bs=3,
                                 bs_freqs_ghz=(2.6, 1.8, 3.6),
                                 local_iters=1, batch_size=8), data,
                        device="cpu")
    env_cfg = system.marl_env_config()
    assert env_cfg.n_twins == 10 and env_cfg.n_bs == 3
    assert env_cfg.data_min == float(system.data_sizes.min())
    agent = t_ddpg.maddpg_init(env_cfg, t_ddpg.DDPGConfig(hidden=(16, 16)),
                               torch.Generator().manual_seed(7))
    assoc, b, tau = system.marl_actions(agent)
    assert assoc.shape == (10,) and b.shape == (10,)
    assert tau.shape == (3, env_cfg.wl.n_subchannels)
    assert assoc.min() >= 0 and assoc.max() < 3
    info = system.run_round(assoc, b, tau, participating_users=3)
    assert info["chain_valid"] and info["round_time_s"] > 0


@pytest.mark.parametrize("option,batch", [("plain", 8), ("plain", 80),
                                          ("migration", 8), ("faults", 8),
                                          ("consensus", 80)])
def test_segment_launches_match_the_formula(monkeypatch, option, batch):
    """The kernel backend forced and counted on the CPU, as the card runs
    it: a run's launches equal ``marl_train_launches`` (batch 80 at M = 3
    packs 74 groups a launch, so the grouped calls take 2 and 4)."""
    calls = []
    kernel = sr._IMPLS["kernel"]

    def counted(*a):
        calls.append(a[2])
        return kernel(*a)

    monkeypatch.setitem(sr._IMPLS, "kernel", counted)
    monkeypatch.setattr(sr, "resolve_backend", lambda *a, **k: "kernel")
    _, ct = cfgs(option, episode_len=4, **SMALL)
    dcfg = t_ddpg.DDPGConfig(batch_size=batch, hidden=(16, 16))
    tcfg = t_train.TrainConfig(steps=11, warmup=6, replay_capacity=32)
    t_train.train(ct, dcfg, tcfg, 0, device="cpu")
    assert len(calls) == t_train.marl_train_launches(ct, dcfg, tcfg)
    assert max(calls) <= sr.MAX_SEGMENTS


def test_full_width_launch_count():
    """chip_smoke.py's full-width run: 200 steps, warmup 48, batch 64 over
    5 BSs (44 groups a launch: 2 launches a target statistic, 8 an
    actor-loss statistic), episodes of 50."""
    n = t_train.marl_train_launches(t_env.EnvConfig(), t_ddpg.DDPGConfig(),
                                    t_train.TrainConfig())
    assert n == 2 + 200 * 9 + 152 * 3 * (2 + 8) + 4 * 2 == 6370


def test_train_sharded_raises_a10():
    """The trainer on 2 gloo ranks with the reference gate's trainer
    config (N = 23 ragged over 2, an episode boundary, updates through the
    mesh). 8 ``train_step``s in the ranks' twin scope from the reference's
    ``train_init`` (bridged), each on the reference's draws of the step,
    against the reference's ``train_step``: the trace at the gate's rtol
    2e-3 / atol 1e-5, the associations equal every step, the actor within
    1e-4 and every agent leaf at rtol 1e-4 / atol 1e-5 (as the
    single-device test above). ``train_sharded`` from a seed against the
    single-device ``train`` from the same seed, at the gate's tolerances.
    The agent and the replay are bitwise equal on both ranks
    (``assert_replicated``). The flat policy is refused."""
    from torch_sharding_helpers import join, spawn, train_ranks

    geo = dict(n_twins=23, n_bs=3, bs_freqs_ghz=(2.6, 1.8, 3.6),
               episode_len=6)
    cj, cfg = cfgs(**geo)
    dj = j_ddpg.DDPGConfig(batch_size=8, hidden=(32, 32))
    dcfg = t_ddpg.DDPGConfig(batch_size=8, hidden=(32, 32))
    kw = dict(steps=8, warmup=4, replay_capacity=32)
    tj, tcfg = j_train.TrainConfig(**kw), t_train.TrainConfig(**kw)
    ts_j = j_train.train_init(cj, dj, tj, jax.random.PRNGKey(5))
    state0 = _bridge_train_state(ts_j)
    step_j = jax.jit(functools.partial(j_train.train_step, cj, dj, tj))
    draws, want, assoc = [], [], []
    for i in range(tcfg.steps):
        draws.append(_reference_draws(cj, dj, tj, ts_j))
        ts_j, m_j = step_j(ts_j, jnp.int32(i))
        want.append(m_j)
        assoc.append(np.asarray(ts_j.env.assoc))
    st1, tr1 = t_train.train(cfg, dcfg, tcfg, 1, device="cpu")
    ranks = spawn(train_ranks, 2, cfg, dcfg, tcfg, 1, state0, draws)
    for r in ranks:
        assert r["replicated"]
        for i in range(tcfg.steps):
            for k in want[i]:
                np.testing.assert_allclose(
                    float(r["metrics"][i][k]), float(want[i][k]), rtol=2e-3,
                    atol=1e-5, err_msg=f"step {i} {k}")
            np.testing.assert_array_equal(r["assoc"][i].numpy(), assoc[i])
        diff = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
                   for a, b in zip(tree_leaves(r["agent"].actor),
                                   jax.tree_util.tree_leaves(ts_j.agent.actor)))
        assert diff < 1e-4, diff
        for a, b in zip(tree_leaves(r["agent"]),
                        jax.tree_util.tree_leaves(ts_j.agent)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
        assert (r["buf"].ptr, r["buf"].size) == (8, 8)
        # train_sharded from a seed against the single-device train
        for k in tr1:
            np.testing.assert_allclose(r["trace"][k].numpy(),
                                       tr1[k].numpy(), rtol=2e-3, atol=1e-5,
                                       err_msg=k)
        diff = max(float(torch.max(torch.abs(a - b))) for a, b in zip(
            tree_leaves(st1.agent.actor), tree_leaves(r["actor"])))
        assert diff < 1e-4, diff
    np.testing.assert_array_equal(
        join([r["data"] for r in ranks], 23).numpy(),
        st1.env.data_sizes.numpy())

    class OneShard:
        n_shards, device = 2, torch.device("cpu")

    with pytest.raises(ValueError, match="factorized"):
        t_train.train_sharded(OneShard(), cfg,
                              t_ddpg.DDPGConfig(policy="flat"), tcfg)

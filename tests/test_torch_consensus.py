"""Parity of the port's consensus core (``repro_torch.core.consensus``) with
the reference on the CPU: the device chain state against the reference's and
the port's host ledger (stakes at rtol 1e-6, as
``tests/test_consensus.py`` holds the reference), the PBFT latency terms
over a grid of fault budgets, byzantine fractions and committee counts
(rtol 1e-5, the latency model's tolerance), and a simulated chain round fed
the reference's own ``jax.random`` draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as j_cons
from repro.core import latency as j_lat
from repro_torch.core import blockchain as t_bc
from repro_torch.core import consensus as t_cons
from repro_torch.core import latency as t_lat

RTOL = 1e-5


def _np(x):
    return torch.tensor(np.asarray(x))


def _cfgs(**kw):
    return j_cons.ConsensusConfig(**kw), t_cons.ConsensusConfig(**kw)


def test_config_fields_match():
    assert ([f.name for f in j_cons.ConsensusConfig.__dataclass_fields__.values()]
            == [f.name for f in
                t_cons.ConsensusConfig.__dataclass_fields__.values()])
    assert j_cons.ConsensusConfig() == j_cons.ConsensusConfig(
        **vars(t_cons.ConsensusConfig()))


@pytest.mark.parametrize("n_groups", [1, 2])
def test_chain_state_trajectory_matches(n_groups):
    m, rounds = 5, 6
    data = [50.0, 125.0, 75.0, 100.0, 150.0]
    jc, tc = _cfgs(quorum_f=1, reward=2.0, tolerance=0.5, s_ini=100.0,
                   history=4, n_groups=n_groups)
    js = j_cons.chain_init(jc, jnp.asarray(data))
    ts = t_cons.chain_init(tc, torch.tensor(data))
    chain = t_bc.DPoSChain(m, data, s_ini=100.0, reward=2.0, tolerance=0.5,
                           n_producers=3)
    group = np.arange(m) % n_groups if n_groups > 1 else None
    rng = np.random.RandomState(5)
    for r in range(rounds):
        losses = rng.uniform(0.1, 1.2, size=m).astype(np.float32)
        losses[rng.randint(m)] += 4.0  # one outlier a round
        sub = rng.rand(m) < 0.85
        n_cli = rng.randint(1, 6, m).astype(np.float32)
        n_sus = rng.randint(0, 4, m).astype(np.float32)
        assert int(t_cons.current_producer(ts, 3)) == int(
            j_cons.current_producer(js, 3))
        if n_groups == 1:
            assert int(t_cons.current_producer(ts, 3)) == \
                chain.current_producer()
        kw_j = dict(n_clients=jnp.asarray(n_cli), n_suspect=jnp.asarray(n_sus))
        kw_t = dict(n_clients=torch.tensor(n_cli), n_suspect=torch.tensor(n_sus))
        if group is not None:
            kw_j["group"], kw_t["group"] = jnp.asarray(group), \
                torch.tensor(group)
        js, jv = j_cons.apply_round(jc, js, jnp.asarray(losses),
                                    jnp.asarray(sub), **kw_j)
        ts, tv = t_cons.apply_round(tc, ts, torch.tensor(losses),
                                    torch.tensor(sub), **kw_t)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(ts.stakes.numpy(), np.asarray(js.stakes),
                                   rtol=1e-6)
        for name in ("verdicts", "rewards"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
        assert ts.round.dtype == torch.int32 and int(ts.round) == r + 1
        np.testing.assert_allclose(t_cons.accept_rate(ts).numpy(),
                                   np.asarray(j_cons.accept_rate(js)),
                                   rtol=1e-6)
        np.testing.assert_allclose(t_cons.stake_share(ts).numpy(),
                                   np.asarray(j_cons.stake_share(js)),
                                   rtol=1e-6)
        if n_groups == 1:  # the host ledger, all submitting, no meta
            for i in range(m):
                chain.submit_model(i, {"w": np.full((2,), float(i))}, r,
                                   float(losses[i]))
            verdicts = chain.verify_round()
            chain.produce_block()
            _, v_all = t_cons.apply_round(
                tc, t_cons.chain_init(tc, torch.tensor(data)),
                torch.tensor(losses), torch.ones(m, dtype=torch.bool))
            assert verdicts == {i: bool(x) for i, x in
                                enumerate(v_all.tolist())}
    assert chain.validate_chain()


def _links(m, seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(1e6, 9e7, m).astype(np.float32),
            (rs.uniform(1.5, 3.6, m) * 1e9).astype(np.float32))


@pytest.mark.parametrize("m", [3, 5, 9])
@pytest.mark.parametrize("quorum_f", [0, 1, 3])
@pytest.mark.parametrize("byz", [0.0, 0.2, 0.6])
def test_pbft_latency_grid_matches(m, quorum_f, byz):
    down, freqs = _links(m, m * 7 + quorum_f)
    jp, tp = j_lat.LatencyParams(), t_lat.LatencyParams()
    for g in (1, 2, 3):
        jc, tc = _cfgs(quorum_f=quorum_f, byzantine_frac=byz, n_groups=g)
        for name in ("t_consensus", "t_consensus_two_tier", "consensus_time"):
            want = getattr(j_cons, name)(jp, jc, jnp.asarray(down),
                                         jnp.asarray(freqs))
            got = getattr(t_cons, name)(tp, tc, torch.tensor(down),
                                        torch.tensor(freqs))
            assert got.shape == () and got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                       err_msg=f"{name} g={g}")
    # per-scenario overrides of the config's scalars
    jc, tc = _cfgs(n_groups=2)
    over = dict(quorum_f=2, byz_frac=0.3, block_size_bits=2e6)
    for name in ("t_consensus", "t_consensus_two_tier"):
        np.testing.assert_allclose(
            float(getattr(t_cons, name)(tp, tc, torch.tensor(down),
                                        torch.tensor(freqs), **over)),
            float(getattr(j_cons, name)(jp, jc, jnp.asarray(down),
                                        jnp.asarray(freqs), **over)),
            rtol=RTOL, err_msg=name)


def test_pbft_reduces_to_eq16_and_grows_with_faults():
    down, freqs = _links(5, 1)
    tp = t_lat.LatencyParams()
    eq16 = float(t_lat.t_block_validation(tp, torch.tensor(down),
                                          torch.tensor(freqs)))
    t0 = float(t_cons.t_consensus(tp, t_cons.ConsensusConfig(quorum_f=0),
                                  torch.tensor(down), torch.tensor(freqs)))
    np.testing.assert_allclose(t0, eq16, rtol=1e-6)
    t1 = float(t_cons.t_consensus(
        tp, t_cons.ConsensusConfig(quorum_f=1, byzantine_frac=0.2),
        torch.tensor(down), torch.tensor(freqs)))
    assert t1 > eq16
    np.testing.assert_array_equal(t_cons.bs_groups(7, 3).numpy(),
                                  np.asarray(j_cons.bs_groups(7, 3)))


@pytest.mark.parametrize("n_groups", [1, 2])
def test_chain_round_with_injected_draws(n_groups):
    m = 6
    jc, tc = _cfgs(quorum_f=1, byzantine_frac=0.4, n_groups=n_groups)
    key = jax.random.PRNGKey(3)
    byz_j = j_cons.draw_byzantine(key, m, 0.4)
    byz_t = t_cons.draw_byzantine(_np(jax.random.uniform(key, (m,))), 0.4)
    np.testing.assert_array_equal(byz_t.numpy(), np.asarray(byz_j))
    occ = np.array([3, 0, 2, 5, 1, 4], np.float32)  # BS 1 submits nothing
    js = j_cons.chain_init(jc, jnp.full((m,), 100.0))
    ts = t_cons.chain_init(tc, torch.full((m,), 100.0))
    for r in range(4):
        k = jax.random.fold_in(key, r)
        z = _np(jax.random.normal(k, (m,)))
        np.testing.assert_allclose(
            t_cons.submission_losses(z, byz_t).numpy(),
            np.asarray(j_cons.submission_losses(k, byz_j)), rtol=1e-6)
        js, jv, jf = j_cons.chain_round(jc, js, k, byz_j, jnp.asarray(occ))
        ts, tv, tf = t_cons.chain_round(tc, ts, z, byz_t, torch.tensor(occ))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert float(tf) == float(jf)
        np.testing.assert_allclose(ts.stakes.numpy(), np.asarray(js.stakes),
                                   rtol=1e-6)
        np.testing.assert_array_equal(ts.verdicts.numpy(),
                                      np.asarray(js.verdicts))
    np.testing.assert_allclose(
        float(t_cons.honest_stake_share(ts, byz_t)),
        float(j_cons.honest_stake_share(js, byz_j)), rtol=1e-6)

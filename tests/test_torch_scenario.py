"""Parity of the port's scenario runners (``repro_torch.core.scenario``)
with the reference on the CPU, at S=3 scenarios of N=12 twins on M=3 BSs,
fed the reference's own ``jax.random`` draws in its key folds
(``torch_scenario_helpers``).

Tolerances: populations at rtol 1e-6 (elementwise fp32); associations
(greedy included), masks and counts exactly; fractions of counts
(straggler, outage, migration and accept fractions) at rtol 1e-6, one ulp
of a mean; round times, loads and stake shares at rtol 1e-5 (the latency
model's tolerance). The batched runners against a per-scenario loop of
the port: bitwise, with the ``segment_sum`` backend pinned (an
index-ordered scatter-add, so one scenario's sums do not depend on the
others in the launch).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import association as j_assoc
from repro.core import comms as j_comms
from repro.core import scenario as j_scn
from repro.core.marl import ddpg as j_ddpg
from repro_torch import bridge
from repro_torch.core import association as t_assoc
from repro_torch.core import scenario as t_scn
from repro_torch.core.marl import ddpg as t_ddpg
from torch_scenario_helpers import (ALL_AXES, AXES, axis_cfgs, batches,
                                    counting_kernel, pin_backend,
                                    scenario_draws)

CPU = "cpu"
LAT = dict(rtol=1e-5, atol=0)


def _close(got, want, tol=LAT):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_make_batch_axes():
    b = t_scn.make_batch(3, 5)
    assert b.seed.shape == (5,) and b.seed.dtype == torch.int64
    assert len(set(b.seed.tolist())) == 5
    for f, (lo, hi) in (("data_min", (100, 400)), ("data_max", (500, 1500)),
                        ("skew", (1, 4)), ("alpha", (0.1, 10.0))):
        x = getattr(b, f)
        assert x.shape == (5,) and x.dtype == torch.float32
        assert float(x.min()) >= lo and float(x.max()) <= hi
    for f in ("straggler", "outage", "malicious", "byzantine", "quorum",
              "block_size"):
        assert getattr(b, f) is None
    assert t_scn.make_batch(3, 5, alpha=None).alpha is None
    full = t_scn.make_batch(3, 5, malicious=(0.0, 0.5), **ALL_AXES)
    for f in ("seed", "data_min", "data_max", "skew", "alpha"):
        _eq(getattr(full, f), getattr(b, f))  # an axis never moves another
    _eq(t_scn.make_batch(3, 2).seed, b.seed[:2])
    lo, hi = ALL_AXES["block_size"]
    assert lo <= float(full.block_size.min()) <= float(
        full.block_size.max()) <= hi
    # the default draws: every row from its own streams, a prefix of more
    cfg = axis_cfgs("all")[1]
    d2 = t_scn.scenario_draws(b, cfg, ("realization", "faults"), 2, CPU)
    d3 = t_scn.scenario_draws(b, cfg, ("realization", "faults"), 3, CPU)
    _eq(d2.data_u, d3.data_u)
    _eq(d2.slow_u, d3.slow_u[:, :2])
    assert d3.slow_u.shape == (5, 3, cfg.n_twins)
    # a row's host bridge reads the population its runners draw
    _eq(t_scn.population_row(b, 4, cfg.n_twins)[0], t_scn.sample_population(
        d2.data_u[4], b.data_min[4], b.data_max[4], b.skew[4]))


@pytest.mark.parametrize("kind, mean, var", [
    ("uniform", 0.5, 1 / 12), ("exponential", 1.0, 1.0),
    ("gumbel", 0.5772157, np.pi ** 2 / 6), ("normal", 0.0, 1.0),
    (7, 3.0, 4.0)])
def test_row_stream_law(kind, mean, var):
    """The default draws' stream: a row's draws are the same whatever batch
    it sits in, later rounds never move earlier ones, other folds and seeds
    give other draws, and 40,000 draws a row have the law's mean (within 5
    standard errors) and variance (within 5%)."""
    seeds = torch.tensor([3, -5, 2**40 + 1])
    (x,) = t_scn.RowStream(seeds, 2, CPU).draw([(kind, (200, 200))])
    assert x.shape == (3, 200, 200)
    for i in range(3):
        _eq(t_scn.RowStream(seeds[i], 2, CPU).draw([(kind, (200, 200))])[0],
            x[i])
    (r2,) = t_scn.RowStream(seeds, 2, CPU).draw([(kind, (5,))], 2)
    (r3,) = t_scn.RowStream(seeds, 2, CPU).draw([(kind, (5,))], 3)
    assert r3.shape == (3, 3, 5)
    _eq(r2, r3[:, :2])
    (other,) = t_scn.RowStream(seeds, 3, CPU).draw([(kind, (200, 200))])
    assert float((other == x).double().mean()) < 0.2
    assert float((x[0] == x[1]).double().mean()) < 0.2
    x = x.double().reshape(3, -1)
    se = (var / x.shape[1]) ** 0.5
    np.testing.assert_allclose(x.mean(1).numpy(), mean, atol=5 * se)
    np.testing.assert_allclose(x.var(1).numpy(), var, rtol=0.05)


def test_row_bridges_and_stream_knobs():
    jb, tb = batches(3, malicious=(0.1, 0.6), **ALL_AXES)
    jc, tc = axis_cfgs("all")
    d = scenario_draws(jc, jb, ("realization", "malicious"))
    for i in range(3):
        sj, aj = j_scn.population_row(jb, i, jc.n_twins)
        st, at = t_scn.population_row(tb, i, tc.n_twins, data_u=d.data_u[i])
        assert st.dtype == np.float32
        _close(st, sj, dict(rtol=1e-6, atol=0))
        assert at == pytest.approx(aj, rel=1e-6)
        mj, s_j, o_j = j_scn.fault_row(jb, i, jc.n_twins)
        mt, s_t, o_t = t_scn.fault_row(tb, i, tc.n_twins, mal_u=d.mal_u[i])
        _eq(mt, mj)
        assert (s_t, o_t) == pytest.approx((s_j, o_j), rel=1e-7)
        assert t_scn.consensus_row(tb, i) == pytest.approx(
            j_scn.consensus_row(jb, i), rel=1e-7)
    for fcfg, ccfg in ((None, None), (AXES["faults"], AXES["consensus"])):
        kj = j_scn.stream_knobs(jb, fcfg=fcfg and fcfg[0],
                                ccfg=ccfg and ccfg[0], lat=jc.lat)
        kt = t_scn.stream_knobs(tb, fcfg=fcfg and fcfg[1],
                                ccfg=ccfg and ccfg[1], lat=tc.lat)
        for a, b in zip(kt, kj):
            _eq(a, b)
        _eq(t_scn.knob_row(kt, 2).skew, j_scn.knob_row(kj, 2).skew)
    clean_j, clean_t = batches(3)
    k2 = t_scn.stream_knobs(clean_t, fcfg=tc.faults)
    _eq(k2.straggler, np.full(3, tc.faults.straggler_rate, np.float32))
    _eq(t_scn.stream_knobs(clean_t).straggler, np.zeros(3))


def test_run_baselines_matches_reference():
    jb, tb = batches(3)
    jc, tc = axis_cfgs()
    want = j_scn.run_baselines(jc, jb)
    draws = scenario_draws(jc, jb, ("realization", "random"))
    got = t_scn.run_baselines(tc, tb, draws, device=CPU)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    assert got["greedy_bs_loads"].shape == (3, 3)


def test_batched_greedy_association_exactly_equal():
    """The batched greedy loop gives each scenario the reference's
    association, exactly, on the reference's realization."""
    jb, _ = batches(3)
    jc, tc = axis_cfgs()
    data, ups, want = [], [], []
    tau = np.full((3, jc.wl.n_subchannels), 1.0 / 3, np.float32)
    for i in range(3):
        st = j_scn.scenario_env(jc, jb.key[i], jb.data_min[i],
                                jb.data_max[i], jb.skew[i])
        up = j_comms.uplink_rate(jc.wl, tau, st.h_up, st.dist)
        want.append(np.asarray(j_assoc.greedy_association(
            jc.lat, st.data_sizes, st.freqs, up)))
        data.append(np.array(st.data_sizes))
        ups.append(np.array(up))
    freqs = np.array(st.freqs)
    got = t_assoc.greedy_association(tc.lat, torch.tensor(np.stack(data)),
                                      torch.tensor(freqs),
                                      torch.tensor(np.stack(ups)))
    assert got.dtype == torch.int32
    _eq(got, np.stack(want))
    _eq(t_assoc.greedy_association(tc.lat, data[1], freqs, ups[1]), want[1])


@pytest.mark.parametrize("axis", list(AXES))
def test_round_runners_match_reference(axis):
    k = 4
    jb, tb = batches(3, **ALL_AXES)
    jc, tc = axis_cfgs(axis)
    if axis == "faults":
        want = j_scn.run_faults(jc, jc.faults, jb, n_rounds=k)
        draws = scenario_draws(jc, jb, ("realization", "outage_init",
                                        "faults"), k)
        got = t_scn.run_faults(tc, tc.faults, tb, k, draws, device=CPU)
        exact = ("straggler_frac", "outage_frac")
    elif axis == "migration":
        want = j_scn.run_migration(jc, jc.migration, jb, n_rounds=k)
        draws = scenario_draws(jc, jb, ("realization", "migration"), k)
        got = t_scn.run_migration(tc, tc.migration, tb, k, draws,
                                  device=CPU)
        exact = ("migration_rates",)
    else:
        want = j_scn.run_consensus(jc, jc.consensus, jb, n_rounds=k)
        draws = scenario_draws(jc, jb, ("realization", "byzantine", "chain"),
                               k)
        got = t_scn.run_consensus(tc, tc.consensus, tb, k, draws, device=CPU)
        exact = ("accept_frac",)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == np.shape(want[key]), key
        _close(got[key], want[key],
               dict(rtol=1e-6, atol=0) if key in exact else LAT)


def test_two_tier_consensus_runner_matches_reference():
    """Two committees over 4 BSs: the two-tier PBFT term (a loop over the
    scenarios) and the grouped verify gate of the batched chains."""
    from repro.core.consensus import ConsensusConfig as JCons
    from repro_torch.core.consensus import ConsensusConfig as TCons

    k = 3
    jb, tb = batches(3, **ALL_AXES)
    jc, tc = axis_cfgs(None, n_bs=4, bs_freqs_ghz=(2.6, 1.8, 3.6, 2.4))
    jcc, tcc = JCons(quorum_f=1, n_groups=2), TCons(quorum_f=1, n_groups=2)
    want = j_scn.run_consensus(jc, jcc, jb, n_rounds=k)
    draws = scenario_draws(jc, jb, ("realization", "byzantine", "chain"), k)
    got = t_scn.run_consensus(tc, tcc, tb, k, draws, device=CPU)
    for key in want:
        _close(got[key], want[key], dict(rtol=1e-6, atol=0)
               if key == "accept_frac" else LAT)


def test_run_policy_matches_reference():
    """One shared factorized agent (the reference's, bridged) rolls out 3
    steps on every scenario of the batch."""
    jb, tb = batches(2)
    jc, tc = axis_cfgs("migration")
    dj = j_ddpg.DDPGConfig(hidden=(16, 16))
    agent_j = j_ddpg.maddpg_init(jc, dj, jax.random.PRNGKey(5))
    agent_t = bridge.maddpg_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, agent_j), CPU)
    want = j_scn.run_policy(jc, agent_j, jb, n_steps=3)
    draws = scenario_draws(jc, jb, ("realization", "rollout"), 3)
    got = t_scn.run_policy(tc, agent_t, tb, 3, draws=draws, device=CPU)
    for k in want:
        _close(got[k], want[k], dict(rtol=1e-4, atol=0))


@pytest.mark.parametrize("runner", ["baselines", "faults", "migration",
                                    "consensus"])
def test_batched_runner_equals_per_scenario_loop(monkeypatch, runner):
    """The batch's scenario axis changes nothing: each row of a 3-scenario
    call equals a 1-scenario call on that row, bit for bit
    (``segment_sum`` pinned)."""
    tb = t_scn.make_batch(1, 3, **ALL_AXES)
    tc = axis_cfgs("all")[1]
    k, kw = 3, dict(device=CPU)
    pin_backend(monkeypatch, "segment_sum")

    def run(batch):
        if runner == "baselines":
            return t_scn.run_baselines(tc, batch, **kw)
        if runner == "faults":
            return t_scn.run_faults(tc, tc.faults, batch, k, **kw)
        if runner == "migration":
            return t_scn.run_migration(tc, tc.migration, batch, k, **kw)
        return t_scn.run_consensus(tc, tc.consensus, batch, k, **kw)

    full = run(tb)
    for i in range(3):
        one = run(t_scn.ScenarioBatch(*(None if x is None else x[i:i + 1]
                                        for x in tb)))
        for key in full:
            _eq(one[key][0], full[key][i])


@pytest.mark.parametrize("runner", ["baselines", "faults", "migration",
                                    "consensus", "policy"])
def test_segment_launches_match_the_formula(monkeypatch, runner):
    """The kernel backend forced and counted on the CPU, as the card runs
    it: 80 scenarios at M = 3 pack 74 a launch, so a grouped call takes 2
    launches."""
    calls = counting_kernel(monkeypatch)
    s, k = (80, 2) if runner != "policy" else (2, 2)
    tc = axis_cfgs("all")[1]
    tb = t_scn.make_batch(2, s, **ALL_AXES)
    if runner == "baselines":
        t_scn.run_baselines(tc, tb, device=CPU)
    elif runner == "faults":
        t_scn.run_faults(tc, tc.faults, tb, k, device=CPU)
    elif runner == "migration":
        t_scn.run_migration(tc, tc.migration, tb, k, device=CPU)
    elif runner == "consensus":
        t_scn.run_consensus(tc, tc.consensus, tb, k, device=CPU)
    else:
        agent = t_ddpg.maddpg_init(tc, t_ddpg.DDPGConfig(hidden=(8, 8)),
                                   torch.Generator().manual_seed(0))
        t_scn.run_policy(tc, agent, tb, k, device=CPU)
    assert len(calls) == t_scn.scenario_launches(runner, tc, s, k)


def test_sharded_runners_raise_a10():
    """The four ``run_*_sharded`` runners on 4 gloo ranks at the reference
    gate's runner width (N = 41, M = 7; 5 scenarios, ragged over the mesh),
    3 rounds with every axis set, against the reference's single-device
    runners on their own draws at the gate's rtol 1e-5; the shardable
    baselines' load diagnostics against the reference's single-device
    ``_baselines_lite_one`` (vmapped over the scenarios), and beside it the
    port's single-device ``_baselines_lite``."""
    from torch_sharding_helpers import runner_ranks, spawn

    k = 3
    jb, tb = batches(5, **ALL_AXES)
    jc, tc = axis_cfgs("all", n_twins=41, n_bs=7)
    draws = {
        "baselines": scenario_draws(jc, jb, ("realization", "random")),
        "migration": scenario_draws(jc, jb, ("realization", "migration"), k),
        "faults": scenario_draws(jc, jb, ("realization", "outage_init",
                                          "faults"), k),
        "consensus": scenario_draws(jc, jb, ("realization", "byzantine",
                                             "chain"), k)}
    configs = {"migration": tc.migration, "faults": tc.faults,
               "consensus": tc.consensus}
    ranks = spawn(runner_ranks, 4, tc, configs, tb, draws, k)
    want = {
        "baselines": j_scn.run_baselines(jc, jb),
        "migration": j_scn.run_migration(jc, jc.migration, jb, n_rounds=k),
        "faults": j_scn.run_faults(jc, jc.faults, jb, n_rounds=k),
        "consensus": j_scn.run_consensus(jc, jc.consensus, jb, n_rounds=k)}
    lite_j = jax.vmap(functools.partial(j_scn._baselines_lite_one, jc))(
        jb.key, jb.data_min, jb.data_max, jb.skew)
    lite = t_scn._baselines_lite(tc, tb, draws["baselines"], device=CPU)
    for r in ranks:
        got = r["baselines"]
        assert set(got) == {"random", "average", "average_imbalance",
                            "average_bs_loads", "total_data"}
        for key in ("random", "average", "total_data"):
            _close(got[key], want["baselines"][key])
        for key in ("average_imbalance", "average_bs_loads"):
            _close(got[key], lite_j[key])
            _close(got[key], lite[key])
        for runner in ("migration", "faults", "consensus"):
            assert set(r[runner]) == set(want[runner])
            for key, w in want[runner].items():
                assert tuple(r[runner][key].shape) == np.shape(w), key
                _close(r[runner][key], w)

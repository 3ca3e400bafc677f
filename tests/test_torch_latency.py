"""Parity of the port's wireless, latency and association models with the
reference on the CPU: rates and the Eqs. 12-17 bill at rtol 1e-5 (fp32
elementwise math in another library), associations exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import association as j_assoc
from repro.core import comms as j_comms
from repro.core import latency as j_lat
from repro_torch.core import association as t_assoc
from repro_torch.core import comms as t_comms
from repro_torch.core import latency as t_lat

RTOL = 1e-5


def _inputs(n, m, seed):
    rs = np.random.RandomState(seed)
    return dict(
        assoc=rs.randint(0, m, n).astype(np.int32),
        b=rs.uniform(0.05, 1.0, n).astype(np.float32),
        data=rs.randint(50, 2000, n).astype(np.float32),
        freqs=(rs.uniform(1.5, 3.6, m) * 1e9).astype(np.float32),
        tau=rs.dirichlet(np.ones(m), 8).T.astype(np.float32),
        h_up=rs.exponential(size=(m, 8)).astype(np.float32),
        h_down=rs.exponential(size=(m, 8)).astype(np.float32),
        dist=rs.uniform(50, 500, m).astype(np.float32))


def _rates(x, m):
    jcfg, tcfg = j_comms.WirelessConfig(n_bs=m), t_comms.WirelessConfig(n_bs=m)
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.as_tensor(v) for k, v in x.items()}
    jr = (j_comms.uplink_rate(jcfg, J["tau"], J["h_up"], J["dist"]),
          j_comms.downlink_rate(jcfg, J["h_down"], J["dist"]))
    tr = (t_comms.uplink_rate(tcfg, T["tau"], T["h_up"], T["dist"]),
          t_comms.downlink_rate(tcfg, T["h_down"], T["dist"]))
    return J, T, jr, tr


@pytest.mark.parametrize("n,m", [(20, 3), (100, 5), (257, 9)])
def test_rates_and_round_time_match(n, m):
    x = _inputs(n, m, n + m)
    J, T, (jup, jdown), (tup, tdown) = _rates(x, m)
    np.testing.assert_allclose(tup.numpy(), np.asarray(jup), rtol=RTOL)
    np.testing.assert_allclose(tdown.numpy(), np.asarray(jdown), rtol=RTOL)
    jp, tp = j_lat.LatencyParams(), t_lat.LatencyParams()
    args_j = (J["assoc"], J["b"], J["data"], J["freqs"], jup, jdown)
    args_t = (T["assoc"], T["b"], T["data"], T["freqs"], tup, tdown)
    for name in ("round_time", "round_time_per_bs", "total_time",
                 "round_time_onehot"):
        want = np.asarray(getattr(j_lat, name)(jp, *args_j))
        got = getattr(t_lat, name)(tp, *args_t).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    pairs = [
        ("t_cmp", args_j[:4], args_t[:4]),
        ("t_cmp_onehot", args_j[:4], args_t[:4]),
        ("t_local_agg", (J["assoc"], J["freqs"]), (T["assoc"], T["freqs"])),
        ("t_local_agg_onehot", (J["assoc"], J["freqs"]),
         (T["assoc"], T["freqs"])),
        ("t_broadcast", (J["assoc"], jup, m), (T["assoc"], tup, m)),
        ("t_broadcast_onehot", (J["assoc"], jup, m), (T["assoc"], tup, m)),
        ("t_block_validation", (jdown, J["freqs"]), (tdown, T["freqs"])),
        ("consensus_term", (jdown, J["freqs"]), (tdown, T["freqs"])),
    ]
    for name, aj, at in pairs:
        want = np.asarray(getattr(j_lat, name)(jp, *aj))
        got = getattr(t_lat, name)(tp, *at).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    np.testing.assert_array_equal(
        t_lat.twin_counts(T["assoc"], m).numpy(),
        np.asarray(j_lat.twin_counts(J["assoc"], m)))


def test_consensus_workload_raises():
    """The PBFT block term: ``round_time(consensus=...)``,
    ``round_time_per_bs``, ``total_time`` and ``consensus_term`` with a
    ``ConsensusConfig`` match the reference (the name is kept from when the
    term raised)."""
    from repro.core.consensus import ConsensusConfig as JCons
    from repro_torch.core.consensus import ConsensusConfig as TCons

    x = _inputs(30, 5, 0)
    J, T, (jup, jdown), (tup, tdown) = _rates(x, 5)
    jp, tp = j_lat.LatencyParams(), t_lat.LatencyParams()
    args_j = (J["assoc"], J["b"], J["data"], J["freqs"], jup, jdown)
    args_t = (T["assoc"], T["b"], T["data"], T["freqs"], tup, tdown)
    for kw in (dict(quorum_f=0), dict(quorum_f=1, byzantine_frac=0.2),
               dict(quorum_f=2, byzantine_frac=0.5, n_groups=2,
                    block_size_bits=2e6)):
        jc, tc = JCons(**kw), TCons(**kw)
        for name in ("round_time", "round_time_per_bs", "total_time"):
            want = np.asarray(getattr(j_lat, name)(jp, *args_j, consensus=jc))
            got = getattr(t_lat, name)(tp, *args_t, consensus=tc).numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       err_msg=f"{name} {kw}")
        np.testing.assert_allclose(
            t_lat.consensus_term(tp, tdown, T["freqs"], tc).numpy(),
            np.asarray(j_lat.consensus_term(jp, jdown, J["freqs"], jc)),
            rtol=RTOL, err_msg=str(kw))


@pytest.mark.parametrize("n,m,seed", [(100, 5, 0), (37, 3, 1), (500, 8, 2)])
def test_greedy_association_exactly_equal(n, m, seed):
    x = _inputs(n, m, seed)
    x["data"][: n // 4] = x["data"][n // 4]  # ties in the largest-first order
    _, _, (jup, _), (tup, _) = _rates(x, m)
    want = np.asarray(j_assoc.greedy_association(
        j_lat.LatencyParams(), x["data"], x["freqs"], jup))
    got = t_assoc.greedy_association(t_lat.LatencyParams(), x["data"],
                                     x["freqs"], tup)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the example's fixed uplink estimate, as examples/fl_cifar10.py calls it
    want = np.asarray(j_assoc.greedy_association(
        j_lat.LatencyParams(), x["data"], x["freqs"], np.full(m, 1e8)))
    got = t_assoc.greedy_association(t_lat.LatencyParams(), x["data"],
                                     x["freqs"], np.full(m, 1e8))
    np.testing.assert_array_equal(got.numpy(), want)


def test_average_association_and_loads_equal():
    np.testing.assert_array_equal(
        t_assoc.average_association(23, 4).numpy(),
        np.asarray(j_assoc.average_association(23, 4)))
    x = _inputs(40, 5, 3)
    want = j_assoc.bs_loads(jnp.asarray(x["assoc"]), jnp.asarray(x["data"]), 5)
    got = t_assoc.bs_loads(torch.as_tensor(x["assoc"]),
                           torch.as_tensor(x["data"]), 5)
    for k in ("counts", "loads", "imbalance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL)


def test_projections_and_scores_match():
    rs = np.random.RandomState(4)
    scores = rs.normal(size=(5, 30)).astype(np.float32)
    np.testing.assert_array_equal(
        t_assoc.assoc_from_scores(torch.as_tensor(scores)).numpy(),
        np.asarray(j_assoc.assoc_from_scores(jnp.asarray(scores))))
    b_raw = rs.uniform(-1.5, 1.5, 30).astype(np.float32)
    tau_l = rs.normal(size=(5, 8)).astype(np.float32)
    jp, tp = j_lat.LatencyParams(), t_lat.LatencyParams()
    b_t = t_assoc.project_batch(tp, torch.as_tensor(b_raw))
    tau_t = t_assoc.project_bandwidth(torch.as_tensor(tau_l))
    np.testing.assert_allclose(
        b_t.numpy(), np.asarray(j_assoc.project_batch(jp, jnp.asarray(b_raw))),
        rtol=RTOL)
    np.testing.assert_allclose(
        tau_t.numpy(),
        np.asarray(j_assoc.project_bandwidth(jnp.asarray(tau_l))), rtol=RTOL)
    assoc = rs.randint(0, 5, 30)
    assert (t_assoc.check_constraints(tp, torch.as_tensor(assoc), b_t, tau_t,
                                      30, 5)
            == j_assoc.check_constraints(jp, jnp.asarray(assoc),
                                         jnp.asarray(b_t.numpy()),
                                         jnp.asarray(tau_t.numpy()), 30, 5))


def test_draws_in_range_and_seeded():
    """torch cannot repeat jax.random draws: the port's draws are held to
    their laws' supports and to their seed, not to the reference's bits."""
    cfg = t_comms.WirelessConfig(n_bs=6)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        draws.append((t_comms.sample_distances(cfg, gen),
                      t_comms.sample_channel(cfg, gen),
                      t_assoc.random_association(gen, 50, 6)))
    (dist, h, assoc), again = draws[0], draws[1]
    for a, b in zip(draws[0], again):
        assert torch.equal(a, b)
    assert dist.shape == (6,) and dist.dtype == torch.float32
    assert bool(((dist >= 50.0) & (dist <= 500.0)).all())
    assert h.shape == (6, 8) and bool((h >= 0).all())
    assert assoc.shape == (50,) and bool(((assoc >= 0) & (assoc < 6)).all())
    assert t_comms.dbm_to_watt(30.0) == j_comms.dbm_to_watt(30.0)

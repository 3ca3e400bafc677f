"""Parity of the port's fault and adversary axis (``repro_torch.core.faults``)
with the reference on the CPU.

The injectors take their draws as tensors; each test feeds the port the
reference's own ``jax.random`` draws and holds the result exactly equal
(the same fp32 comparisons and products). The robust aggregators run on
``tests/test_faults.py``'s ``GRID`` of (clients, BSs, seed) at that file's
tolerances: exact (atol 0) for the zero-knob FedAvg parity, rtol 1e-5 /
atol 1e-6 for the robust outputs. Every segment sum is pinned to the
``segment_sum`` backend on both sides (an index-ordered scatter-add in
both), so the centres that the trimmed mean peels around are bitwise equal
and near-ties break the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as j_faults
from repro.core import hierarchy as j_hier
from repro.core import latency as j_lat
from repro.core.consensus import ConsensusConfig as JCons
from repro_torch.core import faults as t_faults
from repro_torch.core import hierarchy as t_hier
from repro_torch.core import latency as t_lat
from repro_torch.core.consensus import ConsensusConfig as TCons

GRID = [(8, 2, 1), (12, 3, 2), (24, 3, 7), (15, 5, 11)]
BK = "segment_sum"


def _np(x):
    return torch.tensor(np.asarray(x))


def ref_fault_draws(key, n, m):
    """The reference's straggler and outage draws of
    ``faulty_round_time(key)``, in its key-split order."""
    k_slow, k_out = jax.random.split(key)
    k_mask, k_mag = jax.random.split(k_slow)
    return t_faults.FaultDraws(_np(jax.random.uniform(k_mask, (n,))),
                               _np(jax.random.exponential(k_mag, (n,))),
                               _np(jax.random.uniform(k_out, (m,))))


def _stacked(k, seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.normal(size=(k, 3, 4)).astype(np.float32),
            "b": rs.normal(size=(k, 5)).astype(np.float32)}


def _inputs(k, m, seed):
    rs = np.random.RandomState(seed + 100)
    return (rs.uniform(0.5, 2.0, k).astype(np.float32),
            rs.randint(0, m, k).astype(np.int32))


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, **kw):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **kw)


# ---------------------------------------------------------------------------
# injectors and the faulty round time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,rate,mal", [(0, 0.1, 0.0), (3, 0.5, 0.3),
                                           (9, 0.9, 0.7)])
def test_injectors_match_reference(seed, rate, mal):
    n, m = 257, 7
    fj = j_faults.FaultConfig(straggler_rate=rate, outage_rate=rate,
                              malicious_frac=mal, burst_len=2.5)
    ft = t_faults.FaultConfig(straggler_rate=rate, outage_rate=rate,
                              malicious_frac=mal, burst_len=2.5)
    key = jax.random.PRNGKey(seed)
    k_slow, k_mal = jax.random.split(key)
    k_mask, k_mag = jax.random.split(k_slow)
    u = _np(jax.random.uniform(k_mask, (n,)))
    e = _np(jax.random.exponential(k_mag, (n,)))
    slow_j, mal_j = j_faults.fault_draws(fj, key, n)
    slow_t, mal_t = t_faults.fault_draws(
        ft, u, e, _np(jax.random.uniform(k_mal, (n,))))
    np.testing.assert_array_equal(slow_t.numpy(), np.asarray(slow_j))
    np.testing.assert_array_equal(mal_t.numpy(), np.asarray(mal_j))
    assert float(t_faults.straggler_frac(slow_t)) == float(
        j_faults.straggler_frac(slow_j))
    # a per-row rate overrides the config
    np.testing.assert_array_equal(
        t_faults.straggler_slowdowns(ft, u, e, rate=0.25).numpy(),
        np.asarray(j_faults.straggler_slowdowns(fj, k_slow, n, rate=0.25)))
    # the Gilbert-Elliott chain: marginal, transitions, gate
    ko = jax.random.fold_in(key, 1)
    uo = _np(jax.random.uniform(ko, (m,)))
    bad_j = j_faults.outage_draw(fj, ko, m)
    bad_t = t_faults.outage_draw(ft, uo)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    for p_t, p_j in zip(t_faults.ge_transition_probs(ft),
                        j_faults.ge_transition_probs(fj)):
        assert p_t.dtype == torch.float32 and float(p_t) == float(p_j)
    for step in range(2, 6):
        ks = jax.random.fold_in(key, step)
        us = _np(jax.random.uniform(ks, (m,)))
        bad_j = j_faults.outage_step(fj, ks, bad_j)
        bad_t = t_faults.outage_step(ft, us, bad_t)
        np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    up = np.linspace(1e6, 5e7, m).astype(np.float32)
    np.testing.assert_array_equal(
        t_faults.outage_gate(ft, torch.as_tensor(up), bad_t).numpy(),
        np.asarray(j_faults.outage_gate(fj, jnp.asarray(up), bad_j)))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mode", ["drawn", "carried", "pbft"])
def test_faulty_round_time_matches_reference(seed, mode):
    n, m = 40, 4
    rs = np.random.RandomState(seed)
    assoc = rs.randint(0, m, n).astype(np.int32)
    b = rs.uniform(0.05, 1.0, n).astype(np.float32)
    data = rs.randint(50, 2000, n).astype(np.float32)
    freqs = (rs.uniform(1.5, 3.6, m) * 1e9).astype(np.float32)
    up = rs.uniform(1e6, 5e7, m).astype(np.float32)
    down = rs.uniform(1e7, 9e7, m).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    fj = j_faults.FaultConfig(straggler_rate=0.4, outage_rate=0.4)
    ft = t_faults.FaultConfig(straggler_rate=0.4, outage_rate=0.4)
    kw_j, kw_t = {}, {}
    if mode == "carried":
        bad = rs.rand(m) < 0.5
        kw_j["outage_bad"], kw_t["outage_bad"] = jnp.asarray(bad), \
            torch.as_tensor(bad)
    if mode == "pbft":
        kw_j["consensus"] = JCons(quorum_f=1, byzantine_frac=0.3)
        kw_t["consensus"] = TCons(quorum_f=1, byzantine_frac=0.3)
    want = j_faults.faulty_round_time(
        j_lat.LatencyParams(), fj, key, jnp.asarray(assoc), jnp.asarray(b),
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(up),
        jnp.asarray(down), **kw_j)
    got = t_faults.faulty_round_time(
        t_lat.LatencyParams(), ft, ref_fault_draws(key, n, m),
        torch.as_tensor(assoc), torch.as_tensor(b), torch.as_tensor(data),
        torch.as_tensor(freqs), torch.as_tensor(up), torch.as_tensor(down),
        **kw_t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_zero_rates_are_the_clean_round_time():
    ft = t_faults.FaultConfig(straggler_rate=0.0, outage_rate=0.0)
    draws = t_faults.sample_fault_draws(torch.Generator().manual_seed(0),
                                        10, 3)
    args = (torch.zeros(10, dtype=torch.int32), torch.full((10,), 0.5),
            torch.full((10,), 100.0), torch.full((3,), 2e9),
            torch.full((3,), 1e7), torch.full((3,), 1e7))
    lp = t_lat.LatencyParams()
    assert float(t_faults.faulty_round_time(lp, ft, draws, *args)) == float(
        t_lat.round_time(lp, *args))


def test_sample_fault_draws_seeded_and_in_law():
    a = t_faults.sample_fault_draws(torch.Generator().manual_seed(17), 500, 6)
    b = t_faults.sample_fault_draws(torch.Generator().manual_seed(17), 500, 6)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.dtype == torch.float32
    assert a.slow_u.shape == a.slow_exp.shape == (500,)
    assert a.outage_u.shape == (6,)
    assert bool(((a.slow_u >= 0) & (a.slow_u < 1)).all())
    assert bool((a.slow_exp >= 0).all())
    assert abs(float(a.slow_exp.mean()) - 1.0) < 0.2


# ---------------------------------------------------------------------------
# robust aggregation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,m,seed", GRID)
def test_zero_knob_parity_exact(k, m, seed):
    """trim_k=0 / krum_f=0 reproduce the port's weighted FedAvg bit for bit,
    and the reference's within rtol 1e-5."""
    st = _stacked(k, seed)
    sizes, assoc = _inputs(k, m, seed)
    ref_tree, ref_w = t_hier.bs_aggregate_stacked(
        _t(st), torch.as_tensor(sizes), torch.as_tensor(assoc), m, backend=BK)
    for agg, kw in (("trimmed_mean", {"trim_k": 0}), ("krum", {"krum_f": 0})):
        tree, w, surv = t_faults.robust_bs_aggregate_stacked(
            _t(st), torch.as_tensor(sizes), torch.as_tensor(assoc), m,
            aggregator=agg, backend=BK, **kw)
        _close(tree, ref_tree, atol=0.0, rtol=0.0)
        np.testing.assert_array_equal(w.numpy(), ref_w.numpy())
        np.testing.assert_array_equal(surv.numpy(), np.ones(k))
        jtree, jw, _ = j_faults.robust_bs_aggregate_stacked(
            _j(st), jnp.asarray(sizes), jnp.asarray(assoc), m,
            aggregator=agg, backend=BK, **kw)
        _close(tree, jtree, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("k,m,seed", GRID)
@pytest.mark.parametrize("agg", ["trimmed_mean", "krum"])
@pytest.mark.parametrize("knob", [1, 2])
def test_robust_aggregate_matches_reference(k, m, seed, agg, knob):
    st = _stacked(k, seed)
    sizes, assoc = _inputs(k, m, seed)
    # a loud attacker in every cohort, so both rules have work to do
    for key in st:
        st[key][::4] *= 40.0
    kw = {"trim_k": knob} if agg == "trimmed_mean" else {"krum_f": knob}
    jtree, jw, jsurv = j_faults.robust_bs_aggregate_stacked(
        _j(st), jnp.asarray(sizes), jnp.asarray(assoc), m, aggregator=agg,
        backend=BK, **kw)
    ttree, tw, tsurv = t_faults.robust_bs_aggregate_stacked(
        _t(st), torch.as_tensor(sizes), torch.as_tensor(assoc), m,
        aggregator=agg, backend=BK, **kw)
    _close(ttree, jtree, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_array_equal(tsurv.numpy(), np.asarray(jsurv))
    jc, js = j_faults.suspect_counts(jsurv, jnp.asarray(assoc), m, backend=BK)
    tc, ts = t_faults.suspect_counts(tsurv, torch.as_tensor(assoc), m,
                                     backend=BK)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(
        t_faults.update_dispersion(_t(st), torch.as_tensor(assoc), m,
                                   backend=BK).numpy(),
        np.asarray(j_faults.update_dispersion(_j(st), jnp.asarray(assoc), m,
                                              backend=BK)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("agg,kw", [("trimmed_mean", {"trim_k": 3}),
                                    ("krum", {"krum_f": 3})])
def test_breakdown_point_matches_reference(agg, kw):
    """Three +-1e6 attackers in every cohort of 8: the robust aggregate
    stays bounded, and the same clients are suspect in both packages."""
    k, m = 24, 3
    st = _stacked(k, 5)
    sign = np.where(np.arange(k) % 2 == 0, 1e6, -1e6).astype(np.float32)
    for key, v in st.items():
        v[:9] = sign[:9].reshape((9,) + (1,) * (v.ndim - 1))
    sizes = np.ones(k, np.float32)
    assoc = (np.arange(k) % m).astype(np.int32)
    ttree, _, tsurv = t_faults.robust_bs_aggregate_stacked(
        _t(st), torch.as_tensor(sizes), torch.as_tensor(assoc), m,
        aggregator=agg, **kw)
    jtree, _, jsurv = j_faults.robust_bs_aggregate_stacked(
        _j(st), jnp.asarray(sizes), jnp.asarray(assoc), m, aggregator=agg,
        **kw)
    assert max(float(v.abs().max()) for v in ttree.values()) < 100.0
    _close(ttree, jtree, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tsurv.numpy(), np.asarray(jsurv))
    _, n_sus = t_faults.suspect_counts(tsurv, torch.as_tensor(assoc), m)
    _, want = j_faults.suspect_counts(jsurv, jnp.asarray(assoc), m)
    np.testing.assert_array_equal(n_sus.numpy(), np.asarray(want))
    assert (n_sus.numpy() >= 3.0).all()  # the three attackers at least


def test_small_cohort_guard():
    """Cohorts of 1-3 are too small to trim or drop: passed through, the
    ``take & isfinite`` mask of Krum's scores holding at sizes 1 and 2."""
    st = _stacked(4, 9)
    sizes = np.ones(4, np.float32)
    assoc = np.array([0, 0, 1, 1], np.int32)  # BS 2 empty
    ref, _ = t_hier.bs_aggregate_stacked(_t(st), torch.as_tensor(sizes),
                                         torch.as_tensor(assoc), 3)
    for agg, kw in (("trimmed_mean", {"trim_k": 3}), ("krum", {"krum_f": 3})):
        tree, _, surv = t_faults.robust_bs_aggregate_stacked(
            _t(st), torch.as_tensor(sizes), torch.as_tensor(assoc), 3,
            aggregator=agg, **kw)
        _close(tree, ref, atol=0.0, rtol=0.0)
        np.testing.assert_array_equal(surv.numpy(), np.ones(4))
    for assoc in ([0, 1, 1, 1, 2], [0, 0, 0, 1, 1], [2, 2, 2, 2, 0]):
        assoc = np.asarray(assoc, np.int32)
        st5 = _stacked(5, 4)
        j = j_faults.krum_aggregate(_j(st5), jnp.ones(5), jnp.asarray(assoc),
                                    3, krum_f=1)
        t = t_faults.krum_aggregate(_t(st5), torch.ones(5),
                                    torch.as_tensor(assoc), 3, krum_f=1)
        _close(t[0], j[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))


def test_krum_drops_the_outlier_of_a_five_cohort():
    """A cohort of 3 is never peeled; one of 5 loses exactly its outlier
    (``tests/test_faults.py``'s bs_segments contract)."""
    assoc = np.array([0, 1, 0, 1, 1, 0, 1, 1], np.int32)
    st = _stacked(8, 3)
    for v in st.values():
        v[4] = 500.0
        v[5] = 500.0
    _, _, surv = t_faults.krum_aggregate(_t(st), torch.ones(8),
                                         torch.as_tensor(assoc), 2, krum_f=1)
    surv = surv.numpy()
    assert surv[assoc == 0].sum() == 3.0 and surv[assoc == 1].sum() == 4.0
    assert surv[4] == 0.0


def test_suspect_counts_and_dispersion_fixed_cases():
    surv = torch.tensor([0.6, 0.55, 0.7, 0.05, 0.5, 0.6])
    assoc = torch.tensor([0, 0, 0, 0, 1, 1], dtype=torch.int32)
    n_cli, n_sus = t_faults.suspect_counts(surv, assoc, 2)
    np.testing.assert_array_equal(n_cli.numpy(), [4.0, 2.0])
    np.testing.assert_array_equal(n_sus.numpy(), [1.0, 0.0])
    st = {"w": torch.stack([torch.full((3,), float(v))
                            for v in (1, 1, 1, 1, 5, 9)])}
    got = t_faults.update_dispersion(
        st, torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.int32), 2).numpy()
    norms = np.linalg.norm(st["w"].numpy(), axis=1)
    np.testing.assert_allclose(got[0], 0.0, atol=1e-5)
    np.testing.assert_allclose(got[1], norms[3:].std(), rtol=1e-5)


def test_dispatch_rejects_unknown_and_sharded_raise():
    """The unknown aggregator is refused. The sharded entry points run on 4
    gloo ranks at the gate's populations and give the reference's
    single-device draws (exactly) and round time (rtol 1e-5)."""
    st = _t(_stacked(4, 0))
    with pytest.raises(ValueError, match="aggregator"):
        t_faults.robust_bs_aggregate_stacked(st, torch.ones(4),
                                             torch.zeros(4, dtype=torch.int32),
                                             2, aggregator="median")
    assert t_faults.AGGREGATORS == j_faults.AGGREGATORS
    from torch_sharding_helpers import fault_ranks, join, spawn

    fj = j_faults.FaultConfig(straggler_rate=0.4, outage_rate=0.4,
                              malicious_frac=0.3)
    ft = t_faults.FaultConfig(straggler_rate=0.4, outage_rate=0.4,
                              malicious_frac=0.3)
    cases, wants = [], []
    for n, m in [(64, 5), (37, 5), (5, 3)]:
        rs = np.random.RandomState(n)
        assoc = rs.randint(0, m, n).astype(np.int32)
        b = rs.uniform(0.05, 1.0, n).astype(np.float32)
        data = rs.randint(50, 2000, n).astype(np.float32)
        freqs = (rs.uniform(1.5, 3.6, m) * 1e9).astype(np.float32)
        up = rs.uniform(1e6, 5e7, m).astype(np.float32)
        down = rs.uniform(1e7, 9e7, m).astype(np.float32)
        key = jax.random.PRNGKey(n)
        # fault_draws and faulty_round_time split the key alike: the
        # straggler draws come from its first half
        k_mal = jax.random.split(key)[1]
        cases.append({
            "fcfg": ft, "draws": ref_fault_draws(key, n, m),
            "mal_u": _np(jax.random.uniform(k_mal, (n,))),
            "assoc": torch.as_tensor(assoc), "b": torch.as_tensor(b),
            "data": torch.as_tensor(data), "freqs": torch.as_tensor(freqs),
            "up": torch.as_tensor(up), "down": torch.as_tensor(down)})
        slow_j, mal_j = j_faults.fault_draws(fj, key, n)
        t_j = j_faults.faulty_round_time(
            j_lat.LatencyParams(), fj, key, jnp.asarray(assoc),
            jnp.asarray(b), jnp.asarray(data), jnp.asarray(freqs),
            jnp.asarray(up), jnp.asarray(down))
        wants.append((n, slow_j, mal_j, t_j))
    ranks = spawn(fault_ranks, 4, cases)
    for i, (n, slow_j, mal_j, t_j) in enumerate(wants):
        np.testing.assert_array_equal(
            join([r[i]["slow"] for r in ranks], n).numpy(),
            np.asarray(slow_j))
        np.testing.assert_array_equal(
            join([r[i]["mal"] for r in ranks], n).numpy(), np.asarray(mal_j))
        assert bool((torch.cat([r[i]["slow"] for r in ranks])[n:]
                     == 1.0).all())  # padding rows: the identity
        for r in ranks:
            np.testing.assert_allclose(float(r[i]["t"]), float(t_j),
                                       rtol=1e-5)

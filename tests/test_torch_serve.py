"""Parity of the port's always-on serve loop (``repro_torch.core.serve``)
with the reference on the CPU, at N=12 twins on M=3 BSs, fed the
reference's own ``jax.random`` draws in its key folds
(``torch_scenario_helpers``); and the port's own contracts: churn
invariants, streaming against the batch runners, overlap against blocking,
state written in place, the segment launches, and streamed FL against the
port's ``DTWNSystem`` batch rounds.

Tolerances: masks, associations, churn counts, plans and participants
exactly; populations at rtol 1e-6; round times, loads and stake shares at
rtol 1e-5 (the latency model's), fractions of counts at rtol 1e-6 (one
ulp of a mean); in policy mode round times at rtol 1e-4 (the actor's
products). Streaming against the port's batch runners, churn off: bitwise
with the ``segment_sum`` backend pinned. Streamed FL against the port's
``DTWNSystem`` rounds: participants, minibatches and Eq. 4 weights
exactly, the holdout loss at rtol 1e-6 (this test shows 1.04e-7 in its
first round and 0 in the next two: the batched local SGD runs the CNN's
convolutions grouped, the batch rounds one twin at a time).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serve as j_serve
from repro.core.marl import ddpg as j_ddpg
from repro_torch import bridge
from repro_torch.core import association as t_assoc
from repro_torch.core import scenario as t_scn
from repro_torch.core import serve as t_serve
from repro_torch.core.marl import ddpg as t_ddpg
from repro_torch.core.marl import replay as t_replay
from repro_torch.fl import stream as t_fls
from torch_scenario_helpers import (ALL_AXES, axis_cfgs, batches,
                                    counting_kernel, init_draws, knob_rows,
                                    pin_backend, round_draws)

CPU = torch.device("cpu")
LAT = dict(rtol=1e-5, atol=0)
FRAC = dict(rtol=1e-6, atol=0)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, tol=LAT):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _rand_churn_case(seed, n, m):
    rng = np.random.default_rng(seed)
    active = rng.random(n) < 0.6
    data = np.where(active, rng.uniform(100.0, 1500.0, n), 0.0)
    assoc = np.where(active, rng.integers(0, m, n), m).astype(np.int32)
    return (active, data.astype(np.float32), assoc, rng.random(n) < 0.3,
            rng.random(n) < 0.3, rng.uniform(100.0, 1500.0, n).astype(
                np.float32), rng.integers(0, m, n).astype(np.int32))


def test_admit_evict_invariants_and_reference():
    for seed, n, m in [(s, 64, 5) for s in range(4)] + [(9, 16, 3)]:
        active, data, assoc, leave, join, new_d, new_a = _rand_churn_case(
            seed, n, m)
        a1, d1, s1 = t_serve.evict(torch.tensor(active), torch.tensor(data),
                                   torch.tensor(assoc), torch.tensor(leave),
                                   m)
        left = leave & active
        assert int(a1.sum()) == int(active.sum() - left.sum())
        _eq(d1.numpy()[left], 0.0)
        _eq(s1.numpy()[left], m)
        a2, d2, s2 = t_serve.admit(a1, d1, s1, torch.tensor(join),
                                   torch.tensor(new_d), torch.tensor(new_a))
        joined = join & ~a1.numpy()
        assert int(a2.sum()) == int(a1.sum()) + int(joined.sum())
        live = a2.numpy()
        assert (s2.numpy()[live] < m).all()
        _eq(s2.numpy()[~live], m)
        _eq(d2.numpy()[~live], 0.0)
        want = j_serve.admit(*j_serve.evict(
            jnp.asarray(active), jnp.asarray(data), jnp.asarray(assoc),
            jnp.asarray(leave), m), jnp.asarray(join), jnp.asarray(new_d),
            jnp.asarray(new_a))
        for got, w in zip((a2, d2, s2), want):
            _eq(got, w)
        assert s2.dtype == torch.int32


def test_churn_step_matches_reference():
    jc, tc = axis_cfgs()
    jb, tb = batches(3)
    jrow, trow = knob_rows(jb, tb, jc, tc, 0)
    kw = dict(capacity=12, join_rate=0.3, leave_rate=0.3)
    jscfg, tscfg = j_serve.ServeConfig(**kw), t_serve.ServeConfig(**kw)
    rng = np.random.default_rng(0)
    active = rng.random(12) < 0.5
    data = np.where(active, 500.0, 0.0).astype(np.float32)
    assoc = np.where(active, np.arange(12) % 3, 3).astype(np.int32)
    key = jb.key[0]
    want = j_serve.churn_step(jc, jscfg, j_serve.stream_keys(key, 1).churn[0],
                              jnp.asarray(active), jnp.asarray(data),
                              jnp.asarray(assoc), jrow)
    draws = t_serve.round_draws(round_draws(jc, jscfg, key, 1), 0)
    got = t_serve.churn_step(tc, tscfg, draws, torch.tensor(active),
                             torch.tensor(data), torch.tensor(assoc), trow)
    for i, (g, w) in enumerate(zip(got, want)):
        (_close if i == 1 else _eq)(g, w, *([dict(rtol=1e-6, atol=0)]
                                           if i == 1 else []))
    assert int(got[0].sum()) == int(active.sum()) + int(got[3]) - int(got[4])


@pytest.mark.parametrize("n_live", [None, 9])
def test_serve_init_matches_reference(n_live):
    jc, tc = axis_cfgs("all")
    jb, tb = batches(3, **ALL_AXES)
    jrow, trow = knob_rows(jb, tb, jc, tc, 1)
    key = jb.key[1]
    want = j_serve.serve_init(jc, j_serve.ServeConfig(capacity=12), key,
                              jrow, n_live=n_live)
    got = t_serve.serve_init(tc, t_serve.ServeConfig(capacity=12), trow,
                             draws=init_draws(jc, key), n_live=n_live,
                             device=CPU)
    bridged = bridge.serve_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), CPU)
    for st in (got, bridged):
        for f in ("active", "bad", "byz"):
            _eq(getattr(st, f), getattr(want, f))
        _eq(st.env.assoc, want.env.assoc)
        assert st.env.assoc.dtype == torch.int32
        for f in ("data_sizes", "freqs", "h_up", "h_down", "dist"):
            _close(getattr(st.env, f), getattr(want.env, f),
                   dict(rtol=1e-6, atol=0))
        _close(st.env.chain.stakes, want.env.chain.stakes,
               dict(rtol=1e-6, atol=0))
        assert st.round == 0
    with pytest.raises(ValueError, match="capacity"):
        t_serve.serve_init(tc, t_serve.ServeConfig(capacity=8), trow,
                           device=CPU)


def _port_stream(tc, tscfg, trow, key, jc, jscfg, k, *, n_live=None,
                 overlap=False, agent=None):
    st = t_serve.serve_init(tc, tscfg, trow, draws=init_draws(jc, key),
                            n_live=n_live, device=CPU)
    if agent is not None:
        spec_buf = t_replay.replay_init(16, *_replay_dims(tc))
        st = st._replace(agent=agent, buf=spec_buf)
    return t_serve.serve_rounds(tc, tscfg, st, round_draws(jc, jscfg, key, k),
                                trow, n_rounds=k, overlap=overlap)


def _replay_dims(cfg):
    from repro_torch.core.marl import spaces

    spec = spaces.space_spec(cfg)
    return spec.compact_dim, spec.n_bs, spec.enc_dim


STREAM_CASES = {
    "baseline": (None, {}),
    "faults": ("faults", {}),
    "migration": ("migration", {}),
    "consensus": ("consensus", {}),
    "churn_evolve_all": ("all", dict(join_rate=0.3, leave_rate=0.2,
                                     evolve_channels=True)),
    "policy": ("migration", dict(policy="factorized")),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_rounds_match_reference(case):
    """K=4 streamed rounds of the port from the reference's draws against
    the reference's ``serve_rounds``, per axis, with churn and dynamics,
    and in policy mode (the reference's agent, bridged)."""
    axis, kw = STREAM_CASES[case]
    k = 4
    jc, tc = axis_cfgs(axis)
    jb, tb = batches(3, **ALL_AXES)
    jrow, trow = knob_rows(jb, tb, jc, tc, 1)
    key = jb.key[1]
    jscfg = j_serve.ServeConfig(capacity=12, **kw)
    tscfg = t_serve.ServeConfig(capacity=12, **kw)
    n_live = 9 if "join_rate" in kw else None
    st_j = j_serve.serve_init(jc, jscfg, key, jrow, n_live=n_live)
    agent = None
    if "policy" in kw:
        st_j = j_serve.attach_policy(jc, st_j, jax.random.PRNGKey(3),
                                     dcfg=j_ddpg.DDPGConfig(hidden=(16, 16)),
                                     replay_capacity=16)
        agent = bridge.maddpg_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, st_j.agent), CPU)
    _, want = j_serve.serve_rounds(jc, jscfg, st_j,
                                   j_serve.stream_keys(key, k), jrow,
                                   overlap=False)
    want = j_serve.stack_metrics(want)
    state, got = _port_stream(tc, tscfg, trow, key, jc, jscfg, k,
                              n_live=n_live, agent=agent)
    got = t_serve.stack_metrics(got)
    assert set(got) == set(want)
    exact = ("n_active", "n_joined", "n_left")
    fracs = ("straggler_frac", "outage_frac", "migration_rate",
             "accept_frac")
    for key_ in want:
        assert got[key_].shape == want[key_].shape, key_
        if key_ in exact:
            _eq(got[key_], want[key_])
        elif key_ in fracs:
            _close(got[key_], want[key_], FRAC)
        else:
            _close(got[key_], want[key_], dict(rtol=1e-4, atol=0)
                   if "policy" in kw else LAT)
    assert state.round == k and state.env.t == k
    if "policy" in kw:
        assert state.buf.size == k and state.buf.ptr == k


@pytest.mark.parametrize("axis", ["baseline", "faults", "migration",
                                  "consensus"])
def test_streaming_matches_batch_bitwise(monkeypatch, axis):
    """K streamed rounds of the port at a fixed full population equal the
    port's batch runner on the same scenario row, bit for bit (the same
    draw streams, ``segment_sum`` pinned on both)."""
    k, i = 4, 1
    tb = t_scn.make_batch(5, 3, **ALL_AXES)
    tc = axis_cfgs(axis)[1]
    knobs = t_scn.stream_knobs(tb, fcfg=tc.faults, ccfg=tc.consensus,
                               lat=tc.lat)
    row = t_scn.knob_row(knobs, i)
    pin_backend(monkeypatch, "segment_sum")
    scfg = t_serve.ServeConfig(capacity=12)
    seed = tb.seed[i]
    st = t_serve.serve_init(tc, scfg, row, seed=seed, device=CPU)
    _, m = t_serve.serve_rounds(tc, scfg, st,
                                t_serve.stream_draws(tc, scfg, seed, k, CPU),
                                row, n_rounds=k, overlap=False)
    m = t_serve.stack_metrics(m)
    run = dict(device=CPU)
    if axis == "baseline":
        ref = t_scn.run_baselines(tc, tb, **run)
        _eq(m["round_time"], np.full(k, ref["average"][i].numpy()))
        return
    if axis == "faults":
        ref = t_scn.run_faults(tc, tc.faults, tb, k, **run)
        pairs = [("round_time", "round_times"),
                 ("straggler_frac", "straggler_frac"),
                 ("outage_frac", "outage_frac")]
    elif axis == "migration":
        ref = t_scn.run_migration(tc, tc.migration, tb, k, **run)
        pairs = [("round_time", "round_times"),
                 ("migration_rate", "migration_rates"),
                 ("imbalance", "imbalance")]
    else:
        ref = t_scn.run_consensus(tc, tc.consensus, tb, k, **run)
        pairs = [("round_time", "round_times"),
                 ("accept_frac", "accept_frac")]
        _eq(m["consensus_time"], np.full(k, ref["consensus_time"][i]))
        _eq(m["honest_stake_share"][-1], ref["honest_stake_share"][i])
    for mk, rk in pairs:
        _eq(m[mk], ref[rk][i].numpy())


def _fl_tiny_stream(overlap, *, policy=False):
    tc = axis_cfgs("all")[1]
    fcfg = t_fls.FLServeConfig(model="tiny", participants=4, local_iters=2,
                               batch_size=8, n_eval=64)
    scfg = t_serve.ServeConfig(capacity=12, join_rate=0.3, leave_rate=0.2,
                               evolve_channels=True, fl=fcfg,
                               policy="factorized" if policy else None)
    from repro_torch.data import cifar10
    from repro_torch.fl.partition import iid_partition

    data = cifar10.load(max_train=600, max_test=128)
    tb = t_scn.make_batch(7, 2, **ALL_AXES)
    row = t_scn.knob_row(t_scn.stream_knobs(tb, fcfg=tc.faults,
                                            ccfg=tc.consensus), 0)
    st = t_serve.serve_init(tc, scfg, row, seed=tb.seed[0], n_live=9,
                            device=CPU)
    st = st._replace(fl=t_fls.fl_init(fcfg, torch.Generator().manual_seed(1),
                                      data, st.active))
    if policy:
        st = t_serve.attach_policy(tc, st, torch.Generator().manual_seed(2),
                                   dcfg=t_ddpg.DDPGConfig(hidden=(8, 8)),
                                   replay_capacity=8)
    plan = t_fls.stream_fl_plan(fcfg, iid_partition(600, 12, seed=3), 5)
    draws = t_serve.stream_draws(tc, scfg, tb.seed[0], 5, CPU)
    return tc, scfg, st, draws, row, plan


def test_overlap_matches_blocking_and_state_in_place():
    """Overlap is a scheduling change only, FL and churn included; every
    round writes the state's tensors in place (the same storage from the
    first round to the last)."""
    out = {}
    for overlap in (True, False):
        tc, scfg, st, draws, row, plan = _fl_tiny_stream(overlap)
        ptrs = [t.data_ptr() for t in (
            st.active, st.bad, st.env.data_sizes, st.env.assoc,
            st.env.h_up, st.env.freqs, st.env.chain.stakes,
            *st.fl.params.values(), *st.fl.twin_params.values(),
            *st.fl.twin_mom.values())]
        st2, m = t_serve.serve_rounds(tc, scfg, st, draws, row,
                                      overlap=overlap, plan=plan)
        assert [t.data_ptr() for t in (
            st2.active, st2.bad, st2.env.data_sizes, st2.env.assoc,
            st2.env.h_up, st2.env.freqs, st2.env.chain.stakes,
            *st2.fl.params.values(), *st2.fl.twin_params.values(),
            *st2.fl.twin_mom.values())] == ptrs
        out[overlap] = t_serve.stack_metrics(m)
        act = st2.active.numpy()
        assert (st2.env.assoc.numpy()[~act] == 3).all()
        assert (st2.env.data_sizes.numpy()[~act] == 0).all()
        for buf in (*st2.fl.twin_params.values(), *st2.fl.twin_mom.values()):
            assert (buf.numpy()[~act] == 0).all()
    assert out[True].keys() == out[False].keys()
    for key in out[True]:
        _eq(out[True][key], out[False][key])
    assert (out[True]["n_joined"] > 0).any() and (out[True]["n_left"] > 0).any()
    assert np.isfinite(out[True]["fl_loss"]).all()


@pytest.mark.parametrize("policy", [False, True])
def test_serve_launches_match_the_formula(monkeypatch, policy):
    """The kernel backend forced and counted on the CPU, as the card runs
    it: ``serve_init`` and 5 rounds with every axis, churn, dynamics and
    streamed FL (the tiny model's 4 leaves), in policy mode too."""
    calls = counting_kernel(monkeypatch)
    tc, scfg, st, draws, row, plan = _fl_tiny_stream(False, policy=policy)
    assert len(calls) == 1  # serve_init's chain stakes
    t_serve.serve_rounds(tc, scfg, st, draws, row, plan=plan)
    assert len(calls) == 1 + t_serve.serve_launches(tc, scfg, 5, n_leaves=4)


def test_streamed_fl_matches_dtwn_batch_rounds(monkeypatch):
    """Fixed full population, churn off: the streamed FL rounds are the
    port's batch ``DTWNSystem.run_round``s on the same realization, with
    the same participants, the same minibatches and the same Eq. 4
    weights, exactly; the holdout loss within rtol 1e-6."""
    from repro_torch.core import hierarchy as t_hier
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.data import cifar10
    from repro_torch.fl import DTWNSystem, FLConfig
    from repro_torch.fl import client as t_client
    from repro_torch.models import cnn

    n, m, rounds = 16, 3, 3
    data = cifar10.load(max_train=2000, max_test=512)
    fcfg = t_fls.FLServeConfig(model="cnn", participants=5, local_iters=2,
                               batch_size=8, tolerance=25.0)
    system = DTWNSystem(FLConfig(
        n_users=n, n_bs=m, bs_freqs_ghz=(2.6, 1.8, 3.6),
        local_iters=fcfg.local_iters, batch_size=fcfg.batch_size, lr=fcfg.lr,
        consensus=ConsensusConfig(tolerance=fcfg.tolerance)), data, seed=0,
        device=CPU)
    assoc = np.arange(n) % m
    cfg = axis_cfgs(None, n_twins=n)[1]
    scfg = t_serve.ServeConfig(capacity=n, fl=fcfg)
    tb = t_scn.make_batch(0, 2)
    row = t_scn.knob_row(t_scn.stream_knobs(tb), 0)
    st = t_serve.serve_init(cfg, scfg, row, seed=tb.seed[0], device=CPU)
    st = t_fls.attach_fl(scfg, st, system, data, assoc=assoc)
    plan = t_fls.stream_fl_plan(fcfg, system.shards, rounds, seed=0)
    # the minibatches each twin of the batch rounds trains on, in order
    seen = []
    step = t_client.sgd_step

    def spy(loss_fn, opt, params, opt_state, batch):
        seen.append(batch["images"].clone())
        return step(loss_fn, opt, params, opt_state, batch)

    monkeypatch.setattr(t_client, "sgd_step", spy)
    _, mtr = t_serve.serve_rounds(cfg, scfg, st, t_serve.RoundDraws(), row,
                                  n_rounds=rounds, overlap=False, plan=plan)
    mtr = t_serve.stack_metrics(mtr)
    eval_batch = {"images": torch.as_tensor(system.x_test[:fcfg.n_eval]),
                  "labels": torch.as_tensor(system.y_test[:fcfg.n_eval])}
    weights = []
    orig = t_hier.bs_aggregate_stacked

    def capture(*a, **k):
        out = orig(*a, **k)
        weights.append(out[1].numpy())
        return out

    monkeypatch.setattr(t_hier, "bs_aggregate_stacked", capture)
    gaps = []
    for t in range(rounds):
        info = system.run_round(assoc, participating_users=fcfg.participants)
        _eq(plan.users[t].numpy(), info["chosen"])
        images = torch.stack(seen[-fcfg.participants * fcfg.local_iters:])
        want = torch.as_tensor(system.x)[plan.batch[t]].reshape(
            images.shape)
        _eq(images, want)
        _eq(mtr["fl_bs_weight"][t], weights[-1])
        assert info["n_verified"] == info["n_submitted"]
        assert mtr["fl_accept_frac"][t] == 1.0
        with torch.no_grad():
            loss_ref = float(cnn.loss_fn(system.params, eval_batch))
        gaps.append(abs(mtr["fl_loss"][t] - loss_ref) / loss_ref)
    assert max(gaps) <= 1e-6, gaps
    assert mtr["fl_loss"][-1] < mtr["fl_loss"][0]


def _sharded_serve_matches_reference():
    """The serve loop over a 2-rank gloo mesh (``make_serve_init`` and
    ``serve_rounds(ts=)``) at a ragged capacity of 13, every axis, churn
    from 9 live twins, channel dynamics and policy mode (the reference's
    agent, bridged), 4 rounds on the reference's draws: against the
    reference's single-device ``serve_rounds`` as
    ``test_rounds_match_reference`` holds the single-device loop (counts
    exact, fractions at rtol 1e-6, the rest at rtol 1e-4 in policy mode),
    masks and associations equal to the reference's; and against the
    port's single-device loop on the same draws at the gate's rtol 1e-5.
    The replicated leaves are bitwise equal on both ranks
    (``assert_replicated`` in the rank body). ``serve_specs`` names the
    blocked leaves."""
    from repro_torch.core.sharding import P
    from torch_sharding_helpers import serve_ranks, spawn

    k, n_live = 4, 9
    kw = dict(capacity=13, join_rate=0.2, leave_rate=0.2,
              policy="factorized", evolve_channels=True)
    jc, tc = axis_cfgs("all", n_twins=13)
    jscfg, scfg = j_serve.ServeConfig(**kw), t_serve.ServeConfig(**kw)
    specs = t_serve.serve_specs(tc, scfg)
    assert specs.active == specs.env.assoc == P("twin")
    assert specs.bad == specs.agent == specs.buf == P()
    assert t_serve.serve_specs(tc, t_serve.ServeConfig(
        capacity=13, fl=t_fls.FLServeConfig())).fl.twin_params == P("twin")
    jb, tb = batches(3, **ALL_AXES)
    jrow, trow = knob_rows(jb, tb, jc, tc, 2)
    key = jb.key[2]
    st_j = j_serve.serve_init(jc, jscfg, key, jrow, n_live=n_live)
    st_j = j_serve.attach_policy(jc, st_j, jax.random.PRNGKey(3),
                                 dcfg=j_ddpg.DDPGConfig(hidden=(16, 16)),
                                 replay_capacity=16)
    agent = bridge.maddpg_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, st_j.agent), CPU)
    st_j, want = j_serve.serve_rounds(jc, jscfg, st_j,
                                      j_serve.stream_keys(key, k), jrow,
                                      overlap=False)
    want = j_serve.stack_metrics(want)
    init, draws = init_draws(jc, key), round_draws(jc, jscfg, key, k)
    ranks = spawn(serve_ranks, 2, tc, scfg, trow, init, draws, n_live, agent,
                  _replay_dims(tc))
    single, mine = _port_stream(tc, scfg, trow, key, jc, jscfg, k,
                                n_live=n_live, agent=agent)
    exact = ("n_active", "n_joined", "n_left")
    fracs = ("straggler_frac", "outage_frac", "migration_rate",
             "accept_frac")
    for r in ranks:
        _eq(r["active"], st_j.active)
        _eq(r["assoc"], st_j.env.assoc)
        _close(r["data"], st_j.env.data_sizes, FRAC)
        assert (r["round"], r["buf_size"]) == (k, k)
        assert set(r["metrics"]) == set(want) == set(mine)
        for key_, w in want.items():
            got = r["metrics"][key_].numpy()
            assert got.shape == w.shape, key_
            if key_ in exact:
                _eq(got, w)
            elif key_ in fracs:
                _close(got, w, FRAC)
            else:
                _close(got, w, dict(rtol=1e-4, atol=0))
            _close(got, mine[key_].numpy())
        _eq(r["assoc"], single.env.assoc)


def test_serve_refusals():
    tc = axis_cfgs()[1]
    scfg = t_serve.ServeConfig(capacity=12)

    _sharded_serve_matches_reference()
    row = t_scn.knob_row(t_scn.stream_knobs(t_scn.make_batch(0, 1)), 0)
    st = t_serve.serve_init(tc, scfg, row, device=CPU)
    with pytest.raises(ValueError, match="n_rounds"):
        t_serve.serve_rounds(tc, scfg, st, t_serve.RoundDraws(), row)
    fl_scfg = t_serve.ServeConfig(capacity=12, fl=t_fls.FLServeConfig())
    with pytest.raises(ValueError, match="FLPlan"):
        t_serve.serve_rounds(tc, fl_scfg, st, t_serve.RoundDraws(), row,
                             n_rounds=1)
    _, m = t_serve.serve_rounds(tc, scfg, st, t_serve.RoundDraws(), row,
                                n_rounds=2)
    assert m["round_time"].shape == (2,)
    assert t_assoc.bs_loads(st.env.assoc, st.env.data_sizes, 3)[
        "loads"].shape == (3,)
    importlib.import_module("repro_torch.launch.serve_dtwn")

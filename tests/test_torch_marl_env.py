"""Parity of the port's MARL environment (``repro_torch.core.marl.env``)
with the reference on the CPU, fed the reference's own ``jax.random``
draws in its key-split order (``torch_marl_helpers.reset_draws`` and
``step_draws``). Reset, soft reset, evolve and step run under the plain,
migration, faults and consensus configs at the reference tests' size, and
at n_bs = 8 with the default 5-BS wireless config. Tolerances: states and
observations at rtol 1e-6 (elementwise fp32); associations, chain verdicts
and counters exactly; reward, round times and info at rtol 1e-5 (the
latency model's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import association as j_assoc
from repro.core.marl import env as j_env
from repro.core.marl import spaces as j_sp
from repro_torch.core.marl import env as t_env
from repro_torch.core.marl import spaces as t_sp
from torch_marl_helpers import (KEY, OPTIONS, SMALL, cfgs, env_state,
                                random_action, reset_draws, step_draws, t)

STATE = dict(rtol=1e-6, atol=0)
INFO = dict(rtol=1e-5, atol=1e-7)


def _close(got, want, tol=STATE):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **tol)


def _state_close(st_t, st_j):
    for f in ("freqs", "data_sizes", "h_up", "h_down", "dist"):
        _close(getattr(st_t, f), getattr(st_j, f))
    np.testing.assert_array_equal(st_t.assoc.numpy(), np.asarray(st_j.assoc))
    assert st_t.assoc.dtype == torch.int32
    assert st_t.t == int(st_j.t)
    assert (st_t.chain is None) == (st_j.chain is None)
    if st_t.chain is not None:
        _close(st_t.chain.stakes, st_j.chain.stakes)
        for f in ("verdicts", "rewards", "round"):
            np.testing.assert_array_equal(
                getattr(st_t.chain, f).numpy(),
                np.asarray(getattr(st_j.chain, f)))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_reset_soft_reset_and_evolve(option):
    cj, ct = cfgs(option, **SMALL)
    st_j = j_env.env_reset(cj, KEY)
    st_t = t_env.env_reset(ct, reset_draws(cj, KEY))
    _state_close(st_t, st_j)
    k2 = jax.random.fold_in(KEY, 1)
    _state_close(t_env.env_evolve(ct, st_t, step_draws(cj, k2)),
                 j_env.env_evolve(cj, st_j, k2))
    soft_j = j_env.env_soft_reset(cj, st_j._replace(t=jnp.int32(7)), k2)
    soft_t = t_env.env_soft_reset(ct, st_t._replace(t=7),
                                  reset_draws(cj, k2, soft=True))
    _state_close(soft_t, soft_j)
    assert soft_t.data_sizes is st_t.data_sizes  # the population is kept


@pytest.mark.parametrize("option", list(OPTIONS))
def test_env_step_matches_reference(option):
    cj, ct = cfgs(option, **SMALL)
    st_j = j_env.env_reset(cj, KEY)
    st_t = env_state(st_j)
    rs = np.random.RandomState(5)
    for step in range(3):
        s, b, tau = random_action(cj, rs)
        key = jax.random.fold_in(KEY, 100 + step)
        nxt_j, r_j, info_j = j_env.env_step(
            cj, st_j, j_sp.Action(*map(jnp.asarray, (s, b, tau))), key)
        nxt_t, r_t, info_t = t_env.env_step(
            ct, st_t, t_sp.Action(t(s), t(b), t(tau)), step_draws(cj, key))
        assert set(info_t) == set(info_j)
        np.testing.assert_array_equal(info_t["assoc"].numpy(),
                                      np.asarray(info_j["assoc"]))
        _close(r_t, r_j, INFO)
        for k in info_j:
            if k != "assoc":
                _close(info_t[k], info_j[k], INFO)
        _state_close(nxt_t, nxt_j)
        if option == "migration":
            assert float(info_t["migration_rate"]) > 0.0
        st_j, st_t = nxt_j, nxt_t


def test_env_step_flat_layout_and_reward_sign():
    cj, ct = cfgs(**SMALL)
    st_t = env_state(j_env.env_reset(cj, KEY))
    draws = step_draws(cj, KEY)
    flat = np.random.RandomState(2).uniform(-1, 1, (3, ct.action_dim))
    nxt, r, info = t_env.env_step(ct, st_t, t(flat.astype(np.float32)), draws)
    nxt2, r2, _ = t_env.env_step(ct, st_t, t_sp.unflatten_action(
        ct, t(flat.astype(np.float32))), draws)
    assert torch.equal(r, r2) and bool((r < 0).all()) and nxt.t == 1
    assert float(info["system_time"]) >= float(-r.max()) / ct.reward_scale - 1e-3


def test_env_reset_syncs_wireless_shapes_at_n_bs_8():
    """With the default 5-BS WirelessConfig and n_bs=8, every channel,
    distance and rate goes through the n_bs-synced ``cfg.wl``."""
    cj, ct = cfgs(n_twins=24, n_bs=8)
    c = ct.wl.n_subchannels
    st_j = j_env.env_reset(cj, KEY)
    st_t = t_env.env_reset(ct, reset_draws(cj, KEY))
    assert st_t.h_up.shape == (8, c) and st_t.dist.shape == (8,)
    _state_close(st_t, st_j)
    _close(t_env.observe(ct, st_t).bs_feats, j_env.observe(cj, st_j).bs_feats)
    nxt_j, r_j, _ = j_env.env_step(cj, st_j, j_sp.zeros_action(cj), KEY)
    nxt_t, r_t, _ = t_env.env_step(ct, st_t, t_sp.zeros_action(ct),
                                   step_draws(cj, KEY))
    assert r_t.shape == (8,)
    _close(r_t, r_j, INFO)
    soft = t_env.env_soft_reset(ct, nxt_t, reset_draws(cj, KEY, soft=True))
    assert soft.h_up.shape == (8, c) and soft.dist.shape == (8,)
    gen = torch.Generator().manual_seed(0)
    draws = t_env.sample_step_draws(gen, ct)
    assert draws.up.shape == (8, c) and draws.move_u is None


def test_compare_with_baselines_on_reference_random_draws():
    cj, ct = cfgs(**SMALL)
    st_j = j_env.env_reset(cj, KEY)
    rs = np.random.RandomState(4)
    s, b, tau = random_action(cj, rs)
    a_j = j_sp.Action(*map(jnp.asarray, (s, b, tau)))
    want = j_env.compare_with_baselines(cj, st_j, a_j, n_random=4)
    rand = np.stack([np.asarray(j_assoc.random_association(
        jax.random.fold_in(jax.random.PRNGKey(0), i), 12, 3))
        for i in range(4)])
    got = t_env.compare_with_baselines(ct, env_state(st_j),
                                       t_sp.Action(t(s), t(b), t(tau)),
                                       rand_assoc=t(rand))
    for k in ("marl", "average", "random"):
        _close(got[k], want[k], INFO)
    np.testing.assert_array_equal(got["assoc"].numpy(),
                                  np.asarray(want["assoc"]))
    default = t_env.compare_with_baselines(ct, env_state(st_j),
                                           t_sp.Action(t(s), t(b), t(tau)))
    assert torch.isfinite(default["random"])


@pytest.mark.parametrize("option", list(OPTIONS))
def test_sampled_draws_cover_the_config(option):
    _, ct = cfgs(option, **SMALL)
    d = t_env.sample_step_draws(torch.Generator().manual_seed(1), ct)
    used = {"migration": ("move_u", "gumbel"),
            "faults": ("slow_u", "slow_exp", "outage_u"),
            "consensus": ("byz_u", "sub_z")}.get(option, ())
    for f in t_env.StepDraws._fields[3:]:
        assert (getattr(d, f) is not None) == (f in used)
    if option == "migration":
        assert torch.isfinite(d.gumbel).all()
    r = t_env.sample_reset_draws(torch.Generator().manual_seed(1), ct)
    st = t_env.env_reset(ct, r)
    assert bool(((st.data_sizes >= ct.data_min)
                 & (st.data_sizes <= ct.data_max)).all())


def test_sharded_entry_points_raise_a10():
    """``sharded_env_reset``/``observe``/``env_step`` on 4 gloo ranks at the
    gate's ragged N = 37 (M = 5), under every config, against the
    reference's single-device reset, observe and step on its own draws:
    observations and rewards at rtol 1e-5, associations equal; the twin
    leaves are the ranks' blocks (``env_specs``)."""
    from torch_sharding_helpers import env_ranks, join, spawn
    from repro_torch.core.sharding import P

    cases, wants = {}, {}
    k2 = jax.random.fold_in(KEY, 1)
    for option in OPTIONS:
        cj, ct = cfgs(option, n_twins=37, n_bs=5)
        sc, bc, tc = random_action(cj, np.random.RandomState(4))
        st_j = j_env.env_reset(cj, KEY)
        obs_j = j_env.observe(cj, st_j)
        st2_j, r_j, info_j = j_env.env_step(
            cj, st_j, j_sp.Action(jnp.asarray(sc), jnp.asarray(bc),
                                  jnp.asarray(tc)), k2)
        wants[option] = (st_j, obs_j, st2_j, r_j, info_j,
                         j_env.observe(cj, st2_j))
        cases[option] = {"cfg": ct, "reset": reset_draws(cj, KEY),
                         "action": t_sp.Action(t(sc), t(bc), t(tc)),
                         "step": step_draws(cj, k2)}
        specs = t_env.env_specs(ct)
        assert specs.data_sizes == P("twin") and specs.assoc == P("twin")
        assert specs.freqs == P() and specs.h_up == P()
    ranks = spawn(env_ranks, 4, cases)
    n = 37
    for option, (st_j, obs_j, st2_j, r_j, info_j, obs2_j) in wants.items():
        rs = [r[option] for r in ranks]
        _close(join([r["data"] for r in rs], n), st_j.data_sizes)
        np.testing.assert_array_equal(
            join([r["assoc0"] for r in rs], n).numpy(), np.asarray(st_j.assoc))
        _close(join([r["twin_feats"] for r in rs], n), obs_j.twin_feats,
               INFO)
        np.testing.assert_array_equal(
            join([r["assoc"] for r in rs], n).numpy(),
            np.asarray(st2_j.assoc))
        np.testing.assert_array_equal(
            join([r["info"]["assoc"] for r in rs], n).numpy(),
            np.asarray(info_j["assoc"]))
        _close(join([r["info"]["b"] for r in rs], n), info_j["b"], INFO)
        for r in rs:
            _close(r["bs_feats"], obs_j.bs_feats, INFO)
            _close(r["bs_feats2"], obs2_j.bs_feats, INFO)
            _close(r["reward"], r_j, INFO)
            for k in ("system_time", "uplink", "migration_rate",
                      "straggler_frac", "outage_frac", "consensus_time",
                      "accept_frac"):
                if k in info_j:
                    _close(r["info"][k], info_j[k], INFO)
            if st2_j.chain is not None:
                _close(r["chain"].stakes, st2_j.chain.stakes, INFO)

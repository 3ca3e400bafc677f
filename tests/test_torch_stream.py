"""Parity of the port's streamed FL (``repro_torch.fl.stream``) and its tiny
model with the reference on the CPU: the host plans exactly, the tiny model
and the batched local SGD, ``fl_init``, two ``fl_round``s (FedAvg and the
trimmed mean) from one state, and the churn update.

Tolerances: plans, participants, accept fractions and churned rows
exactly; the Eq. 4 weights exactly (integer-valued D_j sums); the stacked
losses and gradients of P models against each model's own, and the tiny
model's loss and gradients against the reference's, at atol 1e-6; a
round's ``fl_loss`` at rtol 1e-5 (the reference's own streamed-FL
tolerance) and its models at atol 1e-5; the batched local SGD against a
loop of the port's ``local_sgd`` at atol 1e-6: two steps of the tiny
model, one of the CNN (after one step the momenta differ by up to 5.4e-7;
from the second step on a max-pool near-tie can route a gradient another
way, and they then differ by up to 1.5e-3 on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import cifar10 as j_cifar
from repro.fl import stream as j_fls
from repro.fl.partition import iid_partition
from repro.models import tiny as j_tiny
from repro_torch import bridge
from repro_torch.fl import client as t_client
from repro_torch.fl import stream as t_fls
from repro_torch.models import cnn as t_cnn
from repro_torch.models import tiny as t_tiny
from repro_torch.optim import make_optimizer
from repro_torch.core.sharding import P
from torch_scenario_helpers import pin_backend

CPU = torch.device("cpu")
N, M = 12, 3


@pytest.fixture(scope="module")
def data():
    return j_cifar.load(max_train=600, max_test=128)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("start_round", [0, 3])
def test_stream_fl_plan_exact(start_round):
    fcfg = t_fls.FLServeConfig(participants=5, local_iters=3, batch_size=8)
    jcfg = j_fls.FLServeConfig(participants=5, local_iters=3, batch_size=8)
    shards = iid_partition(600, N, seed=3)
    got = t_fls.stream_fl_plan(fcfg, shards, 4, seed=2,
                               start_round=start_round)
    want = j_fls.stream_fl_plan(jcfg, shards, 4, seed=2,
                                start_round=start_round)
    for a, b in zip(got, want):
        _eq(a, b)
    assert got.users.dtype == torch.int64 and got.valid.dtype == torch.bool
    _eq(t_fls.plan_row(got, 2).batch, want.batch[2])
    # more participants than twins: -1 slots, not valid
    wide = t_fls.stream_fl_plan(
        t_fls.FLServeConfig(participants=15, local_iters=1, batch_size=8),
        shards, 1)
    assert (wide.users[0, N:] == -1).all() and not wide.valid[0, N:].any()
    with pytest.raises(ValueError, match="n_use"):
        t_fls.stream_fl_plan(t_fls.FLServeConfig(batch_size=64), shards, 1)
    assert [list(s) for s in t_fls.cyclic_shards(100, 7, 30)] == [
        list(s) for s in j_fls.cyclic_shards(100, 7, 30)]


def test_tiny_model_matches(data):
    p_j = j_tiny.init_params(jax.random.PRNGKey(1))
    p_t = {k: torch.tensor(v) for k, v in _np(p_j).items()}
    (x, y), _, _ = data
    batch_j = {"images": jnp.asarray(x[:32]), "labels": jnp.asarray(y[:32])}
    batch_t = {"images": torch.tensor(x[:32]), "labels": torch.tensor(y[:32])}
    np.testing.assert_allclose(t_tiny.forward(p_t, batch_t["images"]).numpy(),
                               np.asarray(j_tiny.forward(p_j, batch_j["images"])),
                               atol=1e-6)
    loss_j, g_j = jax.value_and_grad(j_tiny.loss_fn)(p_j, batch_j)
    leaves = {k: v.clone().requires_grad_() for k, v in p_t.items()}
    loss_t = t_tiny.loss_fn(leaves, batch_t)
    g_t = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), atol=1e-6)
    for k, g in zip(leaves, g_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), atol=1e-6)
    assert float(t_tiny.accuracy(p_t, batch_t)) == float(
        j_tiny.accuracy(p_j, batch_j))
    shapes = {k: tuple(v.shape) for k, v in t_tiny.init_params(
        torch.Generator().manual_seed(0)).items()}
    assert shapes == {k: v.shape for k, v in p_j.items()}
    assert sum(np.prod(s) for s in shapes.values()) == 3258


@pytest.mark.parametrize("model", ["tiny", "cnn"])
def test_loss_stacked_equals_per_model_loss(model, data):
    """P models on P minibatches at once: each loss and gradient is the
    model's own ``loss_fn``'s."""
    mdl = t_fls.get_model(model)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    models = [mdl.init_params(g) for g in gens]
    stacked = {k: torch.stack([m[k] for m in models]).requires_grad_()
               for k in models[0]}
    (x, y), _, _ = data
    xs = torch.tensor(x[:15]).reshape(3, 5, 32, 32, 3)
    ys = torch.tensor(y[:15]).reshape(3, 5)
    losses = mdl.loss_stacked(stacked, {"images": xs, "labels": ys})
    grads = torch.autograd.grad(losses.sum(), list(stacked.values()))
    for i, m in enumerate(models):
        leaves = {k: v.clone().requires_grad_() for k, v in m.items()}
        want = mdl.loss_fn(leaves, {"images": xs[i], "labels": ys[i]})
        g_want = torch.autograd.grad(want, list(leaves.values()))
        np.testing.assert_allclose(float(losses[i].detach()),
                                   float(want.detach()), atol=1e-6)
        for g, gw in zip(grads, g_want):
            np.testing.assert_allclose(g[i].numpy(), gw.numpy(), atol=1e-6)


@pytest.mark.parametrize("model", ["tiny", "cnn"])
def test_local_sgd_stacked_equals_per_twin_loop(model, data):
    """The batched local SGD is ``local_sgd``'s law for every twin."""
    mdl = t_fls.get_model(model)
    params = mdl.init_params(torch.Generator().manual_seed(2))
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    (x, y), _, _ = data
    rs = np.random.RandomState(0)
    idx = rs.randint(0, x.shape[0], (3, 2 if model == "tiny" else 1, 4))
    xs, ys = torch.tensor(x[idx]), torch.tensor(y[idx])
    p, st, losses = t_client.local_sgd_stacked(mdl.loss_stacked, opt,
                                               params, xs, ys)
    assert losses.shape == idx.shape[:2]
    tol = dict(atol=1e-6, rtol=0)
    for i in range(3):
        pi, si, li = t_client.local_sgd(mdl.loss_fn, opt, params, xs[i],
                                        ys[i])
        np.testing.assert_allclose(losses[i].numpy(), li.numpy(), **tol)
        for k in params:
            np.testing.assert_allclose(p[k][i].numpy(), pi[k].numpy(),
                                       err_msg=k, **tol)
            np.testing.assert_allclose(st["mom"][k][i].numpy(),
                                       si["mom"][k].numpy(), **tol)
    assert t_fls.get_model("cnn") is t_cnn
    with pytest.raises(ValueError, match="model must be one of"):
        t_fls.get_model("resnet")


def _states(fcfg_j, data, active, malicious=None):
    fl_j = j_fls.fl_init(fcfg_j, jax.random.PRNGKey(7), data, active,
                         malicious=malicious)
    return fl_j, bridge.fl_state_from_numpy(_np(fl_j), CPU)


def test_fl_init_matches_reference(data):
    active = np.arange(N) < 9
    fcfg_t = t_fls.FLServeConfig(model="tiny", n_eval=64)
    fl_j, fl_t = _states(j_fls.FLServeConfig(model="tiny", n_eval=64), data,
                         active)
    got = t_fls.fl_init(fcfg_t, None, data, torch.tensor(active),
                        params=fl_t.params)
    for k in fl_t.params:
        _eq(got.twin_params[k], fl_j.twin_params[k])
        _eq(got.twin_mom[k], fl_j.twin_mom[k])
        assert got.params[k] is not fl_t.params[k]  # a copy
    _eq(got.x_eval, fl_j.x_eval)
    assert got.x_eval.shape[0] == 64 and not got.malicious.any()
    _eq(got.twin_params["w1"][9:], 0.0)


@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean"])
def test_fl_round_matches_reference(aggregator, data, monkeypatch):
    """Two rounds from one state, 6 of 12 twins planned a round, two of
    them malicious (label flip), the verify gate on, one twin inactive
    (the port's sums on the index-ordered ``segment_sum`` backend)."""
    pin_backend(monkeypatch, "segment_sum")
    kw = dict(model="tiny", participants=6, local_iters=2, batch_size=8,
              aggregator=aggregator, n_eval=64)
    fcfg_j, fcfg_t = j_fls.FLServeConfig(**kw), t_fls.FLServeConfig(**kw)
    active = np.ones(N, bool)
    active[4] = False
    mal = np.zeros(N, bool)
    mal[[1, 7]] = True
    fl_j, fl_t = _states(fcfg_j, data, active, malicious=mal)
    rs = np.random.RandomState(1)
    sizes = np.where(active, rs.randint(20, 80, N), 0).astype(np.float32)
    assoc = np.where(active, np.arange(N) % M, M).astype(np.int32)
    shards = iid_partition(600, N, seed=3)
    plan_j = j_fls.stream_fl_plan(fcfg_j, shards, 2)
    plan_t = t_fls.stream_fl_plan(fcfg_t, shards, 2)
    for t in range(2):
        fl_j, mj = j_fls.fl_round(
            fcfg_j, fl_j, j_fls.plan_row(plan_j, t), active=jnp.asarray(active),
            data_sizes=jnp.asarray(sizes), assoc=jnp.asarray(assoc), n_bs=M)
        fl_t2, mt = t_fls.fl_round(
            fcfg_t, fl_t, t_fls.plan_row(plan_t, t),
            active=torch.tensor(active), data_sizes=torch.tensor(sizes),
            assoc=torch.tensor(assoc), n_bs=M)
        assert fl_t2 is fl_t  # written in place
        assert set(mt) == set(mj)
        _eq(mt["fl_bs_weight"], mj["fl_bs_weight"])
        _eq(mt["fl_n_participants"], mj["fl_n_participants"])
        _eq(mt["fl_accept_frac"], mj["fl_accept_frac"])
        np.testing.assert_allclose(float(mt["fl_loss"]), float(mj["fl_loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mt["fl_accuracy"]),
                                   float(mj["fl_accuracy"]), atol=1 / 64)
        for k in fl_t.params:
            for got, want in ((fl_t.params[k], fl_j.params[k]),
                              (fl_t.twin_params[k], fl_j.twin_params[k]),
                              (fl_t.twin_mom[k], fl_j.twin_mom[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-5, err_msg=k)
        users = plan_t.users[t][plan_t.valid[t]].numpy()
        assert int(mt["fl_n_participants"]) == int(active[users].sum())
    assert (plan_t.users == 4).any()  # twin 4 was planned, but is inactive
    _eq(fl_t.twin_params["w1"][4], 0.0)


def test_fl_churn_update_matches_reference(data):
    fcfg_j = j_fls.FLServeConfig(model="tiny")
    active = np.arange(N) % 4 != 0
    fl_j, fl_t = _states(fcfg_j, data, active)
    rs = np.random.RandomState(4)
    noisy = {k: np.asarray(v) + rs.normal(size=v.shape).astype(np.float32)
             for k, v in fl_j.twin_mom.items()}
    fl_j = fl_j._replace(twin_mom={k: jnp.asarray(v)
                                   for k, v in noisy.items()})
    fl_t = fl_t._replace(twin_mom={k: torch.tensor(v)
                                   for k, v in noisy.items()})
    joined = ~active & (np.arange(N) < 6)
    left = active & (np.arange(N) % 3 == 0)
    want = j_fls.fl_churn_update(fl_j, joined, left)
    got = t_fls.fl_churn_update(fl_t, torch.tensor(joined),
                                torch.tensor(left))
    for k in fl_t.params:
        _eq(got.twin_params[k], want.twin_params[k])
        _eq(got.twin_mom[k], want.twin_mom[k])
    assert got.twin_params["w1"] is fl_t.twin_params["w1"]  # in place
    specs = t_fls.fl_specs(t_fls.FLServeConfig())
    assert specs.twin_params == specs.twin_mom == P("twin")
    assert specs.malicious == P("twin")
    assert specs.params == specs.x == specs.x_eval == P()
    assert t_fls.fl_specs(None) == P()


def test_sharded_fl_round_matches_reference(data):
    """Two FedAvg rounds in the twin scope of 3 gloo ranks at a ragged
    capacity (11), participants planned across the ranks, two malicious,
    one inactive: against the single-device port at the gate's tolerances
    (``fl_loss`` rtol 1e-5, buffers and the global model atol 2e-6) and
    against the reference as ``test_fl_round_matches_reference`` holds it
    (loss rtol 1e-5, models atol 1e-5); the global model is bitwise equal
    on every rank. A robust aggregator refuses a scope."""
    from torch_sharding_helpers import fl_round_ranks, spawn

    n = 11
    kw = dict(model="tiny", participants=6, local_iters=2, batch_size=8,
              n_eval=64)
    fcfg_j, fcfg_t = j_fls.FLServeConfig(**kw), t_fls.FLServeConfig(**kw)
    active = np.ones(n, bool)
    active[4] = False
    mal = np.zeros(n, bool)
    mal[[1, 7]] = True
    fl_j, fl_t = _states(fcfg_j, data, active, malicious=mal)
    rs = np.random.RandomState(1)
    sizes = np.where(active, rs.randint(20, 80, n), 0).astype(np.float32)
    assoc = np.where(active, np.arange(n) % M, M).astype(np.int32)
    shards = iid_partition(600, n, seed=3)
    plan_j = j_fls.stream_fl_plan(fcfg_j, shards, 2)
    plan_t = t_fls.stream_fl_plan(fcfg_t, shards, 2)
    plans = [t_fls.plan_row(plan_t, t) for t in range(2)]
    ranks = spawn(fl_round_ranks, 3, fcfg_t, data,
                  {k: v.clone() for k, v in fl_t.params.items()},
                  torch.tensor(active), torch.tensor(sizes),
                  torch.tensor(assoc), mal, plans, M)
    single = t_fls.fl_init(fcfg_t, None, data, torch.tensor(active),
                           params=fl_t.params, malicious=mal)
    for t in range(2):
        fl_j, mj = j_fls.fl_round(
            fcfg_j, fl_j, j_fls.plan_row(plan_j, t),
            active=jnp.asarray(active), data_sizes=jnp.asarray(sizes),
            assoc=jnp.asarray(assoc), n_bs=M)
        single, ms = t_fls.fl_round(
            fcfg_t, single, plans[t], active=torch.tensor(active),
            data_sizes=torch.tensor(sizes), assoc=torch.tensor(assoc), n_bs=M)
        for r in ranks:
            got = r["metrics"][t]
            _eq(got["fl_n_participants"], mj["fl_n_participants"])
            _eq(got["fl_accept_frac"], mj["fl_accept_frac"])
            np.testing.assert_allclose(got["fl_bs_weight"].numpy(),
                                       ms["fl_bs_weight"].numpy(), rtol=1e-5)
            for want in (ms["fl_loss"], mj["fl_loss"]):
                np.testing.assert_allclose(float(got["fl_loss"]),
                                           float(want), rtol=1e-5)
    for r in ranks:
        for k in single.params:
            np.testing.assert_allclose(r["params"][k].numpy(),
                                       single.params[k].numpy(), atol=2e-6)
            np.testing.assert_allclose(r["p"][k].numpy(),
                                       single.twin_params[k].numpy(),
                                       atol=2e-6)
            np.testing.assert_allclose(r["m"][k].numpy(),
                                       single.twin_mom[k].numpy(), atol=2e-6)
            np.testing.assert_allclose(r["params"][k].numpy(),
                                       np.asarray(fl_j.params[k]), atol=1e-5)
    from repro_torch.core import sharding as t_sh

    with t_sh.twin_scope(n, n, 1):
        with pytest.raises(ValueError, match="sharded form"):
            t_fls.fl_round(t_fls.FLServeConfig(aggregator="krum"), single,
                           plans[0], active=torch.tensor(active),
                           data_sizes=torch.tensor(sizes),
                           assoc=torch.tensor(assoc), n_bs=M)

"""Parity of the port's FL slice with the reference on the CPU: data and
partitions, the CNN, local training, the Eq. 3/4/5 aggregations, and whole
``DTWNSystem`` rounds started from the reference system's state.

Tolerances: the CNN's loss and gradients at atol 1e-5 (one step drifts
about 4e-7 between XLA and torch on the CPU); round losses and latency at
rtol 1e-5, the tolerance of the reference's own streamed-vs-batch FL test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as j_hier
from repro.data import cifar10 as j_cifar
from repro.fl import DTWNSystem as JSystem
from repro.fl import FLConfig as JConfig
from repro.fl import client as j_client
from repro.fl import partition as j_part
from repro.models import cnn as j_cnn
from repro_torch.bridge import state_from_numpy
from repro_torch.core import hierarchy as t_hier
from repro_torch.data import cifar10 as t_cifar
from repro_torch.fl import DTWNSystem as TSystem
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import client as t_client
from repro_torch.fl import partition as t_part
from repro_torch.models import cnn as t_cnn

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    return j_cifar.load(max_train=2000, max_test=500)


@pytest.fixture(scope="module")
def params_np():
    p = j_cnn.init_params(jax.random.PRNGKey(3))
    return {k: np.asarray(v) for k, v in p.items()}


def _t(params_np):
    return {k: torch.tensor(np.asarray(v)) for k, v in params_np.items()}


def test_cifar10_load_identical(data):
    (xtr, ytr), (xte, yte), name = t_cifar.load(max_train=2000, max_test=500)
    (jxtr, jytr), (jxte, jyte), jname = data
    assert name == jname
    for a, b in ((xtr, jxtr), (ytr, jytr), (xte, jxte), (yte, jyte)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["iid", "iid_even", "dirichlet",
                                  "scenario", "scenario_alpha"])
def test_partitions_identical(kind, data):
    y = data[0][1]
    sizes = np.random.RandomState(5).pareto(1.5, 12) + 1.0
    calls = {
        "iid": lambda m: m.iid_partition(2000, 13, seed=4),
        "iid_even": lambda m: m.iid_partition(2000, 13, seed=4, uneven=False),
        "dirichlet": lambda m: m.dirichlet_partition(y, 13, alpha=0.2, seed=4),
        "scenario": lambda m: m.scenario_partition(2000, sizes, seed=4),
        "scenario_alpha": lambda m: m.scenario_partition(
            2000, sizes, labels=y, alpha=0.3, seed=4),
    }
    got, want = calls[kind](t_part), calls[kind](j_part)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cnn_loss_and_grads_match(data, params_np):
    (x, y), _, _ = data
    xb, yb = x[:16], y[:16]
    jloss, jgrads = jax.value_and_grad(j_cnn.loss_fn)(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        {"images": jnp.asarray(xb), "labels": jnp.asarray(yb)})
    tp = {k: v.requires_grad_(True) for k, v in _t(params_np).items()}
    tloss = t_cnn.loss_fn(tp, {"images": torch.as_tensor(xb),
                               "labels": torch.as_tensor(yb)})
    keys = sorted(tp)
    tgrads = torch.autograd.grad(tloss, [tp[k] for k in keys])
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5)
    for k, g in zip(keys, tgrads):
        assert g.shape == jgrads[k].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   atol=1e-5, err_msg=k)
    acc_t = float(t_cnn.accuracy(_t(params_np), {
        "images": torch.as_tensor(x[:64]), "labels": torch.as_tensor(y[:64])}))
    acc_j = float(j_cnn.accuracy(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        {"images": jnp.asarray(x[:64]), "labels": jnp.asarray(y[:64])}))
    assert acc_t == acc_j


def test_train_local_same_batches_and_params(data, params_np):
    (x, y), _, _ = data
    rows = np.arange(100, 180)
    seen = []

    def recording_loss(params, batch):
        seen.append(batch["images"].detach().numpy().copy())
        return t_cnn.loss_fn(params, batch)

    jp, jl = j_client.make_local_trainer(j_cnn.loss_fn, lr=0.05)(
        {k: jnp.asarray(v) for k, v in params_np.items()}, x[rows], y[rows],
        batch_size=16, local_iters=3, seed=1007)
    tp, tl = t_client.make_local_trainer(recording_loss, lr=0.05)(
        _t(params_np), torch.as_tensor(x), torch.as_tensor(y),
        batch_size=16, local_iters=3, seed=1007, rows=rows)
    # the reference's draw law, replayed: the port trained on these rows
    rng = np.random.RandomState(1007)
    assert len(seen) == 3
    for images in seen:
        np.testing.assert_array_equal(
            images, x[rows[rng.choice(rows.size, size=16, replace=False)]])
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    for k in params_np:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-5, err_msg=k)


def _stacked_models(n, seed):
    rs = np.random.RandomState(seed)
    shapes = {"a_w": (n, 3, 4), "b": (n, 5), "c": (n, 1)}
    return {k: rs.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def test_bs_aggregate_stacked_matches():
    st = _stacked_models(9, 0)
    sizes = np.random.RandomState(1).randint(50, 400, 9).astype(np.float32)
    assoc = np.array([0, 2, 2, 1, 0, 2, 4, 4, 0], np.int32)  # BS 3 empty
    jper, jw = j_hier.bs_aggregate_stacked(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(sizes),
        jnp.asarray(assoc), 5)
    tper, tw = t_hier.bs_aggregate_stacked(
        _t(st), torch.as_tensor(sizes), torch.as_tensor(assoc), 5)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for k in st:
        np.testing.assert_allclose(tper[k].numpy(), np.asarray(jper[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_global_aggregate_matches(weighted):
    models = [_stacked_models(1, s) for s in range(4)]
    sizes = [120.0, 40.0, 300.0, 7.0]
    jm = j_hier.global_aggregate(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in models], sizes,
        weighted_global=weighted)
    tm = t_hier.global_aggregate([_t(m) for m in models], sizes,
                                 weighted_global=weighted)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_fedavg_flat_kernel_matches(params_np):
    rs = np.random.RandomState(2)
    models = [{k: (v + rs.normal(scale=0.01, size=v.shape)).astype(np.float32)
               for k, v in params_np.items()} for _ in range(3)]
    sizes = [310.0, 95.0, 512.0]
    jm = j_hier.fedavg_flat_kernel(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in models], sizes)
    tm = t_hier.fedavg_flat_kernel([_t(m) for m in models], sizes)
    for k in params_np:
        assert tm[k].shape == jm[k].shape and tm[k].dtype == torch.float32
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_hierarchical_fedavg_stacked_matches():
    st = _stacked_models(7, 3)
    sizes = np.arange(1, 8, dtype=np.float32) * 10
    assoc = np.array([0, 1, 1, 0, 2, 2, 2], np.int32)
    for weighted in (False, True):
        jm = j_hier.hierarchical_fedavg_stacked(
            {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(sizes),
            jnp.asarray(assoc), 4, weighted_global=weighted)
        tm = t_hier.hierarchical_fedavg_stacked(
            _t(st), torch.as_tensor(sizes), torch.as_tensor(assoc), 4,
            weighted_global=weighted)
        for k in st:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, atol=1e-6)


def _capture_bs_weights(monkeypatch, module, sink):
    orig = module.bs_aggregate_stacked

    def spy(*a, **kw):
        per_bs, bs_w = orig(*a, **kw)
        sink.append(np.asarray(bs_w))
        return per_bs, bs_w

    monkeypatch.setattr(module, "bs_aggregate_stacked", spy)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_dtwn_rounds_match_reference(use_kernel, data, monkeypatch):
    """The slice: two rounds of the port from the reference system's state
    against two rounds of the reference, under one association."""
    kw = dict(n_users=16, n_bs=3, local_iters=2, batch_size=16,
              use_kernel_aggregation=use_kernel)
    jsys = JSystem(JConfig(**kw), data, seed=0)
    init = state_from_numpy({k: np.asarray(v) for k, v in jsys.params.items()},
                            np.asarray(jsys.dist), np.asarray(jsys.h_up),
                            np.asarray(jsys.h_down), CPU)
    tsys = TSystem(TConfig(**kw), data, seed=0, init_state=init, device=CPU)
    np.testing.assert_array_equal(tsys.freqs, jsys.freqs)
    np.testing.assert_array_equal(tsys.data_sizes, jsys.data_sizes)
    assoc = np.arange(16) % 3
    jw, tw = [], []
    _capture_bs_weights(monkeypatch, j_hier, jw)
    _capture_bs_weights(monkeypatch, t_hier, tw)
    for _ in range(2):
        ji = jsys.run_round(assoc, participating_users=6)
        ti = tsys.run_round(assoc, participating_users=6)
        assert ti["chosen"] == ji["chosen"]
        assert ti["n_verified"] == ji["n_verified"]
        assert ti["n_submitted"] == ji["n_submitted"]
        assert ti["chain_valid"] and ji["chain_valid"]
        np.testing.assert_allclose(ti["loss"], ji["loss"], rtol=1e-5)
        np.testing.assert_allclose(ti["round_time_s"], ji["round_time_s"],
                                   rtol=1e-5)
        np.testing.assert_allclose(ti["consensus_time_s"],
                                   ji["consensus_time_s"], rtol=1e-5)
    assert len(jw) == len(tw) == 2
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)  # Eq. 4 weights bit-identical
    assert tsys.chain.stakes == jsys.chain.stakes
    for k in jsys.params:
        np.testing.assert_allclose(tsys.params[k].numpy(),
                                   np.asarray(jsys.params[k]), atol=1e-4)


def test_dtwn_rejects_unported_options(data):
    for bad in (dict(aggregator="krum"), dict(malicious_frac=0.2),
                dict(faults=object()), dict(consensus=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            TSystem(TConfig(n_users=4, n_bs=2, **bad), data, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        TSystem(TConfig(n_users=4, n_bs=2), data, device=CPU,
                scenario=(None, 0))


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_sgd_law_matches(wd):
    """m = mu*m + g; p -= lr*(m + wd*p), weight decay outside the momentum."""
    from repro.optim import sgd as j_sgd
    from repro_torch.optim import sgd as t_sgd

    rs = np.random.RandomState(6)
    params = {"a": rs.normal(size=(3, 4)).astype(np.float32),
              "b": rs.normal(size=5).astype(np.float32)}
    grads = [{k: rs.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jo, to = j_sgd(0.1, momentum=0.9, weight_decay=wd), \
        t_sgd(0.1, momentum=0.9, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = to.update(tp, _t(g), ts)
    assert ts["step"] == int(js["step"]) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts["mom"][k].numpy(),
                                   np.asarray(js["mom"][k]), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_host_list_aggregations_match(weighted):
    st = _stacked_models(8, 4)
    models = [{k: v[i] for k, v in st.items()} for i in range(8)]
    sizes = np.arange(8, dtype=np.float32) * 3 + 5
    assoc = np.array([2, 0, 0, 2, 3, 3, 0, 2])  # BS 1 empty
    jmodels = [{k: jnp.asarray(v) for k, v in m.items()} for m in models]
    tmodels = [_t(m) for m in models]
    pairs = [
        (j_hier.hierarchical_fedavg(jmodels, sizes, assoc, 4,
                                    weighted_global=weighted),
         t_hier.hierarchical_fedavg(tmodels, sizes, assoc, 4,
                                    weighted_global=weighted)),
        (j_hier.flat_fedavg(jmodels, sizes), t_hier.flat_fedavg(tmodels, sizes)),
        (j_hier.bs_aggregate(jmodels[:3], sizes[:3]),
         t_hier.bs_aggregate(tmodels[:3], sizes[:3])),
    ]
    for jm, tm in pairs:
        for k in st:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)

"""Parity of the port's FL slice with the reference on the CPU: data and
partitions, the CNN, local training (honest and malicious), the Eq. 3/4/5
aggregations, and whole ``DTWNSystem`` rounds started from the reference
system's state, plain and under attack, faults and PBFT consensus.

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
from repro.core.consensus import ConsensusConfig as JCons
from repro.core.faults import FaultConfig as JFaults
from repro.data import cifar10 as j_cifar
from repro.fl import DTWNSystem as JSystem
from repro.fl import FLConfig as JConfig
from repro.fl import client as j_client
from repro.fl import partition as j_part
from repro.models import cnn as j_cnn
from repro_torch.bridge import state_from_numpy
from repro_torch.core import faults as t_faults
from repro_torch.core import hierarchy as t_hier
from repro_torch.core.consensus import ConsensusConfig as TCons
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


def test_dtwn_rejects_unported_options(data, monkeypatch):
    """Scenario rows (ROADMAP A8) are ported: ``DTWNSystem(scenario=(batch,
    i))`` takes the row's data sizes (rtol 1e-6), shards, malicious mask,
    straggler/outage rates and consensus overrides as the reference does,
    given the reference's population and malicious uniforms, and its first
    round (the port fed the reference's fault draws) bills the same round
    and PBFT times (rtol 1e-5) with the same participants."""
    from repro.core import scenario as j_scn
    from repro_torch import bridge
    from repro_torch.core import scenario as t_scn

    jb = j_scn.make_batch(jax.random.PRNGKey(4), 3, malicious=(0.2, 0.5),
                          straggler=(0.1, 0.4), outage=(0.05, 0.3),
                          byzantine=(0.0, 0.4), quorum=(0.0, 2.0),
                          block_size=(1e6, 8e6))
    tb = bridge.scenario_batch_from_numpy(
        jax.tree_util.tree_map(np.asarray, jb))
    n, row = 12, 1
    ks = jax.random.split(jb.key[row], 4)
    draws = t_scn.ScenarioDraws(
        data_u=torch.tensor(np.stack([np.asarray(
            jax.random.uniform(ks[0], (n,)))] * 3)),
        mal_u=torch.tensor(np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jb.key[row], 7), (n,)))] * 3)))
    kw = dict(n_users=n, n_bs=3, local_iters=1, batch_size=16)
    jsys = JSystem(JConfig(**kw, faults=JFaults(), consensus=JCons()), data,
                   seed=0, scenario=(jb, row))
    init = state_from_numpy({k: np.asarray(v) for k, v in jsys.params.items()},
                            np.asarray(jsys.dist), np.asarray(jsys.h_up),
                            np.asarray(jsys.h_down), CPU)
    tsys = TSystem(TConfig(**kw, faults=t_faults.FaultConfig(),
                           consensus=TCons()), data, seed=0,
                   init_state=init, device=CPU, scenario=(tb, row),
                   scenario_draws=draws)
    np.testing.assert_allclose(tsys.data_sizes, jsys.data_sizes, rtol=1e-6)
    assert len(tsys.shards) == len(jsys.shards) == n
    for a, b in zip(tsys.shards, jsys.shards):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsys.malicious, jsys.malicious)
    assert 0 < tsys.malicious.sum() < n
    assert (tsys._row_straggler, tsys._row_outage) == pytest.approx(
        (jsys._row_straggler, jsys._row_outage), rel=1e-7)
    for f in ("byzantine_frac", "quorum_f", "block_size_bits"):
        assert getattr(tsys.cfg.consensus, f) == pytest.approx(
            getattr(jsys.cfg.consensus, f), rel=1e-7), f
    monkeypatch.setattr(tsys, "round_fault_draws", lambda: _ref_fault_draws(
        jax.random.fold_in(jsys._fault_key, tsys._round), n, 3))
    assoc = np.arange(n) % 3
    ji = jsys.run_round(assoc, participating_users=4)
    ti = tsys.run_round(assoc, participating_users=4)
    assert ti["chosen"] == ji["chosen"]
    for key in ("round_time_s", "consensus_time_s"):
        np.testing.assert_allclose(ti[key], ji[key], rtol=1e-5, err_msg=key)


def _ref_fault_draws(key, n, m):
    """The reference's straggler and outage draws of
    ``faults.faulty_round_time(key)``, in its key-split order."""
    k_slow, k_out = jax.random.split(key)
    k_mask, k_mag = jax.random.split(k_slow)
    return t_faults.FaultDraws(
        *(torch.tensor(np.asarray(a)) for a in (
            jax.random.uniform(k_mask, (n,)),
            jax.random.exponential(k_mag, (n,)),
            jax.random.uniform(k_out, (m,)))))


ROBUST_CASES = {
    "trimmed_mean_label_flip": (
        dict(aggregator="trimmed_mean", malicious_frac=0.3,
             attack="label_flip"), {}),
    "krum_model_replacement": (
        dict(aggregator="krum", malicious_frac=0.3,
             attack="model_replacement"), {}),
    "faults": ({}, dict(faults=(JFaults(straggler_rate=0.3, outage_rate=0.3),
                                t_faults.FaultConfig(straggler_rate=0.3,
                                                     outage_rate=0.3)))),
    "pbft_consensus": ({}, dict(consensus=(
        JCons(quorum_f=1, byzantine_frac=0.2),
        TCons(quorum_f=1, byzantine_frac=0.2)))),
}


def _spy(monkeypatch, module, name, sink):
    orig = getattr(module, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        sink.append((a, k, out))
        return out

    monkeypatch.setattr(module, name, spy)
    return orig


@pytest.mark.parametrize("case", sorted(ROBUST_CASES))
def test_dtwn_robust_rounds_match_reference(case, data, monkeypatch):
    """Two rounds of the port against the reference from one state, under
    attack with a robust aggregator, with stragglers and outages (the port
    fed the reference's per-round fault draws), and with the PBFT block
    term. Most twins sit on BS 0, so its cohorts (4-5 of the 6 trained)
    are large enough to trim and to drop from.

    The trimmed mean is discontinuous in its inputs: where two clients sit
    nearly as far from the centre at a coordinate, the ~4e-7 a step that
    XLA's and torch's convolutions drift apart (ROADMAP C2) can decide
    which one is peeled, and the aggregate there moves by the clients'
    spread. So the port's aggregator is also held to the reference's on
    the reference's own inputs of each round (the same survivors exactly,
    both on the index-ordered ``segment_sum`` backend), and the end-to-end
    params of that case to atol 1e-4 at all but 1e-5 of the coordinates.
    """
    from repro.core import faults as j_faults_mod

    common, paired = ROBUST_CASES[case]
    kw = dict(n_users=12, n_bs=3, local_iters=2, batch_size=16, **common)
    jkw = {k: v[0] for k, v in paired.items()}
    tkw = {k: v[1] for k, v in paired.items()}
    jsys = JSystem(JConfig(**kw, **jkw), data, seed=0)
    init = state_from_numpy({k: np.asarray(v) for k, v in jsys.params.items()},
                            np.asarray(jsys.dist), np.asarray(jsys.h_up),
                            np.asarray(jsys.h_down), CPU)
    tsys = TSystem(TConfig(**kw, **tkw), data, seed=0, init_state=init,
                   device=CPU)
    np.testing.assert_array_equal(tsys.malicious, jsys.malicious)
    if "faults" in paired:
        monkeypatch.setattr(tsys, "round_fault_draws", lambda: (
            _ref_fault_draws(jax.random.fold_in(jsys._fault_key,
                                                tsys._round), 12, 3)))
    jcalls, tcalls = [], []
    j_agg = _spy(monkeypatch, j_faults_mod, "robust_bs_aggregate_stacked",
                 jcalls)
    t_agg = _spy(monkeypatch, t_faults, "robust_bs_aggregate_stacked",
                 tcalls)
    assoc = np.array([0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 2, 2])
    for _ in range(2):
        ji = jsys.run_round(assoc, participating_users=6)
        ti = tsys.run_round(assoc, participating_users=6)
        assert ti["chosen"] == ji["chosen"]
        for key in ("n_verified", "n_submitted", "n_suspect"):
            assert ti[key] == ji[key], key
        assert ti["chain_valid"] and ji["chain_valid"]
        for key in ("loss", "round_time_s", "consensus_time_s"):
            np.testing.assert_allclose(ti[key], ji[key], rtol=1e-5,
                                       err_msg=key)
    assert tsys.chain.stakes == jsys.chain.stakes
    robust = "aggregator" in common
    assert len(jcalls) == len(tcalls) == (2 if robust else 0)
    for (a, k, _), (_, _, tout) in zip(jcalls, tcalls):
        assert tout[2].min() < 1.0  # the rule peeled or dropped something
        stacked, sizes, assoc_c, m = a
        k = dict(k, backend="segment_sum")
        jt, jw, js = j_agg(stacked, sizes, assoc_c, m, **k)
        tt, tw, ts = t_agg(
            {n: torch.tensor(np.asarray(v)) for n, v in stacked.items()},
            torch.tensor(np.asarray(sizes)), torch.tensor(np.asarray(assoc_c)),
            m, **k)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
        for n in jt:
            np.testing.assert_allclose(tt[n].numpy(), np.asarray(jt[n]),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
    if robust:
        assert tsys.malicious[ti["chosen"]].any()
    for k in jsys.params:
        got, want = tsys.params[k].numpy(), np.asarray(jsys.params[k])
        if common.get("aggregator") == "trimmed_mean":
            assert np.mean(np.abs(got - want) > 1e-4) <= 1e-5, k
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("attack", ["label_flip", "model_replacement"])
def test_attack_trainers_match(attack, data, params_np):
    (x, y), _, _ = data
    rows = np.arange(300, 380)
    jp, jl = j_client.make_attack_trainer(j_cnn.loss_fn, attack=attack,
                                          lr=0.05, boost=3.0)(
        {k: jnp.asarray(v) for k, v in params_np.items()}, x[rows], y[rows],
        batch_size=16, local_iters=3, seed=2011)
    tp, tl = t_client.make_attack_trainer(t_cnn.loss_fn, attack=attack,
                                          lr=0.05, boost=3.0)(
        _t(params_np), torch.as_tensor(x), torch.as_tensor(y),
        batch_size=16, local_iters=3, seed=2011, rows=rows)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    for k in params_np:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-5, err_msg=k)
    assert t_client.ATTACKS == j_client.ATTACKS
    np.testing.assert_array_equal(
        t_client.flip_labels(torch.as_tensor(y[:20])).numpy(),
        np.asarray(j_client.flip_labels(y[:20])))
    with pytest.raises(ValueError, match="attack"):
        t_client.make_attack_trainer(t_cnn.loss_fn, attack="backdoor")


def test_local_sgd_matches(data, params_np):
    from repro.optim import make_optimizer as j_opt
    from repro_torch.optim import make_optimizer as t_opt

    (x, y), _, _ = data
    xs, ys = x[:48].reshape(3, 16, *x.shape[1:]), y[:48].reshape(3, 16)
    jp, _, jl = j_client.local_sgd(
        j_cnn.loss_fn, j_opt("sgd", lr=0.05, momentum=0.9),
        {k: jnp.asarray(v) for k, v in params_np.items()}, jnp.asarray(xs),
        jnp.asarray(ys))
    tp, _, tl = t_client.local_sgd(
        t_cnn.loss_fn, t_opt("sgd", lr=0.05, momentum=0.9), _t(params_np),
        torch.as_tensor(xs), torch.as_tensor(ys))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for k in params_np:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-5, err_msg=k)


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

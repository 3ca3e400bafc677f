"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's, on the CPU.

Both sides start from one parameter tree (nested dicts with a list and a
tuple, stacked (L, d) and (L, d, f) leaves, a vector), and from one state:
the reference's after two steps, carried over by
``bridge.opt_state_from_numpy``. Both then take three steps on the same
gradients, numpy normals made from a seed (the reference's own gradients
would do as well; fixed ones keep adamw's near-``sign(g)`` first steps from
magnifying two frameworks' gradient noise). Tolerances: fp32 params and
moments rtol 1e-6 (atol 1e-7 on values that cross 0: the two frameworks'
fp32 ``pow``/``rsqrt`` orders); bf16 moments and params bit for bit.
adamw and adafactor compute in fp32 and round a bf16 leaf once; sgd, the FL
path's fp32 optimizer, is held in fp32 only (in bf16 torch rounds after
each operation, where XLA's fused expression rounds once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import cosine_schedule as j_cosine
from repro.optim import linear_warmup_cosine as j_warmup
from repro.optim import make_optimizer as j_make
from repro_torch import bridge
from repro_torch.optim import (cosine_schedule, linear_warmup_cosine,
                               make_optimizer)
from repro_torch.utils.tree import tree_leaves, tree_map

OPTS = ("sgd", "adamw", "adamw_bf16", "adafactor")
TOL = dict(rtol=1e-6, atol=1e-7)


def _np_tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"blocks": {"w": n(2, 8, 12), "norm_scale": n(2, 8)},
            "embed": n(16, 8), "bias": n(12),
            "extra": [n(3), (n(4, 5),)]}


def _jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _torch(tree, dtype):
    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(conv(v) for v in a)
        return torch.tensor(np.asarray(a)).to(dtype)

    return conv(tree)


def _bits(x):
    """A leaf as comparable numpy: fp32 values, or a bf16 leaf's bits."""
    if torch.is_tensor(x):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(port, ref):
    got, want = tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape
        if w.dtype == np.int16:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name,param_dtype", [
    *((n, "float32") for n in OPTS),
    *((n, "bfloat16") for n in OPTS[1:])])
def test_updates_match_reference_from_a_mid_training_state(name, param_dtype):
    jdt = jnp.dtype(param_dtype)
    tdt = getattr(torch, param_dtype)
    jopt, topt = j_make(name, lr=0.05), make_optimizer(name, lr=0.05)
    jp = _jax(_np_tree(0), jdt)
    js = jopt.init(jp)
    for k in range(2):  # the reference's state, two steps in
        jp, js = jopt.update(jp, _jax(_np_tree(10 + k, 0.1), jdt), js)
    tp = _torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp), tdt)
    ts = bridge.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), "cpu")
    if name == "sgd":
        ts["step"] = int(ts["step"])  # the port's sgd counts on the host
    _same(tp, jp)
    _same(ts, js)
    for k in range(3):
        g = _np_tree(20 + k, 0.1)
        jp, js = jopt.update(jp, _jax(g, jdt), js)
        tp, ts = topt.update(tp, _torch(g, tdt), ts)
        _same(tp, jp)
        _same(ts, js)
    assert int(ts["step"]) == int(js["step"]) == 5


def test_update_with_lr_now_and_structure():
    """``lr_now`` replaces the lr; the state keeps the reference's
    structure (``{"m", "v", "step"}``, ``{"v": {{"vr", "vc"} | {"v"}},
    "step"}``) and dtypes; the update records no autograd history."""
    for name in OPTS:
        jopt, topt = j_make(name), make_optimizer(name)
        g = _np_tree(3)
        jp, js = jopt.update(_jax(_np_tree(0), jnp.float32),
                             _jax(g, jnp.float32),
                             jopt.init(_jax(_np_tree(0), jnp.float32)),
                             jnp.float32(0.02))
        tp0 = _torch(_np_tree(0), torch.float32)
        tp0 = tree_map(lambda x: x.requires_grad_(), tp0)
        tp, ts = topt.update(tp0, _torch(g, torch.float32), topt.init(tp0),
                             torch.tensor(0.02))
        assert sorted(ts) == sorted(js)
        _same(tp, jp)
        _same(ts, js)
        assert not any(x.requires_grad for x in tree_leaves(tp))
        assert not any(x.requires_grad for x in tree_leaves(ts)
                       if torch.is_tensor(x))
        assert isinstance(tp["extra"], list) and isinstance(tp["extra"][1],
                                                            tuple)


def test_sgd_on_flat_dicts_keeps_its_bits():
    """The FL path's flat dicts: the tree-mapped sgd gives the bits of the
    law the port's FL tests were written against."""
    rng = np.random.default_rng(5)
    params = {k: torch.from_numpy(rng.standard_normal((7, 3)).astype(
        np.float32)) for k in ("conv1_w", "fc1_b", "a")}
    grads = {k: torch.from_numpy(rng.standard_normal((7, 3)).astype(
        np.float32)) for k in params}
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9, weight_decay=1e-3)
    state = opt.init(params)
    p, s = params, state
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    want = dict(params)
    for _ in range(3):
        p, s = opt.update(p, grads, s)
        mom = {k: 0.9 * mom[k] + grads[k] for k in want}
        want = {k: want[k] - 0.05 * (mom[k] + 1e-3 * want[k]) for k in want}
    assert s["step"] == 3
    for k in want:
        assert torch.equal(p[k], want[k])
        assert torch.equal(s["mom"][k], mom[k])


def _quadratic():
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8)).astype(np.float32))

    def loss(params):
        return torch.mean((params["w"] - target) ** 2)

    return loss, {"w": torch.zeros((8, 8))}


@pytest.mark.parametrize("name", OPTS)
def test_optimizers_converge_on_quadratic(name):
    """The reference's ``tests/test_optim_ckpt.py`` check, on the port."""
    loss, params = _quadratic()
    opt = make_optimizer(name, lr=0.3 if name == "sgd" else 0.1,
                         **({"weight_decay": 0.0} if "adamw" in name else {}))
    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state = opt.update(params, {"w": g}, state)
    assert float(loss(params)) < 0.05 * l0, (name, float(loss(params)))


def test_adafactor_factors_stacked_leaves_over_their_last_two_axes():
    """A stacked (L, d) norm scale is a matrix to adafactor, a stacked (L,
    d, f) weight is factored over (d, f) per layer; vectors keep a full
    second moment. The same shapes as the reference's."""
    params = {"scale": torch.zeros((4, 64)), "w": torch.zeros((4, 64, 128)),
              "b": torch.zeros((128,))}
    state = make_optimizer("adafactor").init(params)
    v = state["v"]
    assert set(v["scale"]) == {"vr", "vc"}
    assert v["scale"]["vr"].shape == (4,) and v["scale"]["vc"].shape == (64,)
    assert v["w"]["vr"].shape == (4, 64) and v["w"]["vc"].shape == (4, 128)
    assert set(v["b"]) == {"v"} and v["b"]["v"].shape == (128,)
    assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
    ref = j_make("adafactor").init(jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape), {k: t.numpy() for k, t in params.items()}))
    assert jax.tree_util.tree_map(jnp.shape, ref["v"]) == tree_map(
        lambda x: tuple(x.shape), v)


def test_make_optimizer_builds_all_four():
    params = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    assert make_optimizer("adamw_bf16").init(params)["m"]["w"].dtype == \
        torch.bfloat16
    assert make_optimizer("adamw").init(params)["v"]["w"].dtype == \
        torch.float32
    for name in OPTS:
        make_optimizer(name).init(params)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_schedules_match_reference(as_tensor):
    cases = [(j_cosine(3e-4, 50), cosine_schedule(3e-4, 50)),
             (j_cosine(1.0, 0, 0.2), cosine_schedule(1.0, 0, 0.2)),
             (j_warmup(3e-4, 7, 60), linear_warmup_cosine(3e-4, 7, 60)),
             (j_warmup(1.0, 0, 10), linear_warmup_cosine(1.0, 0, 10))]
    for jf, tf in cases:
        for step in range(0, 70):
            arg = torch.tensor(step, dtype=torch.int32) if as_tensor else step
            got = tf(arg)
            assert got.dtype == torch.float32 and got.ndim == 0
            want = jf(jnp.int32(step) if as_tensor else step)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-12)
    sched = linear_warmup_cosine(1.0, warmup=10, total_steps=110)
    assert float(sched(0)) == 0.0
    assert float(sched(10)) == pytest.approx(1.0, abs=0.02)
    assert float(sched(109)) >= 0.1 * 0.9

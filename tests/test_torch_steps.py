"""The port's step factories (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``), run in process on one CPU device.

Both sides start from one mid-training state: the reference's parameters
and optimizer state after one train step from its smoke init (biases and
norm scales drawn off 0 / 1), carried over by
``bridge.lm_params_from_numpy`` and ``bridge.opt_state_from_numpy``; a
fresh adamw state would make the first update ``lr * sign(g)`` and magnify
two frameworks' gradient noise. Each architecture trains with its config's
optimizer (adafactor for mixtral, command-r-plus, deepseek-v2 and jamba,
adamw for the rest). Tolerances: loss rtol 1e-5; optimizer state after
the step rtol 1e-4, atol 1e-5 (fp32); parameters rtol 1e-4, atol 0.05 lr:
adamw divides each gradient element by its own RMS, so where a gradient
nearly cancels, two frameworks' fp32 gradient noise reaches that element's
update (up to 2.3% of lr measured at these inputs, qwen2-vl; adafactor's
leaf-wide RMS keeps it under 0.3%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import make_optimizer as j_make
from repro_torch import bridge
from repro_torch.launch import steps as TS
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves
from torch_train_helpers import (ARCHS, LOSS_TOL, batch_for, jbatch, smoke,
                                 tbatch)

LR = 1e-3
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=0.05 * LR)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, tol=STATE_TOL):
    got, want = tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64)
                                   if not torch.is_tensor(g)
                                   else g.double().numpy(),
                                   np.asarray(w, np.float64), **tol)


def _mid_training(arch):
    """(j model, t model, j opt, t opt, j params, j state) one reference
    step in."""
    jcfg, tcfg, jp, _ = smoke(arch)
    jm, tm = JM.build_model(jcfg), build_model(tcfg)
    jopt = j_make(jcfg.optimizer, lr=LR)
    topt = make_optimizer(tcfg.optimizer, lr=LR)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    jp, js, _ = jax.jit(JS.make_train_step(jm, jopt))(jp, jopt.init(jp),
                                             jbatch(batch_for(jcfg, seed=9)))
    return jm, tm, jopt, topt, jp, js


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jm, tm, jopt, topt, jp, js = _mid_training(arch)
    b = batch_for(jm.cfg, seed=2)
    tp = bridge.lm_params_from_numpy(_np(jp), "cpu")
    ts = bridge.opt_state_from_numpy(_np(js), "cpu")
    jp2, js2, jloss = jax.jit(JS.make_train_step(jm, jopt))(jp, js,
                                                            jbatch(b))
    tp2, ts2, tloss = TS.make_train_step(tm, topt)(tp, ts, tbatch(b))
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _close(tp2, jp2, PARAM_TOL)
    _close(ts2, js2)
    assert not tloss.requires_grad
    assert not any(x.requires_grad for x in tree_leaves(tp2))
    # the trees it was given are not written
    _close(tp, jp, dict(rtol=0, atol=0))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mixtral-8x22b"])
def test_pod_local_step_and_cross_pod_sync_match_reference(arch):
    """Two pods, each its own half of the batch, stacked (n_pods, ...)
    parameter and state trees (the reference's ``vmap`` over pods), then
    the Eq. 5 mean in fp32: against the reference's pair."""
    n_pods = 2
    jm, tm, jopt, topt, jp, js = _mid_training(arch)
    b = batch_for(jm.cfg, seed=3)
    split = {k: v.reshape((n_pods, v.shape[0] // n_pods) + v.shape[1:])
             for k, v in b.items()}
    stack = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.broadcast_to(x, (n_pods,) + x.shape).copy(), t)
    jps, jss = stack(jp), stack(js)
    # the pods differ before the step
    jps = jax.tree_util.tree_map(
        lambda x: x.at[1].multiply(1.01) if x.dtype == jnp.float32 else x, jps)
    tps = bridge.lm_params_from_numpy(_np(jps), "cpu")
    tss = bridge.opt_state_from_numpy(_np(jss), "cpu")
    jps2, jss2, jloss = jax.jit(JS.make_pod_local_train_step(
        jm, jopt, n_pods))(jps, jss, jbatch(split))
    tps2, tss2, tloss = TS.make_pod_local_train_step(tm, topt, n_pods)(
        tps, tss, tbatch(split))
    assert tloss.shape == (n_pods,)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **LOSS_TOL)
    _close(tps2, jps2, PARAM_TOL)
    _close(tss2, jss2)
    jsync = JS.make_cross_pod_sync(n_pods)(jps2)
    tsync = TS.make_cross_pod_sync(n_pods)(tps2)
    _close(tsync, jsync, PARAM_TOL)
    for x in tree_leaves(tsync):
        assert torch.equal(x[0], x[1])


def test_cross_pod_sync_means_in_fp32_and_keeps_dtypes():
    stack = {"w": torch.tensor([[1.0, 2.0], [2.0, 5.0]], dtype=torch.bfloat16),
             "r": torch.tensor([[0.1], [0.2]])}
    out = TS.make_cross_pod_sync(2)(stack)
    assert out["w"].dtype == torch.bfloat16 and out["r"].dtype == torch.float32
    assert out["w"].tolist() == [[1.5, 3.5], [1.5, 3.5]]
    np.testing.assert_allclose(out["r"].numpy(), [[0.15], [0.15]], rtol=1e-7)
    ref = JS.make_cross_pod_sync(2)(
        {"w": jnp.asarray([[1.0, 2.0], [2.0, 5.0]], jnp.bfloat16),
         "r": jnp.asarray([[0.1], [0.2]])})
    np.testing.assert_array_equal(out["r"].numpy(), np.asarray(ref["r"]))


def test_forward_and_serve_steps_match_reference():
    """Prefill's last-position logits and one decode step."""
    jcfg, tcfg, jp, tp = smoke("h2o-danube-1.8b")
    jm, tm = JM.build_model(jcfg), build_model(tcfg)
    b = batch_for(jcfg, seed=5, s=16)
    jlog = JS.make_forward_step(jm)(jax.tree_util.tree_map(jnp.asarray, jp),
                                    jbatch(b))
    with torch.no_grad():
        tlog = TS.make_forward_step(tm)(tp, tbatch(b))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    tok = b["tokens"][:, :1]
    jcache = jm.init_cache(2, 8)
    jl, _ = JS.make_serve_step(jm)(jax.tree_util.tree_map(jnp.asarray, jp),
                                   jcache, {"token": jnp.asarray(tok)},
                                   jnp.int32(0))
    with torch.no_grad():
        tl, _ = TS.make_serve_step(tm)(tp, tm.init_cache(2, 8),
                                       {"token": torch.tensor(tok)}, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)

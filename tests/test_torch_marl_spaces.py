"""Parity of the port's MARL spaces and observation (``repro_torch.core.marl``
``spaces`` and ``env.observe``/``decode_actions``) with the reference on the
CPU, at the reference tests' size (12 twins, 3 BSs). The env state is the
reference's own reset, bridged. Tolerances: rtol 1e-6 for the observation
and the decode (fp32 elementwise work and short sums), associations and
hard counts exactly, rtol 1e-5 / atol 1e-6 for the encodings and their
gradients (softmax and segment means over the twins).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import association as j_assoc
from repro.core.marl import env as j_env
from repro.core.marl import spaces as j_sp
from repro_torch.core import association as t_assoc
from repro_torch.core.marl import env as t_env
from repro_torch.core.marl import spaces as t_sp
from torch_marl_helpers import KEY, SMALL, cfgs, env_state, random_action, t

sr = importlib.import_module("repro_torch.kernels.segment_reduce")
ENC = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or dict(rtol=1e-6)))


@pytest.mark.parametrize("option", ["plain", "consensus"])
def test_observe_and_compact_obs(option):
    cj, ct = cfgs(option, **SMALL)
    st_j = j_env.env_reset(cj, KEY)
    st_t = env_state(st_j)
    obs_j, obs_t = j_env.observe(cj, st_j), t_env.observe(ct, st_t)
    assert obs_t.bs_feats.shape == (3, t_sp.space_spec(ct).bs_f)
    _close(obs_t.bs_feats, obs_j.bs_feats)
    _close(obs_t.twin_feats, obs_j.twin_feats)
    _close(t_env.observe_flat(ct, st_t), j_env.observe_flat(cj, st_j))
    row_j, row_t = j_sp.compact_obs(obs_j), t_sp.compact_obs(obs_t)
    _close(row_t, row_j)
    back = t_sp.obs_from_compact(ct, row_t, obs_t.twin_feats)
    assert torch.equal(back.bs_feats, obs_t.bs_feats)
    assert t_sp.space_spec(ct) == tuple(j_sp.space_spec(cj))
    assert ct.state_dim == cj.state_dim and ct.action_dim == cj.action_dim


def test_observe_without_chain_builds_it():
    """A consensus config whose state carries no chain view observes a
    fresh one (Eq. 6 stakes from the hosted data), as the reference."""
    cj, ct = cfgs("consensus", **SMALL)
    st_j = j_env.env_reset(cj, KEY)._replace(chain=None)
    _close(t_env.observe(ct, env_state(st_j)).bs_feats,
           j_env.observe(cj, st_j).bs_feats)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_actions_flat_and_structured(seed):
    cj, ct = cfgs(**SMALL)
    rs = np.random.RandomState(seed)
    flat = rs.uniform(-1, 1, (3, cj.action_dim)).astype(np.float32)
    for act_t, act_j in [(t(flat), jnp.asarray(flat)),
                         (t_sp.unflatten_action(ct, t(flat)),
                          j_sp.unflatten_action(cj, jnp.asarray(flat)))]:
        a_t, b_t, tau_t = t_env.decode_actions(ct, act_t)
        a_j, b_j, tau_j = j_env.decode_actions(cj, act_j)
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        _close(b_t, b_j)
        _close(tau_t, tau_j)
    a = t_sp.unflatten_action(ct, t(flat))
    assert torch.equal(t_sp.flatten_action(a), t(flat))


def test_encode_action_per_sample_and_batched():
    cj, ct = cfgs(**SMALL)
    tf_j = j_env.observe(cj, j_env.env_reset(cj, KEY)).twin_feats
    tf_t = t(tf_j)
    rs = np.random.RandomState(3)
    acts = [random_action(cj, rs) for _ in range(6)]
    for s, b, tau in acts:
        e_j = j_sp.encode_action(cj, j_sp.Action(*map(jnp.asarray, (s, b, tau))),
                                 tf_j)
        e_t = t_sp.encode_action(ct, t_sp.Action(t(s), t(b), t(tau)), tf_t)
        _close(e_t, e_j, **ENC)
        np.testing.assert_array_equal(e_t[:, 0].numpy(), np.asarray(e_j[:, 0]))
    stacked = [np.stack(x).reshape((2, 3) + x[0].shape) for x in zip(*acts)]
    want = jax.vmap(jax.vmap(lambda s, b, tau: j_sp.encode_action(
        cj, j_sp.Action(s, b, tau), tf_j)))(*map(jnp.asarray, stacked))
    got = t_sp.encode_action(ct, t_sp.Action(*map(t, stacked)), tf_t)
    assert got.shape == (2, 3, 3, ct.wl.n_subchannels + 5)
    _close(got, want, **ENC)


@pytest.mark.parametrize("backend", ["auto", "kernel"])
def test_encode_gradient_matches_reference_at_ties(monkeypatch, backend):
    """Scores clipped to exactly +-1 tie often: the first index wins the
    argmax (as ``jnp.argmax``), and the winning-score column's gradient is
    split evenly among tied maxima (as ``jnp.max``'s). Held per sample and
    batched, through the kernel backend's gather too."""
    if backend == "kernel":
        monkeypatch.setattr(sr, "resolve_backend", lambda *a, **k: "kernel")
    cj, ct = cfgs(**SMALL)
    tf_j = j_env.observe(cj, j_env.env_reset(cj, KEY)).twin_feats
    tf_t = t(tf_j)
    rs = np.random.RandomState(11)
    s, b, tau = random_action(cj, rs, -3.0, 3.0)
    clipped = t_sp.clip_action(t_sp.Action(t(s), t(b), t(tau)))
    s = clipped.scores.numpy()
    assert (np.abs(s) == 1.0).sum(0).max() >= 2   # ties in some column
    np.testing.assert_array_equal(
        t_assoc.assoc_from_scores(t(s)).numpy(),
        np.asarray(j_assoc.assoc_from_scores(jnp.asarray(s))))
    w = rs.randn(3, ct.wl.n_subchannels + 5).astype(np.float32)

    def loss_j(x):
        a = j_sp.Action(x, jnp.asarray(clipped.b_ctl.numpy()),
                        jnp.asarray(clipped.tau.numpy()))
        return jnp.sum(j_sp.encode_action(cj, a, tf_j) * w)

    g_j = jax.grad(loss_j)(jnp.asarray(s))
    x = t(s).requires_grad_()
    enc = t_sp.encode_action(ct, t_sp.Action(x, clipped.b_ctl, clipped.tau),
                             tf_t)
    (enc * t(w)).sum().backward()
    _close(x.grad, g_j, **ENC)
    xb = t(np.stack([s, s])).requires_grad_()
    enc_b = t_sp.encode_action(
        ct, t_sp.Action(xb, clipped.b_ctl.expand(2, 3),
                        clipped.tau.expand(2, 3, -1)), tf_t)
    (enc_b * t(w)).sum().backward()
    _close(xb.grad[1], g_j, **ENC)


def test_zeros_and_clip_action():
    cj, ct = cfgs(**SMALL)
    z = t_sp.zeros_action(ct)
    zj = j_sp.zeros_action(cj)
    assert [tuple(x.shape) for x in z] == [x.shape for x in zj]
    a = t_sp.clip_action(t_sp.Action(z.scores + 3, z.b_ctl - 3, z.tau))
    assert float(a.scores.max()) == 1.0 and float(a.b_ctl.min()) == -1.0

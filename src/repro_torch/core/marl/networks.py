"""Policies and critics of the multi-agent DDPG (paper Section IV), port of
``repro/core/marl/networks.py``.

A policy is an ``(init, apply)`` pair registered in ``POLICIES``:

    init(gen, cfg: EnvConfig, hidden) -> params       (one agent's dict)
    apply(cfg, params, obs: Observation) -> Action    (one agent's slice:
                                                       scores (N,), b (),
                                                       tau (C,))

``"flat"`` is the monolithic MLP on the flattened observation, O(N)
parameters (the small-N oracle). ``"factorized"`` scores every twin with one
shared head over ``twin_feats`` conditioned on a global trunk, so its
parameters have no N. The critic consumes ``compact_obs`` and the flattened
(M, E) joint-action encoding.

Parameters are nested dicts and lists of tensors with the reference's keys
and shapes. Init draws come from an explicit ``torch.Generator``, on its
device. The apply functions take one agent's parameters and one
observation; the MADDPG code stacks agents on a leading axis and applies
them with ``torch.func.vmap``. Nothing here reaches a kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import sharding
from repro_torch.core.marl.spaces import (Action, Observation, compact_obs,
                                          flatten_obs, space_spec)
from repro_torch.utils.tree import tree_leaves


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _zeros(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.zeros(shape, device=gen.device)


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32):
    """He-normal weights and zero biases, one ``{"w", "b"}`` per layer."""
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = _randn(gen, (a, b)) * (2.0 / a) ** 0.5
        params.append({"w": w.to(dtype), "b": _zeros(gen, (b,)).to(dtype)})
    return params


def mlp_apply(params, x, *, final_tanh: bool = False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return torch.tanh(x) if final_tanh else x


# ---------------------------------------------------------------------------
# flat policy: the legacy monolithic MLP, O(N) params (small-N oracle)
# ---------------------------------------------------------------------------


def flat_policy_init(gen, cfg, hidden=(256, 256)):
    spec = space_spec(cfg)
    return {"mlp": mlp_init(gen, (spec.flat_obs_dim, *hidden,
                                  spec.flat_act_dim))}


def flat_policy_apply(cfg, params, obs: Observation) -> Action:
    """pi(s) in [-1, 1] over the legacy flat action vector, restructured."""
    spec = space_spec(cfg)
    v = mlp_apply(params["mlp"], flatten_obs(obs), final_tanh=True)
    return Action(scores=v[: spec.n_twins], b_ctl=v[spec.n_twins],
                  tau=v[spec.n_twins + 1:])


# ---------------------------------------------------------------------------
# factorized policy: shared per-twin scoring head, O(F) params
# ---------------------------------------------------------------------------


def factorized_policy_init(gen, cfg, hidden=(256, 256)):
    spec = space_spec(cfg)
    h = hidden[-1]
    hs = max(hidden[-1] // 4, 16)  # per-twin head width

    def lin(a, b):
        return _randn(gen, (a, b)) * (2.0 / a) ** 0.5

    return {
        # global trunk: compact obs + attention-pooled twin summary -> (H,)
        "attn_q": _randn(gen, (spec.twin_f,)) * 0.5,
        "trunk": mlp_init(gen, (spec.compact_dim + spec.twin_f, *hidden)),
        # shared per-twin scoring head: [twin_feat_n ; trunk] -> score_n
        "wt": lin(spec.twin_f, hs), "wg": lin(h, hs),
        "bh": _zeros(gen, (hs,)), "wo": lin(hs, 1) * 0.5,
        "bo": _zeros(gen, (1,)),
        # global heads off the trunk: batch control + bandwidth bids
        "wb": lin(h, 1), "bb": _zeros(gen, (1,)),
        "wtau": lin(h, spec.n_subchannels),
        "btau": _zeros(gen, (spec.n_subchannels,)),
    }


def factorized_policy_apply(cfg, params, obs: Observation) -> Action:
    """Score every twin with one shared head: context = MLP(compact_obs ++
    attention-pooled twin features); score_n = tanh(head([twin_feat_n,
    context])). The parameter count has no N."""
    tf = obs.twin_feats                                   # (N, F)
    pooled = sharding.twin_softmax_pool(tf @ params["attn_q"], tf)  # (F,)
    g = torch.relu(mlp_apply(params["trunk"],
                             torch.cat([compact_obs(obs), pooled])))
    h = torch.relu(tf @ params["wt"] + g @ params["wg"] + params["bh"])
    scores = torch.tanh(h @ params["wo"] + params["bo"])[:, 0]   # (N,)
    b = torch.tanh(g @ params["wb"] + params["bb"])[0]
    tau = torch.tanh(g @ params["wtau"] + params["btau"])        # (C,)
    return Action(scores=scores, b_ctl=b, tau=tau)


# ---------------------------------------------------------------------------
# protocol registry
# ---------------------------------------------------------------------------

POLICIES = {
    "flat": (flat_policy_init, flat_policy_apply),
    "factorized": (factorized_policy_init, factorized_policy_apply),
}


def _check_name(name: str) -> None:
    if name not in POLICIES:
        raise ValueError(f"policy must be one of {tuple(POLICIES)}, "
                         f"got {name!r}")


def policy_init(name: str, gen, cfg, hidden=(256, 256)):
    """One agent's actor parameters for the named policy."""
    _check_name(name)
    return POLICIES[name][0](gen, cfg, hidden)


# the key each policy's parameters carry: a policy-name/parameter mismatch
# becomes a clear error instead of a KeyError deep inside the apply
_PARAM_SIGNATURE = {"flat": "mlp", "factorized": "attn_q"}


def policy_apply(name: str, cfg, params, obs: Observation) -> Action:
    """One agent's structured action for the named policy (Eq. 21 before
    noise)."""
    _check_name(name)
    if isinstance(params, dict) and _PARAM_SIGNATURE[name] not in params:
        other = next((n for n, k in _PARAM_SIGNATURE.items()
                      if k in params), "unknown")
        raise ValueError(
            f"policy={name!r} applied to parameters of a {other!r} actor — "
            f"pass the same policy name the agent was initialized with "
            f"(DDPGConfig.policy)")
    return POLICIES[name][1](cfg, params, obs)


def actor_param_count(params) -> int:
    """Total scalar parameter count of one agent's actor."""
    return sum(int(x.numel()) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# critic: policy-agnostic, consumes the compact encodings only
# ---------------------------------------------------------------------------


def critic_init(gen, compact_dim: int, joint_enc_dim: int,
                hidden=(256, 256)):
    """MADDPG critic Q(s, a_1..a_M) (paper Eqs. 22-23) over the compact
    state and the flattened (M, E) joint-action encoding."""
    return mlp_init(gen, (compact_dim + joint_enc_dim, *hidden, 1))


def critic_apply(params, state_c, joint_enc):
    """state_c (..., compact_dim), joint_enc (..., M*E) -> Q (...)."""
    x = torch.cat([state_c, joint_enc], dim=-1)
    return mlp_apply(params, x)[..., 0]

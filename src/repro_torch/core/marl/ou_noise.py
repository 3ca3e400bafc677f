"""Ornstein-Uhlenbeck exploration noise (paper Eq. 21, ref [23]), port of
``repro/core/marl/ou_noise.py``.

The noise state is a tensor or a ``spaces.Action``, so exploration noise
carries the structure of the action it perturbs. The standard normals of a
step are an argument of the same structure, or come from a
``torch.Generator`` one leaf after the other (scores, b_ctl, tau), drawn on
the generator's device.
"""
from __future__ import annotations

import torch


def ou_init(shape, mu: float = 0.0, device=None) -> torch.Tensor:
    """Constant-``mu`` noise state of the given shape. For structured
    actions use ``spaces.zeros_action(cfg)``."""
    return torch.full(shape, mu, dtype=torch.float32, device=device)


def ou_leaf_step(x, eps, *, mu: float = 0.0, theta: float = 0.15,
                 sigma: float = 0.2, dt: float = 1.0):
    """The OU dynamics for one leaf given the standard normal ``eps`` of the
    same shape: x + theta (mu - x) dt + sigma sqrt(dt) eps."""
    return x + theta * (mu - x) * dt + sigma * (dt ** 0.5) * eps


def ou_normals(gen: torch.Generator, state):
    """Standard normals shaped like ``state`` (a tensor or an Action), drawn
    from ``gen`` leaf by leaf on its device."""
    def draw(x):
        return torch.randn(x.shape, generator=gen, device=gen.device)

    if isinstance(state, torch.Tensor):
        return draw(state)
    return type(state)(*(draw(x) for x in state))


def ou_step(state, eps, *, mu: float = 0.0, theta: float = 0.15,
            sigma: float = 0.2, dt: float = 1.0):
    """x' = x + theta (mu - x) dt + sigma sqrt(dt) eps, leaf by leaf.
    ``eps`` has ``state``'s structure, or is a ``torch.Generator`` to draw
    it from (:func:`ou_normals`)."""
    if isinstance(eps, torch.Generator):
        eps = ou_normals(eps, state)
    kw = dict(mu=mu, theta=theta, sigma=sigma, dt=dt)
    if isinstance(state, torch.Tensor):
        return ou_leaf_step(state, eps, **kw)
    return type(state)(*(ou_leaf_step(x, e, **kw)
                         for x, e in zip(state, eps)))

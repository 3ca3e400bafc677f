"""Functional optimizers over parameter dicts (the FL local update).

Only ``sgd`` is ported so far (ROADMAP A11 brings adamw and adafactor). It
keeps the reference's functional law ``m = mu*m + g; p -= lr*(m + wd*p)``;
``torch.optim.SGD`` folds weight decay into the momentum instead, so it is
not a substitute.

    opt = make_optimizer("sgd", lr=...)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


def sgd(lr=1e-2, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mom": {k: torch.zeros_like(v) for k, v in params.items()},
                "step": 0}

    def update(params, grads, state, lr_now=None):
        lr_ = lr_now if lr_now is not None else lr
        mom = {k: momentum * state["mom"][k] + grads[k] for k in params}
        new = {k: params[k] - lr_ * (mom[k] + weight_decay * params[k])
               for k in params}
        return new, {"mom": mom, "step": state["step"] + 1}

    return Optimizer(init, update)


def make_optimizer(name: str, lr=None, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr or 1e-2, **kw)
    if name not in ("adamw", "adamw_bf16", "adafactor"):
        raise ValueError(f"unknown optimizer {name!r}")
    raise NotImplementedError(
        f"optimizer {name!r} is not ported yet (ROADMAP A11)")

"""FL client (digital twin) local training, paper Section II-B; port of
``repro/fl/client.py``.

A twin trains the shared model on its own shard with momentum SGD for
``local_iters`` iterations and returns the updated parameters. Batch indices
come from the same host ``np.random.RandomState(seed)`` draws as the
reference.

Malicious clients (``make_attack_trainer``) are the paper's untrusted users:
a label-flip attacker trains on flipped labels (class c -> C-1-c); a
model-replacement attacker also scales its update by ``boost``. The defence
is ``repro_torch.core.faults``' robust aggregation and the chain's verify
gate.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.optim import make_optimizer


def sgd_step(loss_fn: Callable, opt, params, opt_state, batch):
    """One local SGD step: loss and gradients of ``loss_fn`` at ``params``,
    then one optimizer update. ``loss_fn`` may return a vector of
    independent losses (stacked models, :func:`local_sgd_stacked`): the
    gradient is that of their sum. Returns ``(params, opt_state, loss)``
    with the new params detached from autograd."""
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    loss = loss_fn(dict(zip(keys, leaves)), batch)
    grads = torch.autograd.grad(loss.sum(), leaves)
    params, opt_state = opt.update(
        {k: p.detach() for k, p in zip(keys, leaves)},
        dict(zip(keys, grads)), opt_state)
    return params, opt_state, loss.detach()


def local_sgd(loss_fn: Callable, opt, params, xs, ys):
    """``local_iters`` SGD steps over pre-gathered batches ``xs``/``ys``
    (local_iters, batch, ...), from a fresh optimizer state. Returns
    ``(params, opt_state, losses (local_iters,))``."""
    from repro_torch.core import sharding

    opt_state = sharding.stamp_replicated(opt.init(params))
    losses = []
    for x, y in zip(xs, ys):
        params, opt_state, loss = sgd_step(loss_fn, opt, params, opt_state,
                                           {"images": x, "labels": y})
        losses.append(loss)
    return params, opt_state, torch.stack(losses)


def local_sgd_stacked(loss_stacked: Callable, opt, params, xs, ys):
    """:func:`local_sgd` for P twins at once, all starting from ``params``:
    ``xs``/``ys`` (P, local_iters, batch, ...). ``loss_stacked(params,
    batch) -> (P,)`` evaluates P models (leaves with a leading P axis) on
    their own minibatches (``models.cnn.loss_stacked``: the convolutions
    grouped over the P models). Each step is one :func:`sgd_step` on the
    stacked leaves: its autograd pass over the sum of the P losses gives
    every model exactly its own gradient, and the optimizer's update is
    elementwise. Returns ``(params, opt_state,
    losses (P, local_iters))``, leaves with a leading P axis."""
    p = xs.shape[0]
    params = {k: v.detach().expand((p,) + tuple(v.shape))
              for k, v in params.items()}
    opt_state = opt.init(params)
    losses = []
    for x, y in zip(xs.unbind(1), ys.unbind(1)):
        params, opt_state, loss = sgd_step(loss_stacked, opt, params,
                                           opt_state,
                                           {"images": x, "labels": y})
        losses.append(loss)
    return params, opt_state, torch.stack(losses, dim=1)


def make_local_trainer(loss_fn: Callable, lr: float = 0.05,
                       momentum: float = 0.9):
    opt = make_optimizer("sgd", lr=lr, momentum=momentum)

    def train_local(params, data_x, data_y, *, batch_size: int,
                    local_iters: int, seed: int,
                    rows: Optional[np.ndarray] = None):
        """``local_iters`` steps on batches drawn from ``data_x``/``data_y``.

        ``rows`` (optional) are the twin's sample indices into
        ``data_x``/``data_y``, which may then be the whole training set on
        the device: each batch is gathered there, and the host RandomState
        draws are the same as for ``data_x[rows]``. Returns
        ``(params, losses)``.
        """
        rng = np.random.RandomState(seed)
        opt_state = opt.init(params)
        n = data_x.shape[0] if rows is None else len(rows)
        bs = int(min(batch_size, n))
        device = next(iter(params.values())).device
        data_x = torch.as_tensor(data_x, device=device)
        data_y = torch.as_tensor(data_y, device=device)
        losses = []
        for _ in range(local_iters):
            idx = rng.choice(n, size=bs, replace=n < bs)
            if rows is not None:
                idx = rows[idx]
            take = torch.as_tensor(idx, device=device)
            batch = {"images": data_x[take], "labels": data_y[take]}
            params, opt_state, loss = sgd_step(loss_fn, opt, params,
                                               opt_state, batch)
            losses.append(loss)
        return params, torch.stack(losses).tolist() if losses else []

    return train_local


ATTACKS = ("label_flip", "model_replacement")


def flip_labels(labels, n_classes: int = 10):
    """Deterministic label permutation c -> (C-1) - c (its own inverse), on
    numpy arrays or tensors."""
    return (n_classes - 1) - labels


def make_attack_trainer(loss_fn: Callable, attack: str = "label_flip",
                        lr: float = 0.05, momentum: float = 0.9,
                        boost: float = 5.0, n_classes: int = 10):
    """A drop-in ``train_local`` whose client is malicious.

    ``"label_flip"`` trains honestly on flipped labels.
    ``"model_replacement"`` also flips them, then returns
    ``old + boost * (new - old)`` to dominate the Eq. 4 weighted mean.
    """
    if attack not in ATTACKS:
        raise ValueError(f"attack must be one of {ATTACKS}, got {attack!r}")
    base = make_local_trainer(loss_fn, lr=lr, momentum=momentum)

    def train_malicious(params, data_x, data_y, *, batch_size: int,
                        local_iters: int, seed: int,
                        rows: Optional[np.ndarray] = None):
        new_params, losses = base(params, data_x,
                                  flip_labels(data_y, n_classes),
                                  batch_size=batch_size,
                                  local_iters=local_iters, seed=seed,
                                  rows=rows)
        if attack == "model_replacement":
            new_params = {k: params[k] + boost * (new_params[k] - params[k])
                          for k in new_params}
        return new_params, losses

    return train_malicious

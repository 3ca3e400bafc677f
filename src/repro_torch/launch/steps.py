"""Step factories (port of ``repro/launch/steps.py``): train / prefill /
decode, plus the hierarchical-FL (local-SGD) pair used for the beyond-paper
collective-reduction measurement.

A train step makes fresh leaves of the parameters that require grad,
computes ``model.loss``, takes ``torch.autograd.grad`` over the leaves in
``tree_leaves`` order (a leaf the loss does not reach gets zeros, as
``jax.grad`` gives) and applies ``opt.update``, which records no history.
Every step returns new trees; the ones it is given are not written.

On an LM mesh the trees hold DTensors placed by ``sharding.param_pspecs``
(the reference's jit on sharded arguments): the step runs with plain
tensors taken as replicated (DTensor's ``implicit_replication``), each
gradient is reduced to its parameter's placements, and the new trees keep
the placements of the old.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding.act import placed_like
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


def _mesh_context(leaves):
    if any(isinstance(x, DTensor) for x in leaves):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def make_train_step(model: Model, opt: Optimizer) -> Callable:
    def step(params, opt_state, batch):
        old = tree_leaves(params)
        leaves = [x.detach().requires_grad_() for x in old]
        with _mesh_context(old):
            with torch.enable_grad():
                loss = model.loss(tree_unflatten_like(params, leaves), batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            grads = [placed_like(g, p) for g, p in zip(grads, old)]
            new_p, new_s = opt.update(
                tree_unflatten_like(params, [x.detach() for x in leaves]),
                tree_unflatten_like(params, grads), opt_state)
        new_p = tree_map(placed_like, new_p, params)
        new_s = tree_map(placed_like, new_s, opt_state)
        loss = loss.detach()
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return new_p, new_s, loss

    return step


def make_forward_step(model: Model) -> Callable:
    """Prefill: full-sequence forward, LM head on the last position only
    (serving-prefill semantics — no (B, S, V) logits materialization)."""
    def step(params, batch):
        logits, _ = model.forward(params, batch, last_only=True)
        return logits

    return step


def make_serve_step(model: Model) -> Callable:
    """Decode: one new token against a seq_len KV cache / SSM state."""
    def step(params, cache, batch, pos):
        return model.decode_step(params, cache, batch, pos)

    return step


def make_pod_local_train_step(model: Model, opt: Optimizer,
                              n_pods: int) -> Callable:
    """Hierarchical-FL inner step (paper Eq. 4 on the mesh).

    Parameters and optimizer state carry an explicit leading pod axis, so
    each pod trains on its own batch shard with NO cross-pod exchange. On
    one device the reference's ``vmap`` over the pod axis is a loop over
    the pods, each a :func:`make_train_step` step; the results are stacked
    back. Returns ``(params_stack, opt_stack, loss (n_pods,))``."""
    base = make_train_step(model, opt)

    def pod(tree, i):
        return tree_map(lambda x: x[i] if torch.is_tensor(x) else x, tree)

    def stack(trees):
        # a host number (sgd's step) is the same on every pod
        return tree_map(lambda *xs: torch.stack(xs) if torch.is_tensor(xs[0])
                        else xs[0], *trees)

    def step(params_stack, opt_stack, batch):
        outs = [base(pod(params_stack, i), pod(opt_stack, i), pod(batch, i))
                for i in range(n_pods)]
        return (stack([o[0] for o in outs]), stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    return step


def make_cross_pod_sync(n_pods: int) -> Callable:
    """Hierarchical-FL outer step (paper Eq. 5): average pod-local params
    in fp32 over the pod axis, cast back to each leaf's dtype — the only
    cross-pod exchange, amortized over H inner steps."""
    def sync(params_stack):
        return tree_map(
            lambda x: torch.mean(x.to(torch.float32), dim=0, keepdim=True)
            .to(x.dtype).expand(x.shape).contiguous(), params_stack)

    return sync

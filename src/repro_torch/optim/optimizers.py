"""Optimizers (port of ``repro/optim/optimizers.py``; no ``torch.optim``).

``adamw``     — fp32 or bf16 moment states (``state_dtype``); the bf16 variant
                halves optimizer memory for the >=100B configs.
``adafactor`` — factored second moments (row/col averages for >=2D params):
                ~1 extra value per parameter instead of 2.
``sgd``       — momentum SGD, the FL local-update optimizer (paper Sec. II-B).

All follow the reference's functional interface over parameter trees (nested
dicts, lists and tuples, walked by ``utils.tree``):
    opt = make_optimizer(name, lr=...)
    state = opt.init(params)
    params, state = opt.update(params, grads, state[, lr_now])

``update`` records no autograd history and returns new tensors; the trees it
is given are left as they are. adamw and adafactor go leaf by leaf, so one
leaf's fp32 temporaries are alive at a time. Their ``step`` is a 0-d int32
tensor on the parameters' device, as the reference's ``jnp.int32``; sgd's,
which only the FL path reads, a host int.

The reference's laws are kept as they are: ``sgd`` is ``m = mu*m + g; p -=
lr*(m + wd*p)`` (``torch.optim.SGD`` folds weight decay into the momentum);
adamw decays every leaf, norms and biases included, with fp32 bias
corrections ``1 - b**t``, and rounds bf16 moments (round to nearest even)
only after the update has used them in fp32; adafactor factors every leaf
with ``ndim >= 2`` over its last two axes (a stacked (L, d) norm scale is a
matrix to it) and clips the update's RMS over the whole leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.sharding.act import placed_like
from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------


def sgd(lr=1e-2, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mom": tree_map(torch.zeros_like, params), "step": 0}

    @torch.no_grad()
    def update(params, grads, state, lr_now=None):
        lr_ = lr_now if lr_now is not None else lr
        mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
        new = tree_map(lambda p, m: p - lr_ * (m + weight_decay * p),
                       params, mom)
        return new, {"mom": mom, "step": state["step"] + 1}

    return Optimizer(init, update)


def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype=torch.float32) -> Optimizer:
    def init(params):
        def z(p):  # a DTensor's moments take its placements
            return torch.zeros_like(p, dtype=state_dtype,
                                    memory_format=torch.contiguous_format)

        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, lr_now=None):
        lr_ = lr_now if lr_now is not None else lr
        t = state["step"] + 1
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)
        f32 = torch.float32
        new_p, new_m, new_v = [], [], []
        for p, g, m_, v_ in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state["m"]),
                                tree_leaves(state["v"])):
            g = g.to(f32)
            m = b1 * m_.to(f32) + (1 - b1) * g
            v = b2 * v_.to(f32) + (1 - b2) * torch.square(g)
            step_ = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.to(f32)
            new_p.append((pf - lr_ * (step_ + weight_decay * pf)).to(p.dtype))
            new_m.append(m.to(state_dtype))
            new_v.append(v.to(state_dtype))
        return tree_unflatten_like(params, new_p), {
            "m": tree_unflatten_like(params, new_m),
            "v": tree_unflatten_like(params, new_v), "step": t}

    return Optimizer(init, update)


def adafactor(lr=1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored AdaFactor (Shazeer & Stern 2018) — row/col second-moment
    factors for rank>=2 leaves, full second moment for vectors/scalars."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def st(p):
            f32, dev = torch.float32, p.device
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=f32, device=dev)}
            return {"v": torch.zeros(p.shape, dtype=f32, device=dev)}

        return {"v": tree_map(st, params), "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, lr_now=None):
        lr_ = lr_now if lr_now is not None else lr
        t = state["step"] + 1
        beta = 1.0 - (t.to(torch.float32) + 1.0) ** (-decay)

        def upd(p, g, s):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(p):
                # on a mesh a mean over a split dim is a partial sum, placed
                # as the moment it meets (the card's DTensor, torch 2.11,
                # cannot turn the split moment into a partial one)
                vr = beta * s["vr"] + (1 - beta) * placed_like(
                    torch.mean(g2, dim=-1), s["vr"])
                vc = beta * s["vc"] + (1 - beta) * placed_like(
                    torch.mean(g2, dim=-2), s["vc"])
                rfac = vr / torch.mean(vr, dim=-1, keepdim=True)
                prec = rfac[..., None] * vc[..., None, :]
                u = g * torch.rsqrt(prec + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            new_p = (p.to(torch.float32) - lr_ * u).to(p.dtype)
            return new_p, new_s

        # the state's per-leaf dicts in the leaves' order (the reference's
        # flatten_up_to): tree_map follows the parameter tree's structure
        flat_s = []
        tree_map(lambda _, s: flat_s.append(s), params, state["v"])
        out = [upd(p, g, s) for p, g, s in zip(
            tree_leaves(params), tree_leaves(grads), flat_s)]
        return tree_unflatten_like(params, [o[0] for o in out]), {
            "v": tree_unflatten_like(params, [o[1] for o in out]), "step": t}

    return Optimizer(init, update)


def make_optimizer(name: str, lr=None, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr or 1e-2, **kw)
    if name == "adamw":
        return adamw(lr or 3e-4, **kw)
    if name == "adamw_bf16":
        return adamw(lr or 3e-4, state_dtype=torch.bfloat16, **kw)
    if name == "adafactor":
        return adafactor(lr or 1e-3, **kw)
    raise ValueError(f"unknown optimizer {name!r}")

"""Rank bodies of the LM-mesh tests (``tests/test_torch_lm_mesh.py``,
``test_torch_train_mesh.py``).

:func:`lm_mesh_ranks` runs on every rank of a (2, 2) ``("data", "model")``
gloo mesh on the CPU (``repro_torch.launch.mesh.spawn_lm_ranks``) and, for
each case (an architecture's smoke config, its reference weights and a
batch, as numpy), computes the port's sharded forward under
``activation_mesh``, its loss and gradients, and one train step, each
gathered whole, beside the same on one device. The module imports torch
and the port only, so a rank starts without JAX.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.optim import make_optimizer
from repro_torch.sharding import (batch_pspec, cache_pspecs, param_pspecs,
                                  place_tree)
from repro_torch.sharding.act import activation_mesh
from repro_torch.sharding.specs import place
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

# the train step's optimizer: linear in the gradient, so the step compares
# gradients (a fresh adamw step is ~lr * sign(g))
STEP_OPT = dict(name="sgd", lr=0.1, momentum=0.0)


def config(arch, overrides):
    return dataclasses.replace(get_smoke_config(arch), **overrides)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def unflat(d):
    out = {}
    for path, v in d.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _whole(x):
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.detach().to(torch.float32).numpy() if torch.is_tensor(x) \
        else np.float32(x)


def _batch(case):
    return {k: torch.from_numpy(v).to(torch.int64 if v.dtype.kind == "i"
                                      else torch.float32)
            for k, v in case["batch"].items()}


def _loss_grads(model, params, batch):
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss, tree_unflatten_like(params, list(grads))


def _run(model, params, batch, opt=None, opt_state=None):
    """Forward, loss and gradients, and with ``opt`` one train step."""
    moe_mod.DROP_LOG = []
    logits, aux = model.forward(params, batch)
    drops = [int(_whole(d)) for d in moe_mod.DROP_LOG]
    moe_mod.DROP_LOG = None
    loss, grads = _loss_grads(model, params, batch)
    out = {"logits": _whole(logits), "aux": _whole(aux), "drops": drops,
           "loss": _whole(loss),
           "grads": {k: _whole(v) for k, v in flat(grads).items()}}
    if opt is not None:
        new, _, step_loss = make_train_step(model, opt)(params, opt_state,
                                                        batch)
        out.update(step_loss=_whole(step_loss),
                   step={k: _whole(v) for k, v in flat(new).items()})
    return out


def staged_collectives(mesh) -> dict:
    """The host-staged kernels of DTensor's functional collectives
    (``sharding.collectives._fc_*``, registered for CUDA tensors on gloo)
    called here on CPU tensors over the data group, each beside gloo's own
    collective; returns each pair's max abs difference and the counts."""
    import torch.distributed as dist

    from repro_torch.sharding import collectives as C

    C.reset_counts()
    g = mesh.group("data")
    n, me = dist.get_world_size(g), dist.get_rank(g)
    x = torch.arange(8.0) + 10.0 * mesh.rank
    want = {"all_gather": torch.empty(8 * n), "all_reduce": x.clone(),
            "reduce_scatter": torch.empty(8 // n),
            "all_to_all": torch.empty(8), "broadcast": x.clone()}
    dist.all_gather_into_tensor(want["all_gather"], x, group=g)
    dist.all_reduce(want["all_reduce"], group=g)
    dist.reduce_scatter_tensor(want["reduce_scatter"], x.clone(), group=g)
    dist.all_to_all_single(want["all_to_all"], x, group=g)
    dist.broadcast(want["broadcast"], group=g, group_src=1)
    got = {"all_gather": C._fc_all_gather(x, n, g.group_name),
           "all_reduce": C._fc_all_reduce(x, "sum", g.group_name),
           "reduce_scatter": C._fc_reduce_scatter(x, "sum", n, g.group_name),
           "avg": C._fc_reduce_scatter(x, "avg", n, g.group_name),
           "all_to_all": C._fc_all_to_all(x, [], [], g.group_name),
           "broadcast": C._fc_broadcast(x, 1, g.group_name)}
    want["avg"] = want["reduce_scatter"] / n
    out = {k: float((got[k] - want[k]).abs().max()) for k in want}
    out["counts"] = dict(C.HOST_STAGED)
    out["rank_in_group"] = me
    return out


def lm_mesh_ranks(mesh, cases, decode=((), 0, 0)):
    """Per case: ``mesh`` (the sharded results, one train step among them),
    ``one`` (one device, no step), each with ``drops`` (the forward's dropped (token, slot) pairs per capacity
    layer: this rank's source shard's under EP), ``ep`` (EP dispatches), ``flash`` / ``ssd`` (the local q / x shapes each
    kernel wrapper saw); and ``decode``, :func:`decode_steps` of ``decode``
    (archs, batch, seq). Rank 0 returns them; the others None."""
    torch.set_num_threads(1)
    seen = {"ep": 0, "flash": [], "ssd": []}
    real_ep, real_fa, real_ssd = (moe_mod.moe_capacity_ep_a2a,
                                  fa_mod.flash_attention, ssd_mod.ssd_scan)

    def ep(*a, **k):
        seen["ep"] += 1
        return real_ep(*a, **k)

    def fa(q, *a, **k):
        seen["flash"].append(tuple(q.shape))
        return real_fa(q, *a, **k)

    def ssd(x, *a, **k):
        seen["ssd"].append(tuple(x.shape))
        return real_ssd(x, *a, **k)

    moe_mod.moe_capacity_ep_a2a, fa_mod.flash_attention, ssd_mod.ssd_scan = \
        ep, fa, ssd
    out = {"staged": staged_collectives(mesh),
           "decode": decode_steps(mesh, *decode)}
    for case in cases:
        cfg = config(case["arch"], case["overrides"])
        model = build_model(cfg, use_pallas=True)
        one_p = bridge.lm_params_from_numpy(unflat(case["params"]), "cpu")
        layout = case.get("layout", "2d")
        mesh_p = bridge.lm_params_to_mesh(unflat(case["params"]), mesh,
                                          layout=layout)
        batch = _batch(case)
        placed = {k: place(v, batch_pspec(mesh, v.ndim, layout=layout), mesh)
                  for k, v in batch.items()}
        opt = make_optimizer(STEP_OPT["name"], lr=STEP_OPT["lr"],
                             momentum=STEP_OPT["momentum"])
        seen.update(ep=0, flash=[], ssd=[])
        with activation_mesh(mesh, layout):
            state = opt.init(mesh_p)
            state = place_tree(state, param_pspecs(state, mesh, layout), mesh)
            res = {"mesh": _run(model, mesh_p, placed, opt, state)}
        res.update(ep=seen["ep"], flash=list(seen["flash"]),
                   ssd=list(seen["ssd"]))
        res["one"] = _run(model, one_p, batch)
        if case.get("oracle"):
            dense = build_model(dataclasses.replace(cfg, router_mode="dense"))
            res["oracle"] = _whole(dense.forward(one_p, batch)[0])
        out[case["name"]] = res
    return out if mesh.rank == 0 else None


def _random_like(tree, gen):
    if isinstance(tree, dict):
        return {k: _random_like(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_random_like(v, gen) for v in tree)
    if tree is None:
        return None
    return torch.randn(tree.shape, generator=gen, dtype=tree.dtype)


def decode_steps(mesh, archs, batch, seq):
    """Per architecture: one decode step of its smoke config (weights from
    seed 0, a cache of N(0, 1) values and a token from seed 1, the new
    token at the last slot) on one device and on ``mesh`` in the "decode"
    layout (the cache placed by ``cache_pspecs``: KV caches split on the
    head dim, MLA's on the sequence); {arch: (one, mesh)} logits."""
    import copy

    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        cache = _random_like(model.init_cache(batch, seq, device="cpu"), gen)
        tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen)
        one, _ = model.decode_step(params, copy.deepcopy(cache),
                                   {"token": tok}, seq - 1)
        mesh_p = place_tree(params, param_pspecs(params, mesh, "decode"),
                            mesh)
        mesh_c = place_tree(cache, cache_pspecs(cache, mesh, batch), mesh)
        mesh_t = {"token": place(tok, batch_pspec(mesh, 2, layout="decode"),
                                 mesh)}
        with activation_mesh(mesh, "decode"):
            got, _ = model.decode_step(mesh_p, mesh_c, mesh_t, seq - 1)
        out[arch] = (_whole(one), _whole(got))
    return out

"""Streamed federated learning: the real FL workload inside the serve loop,
port of ``repro/fl/stream.py``.

``DTWNSystem.run_round`` is the batch-mode round: a host loop over the
chosen twins. This module folds the same workload into the always-on
service (``repro_torch.core.serve``):

* **Device-resident FL state.** :class:`FLState` rides inside the
  ``ServeState``: the global model, per-twin model and momentum buffers with
  a capacity-padded ``(capacity, ...)`` leading axis, the malicious mask and
  the train/eval data. They are allocated once (:func:`fl_init`) and every
  round writes them in place. Evicted twins' rows are zeroed and admitted
  twins warm-start from the current global model (:func:`fl_churn_update`).
* **Host-planned, device-trained rounds.** ``run_round``'s participant and
  minibatch draws are host ``numpy.RandomState`` laws, so
  :func:`stream_fl_plan` replays them up front into dense index plans
  (:class:`FLPlan`). The round then runs on the device with no host
  synchronisation: local SGD of the P participants as one batched
  computation (``fl.client.local_sgd_stacked`` on the model's
  ``loss_stacked``: grouped convolutions for the CNN), a scatter into their
  buffer rows, Eq. 4 over the capacity axis (plain or robust), the
  ``verify_metas`` gate on a fixed holdout slice, and Eq. 5 (the old global
  model kept, by a device select, when nothing passes).
* **Parity.** At a fixed full population (churn off) the streamed rounds
  are ``run_round``'s: the same participants, minibatches and update law,
  and Eq. 4 weights that are integer-valued D_j sums, so order-exact. The
  losses differ by float error (the batched local SGD runs P convolutions
  as one grouped convolution).

A model in :data:`MODELS` provides ``init_params``, ``loss_fn``,
``accuracy`` and ``loss_stacked`` (P models on P minibatches, (P,)).

Aggregation runs over the capacity axis, not the participant axis:
non-participants carry weight 0 and the out-of-range association id, so
they drop out of every segment sum. On the card, Eq. 4 is the segment
kernel at N = capacity over each leaf (``hierarchy.bs_aggregate_stacked``).

Over a twin mesh (``core.sharding``) the capacity-axis buffers are
twin-blocked and the global model and data replicated (:func:`fl_specs`):
in the rank's twin scope the participants' rows are gathered by a masked
gather and a SUM all-reduce, every rank trains the same P participants,
writes back only the rows it owns, and Eq. 4 over its block of the capacity
axis is the sharded segment call (the local kernel, then one all-reduce).
The robust aggregators have no sharded form and refuse a scope.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import consensus as consensus_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import hierarchy, sharding
from repro_torch.core.sharding import TWIN_AXIS, P
from repro_torch.fl import client as client_mod
from repro_torch.models import cnn, tiny
from repro_torch.optim import make_optimizer
from repro_torch.utils.device import default_device, deterministic_cudnn

__all__ = [
    "FLServeConfig", "FLPlan", "FLState", "MODELS", "get_model",
    "fl_init", "attach_fl", "stream_fl_plan", "plan_row", "fl_round",
    "fl_churn_update", "fl_specs", "cyclic_shards",
]

# model registry: everything the streamed trainer needs from a model, keyed
# by the name carried in FLServeConfig
MODELS = {
    "cnn": cnn,    # the paper's Section-V CNN (~2.1M params)
    "tiny": tiny,  # 3,258 params: per-twin buffers at N=10^4+
}


def get_model(name: str):
    if name not in MODELS:
        raise ValueError(f"model must be one of {sorted(MODELS)}, "
                         f"got {name!r}")
    return MODELS[name]


@dataclasses.dataclass(frozen=True)
class FLServeConfig:
    """Static streamed-FL knobs (``ServeConfig.fl``): the ``FLConfig``
    fields the round step reads."""
    model: str = "cnn"
    participants: int = 10       # P twins trained a round
    local_iters: int = 5
    batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    weighted_global: bool = False
    aggregator: str = "fedavg"   # "fedavg" | "trimmed_mean" | "krum"
    trim_k: int = 1
    krum_f: int = 1
    attack: str = "label_flip"   # applied to malicious twins
    attack_boost: float = 5.0
    verify: bool = True          # the Eq. 4 verify gate
    tolerance: float = 0.5       # DPoSChain's default loss tolerance
    n_eval: int = 256            # fixed holdout slice for losses/metrics


class FLPlan(NamedTuple):
    """One stream's host-made round plans (leading axis n_rounds).

    ``users`` (n_rounds, P) int64 chosen twin ids (-1: unused slot);
    ``batch`` (n_rounds, P, local_iters, B) int64 sample indices; ``valid``
    (n_rounds, P) bool. The device also gates on the live ``active`` mask,
    so a planned participant that churned out contributes nothing.
    """
    users: torch.Tensor
    batch: torch.Tensor
    valid: torch.Tensor


class FLState(NamedTuple):
    """Streamed-FL state, a part of the ``ServeState``: the global model
    ``params``; ``twin_params``/``twin_mom`` with the capacity axis (rows of
    inactive twins all-zero); ``malicious`` (capacity,) bool; the training
    data ``x``/``y`` and the fixed holdout slice ``x_eval``/``y_eval``."""
    params: Any
    twin_params: Any
    twin_mom: Any
    malicious: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    x_eval: torch.Tensor
    y_eval: torch.Tensor


def fl_specs(fcfg):
    """Which :class:`FLState` leaves are twin-blocked over a twin mesh: the
    capacity-axis buffers and the malicious mask (``P("twin")``); the global
    model and the data are replicated. ``P()`` when FL is off."""
    if fcfg is None:
        return P()
    return FLState(params=P(), twin_params=P(TWIN_AXIS),
                   twin_mom=P(TWIN_AXIS), malicious=P(TWIN_AXIS), x=P(),
                   y=P(), x_eval=P(), y_eval=P())


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def fl_init(fcfg: FLServeConfig, gen, data, active, *, params=None,
            malicious=None, device=None) -> FLState:
    """Fresh :class:`FLState` at capacity ``active.shape[0]``, allocated
    once.

    ``data`` is the ``repro_torch.data.cifar10.load`` tuple. ``active`` (the
    serve state's live mask) seeds the warm start: live twins' rows start
    at the global model, empty slots at zero. The state lives on
    ``active``'s device when it is a tensor, else on ``device`` (default
    ``cuda``). ``params`` overrides the global init from ``gen`` (it is
    copied: the serve loop writes its state in place). Inside a twin scope
    ``active`` is this rank's block and ``malicious`` the global mask, of
    which the rank keeps its block."""
    if isinstance(active, torch.Tensor) and device is None:
        dev = active.device
    else:
        dev = default_device(device)
    mdl = get_model(fcfg.model)
    (x, y), (x_test, y_test), _ = data
    active = torch.as_tensor(active, dtype=torch.bool).to(dev)
    cap = active.shape[0]
    if params is None:
        params = mdl.init_params(gen, device=dev)
    params = {k: torch.as_tensor(v, dtype=torch.float32).to(dev).clone()
              for k, v in params.items()}
    n_eval = min(fcfg.n_eval, x_test.shape[0])
    if malicious is None:
        malicious = torch.zeros(cap, dtype=torch.bool)
    else:
        malicious = sharding.localize(
            torch.as_tensor(np.asarray(malicious, bool)), fill=False)

    def per_twin(p):
        rows = p[None].expand((cap,) + tuple(p.shape))
        m = active.reshape((-1,) + (1,) * p.ndim)
        return torch.where(m, rows, 0.0).contiguous()

    return FLState(
        params=params,
        twin_params={k: per_twin(v) for k, v in params.items()},
        twin_mom={k: torch.zeros((cap,) + tuple(v.shape), dtype=v.dtype,
                                 device=dev) for k, v in params.items()},
        malicious=malicious.to(dev),
        x=torch.as_tensor(x).to(dev), y=torch.as_tensor(y).to(dev),
        x_eval=torch.as_tensor(x_test[:n_eval]).to(dev),
        y_eval=torch.as_tensor(y_test[:n_eval]).to(dev))


def attach_fl(scfg, state, system, data, assoc=None):
    """Bridge a batch ``DTWNSystem`` into a serve state: attaches an
    :class:`FLState` built from the system's model, shards and malicious
    mask, and writes the system's ``data_sizes`` (and, when given,
    ``assoc``) into the env, masked by the live set, so the streamed rounds
    train, weight (Eq. 4) and price (Eqs. 12-17) the batch system's
    realization. Returns the new ``ServeState``."""
    mdl = get_model(scfg.fl.model)
    want = {k: tuple(v.shape) for k, v in
            mdl.init_params(torch.Generator().manual_seed(0)).items()}
    have = {k: tuple(v.shape) for k, v in system.params.items()}
    if want != have:
        raise ValueError(
            f"FLServeConfig.model={scfg.fl.model!r} does not match the "
            f"system's parameter tree: the batch DTWNSystem trains the "
            f"paper CNN; pair it with model='cnn'")
    active = state.active
    dev = active.device
    fl = fl_init(scfg.fl, None, data, active, params=system.params,
                 malicious=system.malicious)
    sizes = torch.as_tensor(np.asarray(system.data_sizes, np.float32)).to(dev)
    state.env.data_sizes.copy_(torch.where(active, sizes, 0.0))
    if assoc is not None:
        a = torch.as_tensor(np.asarray(assoc)).to(dev, torch.int32)
        state.env.assoc.copy_(torch.where(active, a, int(system.cfg.n_bs)))
    return state._replace(fl=fl)


def cyclic_shards(n_samples: int, n_users: int, shard_size: int):
    """Overlapping fixed-size shards for population-scale sweeps: twin u
    reads ``shard_size`` consecutive samples from a stride offset, wrapping
    around the dataset (at N=10^4+ the dataset is smaller than the
    population)."""
    stride = max(1, n_samples // n_users)
    base = np.arange(shard_size)
    return [((u * stride + base) % n_samples).astype(np.int64)
            for u in range(n_users)]


# ---------------------------------------------------------------------------
# the plan: run_round's host RNG laws, replayed up front
# ---------------------------------------------------------------------------


def stream_fl_plan(fcfg: FLServeConfig, shards, n_rounds: int, *,
                   seed: int = 0, b: float = 0.5,
                   start_round: int = 0) -> FLPlan:
    """``n_rounds`` of participant and minibatch plans, on the CPU.

    Replays ``DTWNSystem.run_round``'s host RNG laws, so fixed-population
    streamed rounds are the batch rounds: participants
    ``RandomState(seed + 1).choice(n_users, P, replace=False)`` a round;
    for twin u at round t, ``n_use = min(shard.size, max(8, int(b *
    shard.size)))``, ``use = shard[:n_use]``, then ``RandomState(t*1000 +
    u)`` draws ``local_iters`` batches ``use[choice(n_use, B,
    replace=False)]``. ``B`` must not exceed any participant's ``n_use``
    (rectangular plans); a ``ValueError`` names the twin.
    """
    n_users = len(shards)
    p = min(fcfg.participants, n_users)
    rng = np.random.RandomState(seed + 1)
    users = np.full((n_rounds, fcfg.participants), -1, np.int64)
    batch = np.zeros((n_rounds, fcfg.participants, fcfg.local_iters,
                      fcfg.batch_size), np.int64)
    valid = np.zeros((n_rounds, fcfg.participants), bool)
    for t in range(n_rounds):
        chosen = rng.choice(n_users, size=p, replace=False)
        users[t, :p] = chosen
        valid[t, :p] = True
        for k, u in enumerate(chosen):
            shard = np.asarray(shards[u])
            n_use = min(shard.size, max(8, int(b * shard.size)))
            if n_use < fcfg.batch_size:
                raise ValueError(
                    f"twin {u}: n_use={n_use} < batch_size="
                    f"{fcfg.batch_size}: rectangular plans need every "
                    f"participant to fill a batch (shrink batch_size or "
                    f"grow the shards)")
            use = shard[:n_use]
            rng_u = np.random.RandomState((start_round + t) * 1000 + int(u))
            for i in range(fcfg.local_iters):
                idx = rng_u.choice(n_use, size=fcfg.batch_size,
                                   replace=False)
                batch[t, k, i] = use[idx]
    return FLPlan(users=torch.from_numpy(users), batch=torch.from_numpy(batch),
                  valid=torch.from_numpy(valid))


def plan_row(plan: FLPlan, t: int) -> FLPlan:
    """Round ``t``'s plan out of a :func:`stream_fl_plan` stack."""
    return FLPlan(*(x[t] for x in plan))


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


def _col(mask, ndim: int):
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def fl_round(fcfg: FLServeConfig, fl: FLState, plan: FLPlan, *, active,
             data_sizes, assoc, n_bs: int):
    """One streamed FL round, on the plan row's device, without a host
    synchronisation.

    Participants (gated by ``plan.valid`` and the live ``active`` mask)
    warm-start from the global model, run ``local_iters`` SGD steps as one
    batched computation, land in their twin buffer rows, and aggregate over
    the capacity axis: Eq. 4 (plain or robust), the loss gate on the fixed
    holdout slice, Eq. 5 over accepted BSs (the old global model kept when
    nothing passes). ``fl``'s tensors are written in place; returns ``(fl,
    metrics)``. Inside a twin scope the capacity-axis arguments are this
    rank's blocks (module docstring).
    """
    if sharding.in_scope() is not None and fcfg.aggregator != "fedavg":
        raise ValueError(f"the {fcfg.aggregator} aggregator has no sharded "
                         f"form: a twin scope takes aggregator='fedavg'")
    mdl = get_model(fcfg.model)
    opt = make_optimizer("sgd", lr=fcfg.lr, momentum=fcfg.momentum)
    u = plan.users
    part = plan.valid & sharding.twin_gather(active, u, fill=False)
    mal = part & sharding.twin_gather(fl.malicious, u, fill=False)
    w_u = torch.where(part, sharding.twin_gather(data_sizes, u, fill=0.0),
                      0.0)
    assoc_u = torch.where(part, sharding.twin_gather(assoc, u, fill=n_bs),
                          n_bs).to(torch.int32)

    # pre-gathered minibatches (P, L, B, ...); both attacks train on flipped
    # labels (fl.client law), model replacement also boosts below
    xb = fl.x[plan.batch]
    yb = fl.y[plan.batch]
    yb = torch.where(mal[:, None, None], client_mod.flip_labels(yb), yb)
    with deterministic_cudnn():
        p_new, state, _ = client_mod.local_sgd_stacked(mdl.loss_stacked,
                                                       opt, fl.params, xb, yb)
    mom_new = state["mom"]
    if fcfg.attack == "model_replacement":
        boost = torch.where(mal, fcfg.attack_boost, 1.0)
        p_new = {k: fl.params[k][None] + _col(boost, v.ndim)
                 * (v - fl.params[k][None]) for k, v in p_new.items()}

    # scatter the trained rows into the twin buffers in place (dropped
    # participants -> -1 -> no write); Eq. 4 then runs over the capacity
    # axis, each row once
    rows = torch.where(part, u, -1)
    for k in fl.twin_params:
        sharding.twin_scatter_rows(fl.twin_params[k], rows, p_new[k])
        sharding.twin_scatter_rows(fl.twin_mom[k], rows, mom_new[k])
    w_cap = sharding.twin_scatter_rows(torch.zeros_like(data_sizes), rows,
                                       w_u)
    assoc_cap = sharding.twin_scatter_rows(
        torch.full(data_sizes.shape, n_bs, dtype=torch.int32,
                   device=data_sizes.device), rows, assoc_u)

    # --- Eq. 4 (per BS), plain or robust ---
    if fcfg.aggregator == "fedavg":
        per_bs, bs_w = hierarchy.bs_aggregate_stacked(
            fl.twin_params, w_cap, assoc_cap, n_bs)
        n_cli = n_sus = None
    else:
        per_bs, bs_w, survivor = faults_mod.robust_bs_aggregate_stacked(
            fl.twin_params, w_cap, assoc_cap, n_bs,
            aggregator=fcfg.aggregator, trim_k=fcfg.trim_k,
            krum_f=fcfg.krum_f)
        n_cli, n_sus = faults_mod.suspect_counts(survivor, assoc_cap, n_bs)

    # --- the verify gate on the fixed holdout slice ---
    eval_batch = {"images": fl.x_eval, "labels": fl.y_eval}
    submitted = bs_w > 0.0
    if fcfg.verify:
        m_ = bs_w.shape[0]
        bs_losses = mdl.loss_stacked(per_bs, {
            "images": fl.x_eval.expand((m_,) + tuple(fl.x_eval.shape)),
            "labels": fl.y_eval.expand((m_,) + tuple(fl.y_eval.shape))})
        accept = consensus_mod.verify_metas(
            bs_losses, submitted, tolerance=fcfg.tolerance,
            n_clients=n_cli, n_suspect=n_sus)
    else:
        accept = submitted

    # --- Eq. 5 over accepted BSs; the old global model when none pass ---
    agg = hierarchy.global_aggregate_stacked(
        per_bs, bs_w, accept, weighted_global=fcfg.weighted_global)
    any_acc = torch.any(accept)
    for k, old in fl.params.items():
        torch.where(any_acc, agg[k], old, out=old)

    loss = mdl.loss_fn(fl.params, eval_batch)
    acc = mdl.accuracy(fl.params, eval_batch)
    metrics = {
        "fl_loss": loss, "fl_accuracy": acc, "fl_bs_weight": bs_w,
        "fl_n_participants": torch.sum(part.to(torch.int32)),
        "fl_accept_frac": (torch.sum(accept.to(torch.float32))
                           / torch.clamp(torch.sum(
                               submitted.to(torch.float32)), min=1.0)),
    }
    return fl, metrics


def fl_churn_update(fl: FLState, joined, left) -> FLState:
    """Apply one round's churn to the FL buffers, in place: admitted twins
    warm-start from the current global model (zero momentum), evicted
    twins' rows are zeroed (the padding convention, so a departed twin's row
    never re-enters an Eq. 4 weight). ``joined``/``left`` are (capacity,)
    masks. Each buffer is one elementwise pass, with no copy of it."""
    joined = torch.as_tensor(joined, dtype=torch.bool)
    left = torch.as_tensor(left, dtype=torch.bool)
    for k, buf in fl.twin_params.items():
        g = fl.params[k]
        torch.where(_col(joined, buf.ndim), g[None], buf, out=buf)
        buf.masked_fill_(_col(left, buf.ndim), 0.0)
    for buf in fl.twin_mom.values():
        buf.masked_fill_(_col(joined | left, buf.ndim), 0.0)
    return fl

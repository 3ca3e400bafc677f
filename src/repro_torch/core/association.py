"""Edge association (paper Definition 1 + problem (18)), port of
``repro/core/association.py``.

An association is ``assoc: (N,) int`` mapping each digital twin to one BS,
which satisfies (18b) by construction. Batch sizes b (18d) and bandwidth
fractions tau (18c) are projected onto their feasible sets here.
"""
from __future__ import annotations

import torch

from repro_torch.core import latency as lat


def random_association(gen: torch.Generator, n_twins: int, n_bs: int,
                       device=None) -> torch.Tensor:
    """The paper's random baseline: assoc (N,) ~ Uniform{0..M-1}, drawn
    from ``gen`` on the CPU and moved to ``device``."""
    return torch.randint(0, n_bs, (n_twins,), generator=gen).to(device)


def average_association(n_twins: int, n_bs: int, device=None) -> torch.Tensor:
    """The paper's average baseline: round-robin twin j -> BS j mod M."""
    return torch.arange(n_twins, device=device) % n_bs


def bs_loads(assoc, data_sizes, n_bs: int, *, backend: str = "auto") -> dict:
    """Per-BS ``counts`` (M,), ``loads`` (M,) total samples and
    ``imbalance`` max/mean load, through the segment-reduce dispatch. A
    batch of associations and populations (S, N) gives (S, M) counts and
    loads and (S,) imbalances."""
    counts = lat.twin_counts(assoc, n_bs, backend=backend)
    loads = lat.bs_sum(data_sizes, assoc, n_bs, backend=backend)
    mean = torch.clamp(torch.mean(loads, dim=-1), min=1e-12)
    return {"counts": counts, "loads": loads,
            "imbalance": torch.amax(loads, dim=-1) / mean}


def greedy_association(params: lat.LatencyParams, data_sizes, freqs,
                       uplink) -> torch.Tensor:
    """Assign twins (largest first) to the BS with the least accumulated
    estimated time (compute + upload share).

    data_sizes (N,), freqs (M,) Hz, uplink (M,) bit/s; arrays or tensors,
    computed on ``data_sizes``' device (the CPU for numpy input). Returns
    assoc (N,) int32. A batch of scenarios, data_sizes (S, N) and uplink
    (S, M), gives (S, N): one loop over the N twins serves every scenario.
    The reference's ``lax.scan`` is a loop here; the choices stay on the
    device (gathers and scatters, never a 0-dim index), so the loop never
    waits for it.
    """
    data_sizes = torch.as_tensor(data_sizes, dtype=torch.float32)
    dev = data_sizes.device
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=dev)
    uplink = torch.as_tensor(uplink, dtype=torch.float32, device=dev)
    single = data_sizes.ndim == 1
    if single:
        data_sizes, uplink = data_sizes[None], uplink[None]
    s, n_twins = data_sizes.shape
    order = torch.argsort(-data_sizes, dim=1, stable=True)
    sorted_d = torch.gather(data_sizes, 1, order)
    load = torch.zeros((s, freqs.shape[0]), dtype=torch.float32, device=dev)
    upload = params.model_size_bits / torch.clamp(uplink, min=1.0)
    choices = torch.empty((s, n_twins), dtype=torch.int64, device=dev)
    for i in range(n_twins):
        t_add = (sorted_d[:, i:i + 1] * params.cycles_per_sample / freqs
                 + upload)
        choice = torch.argmin(load + t_add, dim=1, keepdim=True)
        load.scatter_add_(1, choice, torch.gather(t_add, 1, choice))
        choices[:, i:i + 1] = choice
    assoc = torch.zeros((s, n_twins), dtype=torch.int32, device=dev)
    assoc.scatter_(1, order, choices.to(torch.int32))
    return assoc[0] if single else assoc


def assoc_from_scores(scores: torch.Tensor) -> torch.Tensor:
    """MARL competitive assignment: scores (M, N) -> assoc (N,) int32,
    twin n goes to argmax_i scores[i, n]."""
    return torch.argmax(scores, dim=0).to(torch.int32)


def project_batch(params: lat.LatencyParams, b_raw: torch.Tensor) -> torch.Tensor:
    """(18d): raw actor outputs in [-1, 1] onto [b_min, b_max]."""
    frac = (torch.clamp(b_raw, -1.0, 1.0) + 1.0) / 2.0
    return params.b_min + frac * (params.b_max - params.b_min)


def project_bandwidth(tau_logits: torch.Tensor) -> torch.Tensor:
    """(18c): tau_logits (M, C) -> softmax over the BS axis."""
    return torch.softmax(tau_logits, dim=0)


def check_constraints(params: lat.LatencyParams, assoc, b, tau, n_twins: int,
                      n_bs: int) -> dict:
    """Constraint audit: a dict of bools keyed by constraint (18b/18c/18d)."""
    assoc, b, tau = (torch.as_tensor(x) for x in (assoc, b, tau))
    return {
        "18b_all_assigned": bool(
            (assoc >= 0).all() and (assoc < n_bs).all()
            and tuple(assoc.shape) == (n_twins,)),
        "18c_bandwidth_simplex": bool(
            torch.all(tau >= -1e-6)
            and torch.all(torch.sum(tau, dim=0) <= 1.0 + 1e-5)),
        "18d_batch_bounds": bool(
            torch.all(b >= params.b_min - 1e-6)
            and torch.all(b <= params.b_max + 1e-6)),
    }

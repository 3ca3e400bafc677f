"""Edge association (paper Definition 1 + problem (18)), port of
``repro/core/association.py``.

An association is ``assoc: (N,) int`` mapping each digital twin to one BS,
which satisfies (18b) by construction. Batch sizes b (18d) and bandwidth
fractions tau (18c) are projected onto their feasible sets here.
"""
from __future__ import annotations

import torch

from repro_torch.core import latency as lat
from repro_torch.kernels.segment_reduce import segment_count, segment_reduce


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
    ``imbalance`` max/mean load, through the segment-reduce dispatch."""
    counts = segment_count(assoc, n_bs, backend=backend)
    loads = segment_reduce(torch.as_tensor(data_sizes, dtype=torch.float32),
                           assoc, n_bs, backend=backend)
    mean = torch.clamp(torch.mean(loads), min=1e-12)
    return {"counts": counts, "loads": loads,
            "imbalance": torch.max(loads) / mean}


def greedy_association(params: lat.LatencyParams, data_sizes, freqs,
                       uplink) -> torch.Tensor:
    """Assign twins (largest first) to the BS with the least accumulated
    estimated time (compute + upload share).

    data_sizes (N,), freqs (M,) Hz, uplink (M,) bit/s; arrays or tensors,
    computed on ``data_sizes``' device (the CPU for numpy input). Returns
    assoc (N,) int32. The reference's ``lax.scan`` is a loop here; the
    choices stay on the device, so the loop never waits for it.
    """
    data_sizes = torch.as_tensor(data_sizes, dtype=torch.float32)
    dev = data_sizes.device
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=dev)
    uplink = torch.as_tensor(uplink, dtype=torch.float32, device=dev)
    n_twins = data_sizes.shape[0]
    order = torch.argsort(-data_sizes, stable=True)
    load = torch.zeros(freqs.shape[0], dtype=torch.float32, device=dev)
    upload = params.model_size_bits / torch.clamp(uplink, min=1.0)
    choices = torch.empty(n_twins, dtype=torch.int64, device=dev)
    for i in range(n_twins):
        d = data_sizes[order[i]]
        t_add = d * params.cycles_per_sample / freqs + upload
        choice = torch.argmin(load + t_add)
        load[choice] += t_add[choice]
        choices[i] = choice
    assoc = torch.zeros(n_twins, dtype=torch.int32, device=dev)
    assoc[order] = choices.to(torch.int32)
    return assoc


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

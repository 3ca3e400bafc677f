"""Roofline term derivation (port of ``repro/launch/roofline.py``) with
NVIDIA H100 SXM constants.

  compute term    = FLOPs / (ranks x peak_FLOP/s)
  memory term     = analytic bytes / (ranks x HBM_bw)
  collective term = collective_bytes / (ranks x link_bw)

The constants live in ``repro_torch.launch.mesh``, as the reference keeps
its TPU v5e constants in its mesh module:

  * peak: dense bf16 on the tensor cores, 989e12 FLOP/s (H100 SXM5 data
    sheet; 1,979e12 is with 2:4 sparsity);
  * HBM: HBM3 at 3.35e12 B/s (data sheet);
  * link, a GPU, one direction: up to 8 ranks (one HGX node) NVLink 4 at
    450e9 B/s (the data sheet's 900 GB/s counts both directions); beyond 8
    one 400 Gb/s ConnectX-7 NIC a GPU, 50e9 B/s (DGX H100). A 256-rank
    mesh crosses nodes, so its collective term is over the NIC: the
    NVLink figure would understate it 9x.

Sources of the inputs, in the port: FLOPs and collective bytes are one
rank's, counted from the aten ops it runs (``launch/dryrun.py``), times
the ranks; the memory term is the analytic traffic model below, the
reference's arithmetic unchanged.

Traffic model (global bytes per step):
  train   : 3x params (fwd + bwd + remat re-read) + 2x params (grad write +
            param write) + 2x opt state (read+write)
            + 8x tokens x d_model x n_layers x act_bytes  (layer carries:
              fwd write/read + remat write/read, x2 residual streams)
  prefill : 1x params + 4x tokens x d_model x n_layers + cache write
  decode  : 1x params (every weight read once per token)
            + 1x KV-cache read + small cache write
"""
from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, link_bw


def analytic_memory_bytes(mode: str, *, params_bytes: float,
                          opt_bytes: float = 0.0, cache_bytes: float = 0.0,
                          tokens: float = 0.0, d_model: int = 0,
                          n_layers: int = 0, act_bytes: int = 2) -> float:
    act = 8.0 * tokens * d_model * n_layers * act_bytes
    if mode == "train":
        return 5.0 * params_bytes + 2.0 * opt_bytes + act
    if mode == "prefill":
        return params_bytes + act / 2.0 + cache_bytes
    # decode
    return params_bytes + cache_bytes + 2.0 * tokens * d_model * n_layers * act_bytes


def roofline_terms(n_chips: int, flops_global: float, mem_bytes_global: float,
                   coll_bytes_global: float) -> dict:
    compute_s = flops_global / (n_chips * PEAK_FLOPS_BF16)
    memory_s = mem_bytes_global / (n_chips * HBM_BW)
    collective_s = coll_bytes_global / (n_chips * link_bw(n_chips))
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=lambda k: terms[k])
    return {**terms, "dominant": dom,
            "roofline_step_s": max(compute_s, memory_s, collective_s)}

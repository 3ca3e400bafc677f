"""The MARL environment (port of ``repro/core/marl/env.py``).

Only ``bs_frequencies`` is ported so far, for the FL driver; the env itself
comes with ROADMAP A7.
"""
from __future__ import annotations

import torch


def bs_frequencies(cfg, device=None) -> torch.Tensor:
    """Nominal BS CPU frequencies (Hz), (n_bs,) fp32. The frequency table is
    cycled when ``n_bs`` exceeds its length."""
    table = torch.as_tensor(cfg.bs_freqs_ghz, dtype=torch.float32)
    idx = torch.arange(cfg.n_bs) % table.shape[0]
    return (table[idx] * 1e9).to(device)

"""Consensus core (paper Section II-C), port of ``repro/core/consensus.py``.

Ported so far: the static :class:`ConsensusConfig`, the stake election and
the vectorized verification gate, which the host ledger
(``repro_torch.core.blockchain.DPoSChain``) delegates to. The device chain
state, ``apply_round`` and the PBFT latency model wait for ROADMAP A5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.segment_reduce import segment_median


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Static consensus knobs: PBFT fault budget ``quorum_f`` (quorum
    2f+1), byzantine BS fraction, prepare/commit header size, block-size
    override, view-change timeout, chain reward/tolerance/initial stake,
    verdict history depth and committee count."""
    quorum_f: int = 1
    byzantine_frac: float = 0.0
    header_bits: float = 2048.0
    block_size_bits: Optional[float] = None
    view_timeout: float = 1.0
    reward: float = 1.0
    tolerance: float = 0.5
    s_ini: float = 100.0
    history: int = 8
    n_groups: int = 1


def elect_producers(stakes, n_producers: int) -> torch.Tensor:
    """Top-``n_producers`` BSs by stake, (n_producers,) int32.

    A stable argsort of ``-stakes`` (fp32): equal stakes are won by the
    smaller BS index, the host ledger's tie rule.
    """
    order = torch.argsort(-torch.as_tensor(stakes, dtype=torch.float32),
                          stable=True)
    return order[:n_producers].to(torch.int32)


def verify_metas(losses, submitted, *, tolerance, n_clients=None,
                 n_suspect=None, group=None, n_groups: int = 1):
    """Vectorized quality gate over stacked per-BS submission metas.

    Accepted iff ``loss <= median(submitted losses) + tolerance`` and the
    cohort is not majority-suspect (``n_suspect * 2 > n_clients``), in
    fp32. The median is over the submitted subset only: non-submitters get
    an out-of-range segment id. ``group``/``n_groups`` gate per committee.
    All inputs (M,); returns (M,) bool (False for non-submitters).
    """
    losses = torch.as_tensor(losses, dtype=torch.float32)
    sub = torch.as_tensor(submitted, dtype=torch.bool, device=losses.device)
    m = losses.shape[0]
    g = (torch.zeros((m,), dtype=torch.int64, device=losses.device)
         if group is None else torch.as_tensor(group, device=losses.device).long())
    seg = torch.where(sub, g, n_groups)
    med = segment_median(losses, seg, n_groups)
    ok = losses <= med[torch.clamp(g, 0, n_groups - 1)] + tolerance
    if n_clients is None or n_suspect is None:
        suspect = torch.zeros((m,), dtype=torch.bool, device=losses.device)
    else:
        suspect = (torch.as_tensor(n_suspect, dtype=torch.float32) * 2.0
                   > torch.as_tensor(n_clients, dtype=torch.float32))
    return sub & ok & ~suspect

"""Wireless communication model (paper Section II-D, Eqs. 7-8), port of
``repro/core/comms.py``.

OFDMA with C shared sub-channels between the M BSs and the MBS. The rates
feed the latency model; they are simulation, not real links. Random draws
take an explicit ``torch.Generator``; they are made on the CPU and moved to
``device``, so a seed gives the same state on every device. Functions of a
fresh draw (``evolve_channel``) take the draw as an argument.
"""
from __future__ import annotations

import dataclasses

import torch


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) * 1e-3


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    n_bs: int = 5
    n_subchannels: int = 8
    subchannel_bw_hz: float = 30e6       # "bandwidth of the subchannel is 30MHz"
    p_uplink_dbm: float = 34.0           # RSU/BS transmit power
    p_downlink_dbm: float = 42.0         # MBS transmit power
    noise_dbm_per_hz: float = -174.0     # N_0
    path_loss_exp: float = 3.0           # alpha
    min_dist_m: float = 50.0
    max_dist_m: float = 500.0
    channel_corr: float = 0.9            # AR(1) fading memory across steps


def sample_distances(cfg: WirelessConfig, gen: torch.Generator,
                     device=None) -> torch.Tensor:
    """BS<->MBS distances r_{i,m}, uniform in [min, max] meters, (M,)."""
    u = torch.rand((cfg.n_bs,), generator=gen)
    return (cfg.min_dist_m + u * (cfg.max_dist_m - cfg.min_dist_m)).to(device)


def sample_channel(cfg: WirelessConfig, gen: torch.Generator,
                   device=None) -> torch.Tensor:
    """Rayleigh-fading power gains h_{i,c} ~ Exp(1), shape (M, C)."""
    h = torch.empty((cfg.n_bs, cfg.n_subchannels)).exponential_(generator=gen)
    return h.to(device)


def evolve_channel(cfg: WirelessConfig, h, fresh) -> torch.Tensor:
    """Gauss-Markov (AR-1) fading evolution of the MARL env dynamics:
    ``rho * h + (1 - rho) * fresh``, with ``fresh`` (M, C) a new Rayleigh
    draw (``sample_channel``)."""
    rho = cfg.channel_corr
    return rho * h + (1.0 - rho) * fresh


def _noise_watt(cfg: WirelessConfig) -> float:
    return dbm_to_watt(cfg.noise_dbm_per_hz) * cfg.subchannel_bw_hz


def uplink_rate(cfg: WirelessConfig, tau, h, dist) -> torch.Tensor:
    """Eq. 7. tau: (M, C) time fractions; h: (M, C) gains; dist: (M,).
    Returns the per-BS achievable uplink rate, bits/s, with leave-one-out
    co-channel interference weighted by the other BSs' time shares. ``h``
    and ``dist`` may carry a leading scenario axis, (S, M, C) and (S, M),
    giving (S, M) rates."""
    P = dbm_to_watt(cfg.p_uplink_dbm)
    pl = dist[..., None] ** (-cfg.path_loss_exp)  # (..., M, 1)
    sig = P * h * pl                              # (..., M, C) received power
    tot = torch.sum(tau * sig, dim=-2, keepdim=True)
    interf = tot - tau * sig
    sinr = sig / (interf + _noise_watt(cfg))
    per_ch = cfg.subchannel_bw_hz * torch.log2(1.0 + sinr)
    return torch.sum(tau * per_ch, dim=-1)


def apply_outage(rate, bad, floor) -> torch.Tensor:
    """Gate a per-BS rate through a channel-outage mask: a BS whose (M,)
    Gilbert-Elliott indicator ``bad`` is set keeps ``floor`` of its rate
    (a deep fade, not a hard zero, which would make Eq. 14 infinite)."""
    rate = torch.as_tensor(rate)
    bad = torch.as_tensor(bad, device=rate.device)
    return torch.where(bad, rate * floor, rate)


def downlink_rate(cfg: WirelessConfig, h_down, dist) -> torch.Tensor:
    """Eq. 8: MBS broadcast of the global model. h_down: (M, C), or
    (S, M, C) with dist (S, M) for a batch of scenarios."""
    P = dbm_to_watt(cfg.p_downlink_dbm)
    pl = dist[..., None] ** (-cfg.path_loss_exp)
    sig = P * h_down * pl
    tot = torch.sum(sig, dim=-2, keepdim=True)
    interf = tot - sig
    sinr = sig / (interf + _noise_watt(cfg))
    per_ch = cfg.subchannel_bw_hz * torch.log2(1.0 + sinr)
    return torch.sum(per_ch, dim=-1)

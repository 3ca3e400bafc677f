"""Mixture-of-Experts layers (port of ``repro/models/moe.py``): top-k
routing with two execution modes.

``dense``    — exact weighted sum over all experts (every expert computes
               every token, combine weights zero out non-selected ones). No
               token drops; the smoke configs' mode and the oracle.
``capacity`` — scatter/gather token dispatch into per-expert capacity
               buffers, the full configs' mode: tokens over an expert's
               capacity are dropped (their expert contribution is zero; the
               residual stream carries them through).

The router is an fp32 leaf whatever the model's dtype. The reference's
expert-parallel dispatch (``moe_capacity_ep_a2a``) needs an LM device mesh
and is never taken on one device; it waits for ROADMAP A11.9. The expert
products are ``torch.einsum`` / ``torch.bmm``, as the reference's are
einsums outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def moe_init(cfg, gen: torch.Generator, dtype):
    E, d, dev = cfg.n_experts, cfg.d_model, gen.device
    ff = cfg.moe_d_ff or cfg.d_ff

    def stack(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    p = {
        "router": L.dense_init(gen, d, E, torch.float32, scale=0.02),
        "wg": stack((E, d, ff), 1.0 / d ** 0.5),
        "wu": stack((E, d, ff), 1.0 / d ** 0.5),
        "wd": stack((E, ff, d), 1.0 / ff ** 0.5),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, ff * cfg.n_shared_experts, dtype)
    return p


def router_probs(cfg, p, x):
    """x: (T, d) -> (gates (T, k), idx (T, k), aux_loss): an fp32 softmax
    over the experts, its top k renormalised to sum to 1, and the Switch
    load-balance loss ``E * sum(mean prob * mean selection)``."""
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    me = probs.mean(0)
    ce = F.one_hot(idx, E).to(torch.float32).sum(1).mean(0)
    return gates, idx, E * torch.sum(me * ce)


def _experts_apply(p, xe):
    """xe: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    return torch.bmm(h, p["wd"])


def _shared(cfg, p, x, out):
    if cfg.n_shared_experts:
        out = out + L.mlp_apply(p["shared"], x)
    return out


def moe_dense(cfg, p, x):
    """Exact all-experts path. x: (B, S, d). The gate-combine is fused into
    the down projection: one product contracting the expert and hidden axes
    together."""
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    xt = x.reshape(T, d)
    gates, idx, aux = router_probs(cfg, p, xt)
    comb = (F.one_hot(idx, E).to(torch.float32) * gates[..., None]).sum(1)
    h = F.silu(torch.einsum("td,edf->tef", xt, p["wg"])) \
        * torch.einsum("td,edf->tef", xt, p["wu"])
    h = h * comb.to(h.dtype)[..., None]  # (T, E, ff)
    out = h.reshape(T, -1) @ p["wd"].reshape(-1, d)
    return _shared(cfg, p, x, out.to(x.dtype).reshape(B, S, d)), aux


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert: ``max(8, int(capacity_factor * T * k / E))``,
    rounded up to a multiple of 128 once ``T * k >= 1024``."""
    k, E = cfg.moe_top_k, cfg.n_experts
    C = max(8, int(cfg.capacity_factor * n_tokens * k / E))
    if n_tokens * k >= 1024:
        C = ((C + 127) // 128) * 128
    return C


def moe_capacity(cfg, p, x):
    """Scatter/gather dispatch with a fixed per-expert capacity. A (token,
    slot)'s rank in its expert is an exclusive cumsum in token-major order;
    ranks at or past the capacity are dropped: they scatter-add zeros into
    the clamped last slot (never disturbing the token that holds it) and
    read back gated to zero."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.moe_top_k, cfg.n_experts
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    gates, idx, aux = router_probs(cfg, p, xt)

    flat_e = idx.reshape(T * k)  # expert of each (token, slot)
    onehot = F.one_hot(flat_e, E)  # (T*k, E)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = pos < C
    pos_c = torch.clamp(pos, max=C - 1)

    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    vals = xt[tok] * keep[:, None].to(xt.dtype)
    buf = torch.zeros((E, C, d), dtype=xt.dtype, device=x.device)
    buf.index_put_((flat_e, pos_c), vals, accumulate=True)
    ye = _experts_apply(p, buf)  # (E, C, d)
    y_tok = ye[flat_e, pos_c].reshape(T, k, d)  # gather back
    g_eff = gates * keep.reshape(T, k).to(gates.dtype)
    out = (y_tok.to(torch.float32) * g_eff[..., None]).sum(1)
    return _shared(cfg, p, x, out.to(x.dtype).reshape(B, S, d)), aux


def moe_apply(cfg, p, x):
    """The config's MoE mode. Returns (out (B, S, d), aux_loss)."""
    if cfg.router_mode == "capacity":
        return moe_capacity(cfg, p, x)
    return moe_dense(cfg, p, x)

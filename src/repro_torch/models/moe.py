"""Mixture-of-Experts layers (port of ``repro/models/moe.py``): top-k
routing with two execution modes.

``dense``    — exact weighted sum over all experts (every expert computes
               every token, combine weights zero out non-selected ones). No
               token drops; the smoke configs' mode and the oracle.
``capacity`` — scatter/gather token dispatch into per-expert capacity
               buffers, the full configs' mode: tokens over an expert's
               capacity are dropped (their expert contribution is zero; the
               residual stream carries them through).

The router is an fp32 leaf whatever the model's dtype. The expert products
are ``torch.einsum`` / ``torch.bmm``, as the reference's are einsums
outside any Pallas kernel.

On an LM mesh (``sharding.act.activation_mesh``, layout "2d") whose fsdp
axis divides the expert count, the capacity mode takes the reference's
expert-parallel dispatch, :func:`moe_capacity_ep_a2a`: the analogue of its
``shard_map`` region. Each fsdp rank routes its own tokens (``to_local``
over the data axes) into a per-(source shard, expert) capacity buffer, one
differentiable all-to-all over the fsdp group sends each expert's slots to
the rank that holds it, the experts run on their owner with their hidden
dim split over "model" (the down projection summed over the model group),
and the inverse all-to-all brings the slots home. Off a mesh it is never
taken.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C
from repro_torch.sharding.act import (as_dtensor, constrain, ep_enabled,
                                      on_local_shards, unshard)
from repro_torch.sharding.specs import P, spec_placements


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
    probs = torch.softmax(x.to(torch.float32)
                          @ unshard(p["router"], None, None), dim=-1)
    gates, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = cfg.n_experts
    me = probs.mean(0)
    ce = F.one_hot(idx, E).to(torch.float32).sum(1).mean(0)
    return gates, idx, E * torch.sum(me * ce)


def _experts_apply(p, xe):
    """xe: (E, C, d) -> (E, C, d) through each expert's SwiGLU. On a mesh,
    as the reference: with expert parallelism (the fsdp axis divides E)
    the weights stay on their owner and the buffer is expert-sharded;
    otherwise the capacity dim is split over data and the weights gathered
    on d_model, the hidden dim staying on "model"."""
    E = xe.shape[0]
    ep = "data" if ep_enabled(E) else None
    cap = None if ep else "data"
    wg = unshard(p["wg"], ep, None, "model")
    wu = unshard(p["wu"], ep, None, "model")
    wd = unshard(p["wd"], ep, "model", None)
    xe = constrain(xe, ep, cap, None)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    h = constrain(h, ep, cap, "model")
    return constrain(torch.bmm(h, wd), ep, cap, None)


def _shared(cfg, p, x, out):
    if cfg.n_shared_experts:
        out = out + L.mlp_apply(p["shared"], x)
    return out


def moe_dense(cfg, p, x):
    """Exact all-experts path. x: (B, S, d). Expert-major: every expert's
    SwiGLU on every token as one batched product over the experts, the
    gate-combine applied to the hidden activations, and the down
    projections summed over the experts (no reshape merges a dim a mesh
    splits)."""
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    xt = constrain(x.reshape(T, d), "batch", None)
    gates, idx, aux = router_probs(cfg, p, xt)
    comb = (F.one_hot(idx, E).to(torch.float32) * gates[..., None]).sum(1)
    wg = unshard(p["wg"], None, None, "model")
    wu = unshard(p["wu"], None, None, "model")
    wd = unshard(p["wd"], None, "model", None)
    xe = xt.expand(E, T, d)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)  # (E, T, ff)
    h = constrain(h, None, "batch", "model")
    h = h * comb.T.to(h.dtype)[..., None]
    out = torch.bmm(h, wd).sum(0)
    out = constrain(out.to(x.dtype).reshape(B, S, d), "batch", None, None)
    return _shared(cfg, p, x, out), aux


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert: ``max(8, int(capacity_factor * T * k / E))``,
    rounded up to a multiple of 128 once ``T * k >= 1024``."""
    k, E = cfg.moe_top_k, cfg.n_experts
    C = max(8, int(cfg.capacity_factor * n_tokens * k / E))
    if n_tokens * k >= 1024:
        C = ((C + 127) // 128) * 128
    return C


def _scatter_slots(vals, flat_e, pos_c, *, n_experts: int, capacity: int):
    """(T * k, d) rows summed into an (E, C, d) buffer at (expert, slot)."""
    buf = vals.new_zeros((n_experts, capacity, vals.shape[-1]))
    buf.index_put_((flat_e, pos_c), vals, accumulate=True)
    return buf


def _gather_slots(ye, flat_e, pos_c):
    return ye[flat_e, pos_c]


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
    # on a mesh the scatter and the gather run on each rank's whole
    # (replicated) tensors: the reference's law, one capacity for all tokens
    buf = on_local_shards(_scatter_slots, (vals, flat_e, pos_c), ({},) * 3,
                          {}, n_experts=E, capacity=C)
    _log_drops(keep)
    buf = constrain(buf, "data", None, None) if ep_enabled(E) \
        else constrain(buf, None, "data", None)
    ye = _experts_apply(p, buf)  # (E, C, d)
    y_tok = on_local_shards(_gather_slots, (ye, flat_e, pos_c), ({},) * 3,
                            {}).reshape(T, k, d)  # gather back
    g_eff = gates * keep.reshape(T, k).to(gates.dtype)
    out = (y_tok.to(torch.float32) * g_eff[..., None]).sum(1)
    out = constrain(out.to(x.dtype).reshape(B, S, d), "batch", None, None)
    return _shared(cfg, p, x, out), aux


# where each capacity call appends its count of dropped (token, slot) pairs
# (a 0-d tensor, this rank's own tokens on a mesh), or None: no count
DROP_LOG = None


def _log_drops(keep):
    if DROP_LOG is not None:
        DROP_LOG.append((~keep).sum())


def ep_capacity(cfg, n_local_tokens: int) -> int:
    """Slots per (source shard, expert) of the expert-parallel dispatch:
    ``max(8, int(capacity_factor * T_loc * k / E))`` rounded up to a
    multiple of 8 (not 128, as :func:`capacity` rounds)."""
    C = max(8, int(cfg.capacity_factor * n_local_tokens * cfg.moe_top_k
                   / cfg.n_experts))
    return ((C + 7) // 8) * 8


def moe_capacity_ep_a2a(cfg, p, x):
    """Expert-parallel capacity dispatch, the reference's ``shard_map`` +
    ``all_to_all`` form (GShard / Switch).

    The fsdp axes are manual: each fsdp rank takes its own batch rows
    (``to_local``), routes them, ranks each (token, slot) in its expert by
    a local cumsum and scatters it into an (E, C_loc, d) buffer; one tiled
    all-to-all over the fsdp group sends expert e's slots to the rank that
    holds e (its weights stored ("data", ., "model")), whose products are
    local, with the hidden dim split over "model" and the down projection
    summed over the model group; the inverse all-to-all returns them. The
    aux loss is each rank's, averaged over the fsdp group. Capacity is per
    (source shard, expert): drops differ from :func:`moe_capacity`'s only
    under shard-imbalanced routing. Shared experts run outside the manual
    region."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.sharding.act import (_current, batch_axes, fsdp_size,
                                          manual_axes)

    mesh = _current()
    man = batch_axes(mesh, layout="2d")
    man_t = (man,) if isinstance(man, str) else tuple(man)
    n_sh = fsdp_size()
    group = mesh.group(man_t)
    E, k = cfg.n_experts, cfg.moe_top_k
    E_loc = E // n_sh
    B, S, d = x.shape
    dmesh = mesh.device_mesh

    # the region's inputs, as its in_specs: x (man, ., .), the router
    # replicated, the expert stacks (man, ., .) with ff over "model" when
    # it divides (the reference leaves "model" to GSPMD inside the region)
    ff = p["wg"].shape[-1]
    m_ax = "model" if "model" in mesh.axis_names else None
    ff_split = m_ax is not None and ff % mesh.shape[m_ax] == 0
    ff_part = m_ax if ff_split else None

    def local(t, spec, grad_spec=None):
        pl = spec_placements(spec, mesh)
        t = as_dtensor(t, mesh).redistribute(dmesh, pl)
        gpl = pl if grad_spec is None else grad_spec
        return t.to_local(grad_placements=gpl)

    x_l = local(x, P(man, None, None))
    # the router's cotangent is this rank's tokens' share: partial over
    # the fsdp axes, the same on every model rank
    r_grad = tuple(Partial() if a in man_t else Replicate()
                   for a in mesh.axis_names)
    router = local(p["router"], P(None, None), r_grad)
    wg = local(p["wg"], P(man, None, ff_part))
    wu = local(p["wu"], P(man, None, ff_part))
    wd = local(p["wd"], P(man, ff_part, None))

    with manual_axes(man_t):
        B_loc = x_l.shape[0]
        T_loc = B_loc * S
        xt = x_l.reshape(T_loc, d)
        probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
        gates, idx = torch.topk(probs, k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        me = probs.mean(0)
        ce = F.one_hot(idx, E).to(torch.float32).sum(1).mean(0)
        aux = C.pmean(E * torch.sum(me * ce), group)

        C_loc = ep_capacity(cfg, T_loc)
        flat_e = idx.reshape(T_loc * k)
        onehot = F.one_hot(flat_e, E)
        pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
        keep = pos < C_loc
        pos_c = torch.clamp(pos, max=C_loc - 1)
        tok = torch.arange(T_loc, device=xt.device).repeat_interleave(k)
        vals = xt[tok] * keep[:, None].to(xt.dtype)
        buf = torch.zeros((E, C_loc, d), dtype=xt.dtype, device=xt.device)
        buf.index_put_((flat_e, pos_c), vals, accumulate=True)
        _log_drops(keep)

        # dispatch: one tiled all-to-all (its own inverse)
        recv = C.all_to_all(buf.reshape(n_sh, E_loc, C_loc, d), group)
        xe = recv.transpose(0, 1).reshape(E_loc, n_sh * C_loc, d)
        if ff_split:
            xe = C.copy_to_group(xe, mesh.group(m_ax))
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        ye = torch.bmm(h, wd)  # (E_loc, n_sh * C_loc, d)
        if ff_split:
            ye = C.reduce_from_group(ye, mesh.group(m_ax))

        # return path: the inverse all-to-all
        y4 = ye.reshape(E_loc, n_sh, C_loc, d).transpose(0, 1)
        back = C.all_to_all(y4, group).reshape(E, C_loc, d)
        y_tok = back[flat_e, pos_c].reshape(T_loc, k, d)
        g_eff = gates * keep.reshape(T_loc, k).to(gates.dtype)
        out = (y_tok.to(torch.float32) * g_eff[..., None]).sum(1)
        out = out.to(x_l.dtype).reshape(B_loc, S, d)

    out = DTensor.from_local(out, dmesh, spec_placements(P(man, None, None),
                                                         mesh),
                             run_check=False)
    aux = DTensor.from_local(aux, dmesh, [Replicate()] * dmesh.ndim,
                             run_check=False)
    # shared experts run outside the manual region, on the GSPMD-style path
    return _shared(cfg, p, x, out), aux


def _use_ep_a2a(cfg) -> bool:
    """The reference's rule: a mesh context, layout "2d", and the fsdp
    axis dividing the expert count."""
    from repro_torch.sharding.act import _current, current_layout

    return (_current() is not None and current_layout() == "2d"
            and ep_enabled(cfg.n_experts))


def moe_apply(cfg, p, x):
    """The config's MoE mode. Returns (out (B, S, d), aux_loss)."""
    if cfg.router_mode == "capacity":
        if _use_ep_a2a(cfg):
            return moe_capacity_ep_a2a(cfg, p, x)
        return moe_capacity(cfg, p, x)
    return moe_dense(cfg, p, x)

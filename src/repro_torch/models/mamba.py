"""Mamba-2 (SSD — state-space duality) block [arXiv:2405.21060] (port of
``repro/models/mamba.py``).

Forward (prefill/scoring) uses the chunked SSD algorithm: quadratic
attention-like compute inside chunks of length Q, linear state passing
between chunks. Decode is the O(1) recurrent update.

Layout follows the reference: in_proj emits [z | x | B | C | dt] with a
causal depthwise conv over [x|B|C]; a single B/C group shared across heads.
``A_log``, ``D`` and ``dt_bias`` are fp32 leaves whatever the model's dtype.
The reference's sharding hooks (``constrain``, ``unshard``) are no-ops off a
device mesh; on one card the port drops them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding.act import (constrain, merge_heads, on_local_shards,
                                     row_parallel, split_heads, unshard)


def mamba_init(cfg, gen: torch.Generator, dtype):
    d, dI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    conv_dim = dI + 2 * N
    in_proj = L.dense_init(gen, d, 2 * dI + 2 * N + H, dtype)
    conv_w = (torch.randn((conv_dim, cfg.ssm_conv), generator=gen, device=dev)
              * 0.1).to(dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "gate_norm_scale": torch.ones((dI,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, dI, d, dtype),
    }


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along seq. xBC: (B,S,Cd), w: (Cd,K).

    w[:, K-1] multiplies the current timestep, w[:, 0] the oldest, as in the
    decode path's window. The sum runs in the input's dtype, term by term,
    in the reference's order. On a mesh each rank convolves its own batch
    rows and channels (the conv never mixes either)."""
    return on_local_shards(_causal_conv_local, (xBC, w, b),
                           ({"b": 0, "h": 2}, {"h": 0}, {"h": 0}),
                           {"b": 0, "h": 2})


def _causal_conv_local(xBC, w, b):
    K = w.shape[-1]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[None, None, :, i]
    return out + b


def ssd_chunked_ref(x, dt, A, Bm, Cm, chunk: int):
    """SSD scan in plain PyTorch (the reference's oracle and XLA path, and
    the SSD kernel's plain version).

    x:  (B, S, H, P) head inputs
    dt: (B, S, H)    discretization steps (post-softplus)
    A:  (H,)         negative decay rates (A < 0)
    Bm: (B, S, N)    input projection (shared across heads, 1 group)
    Cm: (B, S, N)    output projection
    returns y: (B, S, H, P)

    One step differs from the reference's arithmetic, as in the kernel: the
    in-chunk cumulative sum of dt·A is taken in float64, and each exponent
    (cum_q − cum_k, total − cum_k, cum_q, total) is rounded to fp32 once
    before its exp. In fp32, |cum| reaches ~3,300 over a 256-step chunk at
    mamba2-2.7b's width (A down to −16), where one ulp is 2.4e-4, so two
    fp32 cumsums taken in different orders put exponents apart by a few
    ulps and y apart by up to 5e-4, above the reference tests' atol 2e-4.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk "
                         f"{Q}")
    nc = S // Q

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    dA = dtc * A[None, None, None, :]  # (B,nc,Q,H), negative
    # within-chunk cumulative log decay, in float64
    cum = torch.cumsum(dA.to(torch.float64), dim=2)
    total = cum[:, :, -1, :]  # (B,nc,H)

    # intra-chunk: decay(q,k) = exp(cum_q - cum_k) for k <= q. Mask BEFORE
    # exp: masked (future) entries have diff > 0, whose exp can overflow.
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(x.dtype)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    mask = mask[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, 0.0)) * mask
    del diff
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)  # (B,nc,Q,Q)
    att = cb[..., None] * decay  # (B,nc,Q,Q,H)
    del decay
    xdt = xc * dtc[..., None]  # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, xdt)
    del att

    # chunk boundary states: sum_k exp(total_c - cum_k) * B_k (outer) xdt_k
    dec_k = torch.exp((total[:, :, None, :] - cum).to(x.dtype))  # (B,nc,Q,H)
    states = torch.einsum("bckh,bckn,bckhp->bchnp", dec_k, Bc, xdt)

    # inter-chunk recurrence; h_in[:, c] is the state entering chunk c
    h = torch.zeros((Bsz, H, N, P), dtype=x.dtype, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(total[:, c].to(x.dtype))[:, :, None, None] + \
            states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqh,bcqn,bchnp->bcqhp",
                           torch.exp(cum.to(x.dtype)), Cc, h_in)
    return (y_intra + y_inter).reshape(Bsz, S, H, P)


def _ssd_fp32(x, dt, A, Bm, Cm, *, chunk):
    f32 = torch.float32
    return ssd_chunked_ref(x.to(f32), dt, A, Bm.to(f32), Cm.to(f32),
                           chunk=chunk)


def _split_proj(cfg, zxbcdt):
    dI, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :dI]
    xBC = zxbcdt[..., dI:2 * dI + 2 * N]
    dt = zxbcdt[..., 2 * dI + 2 * N:]
    return z, xBC, dt


def mamba_forward(cfg, p, u, *, use_pallas: bool = False):
    """Full-sequence forward. u: (B,S,d) -> (B,S,d). ``use_pallas=True``
    (the reference's keyword for its kernel) sends the SSD scan through the
    hand-written kernel, which needs ``S % cfg.ssm_chunk == 0``."""
    S = u.shape[1]
    dI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(cfg, u @ unshard(p["in_proj"], None, "model"))
    xBC = constrain(xBC, "batch", None, "model")
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x = constrain(split_heads(xBC[..., :dI], H, P),
                  "batch", None, "model", None)
    Bm = xBC[..., dI:dI + N]
    Cm = xBC[..., dI + N:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if use_pallas:
        from repro_torch.kernels import ops as kops

        # x, Bm and Cm go in the model's dtype: the kernel widens bf16 in
        # registers, which is exact
        y = kops.ssd_scan(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        bh = {"b": 0, "h": 2}
        y = on_local_shards(_ssd_fp32, (x, dt, A, Bm, Cm),
                            (bh, bh, {"h": 0}, {"b": 0}, {"b": 0}), bh,
                            chunk=min(cfg.ssm_chunk, S))
    # type promotion widens x exactly: the same fp32 product as from an
    # fp32 copy of x
    y = y + p["D"][None, None, :, None] * x
    y = merge_heads(y).to(u.dtype)
    y = L.rmsnorm(y * F.silu(z), p["gate_norm_scale"], cfg.norm_eps)
    return row_parallel(y, p["out_proj"])


def mamba_state_init(cfg, batch: int, dtype, device=None):
    dI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, dI + 2 * N), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(cfg, p, u, state):
    """One-token recurrent step. u: (B,1,d); returns (y, new_state)."""
    dI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(cfg, u @ p["in_proj"])
    # conv over (state window + current)
    window = torch.cat([state["conv"], xBC], dim=1)  # (B,K,conv_dim)
    conv_out = torch.einsum("bkc,ck->bc", window, p["conv_w"]) + p["conv_b"]
    xBC_t = F.silu(conv_out)[:, None, :]  # (B,1,conv_dim)
    new_conv = window[:, 1:, :]
    x = split_heads(xBC_t[:, 0, :dI], H, P).to(torch.float32)
    Bm = xBC_t[:, 0, dI:dI + N].to(torch.float32)  # (B,N)
    Cm = xBC_t[:, 0, dI + N:].to(torch.float32)
    dt_t = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt_t * A[None, :])  # (B,H)
    h = state["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bn,bhp,bh->bhnp", Bm, x, dt_t)
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    y = y + p["D"][None, :, None] * x
    y = merge_heads(y)[:, None].to(u.dtype)
    y = L.rmsnorm(y * F.silu(z), p["gate_norm_scale"], cfg.norm_eps)
    return row_parallel(y, p["out_proj"]), \
        {"conv": new_conv, "ssm": h}

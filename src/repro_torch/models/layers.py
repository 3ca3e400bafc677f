"""Shared neural-net building blocks (port of ``repro/models/layers.py``).

Parameters are plain dicts of tensors with the reference's keys and
layouts: a dense weight is ``(d_in, d_out)`` and is applied as ``x @ W``;
layer stacks carry a leading ``(n_layers, ...)`` axis. Random inits draw
from a ``torch.Generator`` on the generator's device, so a full-width model
is drawn on the card.

The reference's sharding hooks sit where the reference has them
(``constrain``, ``unshard`` from ``repro_torch.sharding.act``): on an LM
mesh (``activation_mesh``) they redistribute DTensors, off one they return
their input unchanged.

Gemma's variants (the ``1 + scale`` RMSNorm with zero-initialised scales,
and the gelu MLP) are chosen, as in the reference, by the config's name:
:func:`is_gemma`. A field of ``ArchConfig`` would break its equality with
the reference's config.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.act import (align, constrain, on_local_shards,
                                     row_parallel, split_dim, unshard)

# ----------------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------


def is_gemma(cfg) -> bool:
    """The reference's rule for gemma's norms and MLP activation."""
    return cfg.name.startswith("gemma")


def rmsnorm(x, scale, eps: float = 1e-6, *, gemma_style: bool = False):
    """RMSNorm in fp32; ``gemma_style`` multiplies by ``1 + scale``."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    mult = scale.to(torch.float32)
    if gemma_style:
        mult = 1.0 + mult
    return (x * mult).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dt)


def apply_norm(cfg, x, params, prefix: str):
    """The config's norm with ``params[prefix + "_scale"]`` (and ``_bias``
    for layernorm)."""
    if cfg.norm_type == "layernorm":
        return layernorm(x, params[f"{prefix}_scale"],
                         params.get(f"{prefix}_bias"), cfg.norm_eps)
    return rmsnorm(x, params[f"{prefix}_scale"], cfg.norm_eps,
                   gemma_style=is_gemma(cfg))


def norm_params(cfg, d: int, dtype, device=None):
    """Layernorm: ones and zeros. RMSNorm: ones, or zeros for gemma, whose
    norm multiplies by ``1 + scale``."""
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    init = torch.zeros if is_gemma(cfg) else torch.ones
    return {"scale": init((d,), dtype=dtype, device=device)}


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); positions3: (B, S, 3)
    integer temporal / height / width position ids.

    Each of the ``sections`` (t_sec, h_sec, w_sec), which sum to hd // 2,
    takes its angle from its own position axis [arXiv:2409.12191 §2.1]:
    frequency i reads axis ``sec[i]``. With all three axes equal it is
    :func:`apply_rope`."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])  # (hd/2,) in {0, 1, 2}
    pos = torch.gather(positions3.to(torch.float32), -1,
                       sec.expand(*positions3.shape[:2], -1))  # (B, S, hd/2)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype):
    return {
        "w_gate": dense_init(gen, d, ff, dtype),
        "w_up": dense_init(gen, d, ff, dtype),
        "w_down": dense_init(gen, ff, d, dtype),
    }


def mlp_apply(p, x, activation: str = "silu"):
    """Gated MLP: (act(x W_gate) * x W_up) W_down, act silu (SwiGLU) or
    gelu. The reference's gelu is ``jax.nn.gelu``, whose default is the
    tanh approximation."""
    g = x @ unshard(p["w_gate"], None, "model")
    g = F.gelu(g, approximate="tanh") if activation == "gelu" else F.silu(g)
    h = constrain(g * (x @ unshard(p["w_up"], None, "model")),
                  "batch", None, "model")
    return row_parallel(h, p["w_down"])


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ----------------------------------------------------------------------------
# attention cores
# ----------------------------------------------------------------------------

NEG_INF = -2.0e38


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """(Sq, Sk) additive fp32 bias from position vectors; window<=0 => no
    window."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def attention_reference(q, k, v, *, causal=True, window=0, logit_softcap=None,
                        q_offset=0, scale=None):
    """Naive (materialized-scores) GQA attention in fp32. q: (B,Sq,Hq,hd),
    k: (B,Sk,Hkv,hd), v: (B,Sk,Hkv,vd) (MLA's vd differs from hd). Used
    for short sequences and as the oracle; it is also the flash kernel's
    plain version."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    vd = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = softcap(s, logit_softcap)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    s += _mask_bias(q_pos, k_pos, causal=causal, window=window)  # in place
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, Hq, vd).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=0, logit_softcap=None,
                      q_offset=0, scale=None, block_q=512, block_k=512):
    """Flash-style attention in plain PyTorch: a loop over q blocks and,
    inside, over k blocks, with online max/sum rescaling in fp32. Memory is
    O(block_q * block_k) per step instead of O(Sq * Sk). Every k block is
    visited, masked or not, as in the reference. v's head dim may differ
    from q's and k's."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    vd = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device

    pad_q = (-Sq) % block_q
    pad_k = (-Sk) % block_k
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k

    qb = qp.reshape(B, nq, block_q, Hkv, G, hd).to(torch.float32)
    kb = kp.reshape(B, nk, block_k, Hkv, hd).to(torch.float32)
    vb = vp.reshape(B, nk, block_k, Hkv, vd).to(torch.float32)
    k_valid = (torch.arange(kp.shape[1], device=dev) < Sk).reshape(nk, block_k)

    def q_block(qi: int):
        q_i = qb[:, qi]  # (B, bq, Hkv, G, hd)
        q_pos = qi * block_q + torch.arange(block_q, device=dev) + q_offset
        m = torch.full((B, Hkv, G, block_q), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, block_q), device=dev)
        acc = torch.zeros((B, Hkv, G, block_q, vd), device=dev)
        for ki in range(nk):
            k_pos = ki * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", q_i, kb[:, ki]) * scale
            s = softcap(s, logit_softcap)
            bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
            s = s + torch.where(k_valid[ki][None, :], bias, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb[:, ki])
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-37)
        return o.permute(0, 3, 1, 2, 4)  # (B, bq, Hkv, G, vd)

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # as the reference's jax.checkpoint on each q block: the backward
        # recomputes a block's online softmax instead of keeping the fp32
        # scores and probabilities of every (q, k) block pair
        blocks = [checkpoint(q_block, qi, use_reentrant=False)
                  for qi in range(nq)]
    else:
        blocks = [q_block(qi) for qi in range(nq)]
    out = torch.cat(blocks, dim=1).reshape(B, nq * block_q, Hq, vd)[:, :Sq]
    return out.to(q.dtype)


def attention_decode(q, k_cache, v_cache, *, kv_len=None, window=0,
                     logit_softcap=None, scale=None):
    """Single-token decode attention. q: (B,1,Hq,hd); k_cache (B,S,Hkv,hd),
    v_cache (B,S,Hkv,vd).

    ``kv_len``: number of valid cache positions (the new token is at
    kv_len-1). The reference multiplies in the cache's storage dtype with
    fp32 accumulation; products of bf16 values are exact in fp32, so the
    port upcasts both operands, which is the same arithmetic. The
    probabilities are rounded to the cache's dtype before P·V, as there.
    """
    B, _, Hq, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    vd = v_cache.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_len = S if kv_len is None else kv_len
    # on a mesh the query takes the cache's layout (batch rows, KV heads and
    # head dim split as the cache's): the products below merge (B, Hkv),
    # which the card's DTensor (torch 2.11) allows only when no dim but
    # the first is split
    qg = align(split_dim(q[:, 0], 1, (Hkv, G)), k_cache, {0: 0, 2: 1, 3: 3})
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    s = softcap(s, logit_softcap)
    # scores sharded over the seq dim on a mesh: a distributed softmax
    s = constrain(s, "batch", None, None, "model")
    pos = torch.arange(S, device=q.device)
    ok = pos < kv_len
    if window > 0:
        ok &= pos > (kv_len - 1 - window)
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    return o.reshape(B, 1, Hq, vd).to(q.dtype)


def attend(q, k, v, *, causal=True, window=0, logit_softcap=None, q_offset=0,
           scale=None, use_pallas: bool = False):
    """Dispatch, as in the reference: ``use_pallas=True`` (the reference's
    keyword for its kernel) takes the hand-written flash kernel; otherwise
    the chunked plain version for long sequences, the naive one for short.
    On a mesh every route runs on each rank's batch rows and heads
    (``sharding.act.on_local_shards``)."""
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
              q_offset=q_offset, scale=scale)
    if use_pallas:
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, **kw)
    fn = attention_chunked if q.shape[1] * k.shape[1] > 2048 * 2048 \
        else attention_reference
    bh, bg = {"b": 0, "h": 2}, {"b": 0, "g": 2}
    return on_local_shards(fn, (q, k, v), (bh, bg, bg), bh, **kw)

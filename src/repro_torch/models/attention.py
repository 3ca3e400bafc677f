"""Attention blocks (port of ``repro/models/attention.py``): GQA with
sliding window, soft-cap and QKV bias. DeepSeek-V2 MLA, Qwen2-VL M-RoPE and
gemma2's local/global layers wait for ROADMAP A11 (``transformer`` refuses
their configs)."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L

# ---------------------------------------------------------------------------
# standard GQA attention
# ---------------------------------------------------------------------------


def gqa_init(cfg, gen, dtype):
    p = {
        "wq": L.dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
        "wk": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wv": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wo": L.dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                          ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((dim,), dtype=dtype, device=gen.device)
    return p


def _rope(cfg, x, positions):
    if cfg.mrope:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet: "
                                  "ROADMAP A11")
    return L.apply_rope(x, positions, cfg.rope_theta)


def _window(cfg) -> int:
    return cfg.sliding_window if cfg.attn_pattern == "swa" else 0


def _qkv(cfg, p, x):
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def gqa_forward(cfg, p, x, positions, *, use_pallas=False):
    """Full-sequence (train/prefill) forward. Returns (out, (k, v)) so callers
    can stash the KV cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = _rope(cfg, q.reshape(B, S, cfg.n_heads, cfg.head_dim), positions)
    k = _rope(cfg, k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim), positions)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    o = L.attend(q, k, v, causal=True, window=_window(cfg),
                 logit_softcap=cfg.attn_logit_softcap, use_pallas=use_pallas)
    return o.reshape(B, S, cfg.q_dim) @ p["wo"], (k, v)


def _dynamic_start(start: int, size: int, dim: int) -> int:
    """The start index ``jax.lax.dynamic_slice`` and
    ``dynamic_update_slice`` use: a negative start is wrapped once (plus
    ``dim``, as numpy indexing would), then clamped into ``[0, dim - size]``
    so that the slice fits."""
    if start < 0:
        start += dim
    return min(max(start, 0), dim - size)


def gqa_decode(cfg, p, x, cache_k, cache_v, pos: int, positions):
    """One-token decode. x: (B,1,d); caches (B,S,Hkv,hd); pos: index of the
    new token. Returns (out, cache_k, cache_v).

    The new K/V entry is written into the caches in place (the reference
    returns updated copies), and the caches themselves are returned. Start
    indices follow ``jax.lax.dynamic_update_slice_in_dim`` and
    ``dynamic_slice_in_dim`` (:func:`_dynamic_start`).
    """
    B = x.shape[0]
    S = cache_k.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q = _rope(cfg, q.reshape(B, 1, cfg.n_heads, cfg.head_dim), positions)
    k = _rope(cfg, k.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim), positions)
    v = v.reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    at = _dynamic_start(int(pos), 1, S)
    cache_k[:, at:at + 1] = k.to(cache_k.dtype)
    cache_v[:, at:at + 1] = v.to(cache_v.dtype)
    window = _window(cfg)
    if window > 0 and S > window:
        # static window slice ending at pos. While pos < window - 1 the
        # start is negative and, as in the reference, wraps to the cache's
        # tail: the slice then holds unwritten slots (ROADMAP C)
        start = _dynamic_start(int(pos) - (window - 1), window, S)
        o = L.attention_decode(q, cache_k[:, start:start + window],
                               cache_v[:, start:start + window], kv_len=window,
                               logit_softcap=cfg.attn_logit_softcap)
    else:
        o = L.attention_decode(q, cache_k, cache_v, kv_len=int(pos) + 1,
                               logit_softcap=cfg.attn_logit_softcap)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"], cache_k, cache_v

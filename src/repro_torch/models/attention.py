"""Attention blocks (port of ``repro/models/attention.py``): GQA with
sliding window, soft-cap, QKV bias and gemma2's local/global layers, and
DeepSeek-V2 MLA (multi-head latent attention with a compressed KV cache).
A config with ``mrope`` (Qwen2-VL) rotates q and k by M-RoPE over (B, S, 3)
positions in both the forward and the decode step."""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.sharding.act import (constrain, merge_heads, row_parallel,
                                     split_heads, unshard, write_seq)

# past this many cache slots a gemma2 global layer's decode attends to the
# sliding window only (the reference's long-context variant)
GLOBAL_DECODE_LIMIT = 32768

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
    """RoPE on (B, S) positions, or Qwen2-VL's M-RoPE on (B, S, 3)."""
    if cfg.mrope:
        return L.apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return L.apply_rope(x, positions, cfg.rope_theta)


def _window(cfg, is_global: bool, cache_len: int = 0) -> int:
    """The sliding window a layer attends through (0: none). Local layers
    of ``local_global`` take it, and so do its global layers' decode steps
    once the cache is longer than :data:`GLOBAL_DECODE_LIMIT`."""
    if cfg.attn_pattern == "swa":
        return cfg.sliding_window
    if cfg.attn_pattern == "local_global":
        if not is_global or cache_len > GLOBAL_DECODE_LIMIT:
            return cfg.sliding_window
    return 0


def _qkv(cfg, p, x):
    q, k, v = (x @ unshard(p[w], None, "model") for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def gqa_forward(cfg, p, x, positions, *, is_global=True, use_pallas=False):
    """Full-sequence (train/prefill) forward. Returns (out, (k, v)) so callers
    can stash the KV cache. ``is_global`` toggles gemma2's local/global
    layers."""
    q, k, v = _qkv(cfg, p, x)
    heads = ("batch", None, "model", None)
    q = _rope(cfg, constrain(split_heads(q, cfg.n_heads, cfg.head_dim),
                             *heads), positions)
    k = _rope(cfg, constrain(split_heads(k, cfg.n_kv_heads, cfg.head_dim),
                             *heads), positions)
    v = constrain(split_heads(v, cfg.n_kv_heads, cfg.head_dim), *heads)
    o = L.attend(q, k, v, causal=True, window=_window(cfg, is_global),
                 logit_softcap=cfg.attn_logit_softcap, use_pallas=use_pallas)
    o = constrain(o, *heads)
    return row_parallel(merge_heads(o), p["wo"]), \
        (k, v)


def _dynamic_start(start: int, size: int, dim: int) -> int:
    """The start index ``jax.lax.dynamic_slice`` and
    ``dynamic_update_slice`` use: a negative start is wrapped once (plus
    ``dim``, as numpy indexing would), then clamped into ``[0, dim - size]``
    so that the slice fits."""
    if start < 0:
        start += dim
    return min(max(start, 0), dim - size)


def _write(cache, new, pos: int) -> None:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at ``pos`` in
    place, at ``dynamic_update_slice_in_dim``'s start (on a mesh, by
    ``act.write_seq``)."""
    write_seq(cache, new, _dynamic_start(int(pos), 1, cache.shape[1]))


def gqa_decode(cfg, p, x, cache_k, cache_v, pos: int, positions, *,
               is_global=True):
    """One-token decode. x: (B,1,d); caches (B,S,Hkv,hd); pos: index of the
    new token. Returns (out, cache_k, cache_v).

    The new K/V entry is written into the caches in place (the reference
    returns updated copies), and the caches themselves are returned. Start
    indices follow ``jax.lax.dynamic_update_slice_in_dim`` and
    ``dynamic_slice_in_dim`` (:func:`_dynamic_start`).
    """
    S = cache_k.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q = _rope(cfg, split_heads(q, cfg.n_heads, cfg.head_dim), positions)
    k = _rope(cfg, split_heads(k, cfg.n_kv_heads, cfg.head_dim), positions)
    v = split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    _write(cache_k, k, pos)
    _write(cache_v, v, pos)
    window = _window(cfg, is_global, S)
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
    return row_parallel(merge_heads(o), p["wo"]), \
        cache_k, cache_v


# ---------------------------------------------------------------------------
# DeepSeek-V2 MLA
# ---------------------------------------------------------------------------


def mla_init(cfg, gen, dtype):
    H = cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dev = gen.device
    return {
        "q_down": L.dense_init(gen, cfg.d_model, cfg.q_lora_rank, dtype),
        "q_norm_scale": torch.ones((cfg.q_lora_rank,), dtype=dtype, device=dev),
        "q_up": L.dense_init(gen, cfg.q_lora_rank, H * qk, dtype),
        "kv_down": L.dense_init(gen, cfg.d_model,
                                cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype),
        "kv_norm_scale": torch.ones((cfg.kv_lora_rank,), dtype=dtype,
                                    device=dev),
        "kv_up": L.dense_init(gen, cfg.kv_lora_rank,
                              H * (cfg.qk_nope_head_dim + cfg.v_head_dim), dtype),
        "wo": L.dense_init(gen, H * cfg.v_head_dim, cfg.d_model, dtype),
    }


def _mla_qkv(cfg, p, x, positions):
    """Shared q/kv projection math. Returns q_nope, q_rope, c_kv, k_rope."""
    H = cfg.n_heads
    qk_n, qk_r, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q = L.rmsnorm(x @ unshard(p["q_down"], None, None), p["q_norm_scale"],
                  cfg.norm_eps)
    q = split_heads(q @ unshard(p["q_up"], None, "model"), H, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = x @ unshard(p["kv_down"], None, None)  # (B, S, r + qk_r)
    c_kv = L.rmsnorm(ckv[..., :r], p["kv_norm_scale"], cfg.norm_eps)
    k_rope = L.apply_rope(split_heads(ckv[..., r:], 1, qk_r), positions,
                          cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_eff_qkv(cfg, p, q_nope, q_rope, c_kv, k_rope_flat, seq_part=None):
    """The GQA problem MLA reduces to once kv_up's nope projection is
    absorbed into the query: Hkv = 1, effective query (B, Sq, H, r + qk_r)
    = (q_nope · w_kc) ⊕ q_rope, key (B, Skv, 1, r + qk_r) = c_kv ⊕ k_rope,
    value (B, Skv, 1, r) = c_kv. The absorption is an fp32 product cast back
    to the model's dtype, as in the reference. Decode passes
    ``seq_part="model"``: on a mesh the cache's seq dim stays sharded.
    Returns (q, k, v, scale)."""
    H, qk_n = q_nope.shape[2], cfg.qk_nope_head_dim
    w_kc = split_heads(unshard(p["kv_up"], None, "model")[:, :H * qk_n], H,
                       qk_n)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.to(torch.float32),
                         w_kc.to(torch.float32)).to(q_nope.dtype)
    q_eff = constrain(torch.cat([q_lat, q_rope], dim=-1),
                      "batch", None, "model", None)
    k_eff = constrain(torch.cat([c_kv, k_rope_flat], dim=-1)[:, :, None, :],
                      "batch", seq_part, None, None)
    v_eff = constrain(c_kv[:, :, None, :], "batch", seq_part, None, None)
    scale = 1.0 / math.sqrt(qk_n + cfg.qk_rope_head_dim)
    return q_eff, k_eff, v_eff, scale


def _mla_out(cfg, p, o_lat):
    """o_lat: (B, Sq, H, r) latent attention output -> (B, Sq, H * v_dim),
    through kv_up's value half in fp32."""
    H = o_lat.shape[2]
    w_vc = split_heads(unshard(p["kv_up"], None, "model")[
        :, H * cfg.qk_nope_head_dim:], H, cfg.v_head_dim)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(torch.float32),
                     w_vc.to(torch.float32))
    return merge_heads(o).to(o_lat.dtype)


def mla_forward(cfg, p, x, positions, **_):
    """Full-sequence MLA. Returns (out, (c_kv, k_rope)), the compressed
    cache. Its attention takes the plain path, as the reference's, whose
    ``mla_forward`` never passes ``use_pallas``: the effective problem (q
    head dim r + qk_r, v head dim r) is outside the flash kernel's
    ``vd == hd <= 256``."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    k_rope_flat = k_rope.reshape(B, S, -1)
    q_eff, k_eff, v_eff, scale = _mla_eff_qkv(cfg, p, q_nope, q_rope, c_kv,
                                              k_rope_flat)
    o_lat = L.attend(q_eff, k_eff, v_eff, causal=True, scale=scale)
    return row_parallel(_mla_out(cfg, p, o_lat), p["wo"]), \
        (c_kv, k_rope_flat)


def mla_decode(cfg, p, x, cache_ckv, cache_krope, pos: int, positions, **_):
    """One-token MLA decode. cache_ckv: (B, S, kv_lora); cache_krope: (B, S,
    qk_rope), both written at ``pos`` in place. Returns (out, cache_ckv,
    cache_krope)."""
    B = x.shape[0]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    _write(cache_ckv, c_kv, pos)
    _write(cache_krope, k_rope.reshape(B, 1, -1), pos)
    q_eff, k_eff, v_eff, scale = _mla_eff_qkv(cfg, p, q_nope, q_rope,
                                              cache_ckv, cache_krope,
                                              seq_part="model")
    o_lat = L.attention_decode(q_eff, k_eff, v_eff, kv_len=int(pos) + 1,
                               scale=scale)
    return row_parallel(_mla_out(cfg, p, o_lat), p["wo"]), \
        cache_ckv, cache_krope

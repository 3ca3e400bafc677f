"""Encoder-decoder transformer, the seamless-m4t-large-v2 backbone (port of
``repro/models/encdec.py``).

The speech frontend is a stub: the encoder consumes precomputed frame
embeddings (batch, frames, d_model). Frames are seq_len // 4 of the
decoder's length (a conv codec's 4x downsampling); the decoder reads token
ids.

Parameters keep the reference's keys and layout: ``enc_blocks`` ({attn,
ffn}) and ``dec_blocks`` ({attn, ffn, xattn}) hold each leaf stacked over
a leading layer axis, with LayerNorm scales and biases and an untied
``lm_head``; a Python loop over the layers takes the place of
``jax.lax.scan``. The reference's sharding hooks are the identity on one
device and are dropped.

Attention routes as in the reference: the encoder's non-causal and the
decoder's causal self-attention go through ``layers.attend(...,
use_pallas=use_pallas)`` (the flash kernel on the card when
``use_pallas``); cross-attention always takes the plain path (chunked past
2048² query-key pairs); decoding uses ``attention_decode``. The training
objective (:func:`loss_fn`) is ``transformer.chunked_xent`` on the
decoder's hidden states; under autograd ``cfg.remat`` checkpoints one
encoder or decoder layer at a time, as the reference's
``jax.checkpoint(body)``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import chunked_xent, next_token_labels
from repro_torch.sharding.act import (constrain, merge_heads, row_parallel,
                                     split_heads, unshard)
from repro_torch.utils.tree import tree_map, tree_stack


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _norm(cfg, x, scale, bias):
    return L.layernorm(x, scale, bias, cfg.norm_eps)


def _norm_params(cfg, dtype, device) -> dict:
    return {"norm_scale": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "norm_bias": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def _xattn_init(cfg, gen, dtype):
    return {
        "wq": L.dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
        "wk": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wv": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wo": L.dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
        **_norm_params(cfg, dtype, gen.device),
    }


def _enc_layer_init(cfg, gen, dtype):
    attn = {**A.gqa_init(cfg, gen, dtype), **_norm_params(cfg, dtype, gen.device)}
    ffn = {**L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
           **_norm_params(cfg, dtype, gen.device)}
    return {"attn": attn, "ffn": ffn}


def _dec_layer_init(cfg, gen, dtype):
    return {**_enc_layer_init(cfg, gen, dtype),
            "xattn": _xattn_init(cfg, gen, dtype)}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda x: x[i], tree)


def init_params(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from ``gen`` on
    its device."""
    dtype, dev = _dtype(cfg), gen.device
    enc = tree_stack([_enc_layer_init(cfg, gen, dtype)
                      for _ in range(cfg.n_enc_layers)])
    dec = tree_stack([_dec_layer_init(cfg, gen, dtype)
                      for _ in range(cfg.n_layers)])
    enc_norm, final_norm = (_norm_params(cfg, dtype, dev) for _ in range(2))
    return {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "enc_blocks": enc,
        "dec_blocks": dec,
        "enc_norm_scale": enc_norm["norm_scale"],
        "enc_norm_bias": enc_norm["norm_bias"],
        "final_norm_scale": final_norm["norm_scale"],
        "final_norm_bias": final_norm["norm_bias"],
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype,
                                scale=0.02),
    }


def _heads(cfg, t, n_heads: int):
    return split_heads(t, n_heads, cfg.head_dim)


def _proj_heads(cfg, h, w, n_heads: int):
    """``h @ w`` split into heads, constrained to (batch, heads) on a
    mesh."""
    return constrain(_heads(cfg, h @ unshard(w, None, "model"), n_heads),
                     "batch", None, "model", None)


def _self_attn(cfg, p, x, positions, *, causal, use_pallas=False):
    """Pre-norm self-attention sub-layer. Returns (x + attn, (k, v))."""
    h = _norm(cfg, x, p["norm_scale"], p["norm_bias"])
    q = L.apply_rope(_proj_heads(cfg, h, p["wq"], cfg.n_heads), positions,
                     cfg.rope_theta)
    k = L.apply_rope(_proj_heads(cfg, h, p["wk"], cfg.n_kv_heads), positions,
                     cfg.rope_theta)
    v = _proj_heads(cfg, h, p["wv"], cfg.n_kv_heads)
    o = L.attend(q, k, v, causal=causal, use_pallas=use_pallas)
    return x + row_parallel(merge_heads(o), p["wo"]), \
        (k, v)


def _cross_attn(cfg, p, x, enc_k, enc_v):
    """Pre-norm cross-attention sub-layer over the encoder's K/V, on the
    plain attention path (the reference passes no ``use_pallas``)."""
    h = _norm(cfg, x, p["norm_scale"], p["norm_bias"])
    q = _proj_heads(cfg, h, p["wq"], cfg.n_heads)
    o = L.attend(q, enc_k, enc_v, causal=False)
    return x + row_parallel(merge_heads(o), p["wo"])


def _ffn(cfg, p, x):
    h = _norm(cfg, x, p["norm_scale"], p["norm_bias"])
    return x + L.mlp_apply(p, h, activation="gelu")


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _remat(cfg, body, bp, x):
    """``body(bp, x)``, checkpointed when ``cfg.remat`` and autograd is on."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, bp, x, use_reentrant=False)
    return body(bp, x)


def encode(cfg, params, frames, *, use_pallas=False):
    """frames: (B, S_enc, d) stub embeddings -> encoder hidden states."""
    B, S, _ = frames.shape
    x = frames.to(_dtype(cfg))
    positions = _positions(B, S, x.device)

    def body(bp, x):
        x, _ = _self_attn(cfg, bp["attn"], x, positions, causal=False,
                          use_pallas=use_pallas)
        return _ffn(cfg, bp["ffn"], x)

    for i in range(cfg.n_enc_layers):
        x = _remat(cfg, body, _layer(params["enc_blocks"], i), x)
    return _norm(cfg, x, params["enc_norm_scale"], params["enc_norm_bias"])


def _enc_kv(cfg, p, enc_out):
    """A decoder layer's cross-attention K and V of the encoder output."""
    return (_proj_heads(cfg, enc_out, p["wk"], cfg.n_kv_heads),
            _proj_heads(cfg, enc_out, p["wv"], cfg.n_kv_heads))


def forward_hidden(cfg, params, batch, *, use_pallas=False):
    """Decoder trunk up to the final norm. batch: {frames (B, S_enc, d),
    tokens (B, S_dec)}. Returns (x, aux=0.0)."""
    enc_out = encode(cfg, params, batch["frames"], use_pallas=use_pallas)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = constrain(F.embedding(tokens, unshard(params["embed"], None, "model")),
                  "batch", None, None)
    positions = _positions(B, S, x.device)

    def body(bp, x):
        x = constrain(x, "batch", None, None)
        x, _ = _self_attn(cfg, bp["attn"], x, positions, causal=True,
                          use_pallas=use_pallas)
        ek, ev = _enc_kv(cfg, bp["xattn"], enc_out)
        x = _cross_attn(cfg, bp["xattn"], x, ek, ev)
        return constrain(_ffn(cfg, bp["ffn"], x), "batch", None, None)

    for i in range(cfg.n_layers):
        x = _remat(cfg, body, _layer(params["dec_blocks"], i), x)
    return _norm(cfg, x, params["final_norm_scale"],
                 params["final_norm_bias"]), 0.0


def forward(cfg, params, batch, *, use_pallas=False, last_only=False):
    """Scoring / prefill. batch: {frames (B, S_enc, d), tokens (B, S_dec)}.
    Returns (logits (B, S_dec or 1, vocab_padded) fp32, aux=0.0);
    ``last_only`` applies the LM head to the final position only."""
    x, aux = forward_hidden(cfg, params, batch, use_pallas=use_pallas)
    if last_only:
        x = x[:, -1:]
    head = unshard(params["lm_head"], None, "model")
    return (x @ head).to(torch.float32), aux


def init_cache(cfg, batch: int, seq: int, enc_frames: int, dtype=None,
               device=None):
    """Zeros in the reference's structure: ``{"self": {k, v}, "cross": {k,
    v}}``, each leaf (n_layers, batch, seq or enc_frames, Hkv, hd)."""
    dtype = dtype or _dtype(cfg)

    def kv(s):
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"self": kv(seq), "cross": kv(enc_frames)}


def prefill_cross_cache(cfg, params, enc_out):
    """Every decoder layer's cross K/V of the encoder output, computed once:
    ``{"k", "v"}`` each (n_layers, B, S_enc, Hkv, hd)."""
    kv = [_enc_kv(cfg, _layer(params["dec_blocks"], i)["xattn"], enc_out)
          for i in range(cfg.n_layers)]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def decode_step(cfg, params, cache, batch, pos: int):
    """One-token decode. batch: {token (B, 1)}; ``cache`` from
    :func:`init_cache` with the cross K/V filled (:func:`prefill_cross_cache`).
    The new token's self K/V are written at ``pos`` in place and attention
    reads ``pos + 1`` slots; the cross cache is read whole and never
    written. Returns (logits (B, 1, vocab_padded) fp32, cache)."""
    tokens = batch["token"]
    B = tokens.shape[0]
    x = F.embedding(tokens, params["embed"])
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        self_c, cross_c = _layer(cache["self"], i), _layer(cache["cross"], i)
        pa = bp["attn"]
        h = _norm(cfg, x, pa["norm_scale"], pa["norm_bias"])
        q = L.apply_rope(_heads(cfg, h @ pa["wq"], cfg.n_heads), positions,
                         cfg.rope_theta)
        k = L.apply_rope(_heads(cfg, h @ pa["wk"], cfg.n_kv_heads), positions,
                         cfg.rope_theta)
        v = _heads(cfg, h @ pa["wv"], cfg.n_kv_heads)
        A._write(self_c["k"], k, pos)
        A._write(self_c["v"], v, pos)
        o = L.attention_decode(q, self_c["k"], self_c["v"], kv_len=int(pos) + 1)
        x = x + row_parallel(merge_heads(o), pa["wo"])
        px = bp["xattn"]
        hx = _norm(cfg, x, px["norm_scale"], px["norm_bias"])
        qx = _heads(cfg, hx @ px["wq"], cfg.n_heads)
        ox = L.attention_decode(qx, cross_c["k"], cross_c["v"])
        x = x + row_parallel(merge_heads(ox), px["wo"])
        x = _ffn(cfg, bp["ffn"], x)
    x = _norm(cfg, x, params["final_norm_scale"], params["final_norm_bias"])
    return (x @ params["lm_head"]).to(torch.float32), cache


def loss_fn(cfg, params, batch, *, use_pallas=False):
    """Next-token cross-entropy of the decoder (labels: the shifted tokens
    padded with -1) through ``transformer.chunked_xent``."""
    x, _ = forward_hidden(cfg, params, batch, use_pallas=use_pallas)
    labels = next_token_labels(batch["tokens"])
    return chunked_xent(cfg, params, x, labels)

"""Decoder-only LM assembly (port of ``repro/models/transformer.py``), for
the uniform block pattern: every layer an attention mixer and a dense MLP
(h2o-danube and the other dense GQA decoders).

Parameters keep the reference's keys and layout: ``blocks`` holds each leaf
stacked over a leading layer axis, and a Python loop over the layers takes
the place of ``jax.lax.scan``. Caches are ``{"blocks": {"k", "v"}}`` with
the same leading axis; ``decode_step`` writes into them in place.

Not ported yet, and raising where reached: the gemma2 ``pair_lg`` and
jamba ``jamba8`` patterns, deepseek's dense prologue, MLA and MoE (ROADMAP
A11), the mamba mixer (ROADMAP B4), and the training entries ``loss_fn`` /
``chunked_xent`` (the training slice). Batches carry token ids: the
vision/audio stubs' ``embeds`` and M-RoPE's ``positions`` wait for ROADMAP
A11. ``cfg.remat`` has no effect: the
port has no training path yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# block patterns
# ---------------------------------------------------------------------------


def block_layout(cfg):
    """Returns (pattern, n_blocks, prologue_layers). pattern in
    {uniform, pair_lg, jamba8}; prologue covers deepseek's dense layer 0."""
    if cfg.attn_every:  # jamba hybrid
        assert cfg.n_layers % cfg.attn_every == 0
        return "jamba8", cfg.n_layers // cfg.attn_every, 0
    if cfg.attn_pattern == "local_global":
        assert cfg.n_layers % 2 == 0
        return "pair_lg", cfg.n_layers // 2, 0
    if cfg.first_layer_dense and cfg.n_experts:
        return "uniform", cfg.n_layers - 1, 1
    return "uniform", cfg.n_layers, 0


def _layer_kinds(cfg):
    """(mixer_kind, ffn_kind) for the uniform pattern."""
    if cfg.family == "ssm":
        return "mamba", None
    mixer = "mla" if cfg.use_mla else "attn"
    ffn = "moe" if cfg.n_experts else "mlp"
    return mixer, ffn


def _ported_blocks(cfg) -> int:
    """The number of blocks, after checking that the port has every module
    the config needs."""
    pattern, n_blocks, prologue = block_layout(cfg)
    mixer, ffn = _layer_kinds(cfg)
    missing = []
    if cfg.is_encoder_decoder:
        missing.append("encoder-decoder (ROADMAP A11)")
    if pattern == "pair_lg":
        missing.append("the gemma2 pair_lg pattern (ROADMAP A11)")
    if pattern == "jamba8":
        missing.append("the jamba8 hybrid pattern (ROADMAP A11, after B4)")
    if prologue:
        missing.append("the dense prologue layer (ROADMAP A11)")
    if mixer == "mamba":
        missing.append("the mamba mixer (ROADMAP B4)")
    if mixer == "mla":
        missing.append("MLA (ROADMAP A11)")
    if ffn == "moe":
        missing.append("MoE (ROADMAP A11)")
    if missing:
        raise NotImplementedError(f"{cfg.name} needs what the port does not "
                                  f"have yet: {', '.join(missing)}")
    return n_blocks


# ---------------------------------------------------------------------------
# sub-layers (norm + mixer/ffn + residual)
# ---------------------------------------------------------------------------


def _norms(cfg, dtype, device):
    p = {"norm_scale": L.norm_params(cfg, cfg.d_model, dtype, device)["scale"]}
    if cfg.norm_type == "layernorm":
        p["norm_bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if cfg.post_attn_norm:
        p["post_norm_scale"] = L.norm_params(cfg, cfg.d_model, dtype,
                                             device)["scale"]
    return p


def _pre_norm(cfg, p, x):
    if cfg.norm_type == "layernorm":
        return L.layernorm(x, p["norm_scale"], p.get("norm_bias"), cfg.norm_eps)
    return L.rmsnorm(x, p["norm_scale"], cfg.norm_eps)


def _post_norm(cfg, p, y):
    if cfg.post_attn_norm:
        return L.rmsnorm(y, p["post_norm_scale"], cfg.norm_eps)
    return y


def _apply_mixer(cfg, p, x, positions, *, use_pallas=False):
    """Full-sequence attention sub-layer. Returns (residual_out, (k, v))."""
    y, cache = A.gqa_forward(cfg, p, _pre_norm(cfg, p, x), positions,
                             use_pallas=use_pallas)
    return x + _post_norm(cfg, p, y), cache


def _apply_ffn(cfg, p, x):
    y = L.mlp_apply(p, _pre_norm(cfg, p, x))
    return x + _post_norm(cfg, p, y)


def _stack(trees):
    """Stack a list of equal-structured dicts of tensors leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, seq: int, dtype=None, device=None):
    """Stacked-block KV cache (leading axis = n_blocks), zeros."""
    n_blocks = _ported_blocks(cfg)
    shape = (n_blocks, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or _dtype(cfg)
    return {"blocks": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_params(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from ``gen`` on
    its device (a CUDA generator draws a full-width model on the card)."""
    dtype, dev = _dtype(cfg), gen.device
    n_blocks = _ported_blocks(cfg)
    blocks = [{"mixer": {**A.gqa_init(cfg, gen, dtype), **_norms(cfg, dtype, dev)},
               "ffn": {**L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
                       **_norms(cfg, dtype, dev)}}
              for _ in range(n_blocks)]
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "blocks": _stack(blocks),
        "final_norm_scale": L.norm_params(cfg, cfg.d_model, dtype, dev)["scale"],
    }
    del blocks
    if cfg.norm_type == "layernorm":
        params["final_norm_bias"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                                device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_padded,
                                         dtype, scale=0.02)
    return params


def _final_norm(cfg, params, x):
    if cfg.norm_type == "layernorm":
        return L.layernorm(x, params["final_norm_scale"],
                           params.get("final_norm_bias"), cfg.norm_eps)
    return L.rmsnorm(x, params["final_norm_scale"], cfg.norm_eps)


def _logits(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap((x @ head).to(torch.float32), cfg.final_logit_softcap)


def _embed(cfg, params, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _trunk(cfg, params, batch, *, use_pallas: bool, keep_cache: bool):
    """Embedding, every block, final norm. Returns (x, [(k, v) per layer])."""
    n_blocks = _ported_blocks(cfg)
    x = _embed(cfg, params, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    caches = []
    for i in range(n_blocks):
        bp = _layer(params["blocks"], i)
        x, kv = _apply_mixer(cfg, bp["mixer"], x, positions,
                             use_pallas=use_pallas)
        x = _apply_ffn(cfg, bp["ffn"], x)
        if keep_cache:
            caches.append(kv)
    return _final_norm(cfg, params, x), caches


def forward(cfg, params, batch, *, return_cache: bool = False,
            use_pallas: bool = False, last_only: bool = False):
    """Full-sequence forward. batch: {tokens (B, S)}.
    Returns (logits, aux_loss[, cache]). ``last_only`` applies the LM head to
    the final position only (serving-prefill semantics — avoids materializing
    (B, S, V) logits). The cache is ``{"blocks": (k, v)}``, each (n_blocks,
    B, S, Hkv, hd), as the reference's scan stacks the ``(k, v)`` tuples."""
    x, caches = _trunk(cfg, params, batch, use_pallas=use_pallas,
                       keep_cache=return_cache)
    if last_only:
        x = x[:, -1:]
    logits = _logits(cfg, params, x)
    if return_cache:
        ks, vs = zip(*caches)
        return logits, 0.0, {"blocks": (torch.stack(ks), torch.stack(vs))}
    return logits, 0.0


def decode_step(cfg, params, cache, batch, pos: int):
    """One-token decode. batch: {token (B, 1)}.
    ``pos``: index the new token is written at. Returns (logits (B,1,V),
    cache), the cache updated in place."""
    n_blocks = _ported_blocks(cfg)
    x = _embed(cfg, params, batch["token"])
    positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                           device=x.device)
    kc, vc = cache["blocks"]["k"], cache["blocks"]["v"]
    for i in range(n_blocks):
        bp = _layer(params["blocks"], i)
        p = bp["mixer"]
        y, _, _ = A.gqa_decode(cfg, p, _pre_norm(cfg, p, x), kc[i], vc[i],
                               pos, positions)
        x = x + _post_norm(cfg, p, y)
        x = _apply_ffn(cfg, bp["ffn"], x)
    x = _final_norm(cfg, params, x)
    return _logits(cfg, params, x), cache


def forward_hidden(cfg, params, batch, *, use_pallas: bool = False):
    """Trunk forward up to the final norm (no LM head). Returns (x, aux)."""
    x, _ = _trunk(cfg, params, batch, use_pallas=use_pallas, keep_cache=False)
    return x, 0.0

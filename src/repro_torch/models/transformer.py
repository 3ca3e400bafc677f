"""Decoder-only LM assembly (port of ``repro/models/transformer.py``) for
every decoder-only architecture of the reference.

Layers are grouped into the reference's smallest repeating *block pattern*:

  uniform      — every layer identical (mixtral, qwen1.5, h2o-danube,
                 command-r-plus, mamba2, deepseek-v2's layers 1..L-1)
  pair_lg      — gemma2: (local, global) attention pairs
  jamba8       — jamba: a period of ``attn_every`` layers, ``attn_every - 1``
                 mamba mixers and one attention mixer, with dense and MoE
                 FFNs alternating

plus deepseek-v2's dense prologue (layer 0: MLA and a dense MLP).

Parameters keep the reference's keys and layout: ``blocks`` holds each leaf
stacked over a leading block axis (jamba's mamba mixers and FFNs a second
axis inside the block), and a Python loop over the blocks takes the place
of ``jax.lax.scan``. Caches have the reference's structure with the same
leading axis; ``decode_step`` writes into them in place.

A batch carries token ids (``tokens``, a decode step's ``token``) or, for
the vision stub (qwen2-vl), merged text and patch embeddings (``embeds``,
a decode step's ``embed``) with M-RoPE's (B, S, 3) ``positions``
(:func:`_embed_inputs`). The encoder-decoder (seamless) is
``models/encdec.py``.

Training: :func:`loss_fn` is the next-token cross-entropy through
:func:`chunked_xent`, which never forms (B, S, V) logits. Under autograd,
``cfg.remat`` checkpoints one block at a time, as the reference's
``jax.checkpoint(body)``: the backward recomputes a block's activations
from its input.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.sharding.act import constrain, unshard


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


def _prologue_kind(cfg) -> str:
    return "mla" if cfg.use_mla else "attn"


def _jamba_ffn_is_moe(cfg, i: int) -> bool:
    return i % cfg.moe_every == cfg.moe_offset


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


def _mixer_init(cfg, gen, dtype, kind: str):
    init = {"mamba": M.mamba_init, "mla": A.mla_init}.get(kind, A.gqa_init)
    return {**init(cfg, gen, dtype), **_norms(cfg, dtype, gen.device)}


def _ffn_init(cfg, gen, dtype, kind: str):
    if kind == "moe":
        p = moe_init(cfg, gen, dtype)
    else:
        p = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return {**p, **_norms(cfg, dtype, gen.device)}


def _pre_norm(cfg, p, x):
    return L.apply_norm(cfg, x, p, "norm")


def _post_norm(cfg, p, y):
    if cfg.post_attn_norm:
        return L.rmsnorm(y, p["post_norm_scale"], cfg.norm_eps,
                         gemma_style=L.is_gemma(cfg))
    return y


def _apply_mixer(cfg, p, x, positions, kind, *, is_global=True,
                 use_pallas=False):
    """Full-sequence mixer sub-layer. Returns (residual_out, cache entry):
    ``(k, v)`` for attention, ``(c_kv, k_rope)`` for MLA, None for mamba
    (as in the reference)."""
    h = _pre_norm(cfg, p, x)
    if kind == "mamba":
        y, cache = M.mamba_forward(cfg, p, h, use_pallas=use_pallas), None
    elif kind == "mla":
        y, cache = A.mla_forward(cfg, p, h, positions)
    else:
        y, cache = A.gqa_forward(cfg, p, h, positions, is_global=is_global,
                                 use_pallas=use_pallas)
    return x + _post_norm(cfg, p, y), cache


def _apply_mixer_decode(cfg, p, x, cache, pos, positions, kind, *,
                        is_global=True):
    """One-token mixer sub-layer. ``cache`` is this layer's slice of the
    stacked cache, written in place."""
    h = _pre_norm(cfg, p, x)
    if kind == "mamba":
        y, new = M.mamba_decode(cfg, p, h, cache)
        cache["conv"].copy_(new["conv"])
        cache["ssm"].copy_(new["ssm"])
    elif kind == "mla":
        y, _, _ = A.mla_decode(cfg, p, h, cache["ckv"], cache["krope"], pos,
                               positions)
    else:
        y, _, _ = A.gqa_decode(cfg, p, h, cache["k"], cache["v"], pos,
                               positions, is_global=is_global)
    return x + _post_norm(cfg, p, y)


def _apply_ffn(cfg, p, x, kind):
    """FFN sub-layer. Returns (residual_out, aux_loss)."""
    h = _pre_norm(cfg, p, x)
    if kind == "moe":
        y, aux = moe_apply(cfg, p, h)
    else:
        act = "gelu" if L.is_gemma(cfg) else "silu"
        y, aux = L.mlp_apply(p, h, activation=act), 0.0
    return x + _post_norm(cfg, p, y), aux


def _stack(trees):
    """Stack a list of equal-structured nests (dicts, tuples, None) of
    tensors leaf by leaf."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(leaves)) for leaves in zip(*trees))
    return torch.stack(trees)


def _layer(tree, i: int):
    """Entry ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _block_init(cfg, gen, dtype, pattern):
    if pattern == "uniform":
        mixer, ffn = _layer_kinds(cfg)
        p = {"mixer": _mixer_init(cfg, gen, dtype, mixer)}
        if ffn:
            p["ffn"] = _ffn_init(cfg, gen, dtype, ffn)
        return p
    if pattern == "pair_lg":
        return {"local_mixer": _mixer_init(cfg, gen, dtype, "attn"),
                "local_ffn": _ffn_init(cfg, gen, dtype, "mlp"),
                "global_mixer": _mixer_init(cfg, gen, dtype, "attn"),
                "global_ffn": _ffn_init(cfg, gen, dtype, "mlp")}
    # jamba8
    period = cfg.attn_every
    mamba = [_mixer_init(cfg, gen, dtype, "mamba") for _ in range(period - 1)]
    attn = _mixer_init(cfg, gen, dtype, "attn")
    ffns = {"mlp": [], "moe": []}
    for i in range(period):
        kind = "moe" if _jamba_ffn_is_moe(cfg, i) else "mlp"
        ffns[kind].append(_ffn_init(cfg, gen, dtype, kind))
    return {"mamba": _stack(mamba), "attn": attn,
            "ffn_mlp": _stack(ffns["mlp"]), "ffn_moe": _stack(ffns["moe"])}


def _block_apply(cfg, bp, x, positions, pattern, *, use_pallas=False):
    """One block, full-sequence. Returns (x, cache_entry, aux_loss)."""
    if pattern == "uniform":
        mixer, ffn = _layer_kinds(cfg)
        x, cache = _apply_mixer(cfg, bp["mixer"], x, positions, mixer,
                                use_pallas=use_pallas)
        aux = 0.0
        if ffn:
            x, aux = _apply_ffn(cfg, bp["ffn"], x, ffn)
        return x, cache, aux
    if pattern == "pair_lg":
        x, c_l = _apply_mixer(cfg, bp["local_mixer"], x, positions, "attn",
                              is_global=False, use_pallas=use_pallas)
        x, _ = _apply_ffn(cfg, bp["local_ffn"], x, "mlp")
        x, c_g = _apply_mixer(cfg, bp["global_mixer"], x, positions, "attn",
                              is_global=True, use_pallas=use_pallas)
        x, _ = _apply_ffn(cfg, bp["global_ffn"], x, "mlp")
        return x, {"local": c_l, "global": c_g}, 0.0
    # jamba8: the attention layer's (k, v) is the block's cache entry
    aux, cache, mix_i, n = 0.0, None, 0, {"mlp": 0, "moe": 0}
    for i in range(cfg.attn_every):
        if i == cfg.attn_offset:
            x, cache = _apply_mixer(cfg, bp["attn"], x, positions, "attn",
                                    use_pallas=use_pallas)
        else:
            x, _ = _apply_mixer(cfg, _layer(bp["mamba"], mix_i), x, positions,
                                "mamba", use_pallas=use_pallas)
            mix_i += 1
        kind = "moe" if _jamba_ffn_is_moe(cfg, i) else "mlp"
        x, a = _apply_ffn(cfg, _layer(bp[f"ffn_{kind}"], n[kind]), x, kind)
        aux = aux + a
        n[kind] += 1
    return x, cache, aux


def _block_decode(cfg, bp, x, bcache, pos, positions, pattern):
    """One block, one-token decode; ``bcache`` is written in place."""
    if pattern == "uniform":
        mixer, ffn = _layer_kinds(cfg)
        x = _apply_mixer_decode(cfg, bp["mixer"], x, bcache, pos, positions,
                                mixer)
        if ffn:
            x, _ = _apply_ffn(cfg, bp["ffn"], x, ffn)
        return x
    if pattern == "pair_lg":
        x = _apply_mixer_decode(cfg, bp["local_mixer"], x, bcache["local"],
                                pos, positions, "attn", is_global=False)
        x, _ = _apply_ffn(cfg, bp["local_ffn"], x, "mlp")
        x = _apply_mixer_decode(cfg, bp["global_mixer"], x, bcache["global"],
                                pos, positions, "attn", is_global=True)
        x, _ = _apply_ffn(cfg, bp["global_ffn"], x, "mlp")
        return x
    mix_i, n = 0, {"mlp": 0, "moe": 0}
    for i in range(cfg.attn_every):
        if i == cfg.attn_offset:
            x = _apply_mixer_decode(cfg, bp["attn"], x, bcache["attn"], pos,
                                    positions, "attn")
        else:
            x = _apply_mixer_decode(cfg, _layer(bp["mamba"], mix_i), x,
                                    _layer(bcache["mamba"], mix_i), pos,
                                    positions, "mamba")
            mix_i += 1
        kind = "moe" if _jamba_ffn_is_moe(cfg, i) else "mlp"
        x, _ = _apply_ffn(cfg, _layer(bp[f"ffn_{kind}"], n[kind]), x, kind)
        n[kind] += 1
    return x


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def _mixer_cache_init(cfg, kind, batch, seq, dtype, device):
    if kind == "mamba":
        return M.mamba_state_init(cfg, batch, dtype, device)
    if kind == "mla":
        return {"ckv": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((batch, seq, cfg.qk_rope_head_dim),
                                     dtype=dtype, device=device)}
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _zeros_like_stacked(tree, n: int):
    """A nest of zero tensors with a leading axis of ``n`` before each
    leaf's shape, each in its leaf's dtype."""
    if isinstance(tree, dict):
        return {k: _zeros_like_stacked(v, n) for k, v in tree.items()}
    return torch.zeros((n, *tree.shape), dtype=tree.dtype, device=tree.device)


def init_cache(cfg, batch: int, seq: int, dtype=None, device=None):
    """Stacked-block KV / state cache (leading axis = n_blocks), zeros, in
    the reference's structure: ``{"blocks": ...}`` with ``{"k", "v"}``,
    MLA's ``{"ckv", "krope"}``, mamba's ``{"conv", "ssm"}``, gemma2's
    ``{"local", "global"}`` or jamba's ``{"mamba" (each leaf (n_blocks,
    attn_every - 1, ...)), "attn"}``, plus ``"prologue"`` for deepseek's
    dense layer 0. A mamba state's ``ssm`` leaf is fp32 whatever ``dtype``
    is."""
    pattern, n_blocks, prologue = block_layout(cfg)
    dtype = dtype or _dtype(cfg)

    def mixer(kind):
        return _mixer_cache_init(cfg, kind, batch, seq, dtype, device)

    if pattern == "uniform":
        one = mixer(_layer_kinds(cfg)[0])
    elif pattern == "pair_lg":
        one = {"local": mixer("attn"), "global": mixer("attn")}
    else:
        one = {"mamba": _zeros_like_stacked(mixer("mamba"),
                                            cfg.attn_every - 1),
               "attn": mixer("attn")}
    out = {"blocks": _zeros_like_stacked(one, n_blocks)}
    if prologue:
        out["prologue"] = mixer(_prologue_kind(cfg))
    return out


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_params(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from ``gen`` on
    its device (a CUDA generator draws a full-width model on the card)."""
    dtype, dev = _dtype(cfg), gen.device
    pattern, n_blocks, prologue = block_layout(cfg)
    blocks = [_block_init(cfg, gen, dtype, pattern) for _ in range(n_blocks)]
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
    if prologue:  # deepseek's dense layer 0
        params["prologue"] = {
            "mixer": _mixer_init(cfg, gen, dtype, _prologue_kind(cfg)),
            "ffn": _ffn_init(cfg, gen, dtype, "mlp")}
    return params


def _final_norm(cfg, params, x):
    return L.apply_norm(cfg, x, params, "final_norm")


def _logits(cfg, params, x):
    logits = (x @ _lm_head(cfg, params)).to(torch.float32)
    logits = constrain(logits, "batch", None, "model")
    return L.softcap(logits, cfg.final_logit_softcap)


def _embed(cfg, table, batch, ids: str, embeds: str):
    """The batch's ``embeds`` entry (the vlm / audio stub frontends) cast to
    the param dtype, else the rows of the embedding ``table`` at its
    ``ids`` entry; scaled by sqrt(d_model) where the config says so."""
    if embeds in batch:
        x = batch[embeds].to(_dtype(cfg))
    else:
        # a gather of rows (DTensor shards its backward, where the card's
        # refuses the index_put of a tensor index's)
        x = F.embedding(batch[ids], table)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _embed_inputs(cfg, params, batch):
    """(x (B, S, d), positions): ``batch["positions"]`` where given ((B, S,
    3) for M-RoPE), else ``arange(S)`` for every row."""
    x = _embed(cfg, unshard(params["embed"], None, "model"), batch, "tokens",
               "embeds")
    B, S = x.shape[:2]
    if "positions" in batch:
        return x, batch["positions"]
    return x, torch.arange(S, device=x.device)[None, :].expand(B, S)


def _block_body(cfg, bp, x, positions, *, pattern, use_pallas):
    """One block with its input and output pinned to the batch sharding
    (the reference's scan body)."""
    x = constrain(x, "batch", None, None)
    x, cache, a = _block_apply(cfg, bp, x, positions, pattern,
                               use_pallas=use_pallas)
    return constrain(x, "batch", None, None), cache, a


def _trunk(cfg, params, batch, *, use_pallas: bool, keep_cache: bool):
    """Embedding, the prologue, every block, final norm. Returns (x, aux,
    [cache entry per block], prologue cache entry)."""
    pattern, n_blocks, prologue = block_layout(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    pro_cache = None
    if prologue:
        pp = params["prologue"]
        x, pro_cache = _apply_mixer(cfg, pp["mixer"], x, positions,
                                    _prologue_kind(cfg), use_pallas=use_pallas)
        x, _ = _apply_ffn(cfg, pp["ffn"], x, "mlp")
    x = constrain(x, "batch", None, None)
    aux, caches = 0.0, []
    remat = cfg.remat and torch.is_grad_enabled()
    body = functools.partial(_block_body, cfg, pattern=pattern,
                             use_pallas=use_pallas)
    for i in range(n_blocks):
        bp = _layer(params["blocks"], i)
        if remat:
            x, cache, a = checkpoint(body, bp, x, positions,
                                     use_reentrant=False)
        else:
            x, cache, a = body(bp, x, positions)
        aux = aux + a
        if keep_cache:
            caches.append(cache)
    return _final_norm(cfg, params, x), aux, caches, pro_cache


def forward(cfg, params, batch, *, return_cache: bool = False,
            use_pallas: bool = False, last_only: bool = False):
    """Full-sequence forward. batch: {tokens (B, S) | embeds (B, S, d)
    [, positions (B, S) or, for M-RoPE, (B, S, 3)]}.
    Returns (logits, aux_loss[, cache]): aux is the MoE layers' summed
    load-balance loss (0.0 without MoE). ``last_only`` applies the LM head
    to the final position only (serving-prefill semantics — avoids
    materializing (B, S, V) logits). The cache is the reference's: each
    block's entry stacked over the blocks, ``{"blocks": (k, v)}`` each
    (n_blocks, B, S, Hkv, hd), MLA's ``(c_kv, k_rope)``, gemma2's
    ``{"local": (k, v), "global": (k, v)}``, jamba's attention ``(k, v)``,
    None for mamba2 (whose forward keeps no state); and deepseek's
    ``"prologue"`` entry, unstacked."""
    x, aux, caches, pro_cache = _trunk(cfg, params, batch,
                                       use_pallas=use_pallas,
                                       keep_cache=return_cache)
    if last_only:
        x = x[:, -1:]
    logits = _logits(cfg, params, x)
    if not return_cache:
        return logits, aux
    cache = {"blocks": _stack(caches)}
    del caches
    if pro_cache is not None:
        cache["prologue"] = pro_cache
    return logits, aux, cache


def decode_step(cfg, params, cache, batch, pos: int):
    """One-token decode. batch: {token (B, 1) | embed (B, 1, d)
    [, positions (B, 1) or, for M-RoPE, (B, 1, 3)]}.
    ``pos``: index the new token is written at. Returns (logits (B,1,V),
    cache), the cache updated in place."""
    pattern, n_blocks, prologue = block_layout(cfg)
    # on a mesh the decode layout keeps the table vocab-split: the lookup's
    # masked partial sums are reduced once, here
    x = constrain(_embed(cfg, params["embed"], batch, "token", "embed"),
                  "batch", None, None)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                               device=x.device)
    if prologue:
        pp = params["prologue"]
        x = _apply_mixer_decode(cfg, pp["mixer"], x, cache["prologue"], pos,
                                positions, _prologue_kind(cfg))
        x, _ = _apply_ffn(cfg, pp["ffn"], x, "mlp")
    for i in range(n_blocks):
        x = _block_decode(cfg, _layer(params["blocks"], i), x,
                          _layer(cache["blocks"], i), pos, positions, pattern)
    x = _final_norm(cfg, params, x)
    return _logits(cfg, params, x), cache


def forward_hidden(cfg, params, batch, *, use_pallas: bool = False):
    """Trunk forward up to the final norm (no LM head). Returns (x, aux)."""
    x, aux, _, _ = _trunk(cfg, params, batch, use_pallas=use_pallas,
                          keep_cache=False)
    return x, aux


def _lm_head(cfg, params):
    """The LM head with its vocab dim over "model" and d_model gathered."""
    if cfg.tie_embeddings:
        return unshard(params["embed"], "model", None).T
    return unshard(params["lm_head"], None, "model")


def _xent_chunk(cfg, head, xc, lc):
    """One chunk's (sum of the masked NLL, count of labels in range)."""
    logits = L.softcap((xc @ head).to(torch.float32), cfg.final_logit_softcap)
    logits = constrain(logits, "batch", None, "model")
    logp = torch.log_softmax(logits, dim=-1)
    safe = torch.clamp(lc, 0, cfg.vocab_padded - 1).to(torch.int64)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    mask = (lc >= 0) & (lc < cfg.vocab_size)
    return torch.sum(nll * mask), torch.sum(mask.to(torch.float32))


def pad_seq(t, n: int, value):
    """``t`` with ``n`` <= ``t.shape[1]`` entries of ``value`` appended
    along dim 1, as a concatenation (a split DTensor takes it; the card's
    DTensor refuses ``F.pad`` there)."""
    return torch.cat([t, torch.full_like(t[:, :n], value)], dim=1)


def next_token_labels(tokens):
    """The shifted tokens, -1 (no label) at the last position."""
    return pad_seq(tokens[:, 1:], 1, -1)


def chunked_xent(cfg, params, x, labels, *, chunk: int = 512):
    """Cross-entropy over the vocab WITHOUT materializing (B, S, V) logits:
    a loop over sequence chunks (the last padded with label -1). Under
    autograd each chunk is checkpointed, so the backward recomputes its
    logits, as the reference's ``jax.checkpoint``. Labels outside ``[0,
    vocab_size)`` are masked; the mean is over the labels that count."""
    head = _lm_head(cfg, params)
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x, labels = pad_seq(x, pad, 0), pad_seq(labels, pad, -1)
    body = functools.partial(_xent_chunk, cfg)
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S + pad, chunk):
        xc, lc = x[:, c:c + chunk], labels[:, c:c + chunk]
        if grad:
            t, n = checkpoint(body, head, xc, lc, use_reentrant=False)
        else:
            t, n = body(head, xc, lc)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg, params, batch, *, use_pallas: bool = False):
    """Next-token cross-entropy (+ MoE aux). Labels default to the shifted
    tokens padded with -1; the vision stub's batch carries ``labels``.
    Uses the chunked vocab head — no (B, S, V) logits tensor."""
    x, aux = forward_hidden(cfg, params, batch, use_pallas=use_pallas)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = next_token_labels(batch["tokens"])
    loss = chunked_xent(cfg, params, x, labels)
    return loss + 0.01 * aux / max(cfg.n_layers, 1)

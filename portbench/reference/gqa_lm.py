"""The plain reference of a decoder-only GQA transformer in fp32 (Llama /
Mistral form, as h2o-danube-1.8b [arXiv:2401.16818]): token embedding; per
layer RMSNorm, grouped-query attention with rotary positions (rotate-half
form, theta ``rope_theta``) under a causal sliding window (key j is seen
from query i when i - window < j <= i), RMSNorm and a SwiGLU MLP, each with
a residual; a final RMSNorm and an untied LM head.

Weights are read from the benchmark's draw in the program's layout
(:func:`param_spec`). Attention runs one block of queries at a time, so the
(S, S) scores are never held whole. :func:`work` counts a request's FLOPs
and the attention's bytes.
"""
from __future__ import annotations

import math

import torch

from portbench.counts import BF16, band_pairs
from portbench.reference.common import F32, linear, require, rmsnorm

Q_BLOCK = 512
SIZES = frozenset({"n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                   "d_ff", "vocab_size", "vocab_padded", "attn_pattern",
                   "sliding_window", "rope_theta", "norm_eps",
                   "tie_embeddings", "param_dtype"})


def known(s: dict) -> None:
    """Raise unless ``s`` is a shape this reference and :func:`work` know."""
    require(s, __name__, SIZES, {"attn_pattern": ("swa", "full"),
                                 "tie_embeddings": (False,)})


def window(s: dict) -> int:
    """The causal window's length, 0 for none."""
    return s["sliding_window"] if s["attn_pattern"] == "swa" else 0


def work(s: dict, batch: int, seq: int, head_positions: int) -> dict:
    """One request's work by part, ``{part: {"flops": n[, "bytes": n]}}``:
    ``dense``, 2 x the trunk's matrix parameters (q, k, v, o and the three
    SwiGLU matrices) x tokens; ``head``, the LM head at ``head_positions``
    a sequence; ``attention``, 4 x head_dim x query heads x the (query,
    key) pairs the causal window allows, with q, k, v read once and o
    written once in bf16."""
    known(s)
    L, d, hd, Hq, Hkv = s["n_layers"], s["d_model"], s["head_dim"], \
        s["n_heads"], s["n_kv_heads"]
    matrices = L * (2 * d * Hq * hd + 2 * d * Hkv * hd + 3 * d * s["d_ff"])
    tokens = batch * seq
    return {"dense": {"flops": 2 * matrices * tokens},
            "head": {"flops": 2 * d * s["vocab_size"] * batch
                     * head_positions},
            "attention": {"flops": L * 4 * hd * Hq * batch
                          * band_pairs(seq, window(s)),
                          "bytes": L * tokens * hd * (2 * Hq + 2 * Hkv)
                          * BF16}}


def param_spec(s: dict) -> list:
    """``(path, shape, dtype, init)`` for every leaf of the program's
    parameters. ``init`` is ``("normal", std)`` or ``("one_plus", std)``
    (1 + N(0, std^2))."""
    d, L, V = s["d_model"], s["n_layers"], s["vocab_padded"]
    q, kv, ff = s["n_heads"] * s["head_dim"], s["n_kv_heads"] * s["head_dim"], \
        s["d_ff"]
    dt = s["param_dtype"]
    out = [(("embed",), (V, d), dt, ("normal", 0.02))]
    for name, (a, b) in (("wq", (d, q)), ("wk", (d, kv)), ("wv", (d, kv)),
                         ("wo", (q, d))):
        out.append((("blocks", "mixer", name), (L, a, b), dt,
                    ("normal", 1 / math.sqrt(a))))
    out.append((("blocks", "mixer", "norm_scale"), (L, d), dt,
                ("one_plus", 0.1)))
    for name, (a, b) in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                         ("w_down", (ff, d))):
        out.append((("blocks", "ffn", name), (L, a, b), dt,
                    ("normal", 1 / math.sqrt(a))))
    out.append((("blocks", "ffn", "norm_scale"), (L, d), dt, ("one_plus", 0.1)))
    out.append((("final_norm_scale",), (d,), dt, ("one_plus", 0.1)))
    out.append((("lm_head",), (d, V), dt, ("normal", 0.02)))
    return out


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x (B, S, H, hd), rotate-half form."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32, device=x.device)
                          / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int) -> torch.Tensor:
    """Causal sliding-window GQA in fp32. q (B, S, Hq, hd); k, v (B, S,
    Hkv, hd); query head h reads key head h // (Hq // Hkv)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    kh = k.permute(0, 2, 1, 3)  # (B, Hkv, S, hd)
    vh = v.permute(0, 2, 1, 3)
    pos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    for lo in range(0, S, Q_BLOCK):
        hi = min(lo + Q_BLOCK, S)
        kl = max(0, lo - window + 1) if window > 0 else 0
        qb = q[:, lo:hi].reshape(B, hi - lo, Hkv, G, hd).permute(0, 2, 3, 1, 4)
        s = torch.einsum("bkgqd,bksd->bkgqs", qb, kh[:, :, kl:hi]) / \
            math.sqrt(hd)
        qp, kp = pos[lo:hi, None], pos[None, kl:hi]
        ok = kp <= qp
        if window > 0:
            ok &= kp > qp - window
        s = s.masked_fill(~ok, float("-inf")).softmax(-1)
        o = torch.einsum("bkgqs,bksd->bkgqd", s, vh[:, :, kl:hi])
        out[:, lo:hi] = o.permute(0, 3, 1, 2, 4).reshape(B, hi - lo, Hq, hd)
    return out


def forward(s: dict, params: dict, tokens: torch.Tensor, *, quant=None,
            on_kv=None, positions: str = "last"):
    """Logits (B, vocab_size) at the last position (``positions="last"``)
    or (B, S, vocab_size) at every one. ``on_kv(layer, k, v)`` receives each
    layer's keys (after RoPE) and values, (B, S, Hkv, hd) fp32."""
    B, S = tokens.shape
    H, Hkv, hd = s["n_heads"], s["n_kv_heads"], s["head_dim"]
    eps, win = s["norm_eps"], window(s)
    blocks = params["blocks"]
    x = params["embed"][tokens].to(F32)
    for i in range(s["n_layers"]):
        m, f = ({k: t[i] for k, t in blocks[part].items()}
                for part in ("mixer", "ffn"))
        h = rmsnorm(x, m["norm_scale"], eps)
        q = rope(linear(h, m["wq"], quant).view(B, S, H, hd), s["rope_theta"])
        k = rope(linear(h, m["wk"], quant).view(B, S, Hkv, hd),
                 s["rope_theta"])
        v = linear(h, m["wv"], quant).view(B, S, Hkv, hd)
        del h
        if on_kv is not None:
            on_kv(i, k, v)
        o = attention(q, k, v, win).reshape(B, S, H * hd)
        del q, k, v
        x = x + linear(o, m["wo"], quant)
        del o
        h = rmsnorm(x, f["norm_scale"], eps)
        g = linear(h, f["w_gate"], quant)
        g = torch.nn.functional.silu(g) * linear(h, f["w_up"], quant)
        del h
        x = x + linear(g, f["w_down"], quant)
        del g
    if positions == "last":
        x = x[:, -1]
    x = rmsnorm(x, params["final_norm_scale"], eps)
    return linear(x, params["lm_head"][:, :s["vocab_size"]], quant)

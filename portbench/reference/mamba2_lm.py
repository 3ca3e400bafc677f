"""The plain reference of a Mamba-2 language model in fp32 [arXiv:2405.21060]:
token embedding; per layer RMSNorm and the Mamba-2 mixer, with a residual;
a final RMSNorm and the LM head.

The mixer: ``in_proj`` gives [z | x | B | C | dt]; a causal depthwise conv
of width ``ssm_conv`` (with bias) over [x | B | C] and SiLU; the SSD scan of
``ssm_heads`` heads of ``ssm_head_dim`` with state ``ssm_state``, one B/C
group shared by all heads, dt = softplus(dt + dt_bias), A = -exp(A_log),
plus the D skip; y * SiLU(z) through an RMSNorm (the gated norm, gate before
the norm); ``out_proj``.

The scan is the SSD's chunked form (the paper's ``ssd_minimal``): within a
chunk the quadratic form under the decay mask exp(segsum), across chunks the
state carried by its decay. It is exact algebra of the recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t; the segment sums
are taken in float64, then rounded to fp32 once. :func:`work` counts a
request's FLOPs and the SSD's bytes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.counts import BF16, F32_BYTES
from portbench.reference.common import F32, linear, require, rmsnorm

LOGIT_ROWS = 1024  # positions of the LM head computed at once
SIZES = frozenset({"n_layers", "d_model", "ssm_state", "ssm_head_dim",
                   "ssm_expand", "ssm_conv", "ssm_chunk", "d_inner",
                   "ssm_heads", "vocab_size", "vocab_padded", "norm_eps",
                   "tie_embeddings", "param_dtype"})


def known(s: dict) -> None:
    """Raise unless ``s`` is a shape this reference and :func:`work` know."""
    require(s, __name__, SIZES, {"tie_embeddings": (False,)})


def work(s: dict, batch: int, seq: int, head_positions: int) -> dict:
    """One request's work by part, ``{part: {"flops": n[, "bytes": n]}}``:
    ``dense``, 2 x the trunk's matrix parameters (in- and out-projection) x
    tokens; ``head``, the LM head at ``head_positions`` a sequence; ``ssd``,
    (2 Q P + 4 N P) H + 2 Q N a token a layer, with x, B and C read once in
    bf16, dt read once and y written once in fp32 (the scan's interface)."""
    known(s)
    L, d, dI = s["n_layers"], s["d_model"], s["d_inner"]
    Q, P, N, H = s["ssm_chunk"], s["ssm_head_dim"], s["ssm_state"], \
        s["ssm_heads"]
    matrices = L * (d * (2 * dI + 2 * N + H) + dI * d)
    tokens = batch * seq
    return {"dense": {"flops": 2 * matrices * tokens},
            "head": {"flops": 2 * d * s["vocab_size"] * batch
                     * head_positions},
            "ssd": {"flops": L * tokens * ((2 * Q * P + 4 * N * P) * H
                                           + 2 * Q * N),
                    "bytes": L * tokens * ((H * P + 2 * N) * BF16
                                           + H * F32_BYTES
                                           + H * P * F32_BYTES)}}


def param_spec(s: dict) -> list:
    """``(path, shape, dtype, init)`` for every leaf of the program's
    parameters. ``init``: ``("normal", std)``, ``("one_plus", std)``,
    ``("const", value)``, ``("A_log", lo, hi)`` (log of U(lo, hi)) or
    ``("dt_bias", lo, hi)`` (softplus^-1 of a dt log-uniform in [lo, hi])."""
    d, L, V = s["d_model"], s["n_layers"], s["vocab_padded"]
    dI, N, H, K = s["d_inner"], s["ssm_state"], s["ssm_heads"], s["ssm_conv"]
    dt = s["param_dtype"]
    conv = dI + 2 * N
    mix = ("blocks", "mixer")
    return [
        (("embed",), (V, d), dt, ("normal", 0.02)),
        (mix + ("in_proj",), (L, d, 2 * dI + 2 * N + H), dt,
         ("normal", 1 / math.sqrt(d))),
        (mix + ("conv_w",), (L, conv, K), dt, ("normal", 0.25)),
        (mix + ("conv_b",), (L, conv), dt, ("normal", 0.1)),
        (mix + ("A_log",), (L, H), "float32", ("A_log", 1.0, 16.0)),
        (mix + ("D",), (L, H), "float32", ("const", 1.0)),
        (mix + ("dt_bias",), (L, H), "float32", ("dt_bias", 1e-3, 1e-1)),
        (mix + ("gate_norm_scale",), (L, dI), dt, ("one_plus", 0.1)),
        (mix + ("out_proj",), (L, dI, d), dt, ("normal", 1 / math.sqrt(dI))),
        (mix + ("norm_scale",), (L, d), dt, ("one_plus", 0.1)),
        (("final_norm_scale",), (d,), dt, ("one_plus", 0.1)),
        (("lm_head",), (d, V), dt, ("normal", 0.02)),
    ]


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): entry (i, j) is sum_{j < t <= i} a_t for
    j <= i, -inf above the diagonal; in float64."""
    Q = a.shape[-1]
    a = a.to(torch.float64)
    x = a[..., None].expand(*a.shape, Q)
    low = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device), -1)
    x = x.masked_fill(~low, 0).cumsum(-2)
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """y (B, S, H, P) fp32 of the scan, one batch row at a time. x (B, S,
    H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N)."""
    return torch.cat([_ssd_row(x[b:b + 1], dt[b:b + 1], A, Bm[b:b + 1],
                               Cm[b:b + 1], chunk) for b in range(x.shape[0])])


def _ssd_row(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    Bsz, S, H, P = x.shape
    nc = S // chunk
    xc = (x * dt[..., None]).reshape(Bsz, nc, chunk, H, P)
    Bc = Bm.reshape(Bsz, nc, chunk, -1)
    Cc = Cm.reshape(Bsz, nc, chunk, -1)
    a = (dt * A).reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)  # (B,H,c,l)
    cum = a.to(torch.float64).cumsum(-1)  # (B, H, c, l)
    # within a chunk: the quadratic form under exp(segsum), segsum(l, s) =
    # cum_l - cum_s for s <= l
    keep = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~keep, float("-inf"))
    decay = seg.exp().to(F32)  # (B, H, c, l, s)
    del seg
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bcls,bhcls,bcshp->bclhp", cb, decay, xc)
    del decay
    # the state at the end of each chunk, from its own inputs
    to_end = (cum[..., -1:] - cum).exp().to(F32)  # (B, H, c, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, to_end, xc)
    # the states carried across chunks
    chunk_sum = cum[..., -1]  # (B, H, c)
    zero = torch.zeros_like(chunk_sum[..., :1])
    carry = segsum(torch.cat([zero, chunk_sum], -1)).exp().to(F32)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    # each chunk's output from the state that enters it
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states,
                         cum.exp().to(F32))
    return y.reshape(Bsz, S, H, P)


def mixer(s: dict, m: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    dI, N, H, P = s["d_inner"], s["ssm_state"], s["ssm_heads"], \
        s["ssm_head_dim"]
    B, S, _ = h.shape
    zxbcdt = linear(h, m["in_proj"], quant)
    z, xbc, dt = zxbcdt.split([dI, dI + 2 * N, H], dim=-1)
    K = m["conv_w"].shape[-1]
    xbc = F.conv1d(xbc.transpose(1, 2), m["conv_w"].to(F32)[:, None, :],
                   m["conv_b"].to(F32), padding=K - 1,
                   groups=xbc.shape[-1])[..., :S].transpose(1, 2)
    xbc = F.silu(xbc)
    x, Bm, Cm = xbc.split([dI, N, N], dim=-1)
    x = x.reshape(B, S, H, P)
    dt = F.softplus(dt + m["dt_bias"].to(F32))
    A = -torch.exp(m["A_log"].to(F32))
    y = ssd(x, dt, A, Bm, Cm, s["ssm_chunk"]) + m["D"].to(F32)[:, None] * x
    y = rmsnorm(y.reshape(B, S, dI) * F.silu(z), m["gate_norm_scale"],
                s["norm_eps"])
    return linear(y, m["out_proj"], quant)


def forward(s: dict, params: dict, tokens: torch.Tensor, *, quant=None,
            on_logits=None):
    """Logits (B, S, vocab_size) at every position. With ``on_logits(lo,
    hi, logits)`` they are handed over LOGIT_ROWS positions at a time (rows
    ``lo:hi`` of the sequence, (B, hi - lo, vocab_size)) and not kept."""
    blocks = params["blocks"]["mixer"]
    x = params["embed"][tokens].to(F32)
    for i in range(s["n_layers"]):
        m = {k: t[i] for k, t in blocks.items()}
        x = x + mixer(s, m, rmsnorm(x, m["norm_scale"], s["norm_eps"]), quant)
    x = rmsnorm(x, params["final_norm_scale"], s["norm_eps"])
    head = params["lm_head"][:, :s["vocab_size"]]
    if on_logits is None:
        return linear(x, head, quant)
    for lo in range(0, x.shape[1], LOGIT_ROWS):
        hi = min(lo + LOGIT_ROWS, x.shape[1])
        on_logits(lo, hi, linear(x[:, lo:hi], head, quant))
    return None

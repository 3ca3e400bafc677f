"""The attention and layer pieces of ROADMAP A11.2 and A11.4 against the
reference, on the CPU, on the same numpy inputs.

* DeepSeek-V2 MLA alone (``mla_forward``, ``mla_decode``) at deepseek's
  smoke width: the fp32 absorption of kv_up into the query, the compressed
  ``(c_kv, k_rope)`` cache, decode at several positions.
* The attention cores with a v head dim other than q's (MLA's effective
  problem): ``attention_reference``, ``attention_chunked`` and
  ``attention_decode``.
* gemma's ``1 + scale`` RMSNorm, ``apply_norm``, zero-initialised norm
  params and the gelu MLP (``jax.nn.gelu``'s tanh approximation).
* gemma2's local and global GQA layers, and a global layer's decode past
  32,768 cache positions, where the reference falls back to the window.

Tolerance: rtol = atol = 1e-4 on fp32 outputs; 1e-5 on the norms and MLPs
(``tests/test_torch_lm.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from torch_lm_helpers import close, perturbed, t

B = 2
FINE = dict(rtol=1e-5, atol=1e-5)


def _mla(seed=0):
    arch = "deepseek-v2-236b"
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    p = perturbed(jax.tree_util.tree_map(np.asarray, JA.mla_init(
        jcfg, jax.random.PRNGKey(seed), jnp.float32)),
        np.random.default_rng(seed))
    return jcfg, tcfg, p, {k: t(v) for k, v in p.items()}


def test_mla_forward_matches_reference():
    jcfg, tcfg, p, tp = _mla()
    rng = np.random.default_rng(1)
    S = 40
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    want, (wc, wk) = JA.mla_forward(jcfg, p, x, jnp.asarray(pos, jnp.int32))
    got, (gc, gk) = TA.mla_forward(tcfg, tp, t(x), torch.from_numpy(pos))
    close(got, want)
    assert tuple(gc.shape) == (B, S, jcfg.kv_lora_rank)
    assert tuple(gk.shape) == (B, S, jcfg.qk_rope_head_dim)
    close(gc, wc)
    close(gk, wk)


@pytest.mark.parametrize("pos", [0, 17, 39])
def test_mla_decode_matches_reference(pos):
    """One step against a random compressed cache of 40 slots, written in
    place at ``pos``."""
    jcfg, tcfg, p, tp = _mla(pos)
    rng = np.random.default_rng(pos + 2)
    x = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32)
    ckv = rng.standard_normal((B, 40, jcfg.kv_lora_rank), dtype=np.float32)
    kr = rng.standard_normal((B, 40, jcfg.qk_rope_head_dim), dtype=np.float32)
    positions = np.full((B, 1), pos)
    want, wc, wk = JA.mla_decode(jcfg, p, x, ckv, kr, jnp.int32(pos),
                                 jnp.asarray(positions, jnp.int32))
    tc, tk = t(ckv), t(kr)
    got, gc, gk = TA.mla_decode(tcfg, tp, t(x), tc, tk, pos,
                                torch.from_numpy(positions))
    assert gc is tc and gk is tk
    close(got, want)
    close(gc, wc)
    close(gk, wk)


# Sq, Sk, Hq, Hkv, hd, vd, causal, window, q_offset
VD_CASES = [
    (48, 48, 8, 1, 40, 32, True, 0, 0),   # MLA's shape: Hkv 1, vd < hd
    (30, 70, 4, 2, 16, 24, True, 20, 40),
    (33, 33, 2, 2, 8, 12, False, 0, 0),
]


@pytest.mark.parametrize("case", VD_CASES, ids=[str(c) for c in VD_CASES])
def test_attention_with_its_own_v_head_dim(case):
    sq, sk, hq, hkv, hd, vd, causal, window, off = case
    rng = np.random.default_rng(sq + vd)
    q = rng.standard_normal((B, sq, hq, hd), dtype=np.float32)
    k = rng.standard_normal((B, sk, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((B, sk, hkv, vd), dtype=np.float32)
    kw = dict(causal=causal, window=window, q_offset=off, scale=0.3)
    want = JL.attention_reference(q, k, v, **kw)
    got = TL.attention_reference(t(q), t(k), t(v), **kw)
    assert tuple(got.shape) == (B, sq, hq, vd)
    close(got, want)
    blocks = dict(block_q=16, block_k=16)
    chunked = TL.attention_chunked(t(q), t(k), t(v), **kw, **blocks)
    close(chunked, JL.attention_chunked(q, k, v, **kw, **blocks))
    close(chunked, want)
    dkw = dict(kv_len=sk - 3, window=window, scale=0.3)
    close(TL.attention_decode(t(q[:, :1]), t(k), t(v), **dkw),
          JL.attention_decode(q[:, :1], k, v, **dkw))


def test_gemma_norms_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    for gemma in (False, True):
        close(TL.rmsnorm(t(x), t(scale), 1e-6, gemma_style=gemma),
              JL.rmsnorm(x, scale, 1e-6, gemma_style=gemma), **FINE)
    bias = rng.standard_normal(16, dtype=np.float32)
    for arch, norm in (("gemma2-9b", "rmsnorm"), ("qwen1.5-4b", "rmsnorm"),
                       ("qwen1.5-4b", "layernorm")):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   norm_type=norm)
        tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                                   norm_type=norm)
        p = {"pre_scale": scale, "pre_bias": bias}
        close(TL.apply_norm(tcfg, t(x), {k: t(v) for k, v in p.items()},
                            "pre"),
              JL.apply_norm(jcfg, x, p, "pre"), **FINE)
        want = JL.norm_params(jcfg, 16, jnp.float32)
        got = TL.norm_params(tcfg, 16, torch.float32)
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[name]))
    assert not TL.norm_params(tconfigs.get_smoke_config("gemma2-9b"), 4,
                              torch.float32)["scale"].any()


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_gated_mlp_activations_match_reference(activation):
    rng = np.random.default_rng(8)
    d, ff = 24, 40
    p = {k: rng.standard_normal(s, dtype=np.float32) * 0.5 for k, s in
         (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d)))}
    x = rng.standard_normal((2, 6, d), dtype=np.float32) * 2
    got = TL.mlp_apply({k: t(v) for k, v in p.items()}, t(x),
                       activation=activation)
    close(got, JL.mlp_apply(p, x, activation=activation), **FINE)
    if activation == "gelu":  # the tanh approximation, not torch's default
        exact = {k: t(v) for k, v in p.items()}
        g = t(x) @ exact["w_gate"]
        erf = (torch.nn.functional.gelu(g) * (t(x) @ exact["w_up"])) \
            @ exact["w_down"]
        assert float((erf - got).abs().max()) > 1e-4


def _gemma_layer(seed):
    jcfg = jconfigs.get_smoke_config("gemma2-9b")
    tcfg = tconfigs.get_smoke_config("gemma2-9b")
    p = jax.tree_util.tree_map(np.asarray, JA.gqa_init(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    return jcfg, tcfg, p, {k: t(v) for k, v in p.items()}


@pytest.mark.parametrize("is_global", [False, True])
def test_gemma_local_and_global_layers_match_reference(is_global):
    """Forward over 96 tokens (local layers mask past the 64-token window,
    global ones do not) with gemma's soft-cap, and one decode step into a
    cache of 100 slots at pos 90."""
    jcfg, tcfg, p, tp = _gemma_layer(3)
    rng = np.random.default_rng(9)
    S = 96
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    want, _ = JA.gqa_forward(jcfg, p, x, jnp.asarray(pos, jnp.int32),
                             is_global=is_global)
    got, _ = TA.gqa_forward(tcfg, tp, t(x), torch.from_numpy(pos),
                            is_global=is_global, use_pallas=True)
    close(got, want)
    kc, vc = rng.standard_normal((2, B, 100, jcfg.n_kv_heads, jcfg.head_dim),
                                 dtype=np.float32)
    want, _, _ = JA.gqa_decode(jcfg, p, x[:, :1], kc, vc, jnp.int32(90),
                               jnp.full((B, 1), 90, jnp.int32),
                               is_global=is_global)
    got, _, _ = TA.gqa_decode(tcfg, tp, t(x[:, :1]), t(kc), t(vc), 90,
                              torch.full((B, 1), 90), is_global=is_global)
    close(got, want)
    local = TA._window(tcfg, is_global, 100)
    assert local == (0 if is_global else jcfg.sliding_window)


@pytest.mark.parametrize("is_global", [False, True])
def test_global_decode_past_32768_positions(is_global):
    """A cache of 32,800 slots at a tiny width (1 KV head of 8): the
    reference's global layers fall back to the 64-slot window past 32,768,
    and so do the port's. The cache is random, so attending to more than
    the window would show."""
    over = dict(d_model=16, n_heads=2, n_kv_heads=1, head_dim=8)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("gemma2-9b"), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("gemma2-9b"), **over)
    p = jax.tree_util.tree_map(np.asarray, JA.gqa_init(
        jcfg, jax.random.PRNGKey(5), jnp.float32))
    rng = np.random.default_rng(10)
    S, at = 32_800, 32_790
    x = rng.standard_normal((1, 1, 16), dtype=np.float32)
    kc, vc = rng.standard_normal((2, 1, S, 1, 8), dtype=np.float32)
    want, wk, _ = JA.gqa_decode(jcfg, p, x, kc, vc, jnp.int32(at),
                                jnp.full((1, 1), at, jnp.int32),
                                is_global=is_global)
    got, gk, _ = TA.gqa_decode(tcfg, {k: t(v) for k, v in p.items()}, t(x),
                               t(kc), t(vc), at, torch.full((1, 1), at),
                               is_global=is_global)
    close(got, want)
    close(gk[:, at - 2:at + 2], np.asarray(wk)[:, at - 2:at + 2])
    assert TA._window(tcfg, is_global, S) == jcfg.sliding_window
    assert TA._window(tcfg, True, TA.GLOBAL_DECODE_LIMIT) == 0

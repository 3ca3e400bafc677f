"""The precision design of the flash kernel's bf16 tensor-core variant, on
the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/flash_attention.cu``) runs
only on the card. Its roundings are emulated here in plain PyTorch, step by
step as the kernel takes them: bf16 q, k and v; S = Q.K^T summed in fp32
(bf16 x bf16 products are exact in fp32); scale, soft-cap and mask in log2
units; an online softmax over 64-key tiles, visiting only the tiles of each
128-row q block's causal / window band; P rounded to bf16 before P.V, with
fp32 sums and l summed from the fp32 P; one rounding of the output,
acc / max(l, 1e-37), to bf16. The emulation is held against the reference's
Pallas kernel in interpret mode and its oracle ``ref.flash_attention_ref``
at ROADMAP B3's bf16 tolerance, 3e-2: the tolerance holds for the numerics
the kernel chose, independently of a run on the card. Inputs are made with
numpy from a seed and given to both.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from test_torch_flash_attention import FLASH_CASES

BLOCK_Q, BLOCK_K = 128, 64  # the kernel's q rows a block, keys a tile
LOG2E = 1.4426950408889634
MASKED = -2.0e38 * LOG2E  # the reference's NEG_INF, in log2 units
TOL = 3e-2


def _band_tiles(q0, q_last, sk, causal, window, q_offset):
    """The k tiles holding any allowed key of q rows [q0, q_last]."""
    n = -(-sk // BLOCK_K)
    lo, hi = 0, n
    if window > 0:
        lo = max(q0 + q_offset - window + 1, 0) // BLOCK_K
    if causal:
        k_max = q_last + q_offset
        hi = 0 if k_max < 0 else min(n, k_max // BLOCK_K + 1)
    return lo, hi


def emulate_bf16_tc(q, k, v, *, causal=True, window=0, logit_softcap=None,
                    q_offset=0, scale=None, round_p=True):
    """The kernel's arithmetic. q (B, Sq, Hq, hd), k / v (B, Sk, Hkv, hd),
    bf16; returns (B, Sq, Hq, hd) bf16. ``round_p=False`` keeps P in fp32
    (not the kernel: the control of the last test)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2)  # (B, Hq, Sq, hd)
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    out = torch.zeros((B, Hq, Sq, hd))
    for q0 in range(0, Sq, BLOCK_Q):
        q1 = min(q0 + BLOCK_Q, Sq)
        qpos = torch.arange(q0, q1) + q_offset
        m = torch.full((B, Hq, q1 - q0), MASKED)
        l = torch.zeros((B, Hq, q1 - q0))
        acc = torch.zeros((B, Hq, q1 - q0, hd))
        for kt in range(*_band_tiles(q0, q1 - 1, Sk, causal, window,
                                     q_offset)):
            k0 = kt * BLOCK_K
            k1 = min(k0 + BLOCK_K, Sk)  # keys past Sk: masked, p = 0
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)
            if logit_softcap:
                x = torch.tanh(s * (scale / logit_softcap)) * (
                    logit_softcap * LOG2E)
            else:
                x = s * (scale * LOG2E)
            kpos = torch.arange(k0, k1)
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                ok &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                ok &= kpos[None, :] > qpos[:, None] - window
            x = torch.where(ok, x, torch.tensor(MASKED))
            mx = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * corr + p.sum(-1)
            pv = p.to(torch.bfloat16).float() if round_p else p
            acc = acc * corr[..., None] + pv @ vf[:, :, k0:k1]
            m = mx
        out[:, :, q0:q1] = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.to(torch.bfloat16).transpose(1, 2)


def _bf16_inputs(B, Sq, Sk, Hq, Hkv, hd, seed, q_std=1.0):
    """numpy draws rounded to bf16 once; returns (jax arrays, torch
    tensors) holding the same bf16 values."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Sq, Hq, hd), dtype=np.float32) * q_std,
              rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32),
              rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32))
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jx]
    return jx, tx


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case,q_std,kw", [
    # tests/test_torch_flash_attention.py's bf16 case
    ((2, 160, 160, 8, 2, 80, 7), 1.0, dict(causal=True, window=100)),
    # peaked: scores of std 4, as the card's check at the prefill's shape
    ((1, 512, 512, 8, 2, 80, 11), 4.0, dict(causal=True, window=256)),
], ids=["bf16_gqa_window", "peaked_std4_s512"])
def test_emulated_kernel_matches_pallas_and_oracle(case, q_std, kw):
    *shape, seed = case
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(*shape, seed, q_std)
    got = emulate_bf16_tc(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    pallas = ops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    oracle = ref.flash_attention_ref(jq, jk, jv, **kw)
    for want in (pallas, oracle):
        _close(got, want)


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_emulated_kernel_matches_oracle_on_reference_cases(case):
    """The reference tests' cases (tests/test_kernels.py), in bf16."""
    *shape, causal, window, cap = case
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(*shape, sum(shape))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    _close(emulate_bf16_tc(tq, tk, tv, **kw),
           ref.flash_attention_ref(jq, jk, jv, **kw))


def test_emulated_kernel_ragged_q_offset():
    """Sq and Sk not multiples of the tiles, queries from q_offset > 0."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(2, 77, 333, 4, 2, 80, 3)
    kw = dict(causal=True, window=90, q_offset=200)
    got = emulate_bf16_tc(tq, tk, tv, **kw)
    pallas = ops.flash_attention(jq, jk, jv, block_q=16, block_k=32, **kw)
    for want in (pallas, ref.flash_attention_ref(jq, jk, jv, **kw)):
        _close(got, want)


def test_rounding_p_is_the_only_departure():
    """With P kept in fp32, the emulation is the reference's arithmetic up
    to the order of fp32 sums: its outputs round to the oracle's bf16
    outputs or one bf16 ulp beside them. So the bf16 rounding of P is what
    the 3e-2 tolerance has to absorb."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(1, 192, 192, 4, 2, 80, 5, 4.0)
    kw = dict(causal=True, window=100)
    oracle = torch.from_numpy(np.array(
        ref.flash_attention_ref(jq, jk, jv, **kw).astype(jnp.float32)))
    bf16_p = emulate_bf16_tc(tq, tk, tv, **kw).float()
    fp32_p = emulate_bf16_tc(tq, tk, tv, round_p=False, **kw).float()
    ulp = torch.finfo(torch.bfloat16).eps * oracle.abs().clamp(min=2**-126)
    assert bool(((fp32_p - oracle).abs() <= 2 * ulp + 1e-30).all())
    assert float((bf16_p - oracle).abs().max()) < TOL

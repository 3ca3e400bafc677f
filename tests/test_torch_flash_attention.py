"""The port's flash attention against the reference's, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` runs the kernel's
plain version (no launch is counted); the reference runs its Pallas kernel
in interpret mode through ``repro.kernels.ops``, as ``tests/test_kernels.py``
does, and its pure-jnp oracle ``ref.flash_attention_ref``. Inputs are made
with numpy from a seed and given to both. Tolerances are the reference
tests': 2e-5 in fp32, 3e-2 in bf16 (ROADMAP B3). The hand-written CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

fa = importlib.import_module("repro_torch.kernels.flash_attention")

# the cases of tests/test_kernels.py:
# B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap
FLASH_CASES = [
    (1, 64, 64, 4, 2, 32, True, 0, None),
    (2, 128, 128, 8, 8, 64, True, 32, None),
    (1, 96, 96, 4, 1, 48, True, 0, 50.0),     # softcap (gemma2)
    (2, 64, 256, 4, 2, 32, False, 0, None),   # cross/non-causal
    (1, 200, 200, 2, 2, 16, True, 64, None),  # non-multiple-of-block seq
    (1, 64, 64, 8, 2, 128, True, 0, None),    # GQA group of 4
]


def _qkv(case, seed=0):
    B, Sq, Sk, Hq, Hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, Hkv, hd), dtype=np.float32))


def test_cases_are_the_reference_tests():
    import test_kernels

    assert test_kernels.FLASH_CASES == FLASH_CASES


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_attention_matches_reference(case):
    *_, causal, window, cap = case
    q, k, v = _qkv(case)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    pallas = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 block_q=64, block_k=64, **kw)
    oracle = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    before = fa.KERNEL.launches
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    assert fa.KERNEL.launches == before  # the plain version: no launch
    assert got.shape == q.shape and got.dtype == torch.float32
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    plain = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), **kw)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("q_offset,window", [(64, 0), (64, 48), (10, 24)])
def test_flash_attention_q_offset(q_offset, window):
    """A query chunk that starts at ``q_offset`` (Sq < Sk)."""
    case = (1, 32, 96, 4, 2, 32)
    q, k, v = _qkv(case, seed=q_offset + window)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=16, block_k=32, **kw)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_attention_bf16_gqa_window():
    """bf16 in and out: both sides compute in fp32 and round once."""
    case = (2, 160, 160, 8, 2, 80)
    q, k, v = _qkv(case, seed=7)
    kw = dict(causal=True, window=100)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = ops.flash_attention(jq, jk, jv, **kw)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jq, jk, jv))
    got = tops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (64, 64, True, 0, 0), (200, 200, True, 64, 0), (64, 256, False, 0, 0),
    (32, 96, True, 48, 64), (50, 70, False, 30, 5), (17, 9, True, 4, -3)])
def test_band_pairs_counts_the_mask(sq, sk, causal, window, q_offset):
    qp = np.arange(sq)[:, None] + q_offset
    kp = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= kp > qp - window
    assert fa.band_pairs(sq, sk, causal=causal, window=window,
                         q_offset=q_offset) == int(ok.sum())


def test_band_pairs_at_the_serving_prefill():
    """Sq = Sk = 4608, window 4096: sum_p min(p + 1, 4096)."""
    assert fa.band_pairs(4608, 4608, causal=True, window=4096) == \
        4096 * 4097 // 2 + 512 * 4096

"""The port's hand-written CUDA kernels against their plain versions, on the
card. Marked ``cuda``: each test skips where no CUDA device is present
(decided inside the fixture, never at import). On a machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda_kernels.py

(``--noconftest`` because ``tests/conftest.py`` imports jax, which a
machine for the port need not have.)
"""
import importlib

import pytest
import torch

sr = importlib.import_module("repro_torch.kernels.segment_reduce")
fr = importlib.import_module("repro_torch.kernels.fedavg_reduce")
fa = importlib.import_module("repro_torch.kernels.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k,m", [(10, 2_097_152, 5), (10, 1, 5),
                                   (100, 1, 5), (100_000, 1, 8),
                                   (3000, 37, 13), (5, 3, 1)])
def test_segment_kernel_matches_plain_and_repeats(cuda, n, k, m):
    gen = torch.Generator().manual_seed(n + k + m)
    vals = torch.randn((n, k), generator=gen).to(cuda)
    ids = torch.randint(-1, m + 2, (n,), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = sr.KERNEL.launches
    out = sr.segment_reduce_kernel(vals, ids, m)
    again = sr.segment_reduce_kernel(vals, ids, m)
    assert sr.KERNEL.launches == before + 2
    torch.cuda.synchronize()
    torch.testing.assert_close(out, sr._seg_tiled_plain(vals, ids, m),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)  # fixed summation order


def test_segment_kernel_refuses_what_it_does_not_take(cuda):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sr.segment_reduce_kernel(torch.ones((4, 2), dtype=torch.float64,
                                            device=cuda), ids, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sr.segment_reduce_kernel(torch.ones((2, 4), device=cuda).T, ids, 2)
    out = sr.segment_reduce_kernel(torch.ones((0, 3), device=cuda),
                                   ids[:0], 2)
    assert out.shape == (2, 3) and not out.any()


@pytest.mark.parametrize("c,n,main_path", [(5, 2_156_490, True),
                                           (5, 2_156_490, False),
                                           (3, 65_537, False),
                                           (16, 4096, False)])
def test_fedavg_kernel_matches_plain(cuda, c, n, main_path):
    """On a stack laid out by ``stack_rows`` (16-byte loads) and on
    contiguous stacks, whose rows are 16-byte aligned only when 4 | N."""
    gen = torch.Generator().manual_seed(c + n)
    x = torch.randn((c, n), generator=gen).to(cuda)
    if main_path:
        x = fr.stack_rows(list(x))
    w = torch.rand((c,), generator=gen).to(cuda) + 0.1
    out = fr.fedavg_reduce(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fr.fedavg_reduce_plain(x, w),
                               rtol=1e-5, atol=1e-5)


# the cases of tests/test_kernels.py:
# B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap
FLASH_CASES = [
    (1, 64, 64, 4, 2, 32, True, 0, None),
    (2, 128, 128, 8, 8, 64, True, 32, None),
    (1, 96, 96, 4, 1, 48, True, 0, 50.0),
    (2, 64, 256, 4, 2, 32, False, 0, None),
    (1, 200, 200, 2, 2, 16, True, 64, None),
    (1, 64, 64, 8, 2, 128, True, 0, None),
]


def _flash_inputs(case, dtype, cuda, seed):
    B, Sq, Sk, Hq, Hkv, hd = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(cuda, dtype)
            for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_fp32(cuda, case):
    """At the reference tests' fp32 tolerance, 2e-5."""
    *_, causal, window, cap = case
    q, k, v = _flash_inputs(case, torch.float32, cuda, sum(case[:6]))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                               rtol=2e-5, atol=2e-5)


def test_flash_kernel_bf16_gqa_window_strided(cuda):
    """bf16 at the serving path's head dim, GQA 4, window shorter than the
    sequence, q_offset, and q, k, v as views of one fused projection (the
    kernel reads their strides). Both versions round once from fp32 math:
    3e-2, ROADMAP B3's bf16 tolerance."""
    B, S, Hq, Hkv, hd = 2, 700, 8, 2, 80
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn((B, S, Hq + 2 * Hkv, hd), generator=gen).to(
        cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    assert not q.is_contiguous()
    for kw in (dict(window=256), dict(window=100, q_offset=0),
               dict(window=0, causal=False)):
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                                   rtol=3e-2, atol=3e-2)
    tail = q[:, -60:]  # the last 60 queries over all keys
    kw = dict(window=256, q_offset=S - 60)
    torch.testing.assert_close(fa.flash_attention(tail, k, v, **kw),
                               fa.flash_attention_plain(tail, k, v, **kw),
                               rtol=3e-2, atol=3e-2)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.ones((1, 8, 4, 32), device=cuda)
    k = torch.ones((1, 8, 2, 32), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), k)
    wide = torch.ones((1, 8, 2, 160), device=cuda)
    with pytest.raises(ValueError, match="hd"):
        fa.flash_attention(torch.ones((1, 8, 4, 160), device=cuda), wide, wide)
    strided = torch.ones((1, 8, 32, 2), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, strided, strided)

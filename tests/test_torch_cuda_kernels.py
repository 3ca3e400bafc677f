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

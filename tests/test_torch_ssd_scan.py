"""The port's SSD scan against the reference's, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.ssd_scan`` runs the kernel's plain
version (no launch is counted); the reference runs its Pallas kernel in
interpret mode through ``repro.kernels.ops``, as ``tests/test_kernels.py``
does, and its pure-jnp oracle ``ref.ssd_scan_ref``. Inputs are made with
numpy from a seed and given to both. Tolerances are the reference tests':
atol 2e-4 / rtol 2e-3 against the kernel, 1e-4 for chunk invariance, and
atol 1e-4 / rtol 1e-3 against the step-by-step recurrence. The hand-written
CUDA kernel itself is held against the plain version on the card
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

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

# the cases of tests/test_kernels.py: B, S, H, P, N, chunk
SSD_CASES = [
    (1, 64, 2, 8, 4, 16),
    (2, 128, 4, 16, 8, 32),
    (1, 256, 8, 32, 16, 64),
    (2, 96, 2, 64, 128, 32),
]


def _inputs(B, S, H, P, N, seed=0):
    """As the reference tests draw them: x, B, C normal, dt = softplus of a
    normal, A = -exp of a normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _port(args, chunk):
    return tops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)


def test_cases_are_the_reference_tests():
    import test_kernels

    assert test_kernels.SSD_CASES == SSD_CASES


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_scan_matches_reference(case):
    *shape, chunk = case
    args = _inputs(*shape, seed=sum(case))
    pallas = ops.ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    oracle = ref.ssd_scan_ref(*(jnp.asarray(a) for a in args), chunk=chunk)
    before = ssd.KERNEL.launches
    got = _port(args, chunk)
    assert ssd.KERNEL.launches == before  # the plain version: no launch
    assert tuple(got.shape) == tuple(shape[:4]) and got.dtype == torch.float32
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-4, rtol=2e-3)
    plain = tref.ssd_scan_ref(*(torch.from_numpy(a) for a in args),
                              chunk=chunk)
    assert torch.equal(got, plain)


def test_ssd_scan_chunk_invariance():
    """The chunked algorithm is exact: the result does not depend on the
    chunk."""
    args = _inputs(1, 128, 2, 8, 4, seed=1)
    np.testing.assert_allclose(_port(args, 32).numpy(),
                               _port(args, 128).numpy(), atol=1e-4, rtol=1e-4)


def test_ssd_matches_sequential_recurrence():
    """SSD chunked == the per-step SSM recurrence, in numpy."""
    B, S, H, P, N = 1, 32, 2, 4, 3
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, seed=2)
    h = np.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        h = h * np.exp(dt[:, t] * A[None])[:, :, None, None] + np.einsum(
            "bn,bhp,bh->bhnp", Bm[:, t], x[:, t], dt[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, t], h))
    np.testing.assert_allclose(_port((x, dt, A, Bm, Cm), 8).numpy(),
                               np.stack(ys, axis=1), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("S,chunk", [(96, 64), (100, 32), (64, 0)])
def test_ssd_scan_raises_on_ragged_chunk(S, chunk):
    args = _inputs(1, S, 2, 8, 4)
    with pytest.raises(ValueError, match="S % chunk"):
        _port(args, chunk)


def test_ssd_scan_refuses_mismatched_shapes():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 8, 4))
    with pytest.raises(ValueError, match="disagree"):
        tops.ssd_scan(x, dt[:, :32], A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="Bm/Cm"):
        tops.ssd_scan(x, dt, A, Bm, Cm[..., :2], chunk=32)


def test_ssd_flops_at_the_main_path():
    """mamba2-2.7b's forward call (B=4, S=4608, H=80, P=64, N=128, Q=256):
    per (batch, chunk, head) P·Q(Q+1) + 4·Q·N·P, per (batch, chunk)
    2·Q²·N; 7.38e10 in all."""
    per_bc = 80 * (64 * 256 * 257 + 4 * 256 * 128 * 64) + 2 * 256 ** 2 * 128
    assert ssd.ssd_flops(4, 4608, 80, 64, 128, 256) == 4 * 18 * per_bc
    assert abs(ssd.ssd_flops(4, 4608, 80, 64, 128, 256) - 7.38e10) < 0.01e10

"""Parity of the port's FedAvg reduce with the reference on the CPU.

On a CPU tensor the port's wrapper runs its plain version; the reference's
``ops.fedavg_reduce`` runs its Pallas kernel in interpret mode here. Both
are held at 1e-5, the tolerance of ``tests/test_kernels.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

t_fr = importlib.import_module("repro_torch.kernels.fedavg_reduce")


@pytest.mark.parametrize("C,N", [(2, 100), (5, 1000), (16, 4096), (3, 65537)])
def test_fedavg_reduce_matches_reference(C, N):
    rs = np.random.RandomState(C * 7 + N)
    stacked = rs.normal(size=(C, N)).astype(np.float32)
    w = rs.uniform(0.1, 10.0, C).astype(np.float32)
    want = np.asarray(j_ops.fedavg_reduce(jnp.asarray(stacked),
                                          jnp.asarray(w)))
    got = t_ops.fedavg_reduce(torch.as_tensor(stacked), torch.as_tensor(w))
    assert got.shape == (N,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        t_ref.fedavg_reduce_ref(torch.as_tensor(stacked),
                                torch.as_tensor(w)).numpy(),
        np.asarray(j_ref.fedavg_reduce_ref(jnp.asarray(stacked),
                                           jnp.asarray(w))),
        atol=1e-5, rtol=1e-5)


def test_fedavg_reduce_is_convex_combination():
    stacked = torch.stack([torch.full((64,), -3.0), torch.full((64,), 7.0)])
    w = torch.tensor([2.0, 6.0])
    out = t_ops.fedavg_reduce(stacked, w)
    assert float(out.min()) >= -3.0 - 1e-5 and float(out.max()) <= 7.0 + 1e-5
    np.testing.assert_allclose(out.numpy(),
                               np.full(64, (-3.0 * 2 + 7.0 * 6) / 8), atol=1e-5)


def test_padded_row_stride_view():
    """The stack ``hierarchy.fedavg_flat_kernel`` passes: built by
    ``stack_rows``, a view of a buffer whose rows are padded to a multiple
    of 4 floats."""
    rs = np.random.RandomState(9)
    x = rs.normal(size=(4, 1001)).astype(np.float32)
    w = rs.uniform(1, 5, 4).astype(np.float32)
    stacked = t_fr.stack_rows(list(torch.as_tensor(x)))
    assert stacked.shape == (4, 1001) and stacked.stride() == (1004, 1)
    np.testing.assert_array_equal(stacked.numpy(), x)
    got = t_ops.fedavg_reduce(stacked, torch.as_tensor(w))
    want = np.asarray(j_ref.fedavg_reduce_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_wrapper_runs_plain_on_cpu_without_launch():
    launches = t_fr.KERNEL.launches
    t_fr.fedavg_reduce(torch.ones((2, 8)), torch.ones(2))
    assert t_fr.KERNEL.launches == launches

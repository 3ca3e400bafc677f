"""The segment-reduce ``"kernel"`` backend's gradient and the grouped call,
on the CPU (the kernel's plain version runs inside the same
``torch.autograd.Function``). The gradient is a gather of the output
gradient at each twin's segment, zero for dropped ids: held equal to the
dense one-hot oracle's autograd gradient (rtol 1e-6, fp32). The grouped
call is held to a per-group loop (rtol/atol 1e-6; the ``"sort"`` backend,
whose sums and gradients are differences of one long prefix sum, at
ROADMAP B1's rtol 1e-4 / atol 1e-5) and launches the kernel once per run of at most
``MAX_SEGMENTS // M`` groups.
"""
import importlib
import math

import numpy as np
import pytest
import torch

sr = importlib.import_module("repro_torch.kernels.segment_reduce")


def _case(n, k, m, seed):
    rs = np.random.RandomState(seed)
    shape = (n,) if k is None else (n, k)
    vals = torch.tensor(rs.randn(*shape).astype(np.float32))
    ids = torch.tensor(rs.randint(-2, m + 2, n).astype(np.int32))
    w = torch.tensor(rs.randn(*((m,) if k is None else (m, k)))
                     .astype(np.float32))
    return vals, ids, w


@pytest.mark.parametrize("n,k,m", [(40, None, 5), (100, 3, 5), (7, 1, 1),
                                   (300, 4, 13)])
def test_kernel_backend_gradient_matches_onehot(n, k, m):
    vals, ids, w = _case(n, k, m, n + m)
    grads = {}
    for backend in ("kernel", "onehot"):
        v = vals.clone().requires_grad_()
        out = sr.segment_reduce(v, ids, m, backend=backend)
        assert out.grad_fn is not None
        (out * w).sum().backward()
        grads[backend] = v.grad
    np.testing.assert_allclose(grads["kernel"].numpy(),
                               grads["onehot"].numpy(), rtol=1e-6)
    dropped = ((ids < 0) | (ids >= m)).numpy()
    assert dropped.any() and not grads["kernel"].numpy()[dropped].any()
    kept = np.clip(ids.numpy(), 0, m - 1)[~dropped]
    np.testing.assert_array_equal(grads["kernel"].numpy()[~dropped],
                                  w.numpy()[kept])


def test_kernel_function_gradient_direct():
    """``segment_reduce_kernel`` itself: (N, K) fp32 and int32 ids."""
    vals, ids, w = _case(64, 6, 7, 3)
    v = vals.clone().requires_grad_()
    out = sr.segment_reduce_kernel(v, ids, 7)
    assert isinstance(out.grad_fn, sr._SegmentReduceKernel._backward_cls)
    (out * w).sum().backward()
    want = torch.where(((ids >= 0) & (ids < 7))[:, None],
                       w[torch.clamp(ids, 0, 6).long()], 0.0)
    assert torch.equal(v.grad, want)
    assert sr.segment_reduce_kernel(vals, ids, 7).grad_fn is None


@pytest.mark.parametrize("backend", ["kernel", "onehot", "segment_sum",
                                     "sort", "auto"])
@pytest.mark.parametrize("g,n,tail,m", [(3, 20, (), 4), (100, 12, (), 5),
                                        (50, 9, (2, 3), 7), (1, 5, (), 300)])
def test_grouped_matches_per_group_loop(backend, g, n, tail, m):
    rs = np.random.RandomState(g + n + m)
    vals = torch.tensor(rs.randn(g, n, *tail).astype(np.float32))
    ids = torch.tensor(rs.randint(-1, m + 1, (g, n)).astype(np.int32))
    v = vals.clone().requires_grad_()
    out = sr.segment_reduce_grouped(v, ids, m, backend=backend)
    assert out.shape == (g, m) + tail
    loop_v = vals.clone().requires_grad_()
    want = torch.stack([sr.segment_reduce(loop_v[i], ids[i], m,
                                          backend="onehot")
                        for i in range(g)])
    tol = (dict(rtol=1e-4, atol=1e-5) if backend == "sort"
           else dict(rtol=1e-6, atol=1e-6))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               **tol)
    w = torch.tensor(rs.randn(*out.shape).astype(np.float32))
    (out * w).sum().backward()
    (want * w).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), loop_v.grad.numpy(), **tol)
    counts = sr.segment_count_grouped(ids, m, backend=backend)
    np.testing.assert_array_equal(
        counts.numpy(),
        [np.bincount(r[(r >= 0) & (r < m)], minlength=m) for r in ids.numpy()])


@pytest.mark.parametrize("g,m", [(320, 5), (64, 5), (44, 5), (45, 5),
                                 (10, 223), (3, 1)])
def test_grouped_kernel_launch_runs(monkeypatch, g, m):
    """One kernel call per run of at most MAX_SEGMENTS // M groups."""
    calls = []
    kernel = sr._IMPLS["kernel"]

    def counted(values, assoc, num_segments):
        calls.append(num_segments)
        assert num_segments <= sr.MAX_SEGMENTS
        assert int(assoc.max()) < num_segments
        return kernel(values, assoc, num_segments)

    monkeypatch.setitem(sr._IMPLS, "kernel", counted)
    ids = torch.randint(0, m, (g, 6), generator=torch.Generator()
                        .manual_seed(g), dtype=torch.int32)
    out = sr.segment_count_grouped(ids, m, backend="kernel")
    per_call = sr.MAX_SEGMENTS // m
    assert len(calls) == math.ceil(g / per_call)
    assert sum(calls) == g * m
    assert torch.equal(out.sum(1), torch.full((g,), 6.0))


def test_max_segments_is_the_kernel_limit():
    """(227 KiB of shared memory - 1024 staged int32 ids) / (256 threads x
    4 bytes), as ``seg_reduce_max_segments`` computes it."""
    assert sr.MAX_SEGMENTS == 223

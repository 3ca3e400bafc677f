"""Parity of the port's segment reductions (``repro_torch.kernels.
segment_reduce``) with the reference on the CPU.

Every port backend, the ``"kernel"`` backend included (on a CPU tensor it
runs the kernel's plain tiled version), is held against the reference under
``backend="onehot"`` and under its Pallas kernel in interpret mode, on the
cases of ``tests/test_segment_reduce.py``, at rtol 1e-4 / atol 1e-5 (fp32
sums taken in different orders). The hand CUDA kernel itself runs only on
the card (``chip_smoke.py`` and ``test_torch_cuda_kernels.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export the function under the module's name, so the
# modules are fetched by path
j_sr = importlib.import_module("repro.kernels.segment_reduce")
t_sr = importlib.import_module("repro_torch.kernels.segment_reduce")

PORT_BACKENDS = ["kernel", "segment_sum", "sort", "onehot", "auto"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _ref(values, assoc, m):
    v, a = jnp.asarray(values), jnp.asarray(assoc)
    onehot = np.asarray(j_sr.segment_reduce(v, a, m, backend="onehot"))
    pallas = np.asarray(j_sr.segment_reduce(v, a, m, backend="pallas",
                                            interpret=True))
    return onehot, pallas


def _port(values, assoc, m, backend):
    out = t_sr.segment_reduce(torch.as_tensor(values), torch.as_tensor(assoc),
                              m, backend=backend)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("n,m", [(1, 1), (17, 5), (1000, 13), (2500, 3)])
def test_backend_matches_reference_1d(backend, n, m):
    rs = np.random.RandomState(n * 31 + m)
    assoc = rs.randint(0, m, n).astype(np.int32)
    vals = rs.uniform(-2.0, 2.0, n).astype(np.float32)
    onehot, pallas = _ref(vals, assoc, m)
    got = _port(vals, assoc, m, backend)
    assert got.shape == (m,)
    np.testing.assert_allclose(got, onehot, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_backend_matches_reference_tail_dims(backend):
    n, m = 201, 6
    rs = np.random.RandomState(0)
    assoc = rs.randint(0, m, n).astype(np.int32)
    vals = rs.normal(size=(n, 3, 4)).astype(np.float32)
    onehot, pallas = _ref(vals, assoc, m)
    got = _port(vals, assoc, m, backend)
    assert got.shape == (m, 3, 4)
    np.testing.assert_allclose(got, onehot, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_several_twin_tiles(backend):
    """N > 1024 twins spans several tiles of the plain tiled version."""
    n, m, k = 3000, 4, 5
    rs = np.random.RandomState(11)
    assoc = rs.randint(-1, m + 1, n).astype(np.int32)  # some ids dropped
    vals = rs.normal(size=(n, k)).astype(np.float32)
    onehot, pallas = _ref(vals, assoc, m)
    got = _port(vals, assoc, m, backend)
    np.testing.assert_allclose(got, onehot, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_empty_segments_and_m_past_max_id(backend):
    assoc = np.array([0, 0, 2, 2, 2], np.int32)
    vals = np.array([1.0, 2.0, 5.0, 7.0, 11.0], np.float32)
    got = _port(vals, assoc, 6, backend)
    np.testing.assert_allclose(got, [3.0, 0.0, 23.0, 0.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(got, _ref(vals, assoc, 6)[1], atol=1e-6)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_out_of_range_ids_dropped(backend):
    assoc = np.array([0, 7, -1, 1], np.int32)
    vals = np.array([1.0, 10.0, 100.0, 2.0], np.float32)
    got = _port(vals, assoc, 3, backend)
    np.testing.assert_allclose(got, [1.0, 2.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(got, _ref(vals, assoc, 3)[1], atol=1e-6)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_empty_population_returns_zeros(backend):
    got = _port(np.zeros((0,), np.float32), np.zeros((0,), np.int32), 4,
                backend)
    np.testing.assert_array_equal(got, np.zeros(4))
    got2 = _port(np.zeros((0, 3), np.float32), np.zeros((0,), np.int32), 4,
                 backend)
    assert got2.shape == (4, 3)
    np.testing.assert_array_equal(got2, np.zeros((4, 3)))


def test_kernel_wrapper_empty_and_plain_on_cpu():
    """The kernel wrapper runs its plain version because the tensor is on
    the CPU, and returns zeros for n == 0."""
    out = t_sr.segment_reduce_kernel(torch.zeros((0, 7)),
                                     torch.zeros((0,), dtype=torch.int32), 3)
    assert out.shape == (3, 7) and not out.any()
    launches = t_sr.KERNEL.launches
    vals = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = t_sr.segment_reduce_kernel(vals, torch.tensor([1, 0, 1, 5],
                                                        dtype=torch.int32), 2)
    np.testing.assert_array_equal(out.numpy(), [[3, 4, 5], [6, 8, 10]])
    assert t_sr.KERNEL.launches == launches  # no CUDA launch on the CPU


@pytest.mark.parametrize("backend", ["kernel", "segment_sum", "sort", "auto"])
def test_segment_count_is_histogram(backend):
    n, m = 333, 9
    assoc = np.random.RandomState(2).randint(0, m, n)
    got = t_sr.segment_count(torch.as_tensor(assoc), m, backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.bincount(assoc, minlength=m))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_sr.segment_count(jnp.asarray(assoc), m)))


@pytest.mark.parametrize("fn", ["segment_max", "segment_min"])
@pytest.mark.parametrize("shape", [(50,), (50, 3), (0,)])
def test_segment_extremes_match(fn, shape):
    rs = np.random.RandomState(3)
    vals = rs.normal(size=shape).astype(np.float32)
    assoc = rs.randint(-1, 7, shape[0]).astype(np.int32)  # ids -1 and 6 dropped
    want = np.asarray(getattr(j_sr, fn)(jnp.asarray(vals), jnp.asarray(assoc),
                                        6))
    got = getattr(t_sr, fn)(torch.as_tensor(vals), torch.as_tensor(assoc), 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m", [(0, 3), (1, 1), (9, 4), (60, 5), (61, 7)])
def test_segment_median_matches(n, m):
    rs = np.random.RandomState(n + m)
    vals = rs.normal(size=n).astype(np.float32)
    vals[: n // 3] = np.round(vals[: n // 3])  # ties
    assoc = rs.randint(-1, m + 1, n).astype(np.int32)
    got = t_sr.segment_median(torch.as_tensor(vals), torch.as_tensor(assoc), m)
    if n:
        want = np.asarray(j_sr.segment_median(jnp.asarray(vals),
                                              jnp.asarray(assoc), m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    for s in range(m):
        sel = vals[assoc == s]
        ref = np.median(sel) if sel.size else 0.0
        np.testing.assert_allclose(float(got[s]), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["kernel", "segment_sum", "onehot"])
def test_segment_std_matches(backend):
    rs = np.random.RandomState(4)
    vals = rs.normal(size=(80, 2)).astype(np.float32)
    assoc = rs.randint(0, 6, 80).astype(np.int32)
    assoc[assoc == 4] = 0  # an empty segment
    want = np.asarray(j_sr.segment_std(jnp.asarray(vals), jnp.asarray(assoc),
                                       6, backend="onehot"))
    got = t_sr.segment_std(torch.as_tensor(vals), torch.as_tensor(assoc), 6,
                           backend=backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_sort_groups_matches():
    assoc = np.random.RandomState(5).randint(-1, 6, 40).astype(np.int32)
    jo, jb = j_sr.sort_groups(jnp.asarray(assoc), 5)
    to, tb = t_sr.sort_groups(torch.as_tensor(assoc), 5)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_resolve_backend_table():
    # CUDA: always the hand kernel
    for n, m in [(1, 1), (10, 5), (100, 5), (10**7, 8), (10**7, 512)]:
        assert t_sr.resolve_backend(n, m, platform="cuda") == "kernel"
    # CPU: the reference's CPU rules, "kernel" where it says "pallas"
    for n, m in [(1_000, 8), (10_000_000, 8), (10_000_000, 512), (10, 2),
                 (2 * 2**20, 8), (2 * 2**20 + 1, 8)]:
        want = j_sr.resolve_backend(n, m, platform="cpu")
        got = t_sr.resolve_backend(n, m, platform="cpu")
        assert got == {"pallas": "kernel"}.get(want, want)
    with pytest.raises(ValueError, match="platform"):
        t_sr.resolve_backend(10, 2, platform="tpu")


def test_invalid_backend_and_shapes_raise():
    with pytest.raises(ValueError, match="backend"):
        t_sr.segment_reduce(torch.ones(3), torch.zeros(3, dtype=torch.int32),
                            2, backend="pallas")
    with pytest.raises(ValueError, match="assoc"):
        t_sr.segment_reduce(torch.ones(3),
                            torch.zeros((3, 1), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="leading axis"):
        t_sr.segment_reduce(torch.ones(4), torch.zeros(3, dtype=torch.int32), 2)
    # the sharded backend needs a twin scope (tests/test_torch_sharded_*.py
    # run it on gloo ranks)
    with pytest.raises(ValueError, match="twin scope"):
        t_sr.segment_reduce(torch.ones(3), torch.zeros(3, dtype=torch.int32),
                            2, backend="sharded")

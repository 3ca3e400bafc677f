"""The port's twin scope (``repro_torch.core.sharding``): outside a scope
each helper is the identity or a plain reduction and matches the reference
on shared numpy inputs (reductions at rtol 1e-6, the rest exactly); inside
a scope every helper that needs the shard index or a collective raises
``NotImplementedError`` naming ROADMAP A10, as do the segment reductions'
``"auto"`` dispatch and extremes.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharding as j_sh
from repro_torch.core import sharding as t_sh

# the package re-exports the function under the module's name
t_seg = importlib.import_module("repro_torch.kernels.segment_reduce")

RS = np.random.RandomState(0)
X = RS.normal(size=(11, 3)).astype(np.float32)
LOGITS = RS.normal(size=(11,)).astype(np.float32)
MASK = RS.rand(11) < 0.5


@pytest.mark.parametrize("name", ["twin_sum", "twin_mean", "twin_max",
                                  "twin_min", "twin_std"])
@pytest.mark.parametrize("axis", [0, 1])
def test_reductions_match_outside_scope(name, axis):
    got = getattr(t_sh, name)(torch.tensor(X), axis=axis)
    want = getattr(j_sh, name)(jnp.asarray(X), axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_identities_and_counts_outside_scope():
    x = torch.tensor(X)
    assert t_sh.in_scope() is None and j_sh.in_scope() is None
    assert t_sh.mask_twins(x, 0.0) is x
    assert t_sh.localize(x) is x
    assert t_sh.localize(x, fill=5) is x
    tree = {"a": x}
    assert t_sh.pmean_in_scope(tree) is tree
    assert t_sh.stamp_replicated(tree) is tree
    assert t_sh.local_twin_count(11) == j_sh.local_twin_count(11) == 11
    assert t_sh.global_twin_count(11) == j_sh.global_twin_count(11) == 11
    got = t_sh.twin_count(torch.tensor(MASK))
    assert got.dtype == torch.int32
    assert int(got) == int(j_sh.twin_count(jnp.asarray(MASK)))
    feats = torch.tensor(X)
    np.testing.assert_allclose(
        t_sh.twin_softmax_pool(torch.tensor(LOGITS), feats).numpy(),
        np.asarray(j_sh.twin_softmax_pool(jnp.asarray(LOGITS),
                                          jnp.asarray(X))),
        rtol=1e-6, atol=1e-7)


def test_gather_and_scatter_rows_match_outside_scope():
    idx = np.array([[3, -1, 10], [11, -12, 0]], np.int32)  # -1 wraps, as jnp
    got = t_sh.twin_gather(torch.tensor(X), torch.tensor(idx), fill=-7.0)
    want = j_sh.twin_gather(jnp.asarray(X), jnp.asarray(idx), fill=-7.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = t_sh.twin_gather(torch.tensor(MASK), torch.tensor(idx[0]),
                           fill=False)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_sh.twin_gather(jnp.asarray(MASK),
                                                 jnp.asarray(idx[0]),
                                                 fill=False)))
    ids = np.array([2, -1, 7, 11, 0], np.int32)  # -1 and 11 are dropped
    rows = RS.normal(size=(5, 3)).astype(np.float32)
    x = torch.tensor(X)
    got = t_sh.twin_scatter_rows(x, torch.tensor(ids), torch.tensor(rows))
    want = j_sh.twin_scatter_rows(jnp.asarray(X), jnp.asarray(ids),
                                  jnp.asarray(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got is x  # written in place: no copy of the buffer


def test_scope_facts_and_nesting():
    with t_sh.twin_scope(10, 3, 4) as s:
        assert t_sh.in_scope() == s
        assert s.axis == t_sh.TWIN_AXIS == j_sh.TWIN_AXIS
        assert not s.exact
        assert t_sh.local_twin_count(99) == 3
        assert t_sh.global_twin_count(99) == 10
        with t_sh.twin_scope(8, 2, 4) as inner:
            assert inner.exact and t_sh.in_scope() == inner
        assert t_sh.in_scope() == s
    assert t_sh.in_scope() is None
    with pytest.raises(RuntimeError, match="twin_scope"):
        t_sh.twin_indices()
    with pytest.raises(RuntimeError, match="twin_scope"):
        t_sh.slice_local(torch.tensor(X))


IN_SCOPE_CALLS = {
    "twin_indices": lambda: t_sh.twin_indices(),
    "mask_twins": lambda: t_sh.mask_twins(torch.tensor(X), 0.0),
    "twin_sum": lambda: t_sh.twin_sum(torch.tensor(X)),
    "twin_count": lambda: t_sh.twin_count(torch.tensor(MASK)),
    "twin_mean": lambda: t_sh.twin_mean(torch.tensor(X)),
    "twin_max": lambda: t_sh.twin_max(torch.tensor(X)),
    "twin_min": lambda: t_sh.twin_min(torch.tensor(X)),
    "twin_std": lambda: t_sh.twin_std(torch.tensor(X)),
    "twin_softmax_pool": lambda: t_sh.twin_softmax_pool(
        torch.tensor(LOGITS), torch.tensor(X)),
    "pmean_in_scope": lambda: t_sh.pmean_in_scope({"a": torch.ones(2)}),
    "stamp_replicated": lambda: t_sh.stamp_replicated({"a": torch.ones(2)}),
    "slice_local": lambda: t_sh.slice_local(torch.tensor(X)),
    "localize": lambda: t_sh.localize(torch.tensor(X)),
    "twin_gather": lambda: t_sh.twin_gather(torch.tensor(X),
                                            torch.tensor([1])),
    "twin_scatter_rows": lambda: t_sh.twin_scatter_rows(
        torch.tensor(X), torch.tensor([1]), torch.ones((1, 3))),
    "segment_reduce": lambda: t_seg.segment_reduce(
        torch.ones(4), torch.zeros(4, dtype=torch.int32), 2),
    "segment_max": lambda: t_seg.segment_max(
        torch.ones(4), torch.zeros(4, dtype=torch.int32), 2),
}


@pytest.mark.parametrize("name", sorted(IN_SCOPE_CALLS))
@pytest.mark.parametrize("exact", [True, False])
def test_in_scope_helpers_raise_a10(name, exact):
    """Never the single-device answer inside a scope, even where N divides
    the mesh and no padding row exists."""
    with t_sh.twin_scope(12 if exact else 11, 3, 4):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            IN_SCOPE_CALLS[name]()
    # outside the scope again, the same call runs
    if name not in ("twin_indices", "slice_local"):
        IN_SCOPE_CALLS[name]()


def test_reference_scope_is_not_touched():
    with t_sh.twin_scope(12, 3, 4):
        assert j_sh.in_scope() is None

"""The port's twin scope (``repro_torch.core.sharding``): outside a scope
each helper is the identity or a plain reduction and matches the reference
on shared numpy inputs (reductions at rtol 1e-6, the rest exactly). Inside
a real scope on 4 gloo ranks (one spawn for the module) every helper, the
segment reductions' ``"auto"`` dispatch and extremes included, gives the
reference's single-device answer on the same global arrays, with N
divisible by the mesh (12) and ragged (11): reductions at rtol 1e-5, the
rest exactly. A scope with no mesh raises, naming it.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharding as j_sh
from repro.kernels import segment_reduce as j_seg_fn
from repro_torch.core import sharding as t_sh
from repro_torch.utils.tree import tree_leaves
from torch_sharding_helpers import BLOCKED, join, scope_ranks, spawn

j_seg = importlib.import_module("repro.kernels.segment_reduce")

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


def _case(n):
    rs = np.random.RandomState(n)
    return {"x": torch.tensor(rs.normal(size=(n, 3)).astype(np.float32)),
            "logits": torch.tensor(rs.normal(size=(n,)).astype(np.float32)),
            "mask": torch.tensor(rs.rand(n) < 0.5),
            "vals": torch.tensor(rs.normal(size=(n,)).astype(np.float32)),
            "ids": torch.tensor(rs.randint(0, 2, n).astype(np.int32)),
            "gidx": torch.tensor([1, n - 1, 0, 7]),
            "sidx": torch.tensor([2, -1, 7, n, 0]),
            "srows": torch.tensor(rs.normal(size=(5, 3)).astype(np.float32))}


CASES = {12: _case(12), 11: _case(11)}


def _single_device(name, c):
    """The reference's single-device answer of each in-scope call."""
    j = {k: jnp.asarray(v.numpy()) for k, v in c.items()}
    n = c["x"].shape[0]
    return {
        "twin_indices": lambda: np.arange(n),
        "mask_twins": lambda: j_sh.mask_twins(j["x"], -5.0),
        "twin_sum": lambda: j_sh.twin_sum(j["x"]),
        "twin_count": lambda: j_sh.twin_count(j["mask"]),
        "twin_mean": lambda: j_sh.twin_mean(j["x"]),
        "twin_max": lambda: j_sh.twin_max(j["x"]),
        "twin_min": lambda: j_sh.twin_min(j["x"]),
        "twin_std": lambda: j_sh.twin_std(j["x"]),
        "twin_softmax_pool": lambda: j_sh.twin_softmax_pool(j["logits"],
                                                            j["x"]),
        # the mean over the 4 ranks of each rank's own value
        "pmean_in_scope": lambda: {"a": np.full(2, 1.5, np.float32)},
        "stamp_replicated": lambda: j_sh.stamp_replicated(
            {"a": jnp.ones(2)}),
        "slice_local": lambda: j["x"],
        "localize": lambda: j["x"],
        "twin_gather": lambda: j_sh.twin_gather(j["x"], j["gidx"],
                                                fill=-7.0),
        "twin_scatter_rows": lambda: j_sh.twin_scatter_rows(
            j["x"], j["sidx"], j["srows"]),
        "segment_reduce": lambda: j_seg_fn(j["vals"], j["ids"], 2),
        "segment_max": lambda: j_seg.segment_max(j["vals"], j["ids"], 2),
    }[name]()


@pytest.fixture(scope="module")
def in_scope_results():
    return spawn(scope_ranks, 4, CASES)


NAMES = sorted(["twin_indices", "mask_twins", "twin_sum", "twin_count",
                "twin_mean", "twin_max", "twin_min", "twin_std",
                "twin_softmax_pool", "pmean_in_scope", "stamp_replicated",
                "slice_local", "localize", "twin_gather", "twin_scatter_rows",
                "segment_reduce", "segment_max"])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("exact", [True, False])
def test_in_scope_helpers_raise_a10(name, exact, in_scope_results):
    """Each helper in a real 4-rank scope gives the single-device answer,
    where N divides the mesh and where padding rows exist; blocked results
    are each rank's block, replicated ones equal on every rank."""
    n = 12 if exact else 11
    want = _single_device(name, CASES[n])
    ranks = [r[(name, n)] for r in in_scope_results]
    if name in BLOCKED:
        got = join(ranks, n)
        full = torch.cat(ranks)
        if name == "mask_twins":  # padding rows hold the fill
            assert bool((full[n:] == -5.0).all())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    for r in ranks[1:]:  # replicated: bitwise equal on every rank
        for a, b in zip(tree_leaves(ranks[0]), tree_leaves(r)):
            assert torch.equal(a, b)
    got = ranks[0]
    if isinstance(got, dict):
        got, want = got["a"], np.asarray(want["a"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_scope_without_a_mesh_names_it():
    with t_sh.twin_scope(12, 3, 4):
        for fn in (t_sh.twin_indices,
                   lambda: t_sh.twin_sum(torch.ones(3)),
                   lambda: t_seg.segment_reduce(
                       torch.ones(3), torch.zeros(3, dtype=torch.int32), 2)):
            with pytest.raises(RuntimeError, match="no twin mesh"):
                fn()


def test_reference_scope_is_not_touched():
    with t_sh.twin_scope(12, 3, 4):
        assert j_sh.in_scope() is None

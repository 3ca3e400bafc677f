"""The port's ``"sharded"`` segment backend and the sharded latency model
(``repro_torch.core.sharding.sharded_*``) on 4 gloo ranks on the CPU,
against the reference's single-device answers on the same global arrays:
the gate's divisible, ragged and empty-shard populations (N, M) = (64, 5),
(37, 5), (5, 3) (``benchmarks/bench_scale.py``'s ``sharded_gate``), at its
rtol 1e-5. One spawn for the module. Also: the card's windowed dispatch
past the kernel's segment ceiling (ROADMAP C1a), the pod means of
``core.hierarchy`` on 3 ranks, and the tree helpers of ``utils.tree``
against the reference.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import latency as j_lat
from repro.utils import tree as j_tree
from repro_torch.utils import tree as t_tree
from torch_sharding_helpers import pod_ranks, segment_ranks, spawn

j_seg = importlib.import_module("repro.kernels.segment_reduce")
t_seg = importlib.import_module("repro_torch.kernels.segment_reduce")

POPULATIONS = [(64, 5), (37, 5), (5, 3)]
G = 3  # groups of the grouped call


def _case(n, m):
    rs = np.random.RandomState(n * 10 + m)
    f32 = np.float32
    return {"values": rs.normal(size=(n, 3)).astype(f32),
            "assoc": rs.randint(0, m, n).astype(np.int32),
            "b": rs.uniform(0.05, 1.0, n).astype(f32),
            "data": rs.uniform(100, 800, n).astype(f32),
            "freqs": rs.uniform(1e9, 4e9, m).astype(f32),
            "up": rs.uniform(1e6, 1e8, m).astype(f32),
            "gvalues": rs.normal(size=(G, n)).astype(f32),
            "gassoc": rs.randint(-1, m + 1, (G, n)).astype(np.int32)}


CASES = [_case(n, m) for n, m in POPULATIONS]


@pytest.fixture(scope="module")
def ranks():
    cases = [{k: torch.tensor(v) for k, v in c.items()} for c in CASES]
    return spawn(segment_ranks, 4, cases)


def _want(c, what):
    j = {k: jnp.asarray(v) for k, v in c.items()}
    m = c["freqs"].shape[0]
    lp = j_lat.LatencyParams()
    args = (j["assoc"], j["b"], j["data"], j["freqs"], j["up"], j["up"])
    return np.asarray({
        "sharded": lambda: j_seg.segment_reduce(j["values"], j["assoc"], m),
        "auto": lambda: j_seg.segment_reduce(j["values"][:, 0], j["assoc"],
                                             m),
        "count": lambda: j_seg.segment_count(j["assoc"], m),
        "max": lambda: j_seg.segment_max(j["values"], j["assoc"], m),
        "min": lambda: j_seg.segment_min(j["values"], j["assoc"], m),
        "grouped": lambda: jnp.stack([
            j_seg.segment_reduce(j["gvalues"][g], j["gassoc"][g], m)
            for g in range(G)]),
        "t_cmp": lambda: j_lat.t_cmp(lp, *args[:4]),
        "t_local_agg": lambda: j_lat.t_local_agg(lp, j["assoc"], j["freqs"]),
        "t_broadcast": lambda: j_lat.t_broadcast(lp, j["assoc"], j["up"], m),
        "round_time": lambda: j_lat.round_time(lp, *args),
        "round_time_per_bs": lambda: j_lat.round_time_per_bs(lp, *args),
        "total_time": lambda: j_lat.total_time(lp, *args),
    }[what]())


WHATS = ["sharded", "auto", "count", "max", "min", "grouped", "t_cmp",
         "t_local_agg", "t_broadcast", "round_time", "round_time_per_bs",
         "total_time"]


@pytest.mark.parametrize("what", WHATS)
@pytest.mark.parametrize("case", range(len(POPULATIONS)),
                         ids=[f"N{n}-M{m}" for n, m in POPULATIONS])
def test_sharded_matches_single_device(case, what, ranks):
    got = [r[case][what] for r in ranks]
    for g in got[1:]:  # replicated: the same bits on every rank
        assert torch.equal(g, got[0])
    np.testing.assert_allclose(got[0].numpy(), _want(CASES[case], what),
                               rtol=1e-5, atol=1e-6)


def test_one_all_reduce_per_scoped_call(ranks):
    """The five scoped segment calls (sum, auto, count, max, min) and the
    grouped one are one all-reduce each."""
    assert {r[c]["calls"] for r in ranks for c in range(3)} == {6}


# ---------------------------------------------------------------------------
# ROADMAP C1a: the card's dispatch by shape
# ---------------------------------------------------------------------------


def test_card_dispatch_is_the_kernel_at_every_segment_count():
    ceiling = t_seg.MAX_SEGMENTS
    assert ceiling == 223
    for m in (1, 5, ceiling, ceiling + 1, 225, 512):
        assert t_seg.resolve_backend(10**6, m, platform="cuda") == "kernel"


@pytest.mark.parametrize("n,m,cap", [(500, 225, 223), (300, 10, 3),
                                     (300, 9, 3), (40, 4, 4)])
def test_segment_windows_match_one_reduction(n, m, cap):
    """The card's launches past the kernel's segment ceiling: windows of at
    most ``cap`` segment ids, here with the kernel's plain version as the
    launch, against the reference's one-hot sum (out-of-range ids
    dropped)."""
    rs = np.random.RandomState(n + m)
    v = rs.normal(size=(n, 3)).astype(np.float32)
    a = rs.randint(-2, m + 3, n).astype(np.int32)
    widths = []

    def launch(values, ids, mw):
        widths.append(mw)
        return t_seg._seg_tiled_plain(values, ids, mw)

    got = t_seg._segment_windows(launch, torch.tensor(v), torch.tensor(a), m,
                                 cap)
    want = j_seg.segment_reduce(jnp.asarray(v), jnp.asarray(a), m,
                                backend="onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert widths == [min(cap, m - lo) for lo in range(0, m, cap)]


def test_migration_flows_past_the_kernel_ceiling_on_the_cpu():
    """migration_flows at n_bs = 15 reduces 225 pair ids; the card runs it
    as two kernel windows (tests/test_torch_cuda_kernels.py)."""
    from repro.core import migration as j_mig
    from repro_torch.core import migration as t_mig

    rs = np.random.RandomState(0)
    old, new = rs.randint(0, 15, 500), rs.randint(0, 15, 500)
    got = t_mig.migration_flows(torch.tensor(old), torch.tensor(new), 15)
    want = j_mig.migration_flows(jnp.asarray(old), jnp.asarray(new), 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# hierarchy's pod means and the tree helpers
# ---------------------------------------------------------------------------


def test_pod_means_average_over_the_ranks():
    rs = np.random.RandomState(5)
    trees = [{"w": torch.tensor(rs.normal(size=(4, 3)).astype(np.float32)),
              "b": torch.tensor(rs.normal(size=(3,)).astype(np.float32))}
             for _ in range(3)]
    out = spawn(pod_ranks, 3, trees)
    for k in ("w", "b"):
        want = np.mean([t[k].numpy() for t in trees], axis=0)
        for r in out:
            for kind in ("intra", "cross"):
                np.testing.assert_allclose(r[kind][k].numpy(), want,
                                           rtol=1e-6, atol=1e-7)


def _trees(seed):
    rs = np.random.RandomState(seed)
    return {"a": rs.normal(size=(3, 2)).astype(np.float32),
            "b": {"c": rs.normal(size=(4,)).astype(np.float32),
                  "n": np.arange(3, dtype=np.int32)}}


@pytest.mark.parametrize("name", ["tree_add", "tree_sub", "tree_scale",
                                  "tree_dot", "tree_norm", "tree_size",
                                  "tree_bytes", "tree_cast", "tree_stack",
                                  "tree_unstack", "tree_zeros_like"])
def test_tree_helpers_match_reference(name):
    a, b = _trees(0), _trees(1)
    ta = t_tree.tree_map(torch.tensor, a)
    tb = t_tree.tree_map(torch.tensor, b)
    ja = {"a": jnp.asarray(a["a"]), "b": {k: jnp.asarray(v)
                                          for k, v in a["b"].items()}}
    jb = {"a": jnp.asarray(b["a"]), "b": {k: jnp.asarray(v)
                                          for k, v in b["b"].items()}}
    got, want = {
        "tree_add": lambda: (t_tree.tree_add(ta, tb), j_tree.tree_add(ja, jb)),
        "tree_sub": lambda: (t_tree.tree_sub(ta, tb), j_tree.tree_sub(ja, jb)),
        "tree_scale": lambda: (t_tree.tree_scale(ta, 0.5),
                               j_tree.tree_scale(ja, 0.5)),
        "tree_dot": lambda: (t_tree.tree_dot(ta, tb), j_tree.tree_dot(ja, jb)),
        "tree_norm": lambda: (t_tree.tree_norm(ta), j_tree.tree_norm(ja)),
        "tree_size": lambda: (t_tree.tree_size(ta), j_tree.tree_size(ja)),
        "tree_bytes": lambda: (t_tree.tree_bytes(ta), j_tree.tree_bytes(ja)),
        "tree_cast": lambda: (t_tree.tree_cast(ta, torch.float16),
                              j_tree.tree_cast(ja, jnp.float16)),
        "tree_stack": lambda: (t_tree.tree_stack([ta, tb]),
                               j_tree.tree_stack([ja, jb])),
        "tree_unstack": lambda: (
            t_tree.tree_unstack(t_tree.tree_stack([ta, tb]), 2),
            j_tree.tree_unstack(j_tree.tree_stack([ja, jb]), 2)),
        "tree_zeros_like": lambda: (t_tree.tree_zeros_like(ta),
                                    j_tree.tree_zeros_like(ja)),
    }[name]()
    if isinstance(want, int):
        assert got == want
        return
    import jax

    gl = t_tree.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(w, np.float64), rtol=1e-6,
                                   atol=1e-6)

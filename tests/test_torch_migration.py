"""Parity of the port's twin migration (``repro_torch.core.migration``) with
the reference on the CPU. The step takes its draws (a (N,) uniform and a
(N, M) Gumbel) as tensors; fed the reference's own ``jax.random`` draws it
gives the same association exactly. Data sizes are whole numbers, so the
per-BS loads are exact sums in any order. Flows, rates and the per-BS
segments are held exactly equal too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import migration as j_mig
from repro_torch.core import migration as t_mig


def _np(x):
    return torch.tensor(np.asarray(x))


def _draws(key, n, m):
    """The reference step's draws, in its key-split order."""
    k_move, k_dst = jax.random.split(key)
    return (_np(jax.random.uniform(k_move, (n,))),
            _np(jax.random.gumbel(k_dst, (n, m))))


def _population(n, m, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, m, n).astype(np.int32),
            rs.randint(50, 2000, n).astype(np.float32))


@pytest.mark.parametrize("n,m,seed", [(50, 4, 0), (301, 7, 1), (64, 2, 2)])
@pytest.mark.parametrize("cfg", [dict(), dict(p_move=0.6, locality=3.0),
                                 dict(p_move=1.0, load_weight=5.0),
                                 dict(p_move=0.0)])
def test_migration_step_exact(n, m, seed, cfg):
    mj, mt = j_mig.MigrationConfig(**cfg), t_mig.MigrationConfig(**cfg)
    assoc, data = _population(n, m, seed)
    key = jax.random.PRNGKey(seed)
    want = j_mig.migration_step(mj, key, jnp.asarray(assoc),
                                jnp.asarray(data), m)
    got = t_mig.migration_step(mt, *_draws(key, n, m), torch.tensor(assoc),
                               torch.tensor(data), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if cfg.get("p_move") == 0.0:
        np.testing.assert_array_equal(got.numpy(), assoc)
    np.testing.assert_array_equal(
        t_mig.migration_flows(torch.tensor(assoc), got, m).numpy(),
        np.asarray(j_mig.migration_flows(jnp.asarray(assoc), want, m)))
    assert float(t_mig.migration_rate(torch.tensor(assoc), got)) == float(
        j_mig.migration_rate(jnp.asarray(assoc), want))


@pytest.mark.parametrize("n,m", [(40, 5), (17, 3), (9, 9)])
def test_bs_segments_and_ring_distance_exact(n, m):
    assoc, _ = _population(n, m, n)
    assoc[:3] = m  # out-of-range ids fall outside every segment
    to, tb = t_mig.bs_segments(torch.tensor(assoc), m)
    jo, jb = j_mig.bs_segments(jnp.asarray(assoc), m)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(np.diff(tb.numpy()),
                                  np.bincount(assoc[assoc < m], minlength=m))
    np.testing.assert_array_equal(t_mig.ring_distance(m).numpy(),
                                  np.asarray(j_mig.ring_distance(m)))


def test_evolve_association_exact():
    n, m, rounds = 80, 5, 4
    mj, mt = (j_mig.MigrationConfig(p_move=0.3),
              t_mig.MigrationConfig(p_move=0.3))
    assoc, data = _population(n, m, 9)
    key = jax.random.PRNGKey(4)
    jf, jt, jr = j_mig.evolve_association(mj, key, jnp.asarray(assoc),
                                          jnp.asarray(data), m, rounds)
    draws = [_draws(k, n, m) for k in jax.random.split(key, rounds)]
    tf, tt, tr = t_mig.evolve_association(
        mt, torch.stack([d[0] for d in draws]),
        torch.stack([d[1] for d in draws]), torch.tensor(assoc),
        torch.tensor(data), m)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_sharded_step_raises():
    """``sharded_migration_step`` on 4 gloo ranks at the gate's divisible,
    ragged and empty-shard populations: the ranks' blocks are the
    reference's single-device step exactly, and padding rows keep the
    out-of-range id M."""
    from torch_sharding_helpers import join, migration_ranks, spawn

    cases, wants = [], []
    for n, m in [(64, 5), (37, 5), (5, 3)]:
        assoc, data = _population(n, m, n)
        key = jax.random.PRNGKey(n)
        mj = j_mig.MigrationConfig(p_move=0.6)
        wants.append(j_mig.migration_step(mj, key, jnp.asarray(assoc),
                                          jnp.asarray(data), m))
        move_u, gumbel = _draws(key, n, m)
        cases.append({"mcfg": t_mig.MigrationConfig(p_move=0.6),
                      "move_u": move_u, "gumbel": gumbel,
                      "assoc": torch.tensor(assoc),
                      "data": torch.tensor(data), "n_bs": m})
    ranks = spawn(migration_ranks, 4, cases)
    for i, (c, want) in enumerate(zip(cases, wants)):
        n = c["assoc"].shape[0]
        blocks = [r[i] for r in ranks]
        np.testing.assert_array_equal(join(blocks, n).numpy(),
                                      np.asarray(want))
        assert bool((torch.cat(blocks)[n:] == c["n_bs"]).all())

"""Parity of the port's chain (consensus core + DPoS ledger) with the
reference: election ties, the verification gate, a whole submit / verify /
produce / audit sequence, and ``hash_pytree`` digests, all exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockchain as j_bc
from repro.core import consensus as j_cons
from repro.models import cnn as j_cnn
from repro_torch.core import blockchain as t_bc
from repro_torch.core import consensus as t_cons


@pytest.mark.parametrize("stakes,k", [
    ([5.0, 20.0, 20.0, 1.0, 30.0], 3),
    ([1.0, 1.0, 1.0, 1.0], 2),
    ([0.0, 2.0, 2.0, 2.0, 0.0, 3.0], 5),
    ([7.0, 7.0], 2),
])
def test_elect_producers_ties(stakes, k):
    got = t_cons.elect_producers(torch.tensor(stakes), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_cons.elect_producers(jnp.asarray(stakes), k)))
    assert got.tolist() == sorted(range(len(stakes)),
                                  key=lambda i: (-stakes[i], i))[:k]


@pytest.mark.parametrize("seed", range(6))
def test_verify_metas_matches(seed):
    rs = np.random.RandomState(seed)
    m = rs.randint(1, 9)
    losses = rs.uniform(0.0, 3.0, m).astype(np.float32)
    losses[rs.rand(m) < 0.3] = 1.25  # ties at the median
    sub = rs.rand(m) < 0.8
    n_cli = rs.randint(1, 6, m).astype(np.float32)
    n_sus = rs.randint(0, 4, m).astype(np.float32)
    group = rs.randint(0, 2, m)
    for kw_j, kw_t in [
        ({}, {}),
        (dict(n_clients=jnp.asarray(n_cli), n_suspect=jnp.asarray(n_sus)),
         dict(n_clients=torch.as_tensor(n_cli),
              n_suspect=torch.as_tensor(n_sus))),
        (dict(group=jnp.asarray(group), n_groups=2),
         dict(group=torch.as_tensor(group), n_groups=2)),
    ]:
        want = np.asarray(j_cons.verify_metas(
            jnp.asarray(losses), jnp.asarray(sub), tolerance=0.5, **kw_j))
        got = t_cons.verify_metas(torch.as_tensor(losses),
                                  torch.as_tensor(sub), tolerance=0.5, **kw_t)
        np.testing.assert_array_equal(got.numpy(), want)


def _params_np(v):
    return {"w": np.full((2, 2), v, np.float32),
            "b": np.arange(3, dtype=np.float32) * v}


def test_chain_sequence_same_verdicts_stakes_and_audit():
    kw = dict(s_ini=9.0, reward=2.0, tolerance=0.5, n_producers=2)
    jc = j_bc.DPoSChain(4, [1.0, 2.0, 2.0, 3.0], **kw)
    tc = t_bc.DPoSChain(4, [1.0, 2.0, 2.0, 3.0], **kw)
    rs = np.random.RandomState(0)
    for r in range(5):
        for s in range(4):
            if rs.rand() < 0.25:
                continue
            loss = float(rs.choice([0.2, 0.6, 1.1, 3.0]))
            p = _params_np(float(r * 4 + s))
            jc.submit_model(s, {k: jnp.asarray(v) for k, v in p.items()}, r,
                            loss)
            tc.submit_model(s, {k: torch.as_tensor(v) for k, v in p.items()},
                            r, loss)
        if r == 2:
            jc.submit_twin_update(1, "ab" * 32, r)
            tc.submit_twin_update(1, "ab" * 32, r)
        assert tc.current_producer() == jc.current_producer()
        assert tc.verify_round() == jc.verify_round()
        assert tc.stakes == jc.stakes
        jb, tb = jc.produce_block(), tc.produce_block()
        assert tb.hash == jb.hash  # same params, same digest, same block
        assert tc.elect_producers() == jc.elect_producers()
    assert tc.validate_chain() and jc.validate_chain()
    for r in range(5):
        assert tc.verified_senders(r) == jc.verified_senders(r)
    blk = tc.blocks[2]
    forged = dataclasses.replace(blk.transactions[0], payload_hash="f" * 64)
    tc.blocks[2] = dataclasses.replace(blk, transactions=(forged,))
    assert not tc.validate_chain()


def test_chain_suspect_meta_gate_matches():
    jc, tc = j_bc.DPoSChain(3, [1.0, 1.0, 1.0]), t_bc.DPoSChain(3, [1.0] * 3)
    for c in (jc, tc):
        c.submit_model(0, {"w": np.zeros(2, np.float32)}, 0, 0.3,
                       n_clients=4, n_suspect=3, dispersion=0.1)
        c.submit_model(1, {"w": np.ones(2, np.float32)}, 0, 0.4,
                       n_clients=4, n_suspect=1, dispersion=0.2)
    assert tc.verify_round() == jc.verify_round() == {0: False, 1: True}


def test_hash_pytree_equals_reference_digest():
    p = j_cnn.init_params(jax.random.PRNGKey(0))
    params_np = {k: np.array(v) for k, v in p.items()}
    want = j_bc.hash_pytree(p)
    assert t_bc.hash_pytree({k: torch.as_tensor(v)
                             for k, v in params_np.items()}) == want
    # key order of the dict does not matter: leaves go in sorted key order
    rev = {k: torch.as_tensor(params_np[k]) for k in reversed(sorted(params_np))}
    assert t_bc.hash_pytree(rev) == want
    assert t_bc.hash_pytree({"a": torch.ones(2)}) != t_bc.hash_pytree(
        {"a": torch.ones(2) + 1e-6})


def _rewrite_consistently(chain, forged_payload):
    """Forge block 0's first transaction and recompute every hash after it,
    so the chain's own hash links still hold."""
    blk = chain.blocks[0]
    forged = dataclasses.replace(blk.transactions[0],
                                 payload_hash=forged_payload)
    blk = dataclasses.replace(blk, transactions=(forged,))
    chain.blocks[0] = dataclasses.replace(blk, hash=blk.compute_hash())
    for i in range(1, len(chain.blocks)):
        b = dataclasses.replace(chain.blocks[i],
                                prev_hash=chain.blocks[i - 1].hash)
        chain.blocks[i] = dataclasses.replace(b, hash=b.compute_hash())


@pytest.mark.parametrize("n_nodes,n_groups", [(5, 2), (4, 2), (7, 3), (3, 1)])
def test_two_tier_chain_matches_reference(n_nodes, n_groups):
    """Committees, verdicts, stakes and anchor hashes equal to the
    reference's over three rounds with poisoned and absent submitters; a
    consistently rewritten tier-1 block breaks the cross-tier checkpoint in
    both."""
    data = [float(5 - i % 5) for i in range(n_nodes)]
    kw = dict(n_groups=n_groups, reward=1.5, tolerance=0.5)
    jc, tc = j_bc.TwoTierChain(n_nodes, data, **kw), \
        t_bc.TwoTierChain(n_nodes, data, **kw)
    assert tc.groups == jc.groups and tc.members == jc.members
    rs = np.random.RandomState(n_nodes)
    for r in range(3):
        for s in range(n_nodes):
            if rs.rand() < 0.2:
                continue
            loss = float(rs.choice([0.2, 0.3, 0.45, 6.0]))
            p = _params_np(float(r * 10 + s))
            meta = dict(n_clients=4, n_suspect=int(rs.randint(0, 4)))
            jc.submit_model(s, {k: jnp.asarray(v) for k, v in p.items()}, r,
                            loss, **meta)
            tc.submit_model(s, {k: torch.as_tensor(v) for k, v in p.items()},
                            r, loss, **meta)
        assert tc.verify_round() == jc.verify_round()
        assert tc.stakes == jc.stakes
        assert tc.produce_round().hash == jc.produce_round().hash
    assert tc.validate() and jc.validate()
    for c in (jc, tc):
        victim = next(ch for ch in c.tier1 if ch.blocks[0].transactions)
        _rewrite_consistently(victim, "e" * 64)
        assert victim.validate_chain()  # its own links hold ...
        assert not c.validate()         # ... the tier-2 checkpoint does not

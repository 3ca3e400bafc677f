"""Permissioned blockchain with DPoS consensus (paper Section II-C), port of
``repro/core/blockchain.py``.

The BSs are the chain nodes. Stake ("training coins") starts proportional to
hosted twin data (Eq. 6) and grows by ``reward`` for each local model that
passes the verification gate: holdout loss within ``tolerance`` of the
round's median, and a cohort that is not majority-suspect. Election and
verification delegate to ``repro_torch.core.consensus`` (fp32), as the
reference delegates to its own consensus core. :class:`DPoSChain` is the host
audit-trail ledger; :class:`TwoTierChain` is the committee ledger of Tang et
al. 2024 built from DPoS chains, its committees from
``consensus.bs_groups``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import consensus as consensus_mod


def _leaves(tree):
    """Leaves in jax.tree_util order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def hash_pytree(tree) -> str:
    """SHA-256 of a parameter dict's bytes, leaves in sorted key order and
    C layout: the same digest the reference gives the same arrays."""
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Transaction:
    kind: str          # dt_model | dt_data | train_model
    sender: int        # BS index
    payload_hash: str
    round: int
    meta: Tuple[Tuple[str, Any], ...] = ()

    def digest(self) -> str:
        return hashlib.sha256(json.dumps(
            [self.kind, self.sender, self.payload_hash, self.round,
             list(self.meta)], sort_keys=True).encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class Block:
    index: int
    prev_hash: str
    producer: int
    transactions: Tuple[Transaction, ...]
    hash: str = ""

    def compute_hash(self) -> str:
        body = json.dumps(
            [self.index, self.prev_hash, self.producer,
             [t.digest() for t in self.transactions]]).encode()
        return hashlib.sha256(body).hexdigest()


GENESIS_HASH = "0" * 64


class DPoSChain:
    """Delegated-Proof-of-Stake permissioned ledger among M BS nodes."""

    def __init__(self, n_nodes: int, twin_data_per_node: Sequence[float],
                 s_ini: float = 100.0, n_producers: int = 3,
                 reward: float = 1.0, tolerance: float = 0.5):
        self.n_nodes = n_nodes
        self.n_producers = min(n_producers, n_nodes)
        self.reward = reward
        self.tolerance = tolerance
        total = float(sum(twin_data_per_node)) or 1.0
        # Eq. 6: initial coins proportional to hosted twin data
        self.stakes = [s_ini * float(d) / total for d in twin_data_per_node]
        # frozen copy: validate_chain replays the stake trajectory from here
        self._initial_stakes = list(self.stakes)
        self.blocks: List[Block] = []
        self.pending: List[Transaction] = []
        self._round = 0

    # ---- stake / producers -------------------------------------------------
    def _elect_from(self, stakes: Sequence[float]) -> List[int]:
        """Election delegated to the vectorized core (stable top-k by stake,
        smallest index wins ties) — host live path, the device ChainState,
        and the validate_chain replay all share one rule, in fp32."""
        idx = consensus_mod.elect_producers(
            torch.tensor(list(stakes), dtype=torch.float32), self.n_producers)
        return [int(i) for i in idx.tolist()]

    def elect_producers(self) -> List[int]:
        """Stake-weighted vote: every node votes its coins; in the permission
        model each node backs candidates proportionally to candidate stake,
        so the elected set is the top-M_p by stake (deterministic ties)."""
        return self._elect_from(self.stakes)

    def current_producer(self) -> int:
        producers = self.elect_producers()
        return producers[len(self.blocks) % len(producers)]

    # ---- transactions ------------------------------------------------------
    def submit_model(self, sender: int, params, round_: int,
                     holdout_loss: float, *,
                     n_clients: Optional[int] = None,
                     n_suspect: Optional[int] = None,
                     dispersion: Optional[float] = None) -> Transaction:
        """Record a per-BS aggregated model for verification.

        The optional keyword meta comes from the robust aggregation layer
        (``repro_torch.core.faults``): ``n_clients``/``n_suspect`` are the BS
        cohort size and how many of its client updates the aggregator
        discarded as outliers, ``dispersion`` the cohort's update-norm std
        (``faults.update_dispersion``). :meth:`verify_round`
        rejects majority-suspect cohorts regardless of loss; omitting the
        kwargs reproduces the original loss-only transaction exactly.
        """
        meta = [("holdout_loss", float(holdout_loss))]
        if n_clients is not None:
            meta.append(("n_clients", int(n_clients)))
        if n_suspect is not None:
            meta.append(("n_suspect", int(n_suspect)))
        if dispersion is not None:
            meta.append(("dispersion", float(dispersion)))
        tx = Transaction("train_model", sender, hash_pytree(params), round_,
                         meta=tuple(meta))
        self.pending.append(tx)
        return tx

    def submit_twin_update(self, sender: int, payload_hash: str,
                           round_: int, kind: str = "dt_data") -> Transaction:
        tx = Transaction(kind, sender, payload_hash, round_)
        self.pending.append(tx)
        return tx

    # ---- verification gate -------------------------------------------------
    def verify_round(self) -> Dict[int, bool]:
        """Quality-gate all pending train_model txs of the current round:
        accepted iff holdout loss <= median + tolerance AND the submitting
        cohort is not majority-suspect (``n_suspect * 2 > n_clients`` per
        the aggregator's malicious flags — a BS whose update was mostly
        formed by discarded-outlier clients is rejected even when its loss
        sneaks under the gate, excluding it from the Eq. 4/5 weights).
        Winners earn coins (paper: 'coins will be awarded'), losers 'get
        no pay'.

        The predicate itself is evaluated by the vectorized core
        (``repro_torch.core.consensus.verify_metas``, fp32) over the stacked
        per-sender metas, and each pending train_model tx is stamped with
        its verdict (``("verified", bool)`` meta entry) *before* block
        production, so the outcome is on-chain — :meth:`verified_senders`
        filters on it and :meth:`validate_chain` replays rewards from it.
        """
        model_txs = [t for t in self.pending if t.kind == "train_model"]
        metas = {t.sender: dict(t.meta) for t in model_txs}
        if not metas:
            return {}
        senders = sorted(metas)
        # host suspect rule needs both counters; encode "missing" as 0/0
        have = [s for s in senders
                if metas[s].get("n_clients") is not None
                and metas[s].get("n_suspect") is not None]
        v = consensus_mod.verify_metas(
            torch.tensor([metas[s]["holdout_loss"] for s in senders],
                         dtype=torch.float32),
            torch.ones((len(senders),), dtype=torch.bool),
            tolerance=self.tolerance,
            n_clients=torch.tensor(
                [metas[s]["n_clients"] if s in have else 0
                 for s in senders], dtype=torch.float32),
            n_suspect=torch.tensor(
                [metas[s]["n_suspect"] if s in have else 0
                 for s in senders], dtype=torch.float32))
        verdicts = {s: bool(ok) for s, ok in zip(senders, v.tolist())}
        for i, t in enumerate(self.pending):
            if t.kind == "train_model" and t.sender in verdicts:
                self.pending[i] = dataclasses.replace(
                    t, meta=t.meta + (("verified", verdicts[t.sender]),))
        for s, ok in verdicts.items():
            if ok:
                self.stakes[s] += self.reward
        return verdicts

    # ---- block production --------------------------------------------------
    def produce_block(self) -> Block:
        producer = self.current_producer()
        prev = self.blocks[-1].hash if self.blocks else GENESIS_HASH
        blk = Block(index=len(self.blocks), prev_hash=prev, producer=producer,
                    transactions=tuple(self.pending))
        blk = dataclasses.replace(blk, hash=blk.compute_hash())
        self.blocks.append(blk)
        self.pending = []
        self._round += 1
        return blk

    # ---- audit ---------------------------------------------------------------
    def validate_chain(self) -> bool:
        """Full audit: hash-chain integrity plus producer eligibility.

        The producer check is exact, not heuristic: starting from the Eq. 6
        initial stakes, the recorded verdicts of each block's transactions
        replay the reward trajectory, so the auditor re-derives the elected
        producer set at every height (rewards land in ``verify_round``
        *before* ``produce_block``, hence each block's own verdicts apply
        before its producer is checked). A forged producer — even with a
        correctly recomputed hash chain — fails the audit.
        """
        prev = GENESIS_HASH
        stakes = list(self._initial_stakes)
        for i, blk in enumerate(self.blocks):
            if blk.index != i or blk.prev_hash != prev:
                return False
            if blk.compute_hash() != blk.hash:
                return False
            for t in blk.transactions:
                if (t.kind == "train_model"
                        and dict(t.meta).get("verified", False)):
                    stakes[t.sender] += self.reward
            producers = self._elect_from(stakes)
            if blk.producer != producers[i % len(producers)]:
                return False
            prev = blk.hash
        return True

    def verified_senders(self, round_: int) -> List[int]:
        """Senders whose round ``round_`` model *passed* verification, read
        from the on-chain verdict meta (a rejected or never-verified
        submission is excluded)."""
        out = []
        for blk in self.blocks:
            for t in blk.transactions:
                if (t.kind == "train_model" and t.round == round_
                        and dict(t.meta).get("verified", False)):
                    out.append(t.sender)
        return out


class TwoTierChain:
    """Multi-tier ledger (Tang et al. 2024, arXiv 2411.02323), host side.

    Tier 1 is one :class:`DPoSChain` per committee of BSs (the committee map
    is ``consensus.bs_groups``); tier 2 is a :class:`DPoSChain` over the G
    committees, staked with each committee's total twin data. Each
    :meth:`produce_round` produces every committee's block and anchors its
    hash on tier 2 as a ``checkpoint`` transaction, so rewriting a tier-1
    block breaks the cross-tier check even when that committee's own hash
    chain is consistently rewritten. Its latency is
    ``consensus.t_consensus_two_tier``.
    """

    def __init__(self, n_nodes: int, twin_data_per_node: Sequence[float],
                 n_groups: int = 2, **chain_kw):
        self.n_nodes = n_nodes
        self.n_groups = max(1, min(n_groups, n_nodes))
        self.groups = [int(g) for g in
                       consensus_mod.bs_groups(n_nodes, self.n_groups).tolist()]
        self.members: List[List[int]] = [
            [i for i in range(n_nodes) if self.groups[i] == g]
            for g in range(self.n_groups)]
        self._local = {i: self.members[self.groups[i]].index(i)
                       for i in range(n_nodes)}
        self.tier1 = [DPoSChain(len(m), [twin_data_per_node[i] for i in m],
                                **chain_kw)
                      for m in self.members]
        self.tier2 = DPoSChain(
            self.n_groups,
            [sum(float(twin_data_per_node[i]) for i in m) or 1.0
             for m in self.members],
            **chain_kw)
        self._round = 0

    def _chain_of(self, sender: int) -> DPoSChain:
        return self.tier1[self.groups[sender]]

    def submit_model(self, sender: int, params, round_: int,
                     holdout_loss: float, **meta_kw) -> Transaction:
        """Route to the sender's committee chain (local sender index)."""
        return self._chain_of(sender).submit_model(
            self._local[sender], params, round_, holdout_loss, **meta_kw)

    def verify_round(self) -> Dict[int, bool]:
        """Per-committee verification against each committee's own median,
        verdicts keyed by global BS id."""
        verdicts: Dict[int, bool] = {}
        for g, chain in enumerate(self.tier1):
            for local, ok in chain.verify_round().items():
                verdicts[self.members[g][local]] = ok
        return verdicts

    def produce_round(self) -> Block:
        """Produce every tier-1 block, checkpoint each on tier 2, produce
        the tier-2 block; returns that anchor block."""
        for g, chain in enumerate(self.tier1):
            blk = chain.produce_block()
            self.tier2.submit_twin_update(g, blk.hash, self._round,
                                          kind="checkpoint")
        anchor = self.tier2.produce_block()
        self._round += 1
        return anchor

    def validate(self) -> bool:
        """Audit every tier and the cross-tier checkpoints: the r-th
        checkpoint of committee g must be the hash of g's r-th block."""
        if not self.tier2.validate_chain():
            return False
        if any(not c.validate_chain() for c in self.tier1):
            return False
        for r, blk in enumerate(self.tier2.blocks):
            cps = {t.sender: t.payload_hash for t in blk.transactions
                   if t.kind == "checkpoint"}
            for g, chain in enumerate(self.tier1):
                if r >= len(chain.blocks):
                    return False
                if cps.get(g) != chain.blocks[r].hash:
                    return False
        return True

    @property
    def stakes(self) -> List[float]:
        """Global per-BS stake view, assembled from the committees."""
        out = [0.0] * self.n_nodes
        for g, chain in enumerate(self.tier1):
            for local, s in enumerate(chain.stakes):
                out[self.members[g][local]] = s
        return out

"""The DTWN federated system driver (paper Sections II + V), port of
``repro/fl/server.py``.

One round: twin shards -> local training of the sampled twins (client) ->
Eq. 4 BS aggregation of the stacked twin models on the device
(``hierarchy.bs_aggregate_stacked``) -> DPoS chain verification -> Eq. 5 (or
Eq. 3 through the FedAvg kernel) global model -> latency bill (Eqs. 12-17).

The port runs the fedavg path. The options outside it raise
``NotImplementedError`` naming the ROADMAP item that ports them: robust
aggregators, attackers, faults and the consensus workload (A5) and scenario
rows (A8). The MARL round hook ``marl_actions`` comes with A7.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import association as assoc_mod
from repro_torch.core import blockchain as bc
from repro_torch.core import comms, hierarchy, latency
from repro_torch.core.marl.env import bs_frequencies
from repro_torch.fl.client import make_local_trainer
from repro_torch.fl.partition import dirichlet_partition, iid_partition
from repro_torch.models import cnn
from repro_torch.utils.device import default_device


@dataclasses.dataclass
class FLConfig:
    n_users: int = 100
    n_bs: int = 5
    bs_freqs_ghz: tuple = (2.6, 1.8, 3.6, 2.4, 2.4)
    local_iters: int = 5
    lr: float = 0.05
    batch_size: int = 32
    use_kernel_aggregation: bool = False  # Eq. 3 through the FedAvg kernel
    weighted_global: bool = False         # Eq. 5 unweighted (paper) by default
    partition: str = "iid"       # "iid" | "dirichlet"
    alpha: Optional[float] = None  # Dirichlet label-skew concentration
    # the fault/adversary and consensus axes of the reference: only their
    # neutral values are ported, any other raises (ROADMAP A5)
    aggregator: str = "fedavg"
    malicious_frac: float = 0.0
    faults: Optional[object] = None
    consensus: Optional[object] = None


def _check_ported(cfg: FLConfig, scenario) -> None:
    unported = []
    if cfg.aggregator != "fedavg":
        unported.append(f"aggregator={cfg.aggregator!r} (ROADMAP A5)")
    if cfg.malicious_frac > 0.0:
        unported.append("malicious_frac > 0 (ROADMAP A5)")
    if cfg.faults is not None:
        unported.append("faults (ROADMAP A5)")
    if cfg.consensus is not None:
        unported.append("consensus (ROADMAP A5)")
    if scenario is not None:
        unported.append("scenario rows (ROADMAP A8)")
    if unported:
        raise NotImplementedError("not ported yet: " + ", ".join(unported))


class DTWNSystem:
    """Host-level simulation of the DTWN stack for the paper's CNN.

    ``data`` is ``cifar10.load()``'s ``((x, y), (x_test, y_test), name)`` in
    numpy; both splits are moved to ``device`` once and every batch is
    gathered there. ``init_state`` (``{"params", "dist", "h_up",
    "h_down"}`` as numpy arrays, see ``repro_torch.bridge``) starts the
    system from given CNN weights and channels, for instance a reference
    system's; without it they are drawn from ``torch.Generator`` seeded
    with ``seed``. The host RNG streams are the reference's: ``seed`` for
    the partition, ``seed + 1`` for the participants, ``seed + 31`` for the
    evaluation batches and ``round * 1000 + u`` for twin ``u``'s batches.
    ``device`` defaults to ``cuda`` and raises when no card is present.
    """

    def __init__(self, cfg: FLConfig, data, seed: int = 0, *,
                 init_state: Optional[dict] = None, device=None,
                 scenario=None):
        _check_ported(cfg, scenario)
        self.device = default_device(device)
        (self.x, self.y), (self.x_test, self.y_test), self.dataset = data
        self.cfg = cfg
        n_samples = self.x.shape[0]
        if cfg.partition == "dirichlet":
            self.shards = dirichlet_partition(
                self.y, cfg.n_users,
                alpha=0.5 if cfg.alpha is None else cfg.alpha, seed=seed)
        else:
            self.shards = iid_partition(n_samples, cfg.n_users, seed=seed)
        self.data_sizes = np.asarray([s.size for s in self.shards],
                                     np.float32)
        # the frequency table cycles past its length (the env's law)
        self.freqs = bs_frequencies(cfg).numpy()
        self.trainer = make_local_trainer(cnn.loss_fn, lr=cfg.lr)
        self.wireless = comms.WirelessConfig(n_bs=cfg.n_bs)
        self.lat = latency.LatencyParams()
        self.chain = bc.DPoSChain(
            cfg.n_bs,
            twin_data_per_node=[1.0] * cfg.n_bs,  # re-staked after association
            n_producers=min(3, cfg.n_bs))
        if init_state is None:
            gen = torch.Generator().manual_seed(seed)
            self.params = cnn.init_params(gen, device=self.device)
            self.dist = comms.sample_distances(self.wireless, gen, self.device)
            self.h_up = comms.sample_channel(self.wireless, gen, self.device)
            self.h_down = comms.sample_channel(self.wireless, gen, self.device)
        else:
            st = bridge.state_from_numpy(
                init_state["params"], init_state["dist"], init_state["h_up"],
                init_state["h_down"], self.device)
            self.params = st["params"]
            self.dist, self.h_up, self.h_down = (st["dist"], st["h_up"],
                                                 st["h_down"])
        self._round = 0
        self._rng = np.random.RandomState(seed + 1)
        # evaluation draws from its own stream, so the number of eval calls
        # never changes which twins train later
        self._eval_rng = np.random.RandomState(seed + 31)
        self._x_dev = torch.as_tensor(self.x, device=self.device)
        self._y_dev = torch.as_tensor(self.y, device=self.device).long()
        self._x_test_dev = torch.as_tensor(self.x_test, device=self.device)
        self._y_test_dev = torch.as_tensor(self.y_test, device=self.device).long()
        self._freqs_dev = torch.as_tensor(self.freqs, device=self.device)
        self._sizes_dev = torch.as_tensor(self.data_sizes, device=self.device)

    # ------------------------------------------------------------------
    def _eval_batch(self, n: int) -> dict:
        n = min(n, self.x_test.shape[0])
        idx = self._eval_rng.choice(self.x_test.shape[0], size=n,
                                    replace=False)
        take = torch.as_tensor(idx, device=self.device)
        return {"images": self._x_test_dev[take],
                "labels": self._y_test_dev[take]}

    def holdout_loss(self, params, n: int = 512) -> float:
        with torch.no_grad():
            return float(cnn.loss_fn(params, self._eval_batch(n)))

    def test_accuracy(self, n: int = 1000) -> float:
        with torch.no_grad():
            return float(cnn.accuracy(self.params, self._eval_batch(n)))

    # ------------------------------------------------------------------
    def run_round(self, assoc, b: Optional[np.ndarray] = None,
                  tau: Optional[np.ndarray] = None,
                  participating_users: int = 10,
                  active: Optional[np.ndarray] = None) -> Dict:
        """One federated round under a given edge association.

        ``assoc`` (n_users,) int, a numpy array or a tensor.
        ``participating_users``: twins trained this round (sampled); latency
        is accounted for the full association as in the paper. ``active``
        (n_users,) bool restamps inactive twins to the out-of-range BS id M
        before the latency bill and never samples them for training.
        """
        cfg = self.cfg
        M = cfg.n_bs
        dev = self.device
        assoc = (assoc.cpu().numpy() if isinstance(assoc, torch.Tensor)
                 else np.asarray(assoc))
        if b is None:
            b = np.full(cfg.n_users, 0.5, np.float32)
        if tau is None:
            tau = np.full((M, self.wireless.n_subchannels), 1.0 / M,
                          np.float32)
        if active is not None:
            active = np.asarray(active, bool)
            assoc = np.where(active, assoc, M)
            b = np.where(active, b, 0.0).astype(np.float32)

        # --- wireless + latency accounting (Eqs. 7-17) ---
        up = comms.uplink_rate(
            self.wireless, torch.as_tensor(tau, dtype=torch.float32,
                                           device=dev), self.h_up, self.dist)
        down = comms.downlink_rate(self.wireless, self.h_down, self.dist)
        t_round = float(latency.round_time(
            self.lat, torch.as_tensor(assoc, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev),
            self._sizes_dev, self._freqs_dev, up, down))
        t_consensus = float(latency.consensus_term(self.lat, down,
                                                   self._freqs_dev))

        # --- local training on a sample of twins ---
        if active is None:
            chosen = self._rng.choice(
                cfg.n_users, size=min(participating_users, cfg.n_users),
                replace=False)
        else:
            pool = np.flatnonzero(active)
            chosen = self._rng.choice(
                pool, size=min(participating_users, pool.size),
                replace=False)
        twin_models, twin_sizes, twin_bs = [], [], []
        for u in chosen:
            shard = self.shards[u]
            # clamp to the shard, so the batch trained is the b*D_j billed
            n_use = min(shard.size, max(8, int(b[u] * shard.size)))
            p_u, _ = self.trainer(
                self.params, self._x_dev, self._y_dev,
                batch_size=cfg.batch_size, local_iters=cfg.local_iters,
                seed=self._round * 1000 + int(u), rows=shard[:n_use])
            twin_models.append(p_u)
            twin_sizes.append(float(self.data_sizes[u]))
            twin_bs.append(int(assoc[u]))

        # --- Eq. 4: per-BS aggregation + blockchain transactions ---
        bs_models, bs_sizes = [], []
        if twin_models:
            stacked = {k: torch.stack([m[k] for m in twin_models])
                       for k in twin_models[0]}
            per_bs_tree, bs_w = hierarchy.bs_aggregate_stacked(
                stacked, torch.tensor(twin_sizes, dtype=torch.float32,
                                      device=dev),
                torch.tensor(twin_bs, dtype=torch.int32, device=dev), M)
            bs_w_host = bs_w.cpu().numpy()
            for j in range(M):
                if bs_w_host[j] <= 0.0:
                    continue
                agg = {k: v[j] for k, v in per_bs_tree.items()}
                hl = self.holdout_loss(agg, n=256)
                self.chain.submit_model(j, agg, self._round, hl)
                bs_models.append((j, agg))
                bs_sizes.append(float(bs_w_host[j]))

        # --- DPoS verification + block production ---
        verdicts = self.chain.verify_round()
        self.chain.produce_block()
        accepted = [i for i, (j, _) in enumerate(bs_models)
                    if verdicts.get(j, True)]
        if accepted:
            models = [bs_models[i][1] for i in accepted]
            sizes = [bs_sizes[i] for i in accepted]
            if cfg.use_kernel_aggregation:
                self.params = hierarchy.fedavg_flat_kernel(models, sizes)
            else:
                self.params = hierarchy.global_aggregate(
                    models, sizes, weighted_global=cfg.weighted_global)

        self._round += 1
        return {
            "round": self._round,
            "chosen": [int(u) for u in chosen],
            "round_time_s": t_round,
            "consensus_time_s": t_consensus,
            "loss": self.holdout_loss(self.params),
            "n_verified": sum(verdicts.values()) if verdicts else 0,
            "n_submitted": len(verdicts),
            "n_suspect": 0,
            "chain_valid": self.chain.validate_chain(),
        }


# The full-width round that ``chip_smoke.py`` drives and
# ``repro_torch.launch.profile_round`` profiles: ``FLConfig()`` defaults,
# the association below and this many participating twins.
EXAMPLE_PARTICIPATING_USERS = 10


def example_association(system: DTWNSystem) -> torch.Tensor:
    """The association ``examples/fl_cifar10.py`` drives a round with:
    greedy, with the example's fixed 1e8 bit/s uplink estimate, computed on
    the system's device."""
    dev = system.device
    return assoc_mod.greedy_association(
        system.lat, torch.as_tensor(system.data_sizes, device=dev),
        torch.as_tensor(system.freqs, device=dev),
        torch.full((system.cfg.n_bs,), 1e8, device=dev))

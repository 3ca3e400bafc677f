"""The DTWN federated system driver (paper Sections II + V), port of
``repro/fl/server.py``.

One round: twin shards -> local training of the sampled twins (client; the
malicious ones through an attack trainer) -> Eq. 4 BS aggregation of the
stacked twin models on the device (``hierarchy.bs_aggregate_stacked``, or a
robust rule of ``core.faults``) -> DPoS chain verification -> Eq. 5 (or Eq. 3
through the FedAvg kernel) global model -> latency bill (Eqs. 12-17, with
stragglers and outages under ``faults`` and the PBFT block term under
``consensus``).

``scenario=(batch, i)`` runs scenario row ``i`` of a
``repro_torch.core.scenario.ScenarioBatch``: its twin data sizes, its
Dirichlet partition, and its fault and consensus axes. ``marl_actions`` is
the MARL controller's round hook: a trained MADDPG agent's decoded
association, batch fractions and bandwidth for the system's current state.
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
from repro_torch.core import consensus as consensus_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core.marl.env import bs_frequencies
from repro_torch.fl.client import make_attack_trainer, make_local_trainer
from repro_torch.fl.partition import (dirichlet_partition, iid_partition,
                                      scenario_partition)
from repro_torch.models import cnn
from repro_torch.utils.device import default_device, deterministic_cudnn


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
    # fault/adversary axis (core.faults + the attack trainers of fl.client)
    aggregator: str = "fedavg"   # "fedavg" | "trimmed_mean" | "krum"
    trim_k: int = 1              # trimmed mean: extremes peeled per side
    krum_f: int = 1              # krum: clients dropped per BS cohort
    malicious_frac: float = 0.0  # Bernoulli attacker fraction
    attack: str = "label_flip"   # "label_flip" | "model_replacement"
    attack_boost: float = 5.0    # model-replacement update scaling
    faults: Optional[faults_mod.FaultConfig] = None  # stragglers, outages
    # consensus axis: the PBFT block term of Eq. 17, and the chain's stake,
    # reward and tolerance
    consensus: Optional[consensus_mod.ConsensusConfig] = None


class DTWNSystem:
    """Host-level simulation of the DTWN stack for the paper's CNN.

    ``data`` is ``cifar10.load()``'s ``((x, y), (x_test, y_test), name)`` in
    numpy; both splits are moved to ``device`` once and every batch is
    gathered there. ``init_state`` (``{"params", "dist", "h_up",
    "h_down"}`` as numpy arrays, see ``repro_torch.bridge``) starts the
    system from given CNN weights and channels, for instance a reference
    system's; without it they are drawn from ``torch.Generator`` seeded
    with ``seed``. The host RNG streams are the reference's: ``seed`` for
    the partition, ``seed + 1`` for the participants, ``seed + 7`` for the
    attacker draw (only when ``malicious_frac > 0``), ``seed + 31`` for the
    evaluation batches and ``round * 1000 + u`` for twin ``u``'s batches.
    The fault draws come from ``torch.Generator(seed + 17)``, one round's
    in a fixed order (``faults.sample_fault_draws``): the reference folds
    the round into a ``jax.random`` key, which torch cannot repeat.
    ``device`` defaults to ``cuda`` and raises when no card is present.

    ``scenario=(batch, i)`` takes row ``i`` of a scenario batch: the twin
    data sizes D_j are the row's population (``scenario.population_row``,
    the realization the runners score at the same population size), the
    dataset is carved in proportion by ``scenario_partition`` with the
    row's label skew, the row's malicious mask and straggler/outage rates
    override the config's (``fault_row``), and its byzantine fraction,
    quorum and block size override ``cfg.consensus`` (``consensus_row``).
    ``scenario_draws`` (a ``scenario.ScenarioDraws`` whose ``data_u`` and
    ``mal_u`` hold the batch's population and malicious uniforms) replaces
    the row's own streams, for instance with a reference run's draws.
    """

    def __init__(self, cfg: FLConfig, data, seed: int = 0, *,
                 init_state: Optional[dict] = None, device=None,
                 scenario=None, scenario_draws=None):
        self.device = default_device(device)
        (self.x, self.y), (self.x_test, self.y_test), self.dataset = data
        self.cfg = cfg
        n_samples = self.x.shape[0]
        # fault axis: a scenario row may override the config's rates
        self._row_straggler: Optional[float] = None
        self._row_outage: Optional[float] = None
        self.malicious = np.zeros(cfg.n_users, bool)
        if scenario is not None:
            from repro_torch.core.scenario import (consensus_row, fault_row,
                                                   population_row)

            batch, row = scenario
            rd = scenario_draws
            sizes, alpha = population_row(
                batch, row, cfg.n_users,
                data_u=None if rd is None or rd.data_u is None
                else rd.data_u[row])
            self.shards = scenario_partition(n_samples, sizes, labels=self.y,
                                             alpha=alpha, seed=seed)
            self.data_sizes = np.asarray(sizes, np.float32)
            mal, s_rate, o_rate = fault_row(
                batch, row, cfg.n_users,
                mal_u=None if rd is None or rd.mal_u is None
                else rd.mal_u[row])
            if mal is not None:
                self.malicious = mal
            self._row_straggler, self._row_outage = s_rate, o_rate
            if cfg.consensus is not None:
                byz, qf, blk = consensus_row(batch, row)
                over = {k: v for k, v in (("byzantine_frac", byz),
                                          ("quorum_f", qf),
                                          ("block_size_bits", blk))
                        if v is not None}
                if over:
                    self.cfg = cfg = dataclasses.replace(
                        cfg, consensus=dataclasses.replace(cfg.consensus,
                                                           **over))
        else:
            self.shards = (
                dirichlet_partition(
                    self.y, cfg.n_users,
                    alpha=0.5 if cfg.alpha is None else cfg.alpha, seed=seed)
                if cfg.partition == "dirichlet"
                else iid_partition(n_samples, cfg.n_users, seed=seed))
            self.data_sizes = np.asarray([s.size for s in self.shards],
                                         np.float32)
        # the frequency table cycles past its length (the env's law)
        self.freqs = bs_frequencies(cfg).numpy()
        self.trainer = make_local_trainer(cnn.loss_fn, lr=cfg.lr)
        # the attacker draw only when asked for (and no scenario row set
        # the mask): a zero fraction consumes no host RNG
        if not self.malicious.any() and cfg.malicious_frac > 0.0:
            draw_rng = np.random.RandomState(seed + 7)
            self.malicious = (draw_rng.uniform(size=cfg.n_users)
                              < cfg.malicious_frac)
        self._attacker = None  # built lazily: self.malicious is mutable
        self._fault_gen = torch.Generator().manual_seed(seed + 17)
        self.wireless = comms.WirelessConfig(n_bs=cfg.n_bs)
        self.lat = latency.LatencyParams()
        # the ledger shares stake init, reward and tolerance with the
        # consensus workload when it is on
        chain_kw = {} if cfg.consensus is None else dict(
            s_ini=cfg.consensus.s_ini, reward=cfg.consensus.reward,
            tolerance=cfg.consensus.tolerance)
        self.chain = bc.DPoSChain(
            cfg.n_bs,
            twin_data_per_node=[1.0] * cfg.n_bs,  # re-staked after association
            n_producers=min(3, cfg.n_bs), **chain_kw)
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
    @property
    def attacker(self):
        """The malicious local trainer (``FLConfig.attack``), built on first
        use so ``self.malicious`` can be set after init."""
        if self._attacker is None:
            self._attacker = make_attack_trainer(
                cnn.loss_fn, attack=self.cfg.attack, lr=self.cfg.lr,
                boost=self.cfg.attack_boost)
        return self._attacker

    def round_fault_draws(self) -> faults_mod.FaultDraws:
        """This round's straggler and outage draws, from the system's fault
        generator."""
        return faults_mod.sample_fault_draws(
            self._fault_gen, self.cfg.n_users, self.cfg.n_bs, self.device)

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
    def marl_env_config(self):
        """EnvConfig mirroring this system: N twins, M BSs, the frequency
        table, and the observation's data range set from the actual shard
        sizes (twin features then stay in the range a trained policy saw)."""
        from repro_torch.core.marl.env import EnvConfig

        return EnvConfig(n_twins=self.cfg.n_users, n_bs=self.cfg.n_bs,
                         bs_freqs_ghz=tuple(self.cfg.bs_freqs_ghz),
                         wireless=self.wireless,
                         data_min=float(self.data_sizes.min()),
                         data_max=float(self.data_sizes.max()))

    def marl_actions(self, agent, *, policy: str = "factorized",
                     env_cfg=None):
        """FL round hook: the controller's actions for the system's CURRENT
        state (channels, distances, frequencies, twin data sizes, a
        round-robin association in the observation), from the MADDPG
        ``agent`` (on this system's device) under the named policy, decoded
        onto the (18) feasible set. Returns host numpy ``(assoc (N,), b
        (N,), tau (M, C))`` for :meth:`run_round`."""
        from repro_torch.core.marl import env as env_mod
        from repro_torch.core.marl.ddpg import act

        cfg = env_cfg if env_cfg is not None else self.marl_env_config()
        st = env_mod.EnvState(
            freqs=self._freqs_dev, data_sizes=self._sizes_dev,
            h_up=self.h_up, h_down=self.h_down, dist=self.dist,
            assoc=assoc_mod.average_association(
                cfg.n_twins, cfg.n_bs, self.device).to(torch.int32),
            t=self._round)
        with torch.no_grad():
            a = act(cfg, agent, env_mod.observe(cfg, st), policy=policy)
            assoc, b, tau = env_mod.decode_actions(cfg, a)
        return assoc.cpu().numpy(), b.cpu().numpy(), tau.cpu().numpy()

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
        assoc_t = torch.as_tensor(assoc, device=dev)
        b_t = torch.as_tensor(b, dtype=torch.float32, device=dev)
        if cfg.faults is not None:
            # straggler slowdowns inflate b, outages gate the uplink
            t_round = float(faults_mod.faulty_round_time(
                self.lat, cfg.faults, self.round_fault_draws(), assoc_t, b_t,
                self._sizes_dev, self._freqs_dev, up, down,
                straggler_rate=self._row_straggler,
                outage_rate=self._row_outage, consensus=cfg.consensus))
        else:
            t_round = float(latency.round_time(
                self.lat, assoc_t, b_t, self._sizes_dev, self._freqs_dev, up,
                down, consensus=cfg.consensus))
        # the block term inside t_round: Eq. 16, or the PBFT model
        t_consensus = float(latency.consensus_term(
            self.lat, down, self._freqs_dev, cfg.consensus))

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
        with deterministic_cudnn():  # the same bits every run (C1b)
            for u in chosen:
                shard = self.shards[u]
                # clamp to the shard, so the batch trained is the b*D_j
                # billed
                n_use = min(shard.size, max(8, int(b[u] * shard.size)))
                trainer = (self.attacker if self.malicious[u]
                           else self.trainer)
                p_u, _ = trainer(
                    self.params, self._x_dev, self._y_dev,
                    batch_size=cfg.batch_size, local_iters=cfg.local_iters,
                    seed=self._round * 1000 + int(u), rows=shard[:n_use])
                twin_models.append(p_u)
                twin_sizes.append(float(self.data_sizes[u]))
                twin_bs.append(int(assoc[u]))

        # --- Eq. 4: per-BS aggregation + blockchain transactions ---
        bs_models, bs_sizes = [], []
        n_suspect_total = 0
        if twin_models:
            stacked = {k: torch.stack([m[k] for m in twin_models])
                       for k in twin_models[0]}
            sizes_dev = torch.tensor(twin_sizes, dtype=torch.float32,
                                     device=dev)
            assoc_dev = torch.tensor(twin_bs, dtype=torch.int32, device=dev)
            robust = cfg.aggregator != "fedavg"
            if robust:
                # the robust rule; survivor fractions feed the suspect gate
                per_bs_tree, bs_w, survivor = \
                    faults_mod.robust_bs_aggregate_stacked(
                        stacked, sizes_dev, assoc_dev, M,
                        aggregator=cfg.aggregator, trim_k=cfg.trim_k,
                        krum_f=cfg.krum_f)
                n_cli, n_sus = faults_mod.suspect_counts(survivor, assoc_dev,
                                                         M)
                disp = faults_mod.update_dispersion(stacked, assoc_dev, M)
                n_cli, n_sus, disp = (t.cpu().numpy()
                                      for t in (n_cli, n_sus, disp))
                n_suspect_total = int(n_sus.sum())
            else:
                per_bs_tree, bs_w = hierarchy.bs_aggregate_stacked(
                    stacked, sizes_dev, assoc_dev, M)
            bs_w_host = bs_w.cpu().numpy()
            for j in range(M):
                if bs_w_host[j] <= 0.0:
                    continue
                agg = {k: v[j] for k, v in per_bs_tree.items()}
                hl = self.holdout_loss(agg, n=256)
                meta = {} if not robust else dict(
                    n_clients=int(n_cli[j]), n_suspect=int(n_sus[j]),
                    dispersion=float(disp[j]))
                self.chain.submit_model(j, agg, self._round, hl, **meta)
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
            "n_suspect": n_suspect_total,
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

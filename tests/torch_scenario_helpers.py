"""Shared pieces of the scenario, streamed-FL and serve parity tests
(``tests/test_torch_{scenario,stream,serve}.py``): matching configs, and
the reference's own ``jax.random`` draws, derived in the reference's key
folds and split orders, as the port's draw tuples (``ScenarioDraws``,
``RoundDraws``)."""
import jax
import numpy as np
import torch

from repro.core import scenario as j_scn
from repro.core.consensus import ConsensusConfig as JCons
from repro.core.faults import FaultConfig as JFaults
from repro.core.marl import env as j_env
from repro.core.migration import MigrationConfig as JMig
from repro_torch import bridge
from repro_torch.core import scenario as t_scn
from repro_torch.core import serve as t_serve
from repro_torch.core.consensus import ConsensusConfig as TCons
from repro_torch.core.faults import FaultConfig as TFaults
from repro_torch.core.marl import env as t_env
from repro_torch.core.migration import MigrationConfig as TMig
from torch_marl_helpers import step_draws, t

KEY = jax.random.PRNGKey(0)
SMALL = dict(n_twins=12, n_bs=3, bs_freqs_ghz=(2.6, 1.8, 3.6))

# the workload axes of the runners and the serve loop, by name:
# (reference config, port config)
AXES = {
    "faults": (JFaults(0.3, 0.2, 0.25), TFaults(0.3, 0.2, 0.25)),
    "migration": (JMig(0.4, 1.5, 0.8), TMig(0.4, 1.5, 0.8)),
    "consensus": (JCons(quorum_f=1), TCons(quorum_f=1)),
}
ALL_AXES = dict(straggler=(0.1, 0.4), outage=(0.05, 0.3),
                byzantine=(0.0, 0.4), quorum=(0.0, 2.0),
                block_size=(1e6, 8e6))


def axis_cfgs(axis=None, **kw):
    """(reference EnvConfig, port EnvConfig) at ``SMALL`` with one axis
    (``"faults"``, ``"migration"``, ``"consensus"``) or ``"all"`` set."""
    names = list(AXES) if axis == "all" else ([] if axis in (None, "baseline")
                                              else [axis])
    jk = {a: AXES[a][0] for a in names}
    tk = {a: AXES[a][1] for a in names}
    kw = {**SMALL, **kw}
    return j_env.EnvConfig(**kw, **jk), t_env.EnvConfig(**kw, **tk)


def batches(n=3, **axes):
    """(reference ScenarioBatch, the port's bridged copy)."""
    jb = j_scn.make_batch(KEY, n, **axes)
    return jb, bridge.scenario_batch_from_numpy(
        jax.tree_util.tree_map(np.asarray, jb))


def _fold_split(key, fold, n):
    return jax.random.split(jax.random.fold_in(key, fold), n)


def row_draws(cfg, key, parts, n_rounds=0):
    """One row's draws of the named parts (``scenario.row_draws``), derived
    from the row key as the reference's runners derive them: a dict of
    ``ScenarioDraws`` fields (CPU tensors, no scenario axis)."""
    n, m, c = cfg.n_twins, cfg.n_bs, cfg.wl.n_subchannels
    d = {}
    if "realization" in parts:
        ks = jax.random.split(key, 4)
        d.update(data_u=t(jax.random.uniform(ks[0], (n,))),
                 up=t(jax.random.exponential(ks[1], (m, c))),
                 down=t(jax.random.exponential(ks[2], (m, c))),
                 dist_u=t(jax.random.uniform(ks[3], (m,))))
    if "random" in parts:
        d["rand_assoc"] = t(jax.random.randint(jax.random.fold_in(key, 1),
                                               (n,), 0, m)).long()
    if "rollout" in parts:
        steps = [step_draws(cfg, k) for k in _fold_split(key, 2, n_rounds)]
        d["steps"] = t_env.StepDraws(*(None if f[0] is None
                                       else torch.stack(f)
                                       for f in zip(*steps)))
    if "migration" in parts:
        mv, gb = [], []
        for k in _fold_split(key, 3, n_rounds):
            k_move, k_dst = jax.random.split(k)
            mv.append(t(jax.random.uniform(k_move, (n,))))
            gb.append(t(jax.random.gumbel(k_dst, (n, m))))
        d["move_u"], d["gumbel"] = torch.stack(mv), torch.stack(gb)
    if "outage_init" in parts:
        d["outage0_u"] = t(jax.random.uniform(jax.random.fold_in(key, 4),
                                              (m,)))
    if "faults" in parts:
        su, se, ou = [], [], []
        for k in _fold_split(key, 5, n_rounds):
            k_slow, k_out = jax.random.split(k)
            k_mask, k_mag = jax.random.split(k_slow)
            su.append(t(jax.random.uniform(k_mask, (n,))))
            se.append(t(jax.random.exponential(k_mag, (n,))))
            ou.append(t(jax.random.uniform(k_out, (m,))))
        d["slow_u"], d["slow_exp"], d["outage_u"] = (torch.stack(x) for x
                                                     in (su, se, ou))
    if "byzantine" in parts:
        d["byz_u"] = t(jax.random.uniform(jax.random.fold_in(key, 6), (m,)))
    if "malicious" in parts:
        d["mal_u"] = t(jax.random.uniform(jax.random.fold_in(key, 7), (n,)))
    if "chain" in parts:
        d["sub_z"] = torch.stack([t(jax.random.normal(k, (m,)))
                                  for k in _fold_split(key, 8, n_rounds)])
    return d


def scenario_draws(cfg, jbatch, parts, n_rounds=0):
    """The batch's ``ScenarioDraws`` from the reference's row keys."""
    rows = [row_draws(cfg, k, parts, n_rounds) for k in jbatch.key]

    def stack(vals):
        if isinstance(vals[0], tuple):
            return type(vals[0])(*(None if f[0] is None else torch.stack(f)
                                   for f in zip(*vals)))
        return torch.stack(vals)

    return t_scn.ScenarioDraws(**{k: stack([r[k] for r in rows])
                                  for k in rows[0]})


def init_draws(cfg, key):
    """``serve_init``'s draws from the row key: the realization, the outage
    init (fold 4) and the byzantine mask (fold 6)."""
    return t_scn.ScenarioDraws(**row_draws(
        cfg, key, ("realization", "outage_init", "byzantine")))


def round_draws(cfg, scfg, key, n_rounds):
    """``serve.stream_keys(key, n_rounds)``'s draws as a port ``RoundDraws``
    stack: the runners' folds 3, 5 and 8, churn (fold 11: ``split(k, 4)``
    of leave/join/data uniforms and the association) and dynamics (fold
    12: ``env_evolve``'s ``split(k, 3)``)."""
    parts = [p for p, on in (("migration", cfg.migration),
                             ("faults", cfg.faults),
                             ("chain", cfg.consensus)) if on is not None]
    d = row_draws(cfg, key, parts, n_rounds)
    n, m, c = cfg.n_twins, cfg.n_bs, cfg.wl.n_subchannels
    if scfg.join_rate > 0 or scfg.leave_rate > 0:
        cols = [[], [], [], []]
        for k in _fold_split(key, 11, n_rounds):
            k_leave, k_join, k_data, k_assoc = jax.random.split(k, 4)
            for col, x in zip(cols, (
                    jax.random.uniform(k_leave, (n,)),
                    jax.random.uniform(k_join, (n,)),
                    jax.random.uniform(k_data, (n,)),
                    jax.random.randint(k_assoc, (n,), 0, m))):
                col.append(t(x))
        d["leave_u"], d["join_u"], d["new_data_u"], d["new_assoc"] = (
            torch.stack(x) for x in cols)
    if scfg.evolve_channels:
        cols = [[], [], []]
        for k in _fold_split(key, 12, n_rounds):
            ks = jax.random.split(k, 3)
            for col, x in zip(cols, (
                    jax.random.normal(ks[0], (m,)),
                    jax.random.exponential(ks[1], (m, c)),
                    jax.random.exponential(ks[2], (m, c)))):
                col.append(t(x))
        d["jitter"], d["up"], d["down"] = (torch.stack(x) for x in cols)
    return t_serve.RoundDraws(**d)


def knob_rows(jbatch, tbatch, jcfg, tcfg, i):
    """Row ``i``'s ``StreamKnobs`` in both packages, with the configs'
    fallbacks."""
    jk = j_scn.stream_knobs(jbatch, fcfg=jcfg.faults, ccfg=jcfg.consensus,
                            lat=jcfg.lat)
    tk = t_scn.stream_knobs(tbatch, fcfg=tcfg.faults, ccfg=tcfg.consensus,
                            lat=tcfg.lat)
    return j_scn.knob_row(jk, i), t_scn.knob_row(tk, i)


def pin_backend(monkeypatch, name):
    """Send every ``"auto"`` segment reduction to the backend ``name``."""
    import importlib

    sr = importlib.import_module("repro_torch.kernels.segment_reduce")
    monkeypatch.setattr(sr, "resolve_backend", lambda *a, **k: name)


def counting_kernel(monkeypatch):
    """Force the kernel backend on the CPU (its plain version) and count
    its calls, as launches on the card: returns the list of calls."""
    import importlib

    sr = importlib.import_module("repro_torch.kernels.segment_reduce")
    kernel = sr._IMPLS["kernel"]
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return kernel(*a, **k)

    monkeypatch.setitem(sr._IMPLS, "kernel", counted)
    pin_backend(monkeypatch, "kernel")
    return calls

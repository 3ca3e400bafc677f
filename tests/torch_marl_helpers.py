"""Shared pieces of the MARL parity tests (``tests/test_torch_marl_*.py``):
matching reference and port configs, and the reference's own ``jax.random``
draws in the reference's key-split order, as the port's draw tuples."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import consensus as j_cons
from repro.core import faults as j_faults
from repro.core import migration as j_mig
from repro.core.marl import env as j_env
from repro_torch import bridge
from repro_torch.core import consensus as t_cons
from repro_torch.core import faults as t_faults
from repro_torch.core import migration as t_mig
from repro_torch.core.marl import env as t_env
from repro_torch.core.marl.spaces import Action

KEY = jax.random.PRNGKey(7)
SMALL = dict(n_twins=12, n_bs=3, bs_freqs_ghz=(2.6, 1.8, 3.6))

# the env's optional workloads, by name: (reference config, port config)
OPTIONS = {
    "plain": {},
    "migration": {"migration": (j_mig.MigrationConfig(p_move=0.5),
                                t_mig.MigrationConfig(p_move=0.5))},
    "faults": {"faults": (j_faults.FaultConfig(straggler_rate=0.3,
                                               outage_rate=0.3),
                          t_faults.FaultConfig(straggler_rate=0.3,
                                               outage_rate=0.3))},
    "consensus": {"consensus": (
        j_cons.ConsensusConfig(quorum_f=1, byzantine_frac=0.3),
        t_cons.ConsensusConfig(quorum_f=1, byzantine_frac=0.3))},
}


def t(x):
    """A jax or numpy array as a CPU tensor."""
    return torch.tensor(np.asarray(x))


def cfgs(option="plain", **kw):
    """(reference EnvConfig, port EnvConfig) with the same fields."""
    opt = OPTIONS[option]
    jk = {k: v[0] for k, v in opt.items()}
    tk = {k: v[1] for k, v in opt.items()}
    return j_env.EnvConfig(**kw, **jk), t_env.EnvConfig(**kw, **tk)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def env_state(st_j):
    return bridge.env_state_from_numpy(tree_np(st_j), "cpu")


def reset_draws(cfg, key, *, soft=False):
    """``env_reset``'s (or ``env_soft_reset``'s) draws from ``key``."""
    m, c = cfg.n_bs, cfg.wl.n_subchannels
    if soft:
        k_up, k_down, k_dist = jax.random.split(key, 3)
        data_u = None
    else:
        k_data, k_up, k_down, k_dist, _ = jax.random.split(key, 5)
        data_u = t(jax.random.uniform(k_data, (cfg.n_twins,)))
    return t_env.ResetDraws(up=t(jax.random.exponential(k_up, (m, c))),
                            down=t(jax.random.exponential(k_down, (m, c))),
                            dist_u=t(jax.random.uniform(k_dist, (m,))),
                            data_u=data_u)


def step_draws(cfg, key):
    """``env_step``'s draws from ``key``: the dynamics split, then the
    dedicated folds of migration (3), faults (4) and consensus (5)."""
    n, m, c = cfg.n_twins, cfg.n_bs, cfg.wl.n_subchannels
    k_jit, k_up, k_down = jax.random.split(key, 3)
    d = {"jitter": t(jax.random.normal(k_jit, (m,))),
         "up": t(jax.random.exponential(k_up, (m, c))),
         "down": t(jax.random.exponential(k_down, (m, c)))}
    if cfg.migration is not None:
        k_move, k_dst = jax.random.split(jax.random.fold_in(key, 3))
        d["move_u"] = t(jax.random.uniform(k_move, (n,)))
        d["gumbel"] = t(jax.random.gumbel(k_dst, (n, m)))
    if cfg.faults is not None:
        k_slow, k_bad = jax.random.split(jax.random.fold_in(key, 4))
        k_mask, k_mag = jax.random.split(k_slow)
        d["slow_u"] = t(jax.random.uniform(k_mask, (n,)))
        d["slow_exp"] = t(jax.random.exponential(k_mag, (n,)))
        d["outage_u"] = t(jax.random.uniform(k_bad, (m,)))
    if cfg.consensus is not None:
        k_byz, k_sub = jax.random.split(jax.random.fold_in(key, 5))
        d["byz_u"] = t(jax.random.uniform(k_byz, (m,)))
        d["sub_z"] = t(jax.random.normal(k_sub, (m,)))
    return t_env.StepDraws(**d)


def ou_draws(noise_j, key):
    """``ou_step``'s normals from ``key``: one split key a leaf."""
    leaves, treedef = jax.tree_util.tree_flatten(noise_j)
    keys = jax.random.split(key, len(leaves))
    eps = [t(jax.random.normal(k, jnp.shape(x))) for x, k in zip(leaves, keys)]
    return Action(*eps)


def random_action(cfg, rs, lo=-1.0, hi=1.0):
    """A joint Action of uniforms in [lo, hi), as numpy arrays."""
    m, n, c = cfg.n_bs, cfg.n_twins, cfg.wl.n_subchannels
    f = np.float32
    return (rs.uniform(lo, hi, (m, n)).astype(f), rs.uniform(lo, hi, m).astype(f),
            rs.uniform(lo, hi, (m, c)).astype(f))

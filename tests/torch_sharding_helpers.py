"""Rank bodies and spawn helpers of the port's twin-mesh tests.

Each ``*_ranks`` function runs on every rank of a gloo mesh on the CPU
(``spawn``: ``repro_torch.launch.mesh.spawn_twin_ranks`` with one thread a
rank) and returns what the test compares: replicated results whole, and
each rank's block of a twin-blocked result (``join`` puts the blocks back
together). The module imports torch and the port only, so a rank starts
without JAX.
"""
import importlib

import torch

from repro_torch.core import faults, hierarchy, latency, migration, scenario
from repro_torch.core import serve, sharding as sh
from repro_torch.core.marl import ddpg, env as env_mod, spaces
from repro_torch.fl import stream
from repro_torch.launch.mesh import spawn_twin_ranks

seg = importlib.import_module("repro_torch.kernels.segment_reduce")
train_mod = importlib.import_module("repro_torch.core.marl.train")


def spawn(fn, n_shards, *args):
    """``fn(mesh, *args)`` on ``n_shards`` gloo ranks on the CPU; the
    ranks' results, rank by rank."""
    return spawn_twin_ranks(fn, n_shards, backend="gloo", device="cpu",
                            args=args)


def join(blocks, n, axis=0):
    """The global array (true extent ``n``) of the ranks' blocks."""
    return torch.cat([torch.as_tensor(b) for b in blocks],
                     dim=axis).narrow(axis, 0, n)


def _ts(mesh):
    torch.set_num_threads(1)
    return sh.TwinSharding(mesh)


# ---------------------------------------------------------------------------
# the scope's helpers
# ---------------------------------------------------------------------------

BLOCKED = {"twin_indices", "mask_twins", "slice_local", "localize",
           "twin_scatter_rows"}


def scope_calls(c):
    """The in-scope calls of the scope test on this rank, from the global
    arrays of case ``c``."""
    loc = sh.slice_local
    return {
        "twin_indices": lambda: sh.twin_indices(),
        "mask_twins": lambda: sh.mask_twins(loc(c["x"]), -5.0),
        "twin_sum": lambda: sh.twin_sum(loc(c["x"])),
        "twin_count": lambda: sh.twin_count(loc(c["mask"])),
        "twin_mean": lambda: sh.twin_mean(loc(c["x"])),
        "twin_max": lambda: sh.twin_max(loc(c["x"])),
        "twin_min": lambda: sh.twin_min(loc(c["x"])),
        "twin_std": lambda: sh.twin_std(loc(c["x"])),
        "twin_softmax_pool": lambda: sh.twin_softmax_pool(
            loc(c["logits"]), loc(c["x"])),
        "pmean_in_scope": lambda: sh.pmean_in_scope(
            {"a": torch.full((2,), float(sh.in_scope().rank))}),
        "stamp_replicated": lambda: sh.stamp_replicated(
            {"a": torch.ones(2)}),
        "slice_local": lambda: loc(c["x"]),
        "localize": lambda: sh.localize(c["x"]),
        "twin_gather": lambda: sh.twin_gather(loc(c["x"]), c["gidx"],
                                              fill=-7.0),
        "twin_scatter_rows": lambda: sh.twin_scatter_rows(
            loc(c["x"]), c["sidx"], c["srows"]),
        "segment_reduce": lambda: seg.segment_reduce(
            loc(c["vals"]), loc(c["ids"], fill=2), 2),
        "segment_max": lambda: seg.segment_max(
            loc(c["vals"]), loc(c["ids"], fill=2), 2),
    }


def scope_ranks(mesh, cases):
    ts = _ts(mesh)
    out = {}
    for n, c in cases.items():
        with ts.scope(n):
            for name, fn in scope_calls(c).items():
                out[(name, n)] = fn()
    return out


# ---------------------------------------------------------------------------
# the segment backend and the latency wrappers
# ---------------------------------------------------------------------------


def segment_ranks(mesh, cases):
    ts = _ts(mesh)
    lp = latency.LatencyParams()
    outs = []
    for c in cases:
        n, m = c["assoc"].shape[0], c["freqs"].shape[0]
        r = {}
        sh.ALL_REDUCE.reset()
        with ts.scope(n):
            v = sh.slice_local(c["values"])
            a = sh.slice_local(c["assoc"], fill=m)
            r["sharded"] = seg.segment_reduce(v, a, m, backend="sharded")
            r["auto"] = seg.segment_reduce(v[:, 0], a, m)
            r["count"] = seg.segment_count(a, m)
            r["max"] = seg.segment_max(v, a, m)
            r["min"] = seg.segment_min(v, a, m)
            r["grouped"] = seg.segment_reduce_grouped(
                sh.slice_local(c["gvalues"], axis=1),
                sh.slice_local(c["gassoc"], axis=1, fill=m), m)
        r["calls"] = sh.ALL_REDUCE.calls
        args = (c["assoc"], c["b"], c["data"], c["freqs"], c["up"], c["up"])
        r["t_cmp"] = sh.sharded_t_cmp(ts, lp, *args[:4])
        r["t_local_agg"] = sh.sharded_t_local_agg(ts, lp, c["assoc"],
                                                  c["freqs"])
        r["t_broadcast"] = sh.sharded_t_broadcast(ts, lp, c["assoc"],
                                                  c["up"], m)
        r["round_time"] = sh.sharded_round_time(ts, lp, *args)
        r["round_time_per_bs"] = sh.sharded_round_time_per_bs(ts, lp, *args)
        r["total_time"] = sh.sharded_total_time(ts, lp, *args)
        outs.append(r)
    return outs


# ---------------------------------------------------------------------------
# faults and migration
# ---------------------------------------------------------------------------


def fault_ranks(mesh, cases):
    ts = _ts(mesh)
    lp = latency.LatencyParams()
    outs = []
    for c in cases:
        fcfg = c["fcfg"]
        slow, mal = faults.sharded_fault_draws(
            ts, fcfg, c["draws"].slow_u, c["draws"].slow_exp, c["mal_u"])
        t = faults.sharded_faulty_round_time(
            ts, lp, fcfg, c["draws"], c["assoc"], c["b"], c["data"],
            c["freqs"], c["up"], c["down"])
        outs.append({"slow": slow, "mal": mal, "t": t})
    return outs


def migration_ranks(mesh, cases):
    ts = _ts(mesh)
    return [migration.sharded_migration_step(
        ts, c["mcfg"], c["move_u"], c["gumbel"], c["assoc"], c["data"],
        c["n_bs"]) for c in cases]


# ---------------------------------------------------------------------------
# the env, the encode, the gradients and the trainer
# ---------------------------------------------------------------------------


def env_ranks(mesh, cases):
    ts = _ts(mesh)
    outs = {}
    for name, c in cases.items():
        cfg = c["cfg"]
        st = env_mod.sharded_env_reset(ts, cfg, c["reset"])
        obs = env_mod.sharded_observe(ts, cfg, st)
        st2, r, info = env_mod.sharded_env_step(ts, cfg, st, c["action"],
                                                c["step"])
        obs2 = env_mod.sharded_observe(ts, cfg, st2)
        outs[name] = {"data": st.data_sizes, "assoc0": st.assoc,
                      "bs_feats": obs.bs_feats, "twin_feats": obs.twin_feats,
                      "reward": r, "info": info, "assoc": st2.assoc,
                      "bs_feats2": obs2.bs_feats,
                      "chain": None if st2.chain is None else st2.chain}
    return outs


def encode_ranks(mesh, cfg, scores, twin_feats, b_ctl, tau):
    ts = _ts(mesh)
    with ts.scope(cfg.n_twins):
        a = spaces.Action(scores=sh.slice_local(scores, axis=-1),
                          b_ctl=b_ctl, tau=tau)
        tf = sh.slice_local(twin_feats)
        return {"enc": spaces.encode_action(cfg, a, tf),
                "pool": spaces.pool_twins(tf)}


def grad_ranks(mesh, cfg, dcfg, agent, batch, twin_feats):
    """One MADDPG update in the rank's scope: each rank's own gradients
    (``raw``) and their mean (``pmean_in_scope``), critic and actor, and
    the state ``maddpg_update`` returns (its momenta are the clipped mean
    gradients)."""
    ts = _ts(mesh)
    with ts.scope(cfg.n_twins):
        tf = sh.slice_local(twin_feats)
        _, cg = ddpg.critic_loss_and_grads(cfg, dcfg, agent, batch, tf)
        _, ag = ddpg.actor_loss_and_grads(cfg, dcfg, agent.actor,
                                          agent.critic, batch[0], tf)
        new, metrics = ddpg.maddpg_update(cfg, dcfg, agent, batch, tf)
        mean = {"critic": sh.pmean_in_scope(list(cg)),
                "actor": sh.pmean_in_scope(list(ag))}
    sh.assert_replicated(new, ts)
    return {"critic_raw": list(cg), "actor_raw": list(ag), **mean,
            "update": new, "metrics": metrics}


def train_ranks(mesh, cfg, dcfg, tcfg, seed, state0, step_draws):
    """``train_sharded`` from ``seed``; then ``train_step`` in the rank's
    scope from the global state ``state0`` on each step's global draws
    (the reference's), with the association gathered after every step."""
    ts = _ts(mesh)
    st, trace = train_mod.train_sharded(ts, cfg, dcfg, tcfg, seed)
    sh.assert_replicated([st.agent, st.buf], ts)
    out = {"trace": trace, "actor": st.agent.actor, "data": st.env.data_sizes,
           "metrics": [], "assoc": []}
    n, m = cfg.n_twins, cfg.n_bs
    with ts.scope(n):
        env = state0.env._replace(
            data_sizes=sh.slice_local(state0.env.data_sizes, fill=0.0),
            assoc=sh.slice_local(state0.env.assoc, fill=m))
        st = state0._replace(
            env=env, obs=env_mod.observe(cfg, env),
            noise=state0.noise._replace(
                scores=sh.slice_local(state0.noise.scores, axis=-1)))
        for i, d in enumerate(step_draws):
            d = d._replace(noise=d.noise._replace(
                scores=sh.slice_local(d.noise.scores, axis=-1)))
            st, metrics = train_mod.train_step(cfg, dcfg, tcfg, st, i, d)
            out["metrics"].append(metrics)
            out["assoc"].append(sh.unshard_tree(st.env.assoc,
                                                sh.P(sh.TWIN_AXIS), n))
    sh.assert_replicated([st.agent, st.buf], ts)
    out.update(agent=st.agent, buf=st.buf, replicated=True)
    return out


# ---------------------------------------------------------------------------
# the runners, streamed FL, the serve loop and the pod means
# ---------------------------------------------------------------------------


def runner_ranks(mesh, cfg, configs, batch, draws, n_rounds):
    ts = _ts(mesh)
    return {
        "baselines": scenario.run_baselines_sharded(ts, cfg, batch,
                                                    draws["baselines"]),
        "migration": scenario.run_migration_sharded(
            ts, cfg, configs["migration"], batch, n_rounds,
            draws["migration"]),
        "faults": scenario.run_faults_sharded(
            ts, cfg, configs["faults"], batch, n_rounds, draws["faults"]),
        "consensus": scenario.run_consensus_sharded(
            ts, cfg, configs["consensus"], batch, n_rounds,
            draws["consensus"]),
    }


def fl_round_ranks(mesh, fcfg, data, params, active, data_sizes, assoc,
                   malicious, plans, n_bs):
    """``fl_init`` and one ``fl_round`` a plan row in the rank's scope;
    the metrics of each round, and the global model and buffers after."""
    ts = _ts(mesh)
    n = active.shape[0]
    metrics = []
    with ts.scope(n):
        act = sh.slice_local(active, fill=False)
        fl = stream.fl_init(fcfg, None, data, act, params=params,
                            malicious=malicious, device="cpu")
        for plan in plans:
            fl, m = stream.fl_round(
                fcfg, fl, plan, active=act,
                data_sizes=sh.slice_local(data_sizes, fill=0.0),
                assoc=sh.slice_local(assoc, fill=n_bs), n_bs=n_bs)
            metrics.append(m)
        bufs = sh.unshard_tree({"p": fl.twin_params, "m": fl.twin_mom},
                               sh.P(sh.TWIN_AXIS), n)
    sh.assert_replicated(fl.params, ts)
    return {"metrics": metrics, "params": fl.params, **bufs}


def serve_ranks(mesh, cfg, scfg, row, init_draws, draws, n_live, agent,
                replay_dims):
    """The serve loop in the rank's layout from the global init and round
    draws, with ``agent`` and an empty replay of ``replay_dims`` attached
    (policy mode) when given; blocking rounds."""
    from repro_torch.core.marl import replay

    ts = _ts(mesh)
    st = serve.make_serve_init(cfg, scfg, ts, n_live=n_live)(
        row, draws=init_draws, device="cpu")
    if agent is not None:
        st = st._replace(agent=agent,
                         buf=replay.replay_init(16, *replay_dims))
    st, m = serve.serve_rounds(cfg, scfg, st, draws, row, ts=ts,
                               overlap=False)
    sh.assert_replicated([st.env.freqs, st.env.h_up, st.bad, st.byz,
                          st.env.chain, st.agent, st.buf], ts)
    with ts.scope(cfg.n_twins):
        twin = sh.unshard_tree({"active": st.active, "assoc": st.env.assoc,
                                "data": st.env.data_sizes},
                               sh.P(sh.TWIN_AXIS), cfg.n_twins)
    return {"metrics": m, "round": st.round,
            "buf_size": None if st.buf is None else st.buf.size, **twin}


def pod_ranks(mesh, trees):
    torch.set_num_threads(1)
    mine = trees[mesh.rank]
    return {"intra": hierarchy.intra_pod_mean(mine),
            "cross": hierarchy.cross_pod_mean(mine)}

"""Always-on DTWN serving CLI (port of ``repro/launch/serve_dtwn.py``):
stream rounds over a live twin population.

Runs the :mod:`repro_torch.core.serve` loop (state written in place,
population churn, overlapped rounds) and reports the rate (rounds/s) and
the streamed round metrics. Runs on ``cuda`` unless ``--device cpu`` is
given, and raises when no card is present. ``--shards N`` (N > 1) spawns N
ranks of a twin mesh (``repro_torch.launch.mesh``) over the
``--dist-backend`` (default nccl on cuda, gloo on cpu): nccl takes one card
per rank, gloo runs on the CPU and puts several ranks on one card. Every
rank streams its twin block; rank 0 prints.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve_dtwn --capacity 1000 \\
      --rounds 50 --join 0.02 --leave 0.02 --faults --migration
  PYTHONPATH=src python -m repro_torch.launch.serve_dtwn --capacity 10000 \\
      --rounds 20 --fl --fl-model tiny --join 0.01 --leave 0.01
  PYTHONPATH=src python -m repro_torch.launch.serve_dtwn --capacity 64 \\
      --rounds 10 --fl --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_dtwn --capacity 64 \\
      --rounds 10 --fl --shards 2 --device cpu
"""
import argparse
import contextlib
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=1000,
                    help="twin-buffer capacity (= EnvConfig.n_twins)")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--live", type=int, default=0,
                    help="initial live population (default: capacity)")
    ap.add_argument("--n-bs", type=int, default=10)
    ap.add_argument("--join", type=float, default=0.0,
                    help="per-round per-empty-slot admission probability")
    ap.add_argument("--leave", type=float, default=0.0,
                    help="per-round per-live-twin departure probability")
    ap.add_argument("--migration", action="store_true",
                    help="enable the between-round migration kernel")
    ap.add_argument("--faults", action="store_true",
                    help="enable straggler/outage injection")
    ap.add_argument("--consensus", action="store_true",
                    help="enable the PBFT chain workload")
    ap.add_argument("--policy", default=None,
                    help="MARL policy for association (e.g. factorized); "
                         "default streams round-robin")
    ap.add_argument("--evolve", action="store_true",
                    help="advance channel/frequency dynamics each round")
    ap.add_argument("--fl", action="store_true",
                    help="stream the FL workload through the round step "
                         "(per-twin model buffers + Eq. 4/5 on the device)")
    ap.add_argument("--fl-model", default="tiny",
                    help="model to train: tiny (N=10^4+ scale) or cnn")
    ap.add_argument("--fl-participants", type=int, default=10,
                    help="twins trained per round")
    ap.add_argument("--fl-iters", type=int, default=5,
                    help="local SGD iterations per participant per round")
    ap.add_argument("--fl-batch", type=int, default=8)
    ap.add_argument("--fl-aggregator", default="fedavg",
                    help="fedavg | trimmed_mean | krum")
    ap.add_argument("--fl-shard-size", type=int, default=128,
                    help="per-twin cyclic shard size over the dataset")
    ap.add_argument("--fl-train", type=int, default=4096,
                    help="training samples to load (CIFAR-10 or the "
                         "deterministic synthetic fallback)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="synchronise after every round")
    ap.add_argument("--shards", type=int, default=0,
                    help="twin shards: ranks of a twin mesh (0 or 1: none)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="collectives of the twin mesh (default: nccl on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(argv=None, *, final_state: bool = False, inputs=None) -> dict:
    """Stream as ``main`` does and return rank 0's result: ``rc``, the
    metrics as numpy arrays and ``counts`` (the segment kernel's launches
    and the all-reduce calls and bytes of the rank, warm-up round included,
    and the timed stream's wall seconds).

    ``final_state=True`` adds ``state``: the final state's twin leaves
    (``active``, ``assoc``, ``data_sizes`` and, with ``--fl``, the model
    buffers) at their global extent, after checking that the replicated
    leaves are bitwise equal on every rank; over a mesh that costs an
    all-reduce of every twin leaf. ``inputs`` replaces the scenario row's
    knobs and streams: a dict with the knob ``row``, the init's
    ``ScenarioDraws`` (``init_draws``) and the stream's ``RoundDraws``
    (``draws``), as ``serve_init`` and ``serve_rounds`` take them."""
    args = parse_args(argv)
    if args.shards <= 1:
        return _stream(args, None, final_state, inputs)
    from repro_torch.launch import mesh
    from repro_torch.utils.device import default_device

    dev = default_device(args.device)
    if dev.type == "cuda":  # build once here; the ranks load the library
        from repro_torch.kernels.segment_reduce import KERNEL

        KERNEL.lib()
    return mesh.spawn_twin_ranks(_stream_rank, args.shards,
                                 backend=args.dist_backend, device=dev,
                                 args=(args, final_state, inputs))[0]


def _stream_rank(twin_mesh, args, final_state, inputs):
    from repro_torch.core.sharding import TwinSharding

    out = _stream(args, TwinSharding(twin_mesh), final_state, inputs)
    return out if twin_mesh.rank == 0 else None


def _stream(args, ts, final_state=False, inputs=None) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import scenario, serve, sharding
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.marl.env import EnvConfig
    from repro_torch.core.migration import MigrationConfig
    from repro_torch.utils.device import default_device

    from repro_torch.kernels.segment_reduce import KERNEL

    launches0 = KERNEL.launches
    reduces0 = (sharding.ALL_REDUCE.calls, sharding.ALL_REDUCE.bytes)
    dev = default_device(args.device) if ts is None else ts.device
    say = print if ts is None or ts.rank == 0 else (lambda *a, **k: None)
    cfg = EnvConfig(
        n_twins=args.capacity, n_bs=args.n_bs,
        migration=MigrationConfig() if args.migration else None,
        faults=FaultConfig() if args.faults else None,
        consensus=ConsensusConfig() if args.consensus else None,
    )
    fcfg = None
    if args.fl:
        from repro_torch.fl.stream import FLServeConfig

        fcfg = FLServeConfig(model=args.fl_model,
                             participants=args.fl_participants,
                             local_iters=args.fl_iters,
                             batch_size=args.fl_batch,
                             aggregator=args.fl_aggregator,
                             verify=args.consensus)
    scfg = serve.ServeConfig(capacity=args.capacity, join_rate=args.join,
                             leave_rate=args.leave, policy=args.policy,
                             evolve_channels=args.evolve, fl=fcfg)

    batch = scenario.make_batch(
        args.seed, 1,
        straggler=(0.1, 0.3) if args.faults else None,
        outage=(0.05, 0.2) if args.faults else None,
        byzantine=(0.0, 0.3) if args.consensus else None,
        quorum=(1.0, 2.0) if args.consensus else None)
    knobs = scenario.stream_knobs(scenario.batch_to(batch, dev),
                                  fcfg=cfg.faults, ccfg=cfg.consensus,
                                  lat=cfg.lat)
    row = scenario.knob_row(knobs, 0)
    row_seed = int(batch.seed[0])
    init = serve.make_serve_init(cfg, scfg, ts, n_live=args.live or None)
    init_kw = dict(seed=row_seed, device=dev)
    if inputs is not None:
        row = inputs["row"]
        init_kw["draws"] = inputs["init_draws"]

    plan = data = None
    if args.fl:
        from repro_torch.data import cifar10
        from repro_torch.fl import stream as fl_stream

        data = cifar10.load(max_train=args.fl_train, max_test=512)
        shards = fl_stream.cyclic_shards(data[0][0].shape[0], args.capacity,
                                         args.fl_shard_size)
        plan = fl_stream.stream_fl_plan(fcfg, shards, args.rounds,
                                        seed=args.seed)
        plan = fl_stream.FLPlan(*(x.to(dev) for x in plan))

    def fresh_state():
        st = init(row, **init_kw)
        if args.policy is not None:
            st = serve.attach_policy(
                cfg, st, torch.Generator(device=dev).manual_seed(
                    args.seed + 1))
        if args.fl:
            with (ts.scope(cfg.n_twins) if ts is not None
                  else contextlib.nullcontext()):
                st = st._replace(fl=fl_stream.fl_init(
                    fcfg, torch.Generator().manual_seed(args.seed + 2), data,
                    st.active))
        return st

    step = serve.make_round_step(cfg, scfg, ts)
    draws = (serve.stream_draws(cfg, scfg, row_seed, args.rounds, dev)
             if inputs is None else inputs["draws"])

    say(f"serving capacity={args.capacity} live={args.live or args.capacity}"
          f" bs={args.n_bs} device={dev}"
          f" churn=({args.join},{args.leave}) policy={args.policy or 'static'}"
          f" axes=[{'M' if args.migration else ''}"
          f"{'F' if args.faults else ''}{'C' if args.consensus else ''}"
          f"{'L' if args.fl else ''}]"
          f" overlap={not args.no_overlap}"
          f" shards={max(args.shards, 1)}")
    if args.fl:
        say(f"fl model={args.fl_model} participants="
              f"{args.fl_participants} iters={args.fl_iters} "
              f"batch={args.fl_batch} agg={args.fl_aggregator} "
              f"data={data[2]}[{data[0][0].shape[0]}]")

    # warm up one round off the clock, on a state thrown away after
    warm_draws = serve.stream_draws(cfg, scfg, row_seed + 99, 1, dev)
    plan1 = (None if plan is None else
             fl_stream.FLPlan(*(x[:1] for x in plan)))
    serve.serve_rounds(cfg, scfg, fresh_state(), warm_draws, row, n_rounds=1,
                       step=step, overlap=False, plan=plan1)
    state = fresh_state()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    state, metrics = serve.serve_rounds(cfg, scfg, state, draws, row,
                                        n_rounds=args.rounds, step=step,
                                        overlap=not args.no_overlap,
                                        plan=plan)
    metrics = serve.stack_metrics(metrics)  # waits: the end of the stream
    dt = time.perf_counter() - t0

    rt = metrics["round_time"]
    say(f"{args.rounds} rounds in {dt:.2f}s wall "
          f"({args.rounds / max(dt, 1e-9):.1f} rounds/s)")
    say(f"round_time  mean={rt.mean():.3f}s  p95={np.quantile(rt, .95):.3f}"
          f"s  (simulated)")
    say(f"population  start={int(metrics['n_active'][0])} "
          f"end={int(metrics['n_active'][-1])} "
          f"joined={int(metrics['n_joined'].sum())} "
          f"left={int(metrics['n_left'].sum())}")
    for k in ("straggler_frac", "outage_frac", "migration_rate", "imbalance",
              "accept_frac", "consensus_time", "honest_stake_share"):
        if k in metrics:
            say(f"{k:18s} mean={float(np.mean(metrics[k])):.4f}")
    if args.fl:
        fll, fla = metrics["fl_loss"], metrics["fl_accuracy"]
        say(f"fl_loss     {float(fll[0]):.4f} -> {float(fll[-1]):.4f}   "
              f"fl_accuracy {float(fla[0]):.4f} -> {float(fla[-1]):.4f}")
        say(f"fl_rounds   participants/round mean="
              f"{float(np.mean(metrics['fl_n_participants'])):.1f}  "
              f"accept_frac mean="
              f"{float(np.mean(metrics['fl_accept_frac'])):.3f}")
    rc = 0
    if args.fl and not (np.isfinite(metrics["fl_loss"]).all()
                        and np.isfinite(metrics["fl_accuracy"]).all()):
        print("ERROR: non-finite FL metrics", file=sys.stderr)
        rc = 1
    if not np.isfinite(rt).all():
        print("ERROR: non-finite round times", file=sys.stderr)
        rc = 1
    counts = {"segment_launches": KERNEL.launches - launches0,
              "all_reduce": [sharding.ALL_REDUCE.calls - reduces0[0],
                             sharding.ALL_REDUCE.bytes - reduces0[1]],
              "wall_s": dt}
    out = {"rc": rc, "metrics": metrics, "counts": counts}
    if final_state:
        out["state"] = _global_state(cfg, scfg, state, ts)
    return out


def _global_state(cfg, scfg, state, ts) -> dict:
    """The final state's twin leaves at their global extent (on every rank:
    gathered by the mesh's all-reduce), after checking that the replicated
    leaves agree bitwise on every rank."""
    from repro_torch.core import sharding

    twin = {"active": state.active, "assoc": state.env.assoc,
            "data_sizes": state.env.data_sizes}
    if scfg.fl is not None:
        twin["twin_params"] = state.fl.twin_params
        twin["twin_mom"] = state.fl.twin_mom
    if ts is None or ts.n_shards == 1:
        return twin
    sharding.assert_replicated(
        [state.env.freqs, state.env.h_up, state.env.h_down, state.bad,
         state.byz, state.env.chain, state.agent, state.buf,
         None if state.fl is None else state.fl.params], ts)
    with ts.scope(cfg.n_twins):
        return sharding.unshard_tree(twin, sharding.P(sharding.TWIN_AXIS),
                                     cfg.n_twins)


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main())

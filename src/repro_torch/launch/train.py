"""End-to-end trainer CLI (port of ``repro/launch/train.py``).

Trains any registered architecture (smoke variant by default; ``--full`` for
the production config, on the card) on the synthetic token pipeline, with
checkpointing, on one device or a mesh of ranks:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --full --steps 4 --batch 2 --seq 4096 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 3 --batch 2 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 3 --batch 4 --seq 32 --device cpu --devices 4 --hierarchical 2

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no card
is present. Weights are random, drawn on the run's device from seed
``SEED``; the model takes the plain path (``build_model(cfg)``), as the
reference's trainer does: the hand kernels have no backward. The data are
the reference's: ``synthetic_tokens(vocab, 2_000_000, seed=0)`` windows from
``batches(seed=1)``. The optimizer is the config's, at a constant ``--lr``:
the reference builds its warmup-cosine schedule and never applies it, and
the port keeps that law (ROADMAP C2). Every 50 steps ``--ckpt-dir`` gets
``{"params", "step"}``.

The stub frontends get the inputs ``repro/launch/specs.py`` specifies, which
the reference's CLI does not build (it stops on both; ROADMAP C2): an
encoder-decoder (seamless) the audio stub's frames (B, max(S // 4, 8), d) in
the param dtype, and the vision stub (qwen2-vl) merged embeddings (B, S, d)
with M-RoPE positions ``arange(S)`` on all three axes and the token
windows' shifted labels; both drawn each step from one generator seeded
``SEED + 1`` on the run's device, as ``launch/serve.py`` draws them.

Meshes (the reference's branches). ``--devices N`` > 1 spawns N ranks of
one SPMD mesh (``launch/mesh.py``): gloo on the CPU, or when the ranks
share a card (more ranks than cards); nccl with one card a rank. Without
``--devices``, more than one visible card makes a mesh over them. Then:

* **Synced** (the default): :func:`make_debug_mesh` of the ranks, or with
  ``--full`` and no ``--devices`` :func:`make_production_mesh` (256 ranks;
  any other world is refused). ``--devices`` names the debug mesh, as the
  reference's help says, ``--full`` or not. Parameters are placed by
  ``param_pspecs``, the optimizer state by ``param_pspecs(opt_state)`` (the
  reference's call, not ``state_pspecs``; ROADMAP C2), each batch leaf by
  ``batch_pspec``, as DTensors; the step is ``make_train_step`` on them.
  Like the reference's CLI it does not enter ``activation_mesh``.
* **Hierarchical** (``--hierarchical H`` on a pod mesh,
  ``make_debug_mesh(n, multi_pod=True)``): each rank trains its pod's
  replica on the pod's share of every batch (``make_train_step``, the
  stacked ``make_pod_local_train_step`` of the reference one pod a rank),
  and every H steps ``hierarchy.cross_pod_mean`` averages the parameters
  over the pod group in fp32 (``make_cross_pod_sync``'s law). Pod 0's
  parameters are the result; as in the reference, this path writes no
  checkpoint.

On a mesh rank 0 prints, and on the synced mesh writes the checkpoints
from the gathered trees, in the reference's file format; :func:`main` returns rank 0's
results with each rank's peak device memory and host-staged collective
bytes (``sharding.collectives.HOST_STAGED``). On one device the reference
ignores ``--hierarchical`` (it has no pod mesh), and so does the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch
import torch.nn.functional as F

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch_config, get_smoke_config
from repro_torch.core.sharding import group_sum
from repro_torch.data.tokens import batches, synthetic_tokens
from repro_torch.launch.mesh import (check_world, debug_mesh_shape,
                                     production_mesh_shape, spawn_lm_ranks)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.device import default_device
from repro_torch.utils.tree import tree_map, tree_size

SEED = 0
CKPT_EVERY = 50


def train_batch(cfg, tokens, gen: torch.Generator) -> dict:
    """The train step's batch for ``tokens`` (B, S) int64 on the run's
    device: ``{"tokens"}``; an encoder-decoder's adds the audio stub's
    ``frames``; the vision stub's is ``{"embeds", "positions", "labels"}``
    (module docstring). Draws come from ``gen``."""
    B, S = tokens.shape
    dtype = getattr(torch, cfg.param_dtype)
    if cfg.is_encoder_decoder:
        frames = torch.randn((B, max(S // 4, 8), cfg.d_model), generator=gen,
                             device=tokens.device)
        return {"frames": frames.to(dtype), "tokens": tokens}
    if cfg.modality == "vision_stub":
        embeds = torch.randn((B, S, cfg.d_model), generator=gen,
                             device=tokens.device)
        pos = torch.arange(S, device=tokens.device)[None, :, None]
        return {"embeds": embeds.to(dtype), "positions": pos.expand(B, S, 3),
                "labels": F.pad(tokens[:, 1:], (0, 1), value=-1)}
    return {"tokens": tokens}


def _mark(dev):
    """A point in time: a recorded CUDA event on the card, else the host
    clock."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) \
        else (b - a) * 1e3


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="use the full production config (on the card)")
    ap.add_argument("--hierarchical", type=int, default=0, metavar="H",
                    help="local-SGD: sync across pods every H steps (on a "
                    "pod mesh)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the debug mesh (one process each)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override smoke d_model (e.g. scale to ~100M params)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    return ap


def _config(args):
    cfg = get_arch_config(args.arch) if args.full else get_smoke_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides.update(d_model=args.d_model,
                         d_ff=0 if cfg.d_ff == 0 else args.d_model * 3)
    if args.layers:
        overrides["n_layers"] = args.layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def main(argv=None, *, trees: bool = True) -> dict:
    """The CLI. Prints the reference's lines (the model, a loss every
    ``--log-every`` steps, the final loss), then each step's time and the
    warm tokens/s. Returns ``losses`` (every step's; on a pod mesh the mean
    over the pods), ``step_ms`` (each step: CUDA-event ms on the card,
    host ms on the CPU), ``tokens_per_s`` (over the steps after the first),
    ``n_params``, ``cfg``, ``devices`` and, with ``trees``, ``params`` and
    ``opt_state`` (the trained trees, gathered whole on a mesh; pod 0's on a
    pod mesh). A mesh run adds ``mesh`` (its axes and sizes), ``rank_peak_mb``
    (each rank's peak device memory, MiB; None on the CPU) and
    ``rank_host_bytes`` (each rank's host-staged collective counts)."""
    args = _parser().parse_args(argv)
    dev = default_device(args.device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n_dev = args.devices or max(n_cards, 1)
    if n_dev <= 1:
        return _run(args, None, dev, trees)
    backend = "nccl" if dev.type == "cuda" and n_dev <= n_cards else "gloo"
    production = args.full and not args.devices
    pods = args.hierarchical > 0
    check_world(*(production_mesh_shape(multi_pod=pods) if production
                  else debug_mesh_shape(n_dev, multi_pod=pods)), n_dev)
    outs = spawn_lm_ranks(_train_rank, n_dev, multi_pod=pods,
                          production=production, backend=backend,
                          device=dev, args=(argv, trees))
    out = outs[0]
    out["rank_peak_mb"] = [o["peak_mb"] for o in outs]
    out["rank_host_bytes"] = [o["host_staged"] for o in outs]
    return out


def _train_rank(mesh, argv, trees):
    """One rank of a mesh run: :func:`_run` on ``mesh``, quiet but on
    rank 0."""
    import contextlib
    import io

    args = _parser().parse_args(argv)
    quiet = io.StringIO() if mesh.rank else None
    with contextlib.redirect_stdout(quiet) if quiet else \
            contextlib.nullcontext():
        return _run(args, mesh, mesh.device, trees)


def _gathered(tree):
    """``tree`` with every DTensor gathered whole (a collective: every rank
    calls it)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def _run(args, mesh, dev, trees: bool) -> dict:
    from repro_torch.sharding.collectives import HOST_STAGED, reset_counts

    cfg = _config(args)
    model = build_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()

    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params = tree_size(params)
    hier = args.hierarchical
    pods = mesh is not None and hier > 0 and "pod" in mesh.axis_names
    n_dev = mesh.size if mesh is not None else (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M devices={n_dev} "
          f"hierarchical={hier or 'off'}")

    # a constant lr: the reference builds linear_warmup_cosine(lr,
    # min(20, steps // 5 + 1), steps) here and never applies it
    opt = make_optimizer(cfg.optimizer, lr=args.lr)

    data = synthetic_tokens(cfg.vocab_size, 2_000_000, seed=0)
    it = batches(data, args.batch, args.seq, seed=1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    if pods:
        n_pods, pod = mesh.shape["pod"], mesh.coords[0]
        if args.batch % n_pods:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"{n_pods} pods")
        rows = slice(pod * args.batch // n_pods,
                     (pod + 1) * args.batch // n_pods)
        opt_state = opt.init(params)
    elif mesh is not None:
        from repro_torch.sharding import param_pspecs, place_tree

        params = place_tree(params, param_pspecs(params, mesh), mesh)
        opt_state = opt.init(params)
        opt_state = place_tree(opt_state, param_pspecs(opt_state, mesh), mesh)
    else:
        opt_state = opt.init(params)

    step_fn = make_train_step(model, opt)
    losses, marks = [], []
    t0 = time.time()
    for step in range(args.steps):
        toks = torch.from_numpy(next(it)["tokens"]).to(dev, torch.int64)
        batch = train_batch(cfg, toks, gen)
        if pods:
            batch = {k: v[rows] for k, v in batch.items()}
        elif mesh is not None:
            from repro_torch.sharding import batch_pspec
            from repro_torch.sharding.specs import place

            batch = {k: place(v, batch_pspec(mesh, v.ndim), mesh)
                     for k, v in batch.items()}
        marks.append(_mark(dev))
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if pods:
            if (step + 1) % hier == 0:  # Eq. 5: the cross-pod average
                params = _cross_pod_sync(params, mesh.group("pod"))
            loss = group_sum(loss, mesh.group("pod")) / n_pods
        marks.append(_mark(dev))
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step} loss {float(loss):.4f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % CKPT_EVERY == 0 and not pods:
            whole = _gathered(params) if mesh is not None else params
            if mesh is None or mesh.rank == 0:
                save_checkpoint(args.ckpt_dir, step + 1,
                                {"params": whole, "step": step + 1})
            del whole
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    losses = [float(x) for x in losses]
    step_ms = [_ms(a, b) for a, b in zip(marks[::2], marks[1::2])]
    warm = step_ms[1:]
    tok_s = (args.batch * args.seq * len(warm) / (sum(warm) / 1e3)
             if warm else float("nan"))
    if losses:
        print("final loss:", losses[-1])
        print(f"ms a step {[round(x, 1) for x in step_ms]}; warm "
              f"{tok_s:.1f} tokens/s")
    out = {"losses": losses, "step_ms": step_ms, "tokens_per_s": tok_s,
           "n_params": n_params, "cfg": cfg, "devices": n_dev}
    if mesh is not None:
        out["mesh"] = mesh.shape
        out["peak_mb"] = (torch.cuda.max_memory_allocated(dev) / 2**20
                          if dev.type == "cuda" else None)
        out["host_staged"] = dict(HOST_STAGED)
    if trees:
        if mesh is not None and not pods:
            params, opt_state = _gathered(params), _gathered(opt_state)
        out.update(params=params, opt_state=opt_state)
    return out


def _cross_pod_sync(params, group):
    """``make_cross_pod_sync`` over the pod group: the fp32 mean of the
    pods' parameters (``hierarchy.cross_pod_mean``), cast back to each
    leaf's dtype."""
    from repro_torch.core.hierarchy import cross_pod_mean

    mean = cross_pod_mean(tree_map(lambda x: x.to(torch.float32), params),
                          group)
    return tree_map(lambda m, x: m.to(x.dtype), mean, params)


if __name__ == "__main__":
    main()
    sys.exit(0)

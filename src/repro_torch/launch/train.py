"""End-to-end trainer CLI (port of ``repro/launch/train.py``).

Trains any registered architecture (smoke variant by default; ``--full`` for
the production config, on the card) on the synthetic token pipeline, with
checkpointing, on one device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --full --steps 4 --batch 2 --seq 4096 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 3 --batch 2 --seq 32 --device cpu

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

The multi-device paths (``--devices N`` > 1, more than one visible card, and
``--hierarchical`` over a pod mesh) wait for the LM meshes (ROADMAP A11.9)
and raise. On one device the reference ignores ``--hierarchical`` (it has no
pod mesh), and so does the port.
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
from repro_torch.data.tokens import batches, synthetic_tokens
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.device import default_device
from repro_torch.utils.tree import tree_size

SEED = 0
CKPT_EVERY = 50


def _mesh_not_ported(what: str):
    return NotImplementedError(
        f"{what}: the LM meshes are not ported yet (ROADMAP A11.9); the "
        f"port trains on one device")


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


def main(argv=None) -> dict:
    """The CLI. Prints the reference's lines (the model, a loss every
    ``--log-every`` steps, the final loss), then each step's time and the
    warm tokens/s. Returns ``losses`` (every step's), ``step_ms`` (each
    step: CUDA-event ms on the card, host ms on the CPU), ``tokens_per_s``
    (over the steps after the first), ``n_params``, ``cfg``, ``params`` and
    ``opt_state`` (the trained trees)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="use the full production config (on the card)")
    ap.add_argument("--hierarchical", type=int, default=0, metavar="H",
                    help="local-SGD: sync across pods every H steps (needs "
                    "a pod mesh: ROADMAP A11.9)")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to span (more than 1: ROADMAP A11.9)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override smoke d_model (e.g. scale to ~100M params)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    if args.devices > 1:
        raise _mesh_not_ported(f"--devices {args.devices}")
    dev = default_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_dev > 1:
        raise _mesh_not_ported(f"{n_dev} visible cards (a data/model mesh"
                               + (", a pod mesh for --hierarchical)"
                                  if args.hierarchical else ")"))

    cfg = get_arch_config(args.arch) if args.full else get_smoke_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides.update(d_model=args.d_model,
                         d_ff=0 if cfg.d_ff == 0 else args.d_model * 3)
    if args.layers:
        overrides["n_layers"] = args.layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg)

    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params = tree_size(params)
    hier = args.hierarchical
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M devices={n_dev} "
          f"hierarchical={hier or 'off'}")

    # a constant lr: the reference builds linear_warmup_cosine(lr,
    # min(20, steps // 5 + 1), steps) here and never applies it
    opt = make_optimizer(cfg.optimizer, lr=args.lr)

    data = synthetic_tokens(cfg.vocab_size, 2_000_000, seed=0)
    it = batches(data, args.batch, args.seq, seed=1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    losses, marks = [], []
    t0 = time.time()
    for step in range(args.steps):
        toks = torch.from_numpy(next(it)["tokens"]).to(dev, torch.int64)
        batch = train_batch(cfg, toks, gen)
        marks.append(_mark(dev))
        params, opt_state, loss = step_fn(params, opt_state, batch)
        marks.append(_mark(dev))
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step} loss {float(loss):.4f} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % CKPT_EVERY == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "step": step + 1})
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
    return {"losses": losses, "step_ms": step_ms, "tokens_per_s": tok_s,
            "n_params": n_params, "cfg": cfg, "params": params,
            "opt_state": opt_state}


if __name__ == "__main__":
    main()
    sys.exit(0)

"""Batched serving CLI (port of ``repro/launch/serve.py``): prefill a batch
of prompts, then greedy-decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --full --batch 4 --prompt-len 4608 --gen 32

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no card
is present. Weights are random, drawn on the run's device from seed
``SEED``, as are the prompts. Without ``--full`` it serves the
architecture's smoke config.

The prefill goes through ``build_model(cfg, use_pallas=True)``, so every
layer's attention runs the hand-written flash kernel on the card, and reads
only the last position's logits (``last_only``): greedy decoding needs no
more. Its ``(k, v)`` per layer go into the ``{"k", "v"}`` cache slots
``[0, P)``, then each decode step writes slot ``t``.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_arch_config, get_smoke_config
from repro_torch.kernels.flash_attention import KERNEL as FLASH
from repro_torch.models import build_model
from repro_torch.utils.device import default_device

SEED = 0
# the main path's full-width run, which chip_smoke.py drives and
# profile_serve profiles: arch, prompts, prompt length, new tokens each
ARCH = "h2o-danube-1.8b"
BATCH, PROMPT_LEN, GEN = 4, 4608, 32


def random_model(cfg, seed: int, device):
    """``(model, params)``: the model through the flash kernel
    (``use_pallas=True``) and random weights drawn on ``device`` from
    ``seed``."""
    model = build_model(cfg, use_pallas=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, model.init(gen)


def random_prompts(cfg, batch: int, prompt_len: int, seed: int, device):
    """(batch, prompt_len) token ids in [0, vocab_size), drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def place_prefill(cache, prefill_cache) -> None:
    """Copy the prefill's stacked ``(k, v)``, each (n_blocks, B, P, Hkv,
    hd), into the ``{"k", "v"}`` cache slots ``[0, P)``, in place."""
    k, v = prefill_cache["blocks"]
    P = k.shape[2]
    cache["blocks"]["k"][:, :, :P].copy_(k)
    cache["blocks"]["v"][:, :, :P].copy_(v)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, prompts, gen: int) -> dict:
    """Prefill ``prompts`` (B, P), then greedy-decode to ``gen`` new tokens
    per sequence (the first from the prefill's logits).

    Returns ``tokens`` (B, gen), ``logits`` (B, gen, vocab_padded) fp32 (the
    logits each token was picked from), ``prefill_ms``, ``decode_s`` (the
    gen - 1 decode steps), each on the host clock after a synchronize, and
    ``flash_launches`` (flash kernel launches during the prefill).
    """
    cfg, dev = model.cfg, prompts.device
    B, P = prompts.shape
    _sync(dev)
    launches0, t0 = FLASH.launches, time.perf_counter()
    logits, _, pcache = model.forward(params, {"tokens": prompts},
                                      return_cache=True, last_only=True)
    cache = model.init_cache(B, P + gen, device=dev)
    place_prefill(cache, pcache)
    del pcache
    out = [torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]]
    steps = [logits[:, -1]]
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = FLASH.launches - launches0
    t0 = time.perf_counter()
    for t in range(P, P + gen - 1):
        logits, cache = model.decode_step(params, cache, {"token": out[-1]}, t)
        out.append(torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None])
        steps.append(logits[:, -1])
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "logits": torch.stack(steps, 1),
            "prefill_ms": prefill_ms, "decode_s": time.perf_counter() - t0,
            "flash_launches": launches}


def main(argv=None) -> dict:
    """The CLI. Prints the prefill time, the flash kernel's launches, the
    decode rate and the first generated tokens; returns what
    :func:`generate` returns, with ``decode_tok_s`` and the config."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be at least 1")

    dev = default_device(args.device)
    cfg = get_arch_config(args.arch) if args.full else get_smoke_config(args.arch)
    B, P, G = args.batch, args.prompt_len, args.gen
    with torch.inference_mode():
        model, params = random_model(cfg, SEED, dev)
        prompts = random_prompts(cfg, B, P, SEED, dev)
        res = generate(model, params, prompts, G)
    n_dec = B * (G - 1)
    res["decode_tok_s"] = n_dec / res["decode_s"] if n_dec else 0.0
    res["cfg"] = cfg
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name} on {where}: prefill {P} tokens x {B} seqs in "
          f"{res['prefill_ms']:.1f} ms; flash kernel launches "
          f"{res['flash_launches']}")
    print(f"decoded {G - 1} tokens/seq x {B} seqs in {res['decode_s']:.3f} s "
          f"({res['decode_tok_s']:.1f} tok/s); {G} generated per seq")
    print(res["tokens"][:, :16].tolist())
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)

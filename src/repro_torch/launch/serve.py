"""Batched serving CLI (port of ``repro/launch/serve.py``): prefill a batch
of prompts, then greedy-decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --full --batch 4 --prompt-len 4608 --gen 32

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no card
is present. Weights are random, drawn on the run's device from seed
``SEED``, as are the prompts. Without ``--full`` it serves the
architecture's smoke config.

The prefill of an attention model goes through ``build_model(cfg,
use_pallas=True)``, so every GQA layer's attention runs the hand-written
flash kernel on the card (MLA's takes the plain path, as in the
reference), and reads only the last position's logits (``last_only``):
greedy decoding needs no more. Its cache entries go into the cache's slots
``[0, P)`` (:func:`place_prefill`), then each decode step writes slot
``t``. An SSM (``family == "ssm"``, mamba2) or a hybrid (``attn_every``,
jamba) prefills by stepping ``decode_step`` over the prompt, as the
reference's serve does (its state is O(1)), so it launches no kernel; its
full-sequence forward, which runs the SSD-scan and flash kernels, is the
scoring path (``model.forward``).
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
# the SSM's main path: its full-sequence scoring forward through the SSD
# kernel at the same BATCH x PROMPT_LEN, 18 chunks of 256 (``generate``
# steps an SSM token by token and never runs the kernel)
SSM_ARCH = "mamba2-2.7b"


def random_model(cfg, seed: int, device):
    """``(model, params)``: the model through the hand-written kernels
    (``use_pallas=True``: flash attention, or the SSD scan) and random
    weights drawn on ``device`` from ``seed``."""
    model = build_model(cfg, use_pallas=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, model.init(gen)


def random_prompts(cfg, batch: int, prompt_len: int, seed: int, device):
    """(batch, prompt_len) token ids in [0, vocab_size), drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def steps_prefill(cfg) -> bool:
    """Whether the prefill steps ``decode_step`` (an SSM or a hybrid)."""
    return cfg.family == "ssm" or bool(cfg.attn_every)


def _place(slots: dict, entry, seq_axis: int) -> None:
    """Copy one prefill cache entry into the cache's slots ``[0, P)`` along
    ``seq_axis``, in place: a ``(k, v)`` or MLA ``(c_kv, k_rope)`` tuple
    into ``{"k", "v"}`` or ``{"ckv", "krope"}``, a dict (gemma2's
    ``{"local", "global"}``) key by key."""
    if isinstance(entry, dict):
        for name, sub in entry.items():
            _place(slots[name], sub, seq_axis)
        return
    names = ("ckv", "krope") if "ckv" in slots else ("k", "v")
    for name, t in zip(names, entry, strict=True):
        slots[name].narrow(seq_axis, 0, t.shape[seq_axis]).copy_(t)


def place_prefill(cache, prefill_cache) -> None:
    """Copy the prefill's cache (``forward(return_cache=True)``) into the
    decode cache's slots ``[0, P)``, in place: the stacked block entries
    (sequence axis 2) and deepseek's unstacked ``prologue`` (axis 1). The
    reference's serve crashes here on every attention model (ROADMAP C2);
    the port places them."""
    _place(cache["blocks"], prefill_cache["blocks"], 2)
    if "prologue" in prefill_cache:
        _place(cache["prologue"], prefill_cache["prologue"], 1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, prompts, gen: int) -> dict:
    """Prefill ``prompts`` (B, P), then greedy-decode to ``gen`` new tokens
    per sequence (the first from the prefill's logits). An SSM's or a
    hybrid's prefill steps ``decode_step`` over the prompt, as the
    reference's serve does.

    Returns ``tokens`` (B, gen), ``logits`` (B, gen, vocab_padded) fp32 (the
    logits each token was picked from), ``prefill_ms``, ``decode_s`` (the
    gen - 1 decode steps), each on the host clock after a synchronize, and
    ``flash_launches`` (flash kernel launches during the prefill).
    """
    cfg, dev = model.cfg, prompts.device
    B, P = prompts.shape
    _sync(dev)
    launches0, t0 = FLASH.launches, time.perf_counter()
    if steps_prefill(cfg):
        cache = model.init_cache(B, P + gen, device=dev)
        for t in range(P):
            logits, cache = model.decode_step(
                params, cache, {"token": prompts[:, t:t + 1]}, t)
    else:
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

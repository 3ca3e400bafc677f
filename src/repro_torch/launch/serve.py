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

The stub frontends, as in the reference's serve. The vision stub
(qwen2-vl) serves merged text and patch embeddings (B, P, d) drawn from the
seed, with M-RoPE positions ``arange(P)`` on all three axes unless
:func:`generate` is given others; each decode step draws a fresh embedding
(the greedy token is recorded, not fed back). The audio stub (seamless, an
encoder-decoder) draws frames (B, max(P // 4, 8), d), encodes them through
the flash kernel, fills the cross-attention cache and greedy-decodes from
BOS 0 with no decoder prefill: ``P + G - 1`` steps in the CLI.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_arch_config, get_smoke_config
from repro_torch.kernels.flash_attention import KERNEL as FLASH
from repro_torch.models import build_model, encdec
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
    """The served prompts, drawn from ``seed``: (batch, prompt_len) token ids
    in [0, vocab_size); for the vision stub, merged embeddings (batch,
    prompt_len, d_model); for the encoder-decoder's audio stub, frames
    (batch, max(prompt_len // 4, 8), d_model). Embeddings are fp32 standard
    normals, as the reference's."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if cfg.is_encoder_decoder or cfg.modality == "vision_stub":
        rows = max(prompt_len // 4, 8) if cfg.is_encoder_decoder else prompt_len
        return torch.randn((batch, rows, cfg.d_model), generator=gen,
                           device=device)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def prompt_batch(cfg, prompts, positions=None) -> dict:
    """The prefill forward's batch of ``prompts`` (:func:`random_prompts`):
    ``{"tokens"}``, or for the vision stub ``{"embeds", "positions"}`` with
    ``positions`` (B, P, 3), by default the reference serve's law,
    ``arange(P)`` on all three axes (there M-RoPE is RoPE)."""
    if cfg.modality != "vision_stub":
        return {"tokens": prompts}
    B, P = prompts.shape[:2]
    if positions is None:
        positions = torch.arange(P, device=prompts.device)[None, :, None]
        positions = positions.expand(B, P, 3)
    return {"embeds": prompts, "positions": positions}


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


def generate(model, params, prompts, gen: int, *, positions=None,
             step_embeds=None) -> dict:
    """Prefill ``prompts`` (:func:`random_prompts`), then greedy-decode to
    ``gen`` new tokens per sequence (the first from the prefill's logits).
    An SSM's or a hybrid's prefill steps ``decode_step`` over the prompt, as
    the reference's serve does. An encoder-decoder takes frames and decodes
    ``gen`` steps from BOS (:func:`generate_encdec`).

    The vision stub: ``prompts`` are embeddings (B, P, d) and ``positions``
    their M-RoPE positions (B, P, 3), default :func:`prompt_batch`'s. Decode
    step ``i`` takes ``step_embeds[:, i:i + 1]`` (default: (B, gen - 1, d)
    drawn on the prompts' device from a generator seeded ``SEED + 2``), at
    the next text position after the prompt's largest on all three axes
    (``t`` when the positions are ``arange(P)``, as in the reference).

    Returns ``tokens`` (B, gen), ``logits`` (B, gen, vocab_padded) fp32 (the
    logits each token was picked from), ``prefill_ms``, ``decode_s`` (the
    ``decode_steps`` = gen - 1 decode steps), each on the host clock after a
    synchronize, and ``flash_launches`` (flash kernel launches during the
    prefill).
    """
    cfg, dev = model.cfg, prompts.device
    if cfg.is_encoder_decoder:
        return generate_encdec(model, params, prompts, gen)
    B, P = prompts.shape[:2]
    vision = cfg.modality == "vision_stub"
    _sync(dev)
    launches0, t0 = FLASH.launches, time.perf_counter()
    if steps_prefill(cfg):
        cache = model.init_cache(B, P + gen, device=dev)
        for t in range(P):
            logits, cache = model.decode_step(
                params, cache, {"token": prompts[:, t:t + 1]}, t)
    else:
        batch = prompt_batch(cfg, prompts, positions)
        logits, _, pcache = model.forward(params, batch, return_cache=True,
                                          last_only=True)
        cache = model.init_cache(B, P + gen, device=dev)
        place_prefill(cache, pcache)
        del pcache
    out = [torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]]
    steps = [logits[:, -1]]
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = FLASH.launches - launches0
    if vision:  # the next text position: past the prompt's largest
        shift = batch["positions"].amax(dim=(1, 2)) + 1 - P  # (B,)
        if step_embeds is None:
            draw = torch.Generator(device=dev).manual_seed(SEED + 2)
            step_embeds = torch.randn((B, gen - 1, cfg.d_model),
                                      generator=draw, device=dev)
    t0 = time.perf_counter()
    for i, t in enumerate(range(P, P + gen - 1)):
        if vision:
            step = {"embed": step_embeds[:, i:i + 1],
                    "positions": (shift + t)[:, None, None].expand(B, 1, 3)}
        else:
            step = {"token": out[-1]}
        logits, cache = model.decode_step(params, cache, step, t)
        out.append(torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None])
        steps.append(logits[:, -1])
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "logits": torch.stack(steps, 1),
            "prefill_ms": prefill_ms, "decode_s": time.perf_counter() - t0,
            "decode_steps": gen - 1, "flash_launches": launches}


def generate_encdec(model, params, frames, steps: int) -> dict:
    """The audio stub's serving: encode ``frames`` (B, F, d) through the
    model's attention route (the flash kernel for ``random_model``), fill
    the cross cache, then greedy-decode ``steps`` tokens from BOS 0 with no
    decoder prefill, in a self cache of ``steps + 1`` slots.

    Returns ``tokens`` (B, steps) (BOS not included), ``logits`` (B, steps,
    vocab_padded) fp32, ``prefill_ms`` (the encode and the cross cache),
    ``decode_s`` (the ``decode_steps`` = steps decode steps) and
    ``flash_launches`` (flash launches during the encode)."""
    cfg, dev = model.cfg, frames.device
    B = frames.shape[0]
    _sync(dev)
    launches0, t0 = FLASH.launches, time.perf_counter()
    enc_out = model.encode(params, frames)
    cache = model.init_cache(B, steps + 1, enc_out.shape[1], device=dev)
    cache["cross"] = encdec.prefill_cross_cache(cfg, params, enc_out)
    del enc_out
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = FLASH.launches - launches0
    out = [torch.zeros((B, 1), dtype=torch.int64, device=dev)]  # BOS
    logits_t = []
    t0 = time.perf_counter()
    for t in range(steps):
        logits, cache = model.decode_step(params, cache, {"token": out[-1]}, t)
        out.append(torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None])
        logits_t.append(logits[:, -1])
    _sync(dev)
    return {"tokens": torch.cat(out[1:], dim=1),
            "logits": torch.stack(logits_t, 1), "prefill_ms": prefill_ms,
            "decode_s": time.perf_counter() - t0, "decode_steps": steps,
            "flash_launches": launches}


def main(argv=None) -> dict:
    """The CLI. Prints the prefill time (an encoder-decoder's encode time),
    the flash kernel's launches, the decode rate and the first generated
    tokens; returns what :func:`generate` returns, with ``decode_tok_s`` and
    the config. An encoder-decoder decodes ``P + G - 1`` steps from BOS, as
    the reference's serve does."""
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
        res = generate(model, params, prompts,
                       P + G - 1 if cfg.is_encoder_decoder else G)
    n_dec = B * res["decode_steps"]
    res["decode_tok_s"] = n_dec / res["decode_s"] if n_dec else 0.0
    res["cfg"] = cfg
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    what = (f"encode {prompts.shape[1]} frames" if cfg.is_encoder_decoder
            else f"prefill {P} tokens")
    print(f"{cfg.name} on {where}: {what} x {B} seqs in "
          f"{res['prefill_ms']:.1f} ms; flash kernel launches "
          f"{res['flash_launches']}")
    print(f"decoded {res['decode_steps']} tokens/seq x {B} seqs in "
          f"{res['decode_s']:.3f} s ({res['decode_tok_s']:.1f} tok/s); "
          f"{res['tokens'].shape[1]} generated per seq")
    print(res["tokens"][:, :16].tolist())
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)

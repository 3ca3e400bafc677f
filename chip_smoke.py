#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the port's hand-written kernels from the checkout's
sources, in parallel, and drives the port's paths:

* the DTWN federated round: the segment-reduce and FedAvg kernels are held
  against their plain PyTorch versions at the round's shapes and timed,
  three full-width rounds run through ``DTWNSystem``, and one GPU round is
  checked against the same round on the CPU;
* the same round under attack, faults and PBFT verification: three
  full-width trimmed-mean rounds and one Krum round with model-replacement
  attackers, stragglers, outages and the PBFT block term, the segment
  kernel's launches held to the count the code makes, the first
  trimmed-mean round run twice from one state and held bit for bit, and a
  trimmed-mean and a Krum round on the GPU checked against the same rounds
  on the CPU;
* the MARL edge-association controller: the segment kernel's gradient (a
  gather) and grouped call held against the plain version's autograd at
  the update's shapes; 200 full-width MADDPG training steps (100 twins, 5
  BSs, factorized policy, hidden 256, batch 64) and 60 more with
  migration, faults and PBFT consensus set, the segment launches held to
  the count the code makes, the final actions feasible; a profiler trace
  of 20 warm steps and a split of a step's host time; one update, its
  actor gradient and one env step per config on the GPU against the CPU;
  and one FL round driven by the trained controller's actions;
* the scenario runners at the paper's width (100 twins, 5 BSs, 256
  scenarios): the baselines, 10 faulted, migrating and PBFT rounds, and the
  trained controller's rollouts (32 scenarios), the segment launches held to
  the count the code makes, and 8 scenarios of each on the GPU against the
  CPU from the same draws;
* the always-on service with streamed FL at the paper's width (capacity
  100, the CNN, migration, faults, PBFT and churn): 6 overlapped rounds
  with no host synchronisation (the sync debug mode set to raise), equal
  bit for bit to 6 blocking rounds, device memory flat from the second
  round on, the segment launches held to the count the code makes, a
  round's profile, streaming against the batch runners per axis, one
  round on the GPU against the CPU, and a policy-driven stream; then the
  serving CLI with the tiny model at capacity 10,000;
* the twin mesh: 2 ranks on the one card over gloo (NCCL needs a card per
  rank), each sharded entry point against the same call on one rank at
  the sizes of docs/SCALING.md (the segment backend at 1,000,003 twins,
  the latency model and the env at 10^6, 60 MARL steps, the four runners
  on 256 scenarios, the serving CLI at 10,000 twins), the segment kernel's
  launches on each rank held to the one-rank run's, the all-reduce calls
  counted, the replicated state checked bitwise equal on both ranks;
* the LM serving path: the flash-attention kernel is held against its plain
  version on the reference tests' cases (fp32 through its CUDA-core
  variant, bf16 through its tensor-core variant), at head dims up to 256,
  on bf16 views whose rows are not 16-byte aligned, and at the prefill's
  shape in bf16, and timed there and at gemma2-9b's attention shape (hd
  256); ``repro_torch.launch.serve`` serves
  h2o-danube-1.8b at full width (random weights from a seed, 4 prompts of
  4608 tokens, 32 new tokens each; the tensor-core variant once per layer);
  its last-position logits are checked against the plain attention path on
  the card, and a 2-layer fp32 cut of it on the GPU against the CPU;
* mamba2-2.7b's scoring forward: the SSD-scan kernel is held against its
  plain version on the reference tests' cases (x, B and C in fp32 and in
  bf16) and at the forward's shape (bf16 x, B and C, as the forward passes
  them), and timed there, each of its launches too; ``build_model(cfg, use_pallas=True).forward`` runs at
  full width (random bf16 weights from a seed, 4 prompts of 4608 tokens,
  last-position logits) with one kernel launch per layer; its logits are
  checked against the plain-SSD forward on the card, a 2-layer fp32 cut on
  the GPU against the CPU, and the serving CLI steps a short SSM prompt;
* the other decoder-only LM families: the flash kernel timed at
  qwen1.5-4b's attention shape (hd 128, one KV head a query head);
  ``repro_torch.launch.serve`` serves gemma2-9b (21 local layers with a
  4096-token window and 21 global ones, hd 256, soft-cap) and qwen1.5-4b
  (QKV bias) at full width as it serves h2o-danube, one bf16 tensor-core
  flash launch per layer, their kernel paths checked against the plain
  attention path; full-width layer cuts of mixtral-8x22b (4 layers, the
  capacity router at 18,432 tokens), command-r-plus-104b (4 layers, the
  tied 256,000-row embedding) and deepseek-v2-236b (the dense prologue
  and 2 MoE layers of 160 experts, MLA on the plain attention path: no
  flash launch) serve the same prompts and decode a few tokens; jamba's
  smoke config runs its forward through the SSD and flash kernels, held
  against the plain forward; and a 2-layer fp32 cut of each family (jamba:
  its smoke config) on the GPU against the CPU, the MoE routers' choices
  equal on both;
* the last two LM families: the flash kernel timed at qwen2-vl-7b's
  attention shape (7 query heads a KV head, hd 128) and at
  seamless-m4t-large-v2's non-causal encoder and causal decoder shapes (hd
  64), beside SDPA; qwen2-vl-7b served at full width through its vision
  stub (merged embeddings, M-RoPE positions equal on all three axes, as
  the reference's serve lays them out) and then with an image layout in
  which the axes differ, one flash launch a layer, checked against the
  plain attention path; seamless-m4t-large-v2 at full width: 4 x 1,152
  frames encoded through the kernel (one non-causal launch an encoder
  layer), 32 greedy steps from BOS (no launch), and one scoring forward
  over 4 x 4,608 tokens (24 non-causal and 24 causal launches), checked
  against the plain attention path; and a 2-layer fp32 cut of each (the
  image layout for qwen2-vl) on the GPU against the CPU;
* the LM trainer: ``repro_torch.launch.train`` trains h2o-danube-1.8b at
  full width (24 layers, d 2560, bf16, remat on, adamw; 4 steps of 2 x
  4,096 synthetic tokens) on the plain path, with no kernel launch, finite
  losses that do not explode, and its warm step time, tokens/s and peak
  memory; a 2-layer full-width cut's loss and bf16 gradients with remat on
  and off; every registered architecture at its smoke config trained 3
  steps on the card with its config's optimizer, its loss and gradients
  against the CPU, a checkpoint reload stepped once against the step
  without it, and 2 synced pods against the synced step; and the flash and
  SSD kernels' refusal of inputs that require grad (they have no
  backward);
* the LM meshes: 4 gloo ranks sharing the card as a (2, 2) ("data",
  "model") mesh. mixtral-8x22b at full width cut to 2 layers runs one
  prefill forward of 4 x 4,096 tokens under ``activation_mesh``, through
  the flash kernel on each rank's 24 local heads and the expert-parallel
  all-to-all (4 experts a rank, ff split over "model"), held against one
  rank at capacity factor 8.0 and with each layer's dropped slots at 1.25;
  jamba's smoke config through the SSD and flash kernels on local heads
  against one rank; the train CLI on the synced mesh (danube at full
  width, 2 steps of 2 x 2,048 tokens) against the one-device CLI; and
  ``--hierarchical 1`` on the (2, 1, 2) pod mesh against the synced step.
  Each rank's launches, host-staged collectives, ms and peak memory are
  printed;
* the dry run: ``python -m repro_torch.launch.dryrun`` at full width on
  the production meshes, each in its own process on the CPU (a fake
  process group of 256 or 512 ranks, meta DTensors, no card): danube's
  train_4k on (16, 16) ("dp") and on (2, 16, 16), mixtral-8x22b's train_4k
  (no expert parallelism: 8 experts on 16 FSDP ranks), deepseek-v2-236b's
  train_4k (the EP all-to-all) and decode_32k, each record ``ok`` with its
  roofline terms, resident bytes and collectives printed; the counting
  mode's deferral on this torch (one placed product counted as the rank's
  local product); and the one-rank roofline of danube's training step and
  prefill, each below the time this run measured for it, the share of the
  roofline printed beside the card's name and power limit.

Any failure raises and exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

Output: one line per check and per timing, then a ``{"kernels": [...]}``
line, then ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # H100 SXM peaks (NVIDIA data sheet, ``repro_torch.launch.mesh``): HBM
    # bandwidth, fp32 outside the tensor cores (the rate of the kernels'
    # adds and multiply-adds), dense bf16 on the tensor cores (the least
    # time of the bf16 attention's products) and tf32
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_OPS_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_OPS_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_OPS_PER_S
except ImportError:
    print("chip_smoke: run it from a checkout of the repository "
          "(src/repro_torch is missing)", file=sys.stderr)
    sys.exit(1)
# the CNN's Eq. 4 leaves (fc2_b, conv1_b, conv2_b, fc1_b, conv1_w, fc2_w,
# conv2_w, fc1_w) and the Eq. 4 weights (K=1): N=10 twins over M=5 BSs
EQ4_K = (1, 10, 32, 64, 512, 2400, 5120, 51200, 2_097_152)
CNN_PARAMS = 2_156_490
# the streamed FL round's Eq. 4 over the capacity axis: fc1_w at capacity
# 100 over 5 BSs
EQ4_CAPACITY = (100, 2_097_152, 5)
SEG_RTOL, SEG_ATOL = 1e-5, 1e-6
FED_TOL = 1e-5
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


# the LM serving path: the reference tests' flash cases (B, Sq, Sk, Hq,
# Hkv, hd, causal, window, softcap) and tolerances
FLASH_CASES = [
    (1, 64, 64, 4, 2, 32, True, 0, None),
    (2, 128, 128, 8, 8, 64, True, 32, None),
    (1, 96, 96, 4, 1, 48, True, 0, 50.0),
    (2, 64, 256, 4, 2, 32, False, 0, None),
    (1, 200, 200, 2, 2, 16, True, 64, None),
    (1, 64, 64, 8, 2, 128, True, 0, None),
    # qwen2-vl's 7 query heads a KV head at hd 128, and seamless's
    # non-causal encoder self-attention at hd 64
    (1, 128, 128, 14, 2, 128, True, 0, None),
    (2, 144, 144, 4, 4, 64, False, 0, None),
]
FLASH_TOL_F32, FLASH_TOL_BF16 = 2e-5, 3e-2
# head dims above 128 (gemma2's 256), in both variants, and bf16 views
# whose rows are not 16-byte aligned (the wrapper copies them into padded
# buffers for the same kernel)
FLASH_WIDE_CASES = [
    (1, 128, 128, 4, 2, 256, True, 0, 50.0),
    (2, 200, 200, 4, 4, 256, True, 64, None),
    (1, 64, 64, 2, 1, 160, False, 0, None),
]
# the LM families' attention shapes, self-attention over S positions:
# (B, S, Hq, Hkv, hd, causal, window, softcap). gemma2-9b's prefill at one
# 4608-token prompt; at the served batch, qwen1.5-4b's (one KV head a query
# head, G = 1), qwen2-vl-7b's (G = 7), and seamless-m4t-large-v2's
# non-causal encoder over 4608 // 4 = 1152 frames and causal decoder
FLASH_SHAPE_KEYS = ("B", "S", "Hq", "Hkv", "hd", "causal", "window",
                    "softcap")
FLASH_GEMMA = (1, 4608, 16, 8, 256, True, 4096, 50.0)
FLASH_QWEN = (4, 4608, 20, 20, 128, True, 0, None)
FLASH_QWEN2VL = (4, 4608, 28, 4, 128, True, 0, None)
FLASH_SEAMLESS_ENC = (4, 1152, 16, 16, 64, False, 0, None)
FLASH_SEAMLESS_DEC = (4, 4608, 16, 16, 64, True, 0, None)
# mamba2's path: the reference tests' SSD cases (B, S, H, P, N, chunk) and
# tolerance, and the short SSM serving run (prompts, prompt length, new
# tokens)
SSD_CASES = [
    (1, 64, 2, 8, 4, 16),
    (2, 128, 4, 16, 8, 32),
    (1, 256, 8, 32, 16, 64),
    (2, 96, 2, 64, 128, 32),
]
SSD_ATOL, SSD_RTOL = 2e-4, 2e-3
SSM_SERVE = (4, 64, 8)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    """Least time on the card: the larger of bytes over HBM bandwidth and
    operations over the peak rate for their type (fp32 by default).
    Returns (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, copies, batch: int = 40, reps: int = 5) -> dict:
    """Time ``fn(*args)`` over the argument tuples in ``copies``.

    ``ms``: device time per call. A ~10 ms device sleep is queued first, so
    the host issues ``batch`` calls behind it and the device then runs them
    back to back; CUDA events around the batch, divided by ``batch``, median
    of ``reps`` batches. The calls cycle through ``copies`` so that the
    working set exceeds the 50 MB L2 where one copy does not.
    ``covered`` says whether the host issued each batch within the sleep
    (else ``ms`` includes host time). ``call_ms``: one call alone after a
    synchronize, host launch latency included; median of ``reps * 4``.
    """
    for args in copies:
        fn(*args)
    torch.cuda.synchronize()
    per_call, covered = [], True
    for _ in range(reps):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        torch.cuda._sleep(20_000_000)
        e[1].record()
        t0 = time.perf_counter()
        for i in range(batch):
            fn(*copies[i % len(copies)])
        issue_ms = (time.perf_counter() - t0) * 1e3
        e[2].record()
        e[2].synchronize()
        covered &= issue_ms < e[0].elapsed_time(e[1])
        per_call.append(e[1].elapsed_time(e[2]) / batch)
    single = []
    for i in range(reps * 4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*copies[i % len(copies)])
        end.record()
        end.synchronize()
        single.append(start.elapsed_time(end))
    return {"ms": statistics.median(per_call), "covered": covered,
            "call_ms": statistics.median(single)}


def n_copies(n_bytes: int) -> int:
    """Copies of a call's inputs that together exceed twice the 50 MB L2
    (at most 8)."""
    return min(8, max(1, math.ceil(2 * L2_BYTES / max(n_bytes, 1))))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}")
    log("[device] nvidia-smi name, power.limit:")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] tf32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return {"name": name, "smi": smi, "count": torch.cuda.device_count()}


def phase_build(kernels, build):
    t0 = time.perf_counter()
    build.build_all(kernels)
    for k in kernels:
        k.lib()
        report = [ln.strip() for ln in k.build_log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"[build] {k.target.name}: " + " | ".join(report))
    log(f"[build] {len(kernels)} kernels built and loaded in "
        f"{time.perf_counter() - t0:.3f} s")


def _seg_case(torch, gen, n, k, m, *, lo=0, hi=None, positive=False):
    dev = "cuda"
    vals = (torch.rand((n, k), generator=gen, device=dev) if positive
            else torch.randn((n, k), generator=gen, device=dev))
    ids = torch.randint(lo, m if hi is None else hi, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
    return vals, ids


def phase_segment_check(torch, sr) -> float:
    """Kernel vs plain version; returns the largest absolute error over
    the main path's shapes (the Eq. 4 and Eq. 12/15 calls)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("eq4", 10, k, 5, {}) for k in EQ4_K]
    cases += [("eq12_15", 100, 1, 5, {}),
              ("stage2", 100_000, 1, 8, {"positive": True}),
              ("stage2_wide", 20_000, 40, 6, {"positive": True}),
              ("out_of_range", 1000, 33, 8, {"lo": -3, "hi": 12})]
    worst = 0.0
    for tag, n, k, m, kw in cases:
        vals, ids = _seg_case(torch, gen, n, k, m, **kw)
        if tag == "out_of_range":  # leave segments 2 and 5 empty
            ids = torch.where((ids == 2) | (ids == 5), 9, ids)
        out = sr.segment_reduce_kernel(vals, ids, m)
        again = sr.segment_reduce_kernel(vals, ids, m)
        plain = sr._seg_tiled_plain(vals, ids, m)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        torch.testing.assert_close(out, plain, rtol=SEG_RTOL, atol=SEG_ATOL)
        if not torch.equal(out, again):
            raise AssertionError(f"segment kernel not bitwise repeatable at "
                                 f"N={n} K={k} M={m}")
        if tag == "out_of_range" and (out[2].any() or out[5].any()):
            raise AssertionError("empty segments are not zero")
        if tag in ("eq4", "eq12_15"):
            worst = max(worst, err)
        log(f"[segment] N={n} K={k} M={m} tiles="
            f"{sr.KERNEL.lib().seg_reduce_tiles(n, k)} max_abs_err={err:.3e} "
            f"bitwise_repeat=True ({tag})")
    before = sr.KERNEL.launches
    empty = sr.segment_reduce_kernel(
        torch.zeros((0, 7), device="cuda"),
        torch.zeros((0,), dtype=torch.int32, device="cuda"), 5)
    if empty.shape != (5, 7) or empty.any() or sr.KERNEL.launches != before:
        raise AssertionError("n=0 must return zeros without a launch")
    log("[segment] N=0: zeros (5, 7), no launch")
    # past the kernel's MAX_SEGMENTS (223) segments: one launch a window of
    # at most 223 segment ids (ROADMAP C1a)
    from repro_torch.core import migration

    cap = sr.KERNEL.lib().seg_reduce_max_segments()
    for m in (cap + 1, 500):
        vals, ids = _seg_case(torch, gen, 5000, 3, m, lo=-1, hi=m + 2)
        before = sr.KERNEL.launches
        out = sr.segment_reduce(vals, ids, m)
        launched = sr.KERNEL.launches - before
        err = float((out - sr._seg_tiled_plain(vals, ids, m)).abs().max())
        torch.testing.assert_close(out, sr._seg_tiled_plain(vals, ids, m),
                                   rtol=SEG_RTOL, atol=SEG_ATOL)
        if launched != -(-m // cap):
            raise AssertionError(f"M={m}: {launched} launches, not one a "
                                 f"window of {cap}")
        log(f"[segment] N=5000 K=3 M={m}: {launched} window launches, "
            f"max_abs_err={err:.3e}")
    old = torch.randint(0, 15, (100_000,), generator=gen, device="cuda")
    new = torch.randint(0, 15, (100_000,), generator=gen, device="cuda")
    before = sr.KERNEL.launches
    flows = migration.migration_flows(old, new, 15)
    launched = sr.KERNEL.launches - before
    plain = sr._seg_tiled_plain(
        torch.ones((100_000, 1), device="cuda"),
        (old * 15 + new).to(torch.int32), 225).reshape(15, 15)
    if launched != 2 or not torch.equal(flows, plain) or not torch.equal(
            flows.cpu(), migration.migration_flows(old.cpu(), new.cpu(), 15)):
        raise AssertionError(f"migration_flows at n_bs=15: {launched} "
                             f"launches, or flows unlike the plain version "
                             f"and the CPU")
    log("[segment] migration_flows n_bs=15 (225 pair ids): 2 window "
        "launches, equal to the plain version and to the CPU")
    log(f"[segment] ok: all within rtol {SEG_RTOL} / atol {SEG_ATOL} of the "
        f"plain version; max_abs_err at the main path's shapes {worst:.3e}")
    return worst


def _fedavg_case(torch, fr, gen, c, n, main_path):
    """Random (C, N) stack and weights: laid out by ``stack_rows`` as on the
    main path, or contiguous."""
    x = torch.randn((c, n), generator=gen, device="cuda")
    w = torch.rand((c,), generator=gen, device="cuda") + 0.1
    return (fr.stack_rows(list(x)) if main_path else x), w


def phase_fedavg_check(torch, fr) -> float:
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for c, n, main_path in [(5, CNN_PARAMS, True), (5, CNN_PARAMS, False),
                            (3, 65_537, False), (16, 4096, False)]:
        x, w = _fedavg_case(torch, fr, gen, c, n, main_path)
        vec = x.stride(0) % 4 == 0
        tag = ("main path, stack_rows" if main_path else "contiguous") + (
            ": 16-byte loads" if vec else ": rows not 16-byte aligned, "
            "4-byte loads")
        out = fr.fedavg_reduce(x, w)
        plain = fr.fedavg_reduce_plain(x, w)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        torch.testing.assert_close(out, plain, rtol=FED_TOL, atol=FED_TOL)
        worst = max(worst, err)
        log(f"[fedavg] C={c} N={n} row_stride={x.stride(0)} "
            f"max_abs_err={err:.3e} ({tag})")
    log(f"[fedavg] ok: all within {FED_TOL} of the plain version")
    return worst


def _timed(torch, label, kernel, plain, library, copies, n_bytes, n_ops,
           ops_per_s=FP32_OPS_PER_S, **timing):
    row = {"library_ms": None, "library_call_ms": None,
           "library_covered": None}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:  # no single library call computes the function
            continue
        got = time_ms(torch, fn, copies, **timing)
        row[key + "ms"] = got["ms"]
        row[key + "call_ms"] = got["call_ms"]
        row[key + "covered"] = got["covered"]
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_ops, ops_per_s)
    lib = ("none" if library is None else
           f"{row['library_ms']:.4f} ({row['library_call_ms']:.4f})")
    log(f"[timing] {label}: kernel {row['ms']:.4f} ms (one call alone "
        f"{row['call_ms']:.4f}), plain {row['plain_ms']:.4f} "
        f"({row['plain_call_ms']:.4f}), library {lib}, bound "
        f"{row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); host kept ahead: {row['covered']}/"
        f"{row['plain_covered']}/{row['library_covered']}")
    return row


def phase_timing(torch, sr, fr) -> dict:
    """Kernel, plain and library times at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    seg_rows = []
    for n, k, m in [(10, kk, 5) for kk in EQ4_K] + [(100, 1, 5)]:
        vals, ids = _seg_case(torch, gen, n, k, m)
        n_bytes = n * k * 4 + n * 4 + m * k * 4
        row = _timed(
            torch, f"segment_reduce N={n} K={k} M={m}",
            lambda v, a: sr.segment_reduce_kernel(v, a, m),
            lambda v, a: sr._seg_tiled_plain(v, a, m),
            lambda v, a: torch.zeros((m, k), device="cuda").index_add_(
                0, a.long(), v),
            [(vals.clone(), ids.clone()) for _ in range(n_copies(n_bytes))],
            n_bytes, n * k)
        row.update(N=n, K=k, M=m)
        seg_rows.append(row)
    c, n = 5, CNN_PARAMS
    x, w = _fedavg_case(torch, fr, gen, c, n, True)
    n_bytes = c * n * 4 + c * 4 + n * 4
    copies = [(fr.stack_rows(list(x)), w.clone())  # laid out as x
              for _ in range(n_copies(n_bytes))]
    fed = _timed(torch, f"fedavg_reduce C={c} N={n}", fr.fedavg_reduce,
                 fr.fedavg_reduce_plain,
                 lambda xx, ww: torch.mv(xx.t(), ww / ww.sum()),
                 copies, n_bytes, 2 * c * n)
    fed.update(C=c, N=n)
    # the streamed round's capacity-axis Eq. 4 at its largest leaf: the
    # CNN's fc1_w over a capacity of 100 twins
    n, k, m = EQ4_CAPACITY
    vals, ids = _seg_case(torch, gen, n, k, m)
    n_bytes = n * k * 4 + n * 4 + m * k * 4
    cap = _timed(
        torch, f"segment_reduce N={n} K={k} M={m} (capacity-axis Eq. 4)",
        lambda v, a: sr.segment_reduce_kernel(v, a, m),
        lambda v, a: sr._seg_tiled_plain(v, a, m),
        lambda v, a: torch.zeros((m, k), device="cuda").index_add_(
            0, a.long(), v),
        [(vals, ids)], n_bytes, n * k)
    cap.update(N=n, K=k, M=m)
    del vals, ids
    calls = seg_rows + [seg_rows[-1]]  # the N=100 K=1 call is made twice
    log(f"[timing] segment_reduce, one round's 11 calls (the weights and 8 "
        f"leaves of Eq. 4, Eqs. 12 and 15): kernel "
        f"{sum(r['ms'] for r in calls):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in calls):.4f} ms")
    return {"segment": seg_rows, "fedavg": fed, "eq4_capacity": cap}


def phase_slice(torch, sr, fr, data, kernels) -> dict:
    from repro_torch.fl import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                                FLConfig, example_association)

    cfg = FLConfig(use_kernel_aggregation=True)
    system = DTWNSystem(cfg, data, seed=0)  # cuda by default
    n_params = sum(v.numel() for v in system.params.values())
    if n_params != CNN_PARAMS:
        raise AssertionError(f"CNN has {n_params} params, not {CNN_PARAMS}")
    log(f"[slice] FLConfig() defaults: {cfg.n_users} users, {cfg.n_bs} BSs, "
        f"{cfg.local_iters} local iters, batch {cfg.batch_size}, "
        f"use_kernel_aggregation=True; data {data[2]} "
        f"{data[0][0].shape[0]}/{data[1][0].shape[0]}; CNN {n_params} params")
    _reset(kernels)  # every count, just before the round's path
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assoc = example_association(system)
        info = system.run_round(
            assoc, participating_users=EXAMPLE_PARTICIPATING_USERS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"[slice] round {info['round']}: wall {wall:.1f} ms, loss "
            f"{info['loss']:.6f}, round_time_s {info['round_time_s']:.6f}, "
            f"verified {info['n_verified']}/{info['n_submitted']}, "
            f"chain_valid {info['chain_valid']}")
        if not math.isfinite(info["loss"]):
            raise AssertionError(f"loss is not finite: {info['loss']}")
        if not info["chain_valid"]:
            raise AssertionError("chain does not validate")
    launches = {"segment_reduce": sr.KERNEL.launches,
                "fedavg_reduce": fr.KERNEL.launches}
    log(f"[slice] kernel launches in 3 rounds: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} kernel never launched in the slice")
    return launches


def phase_gpu_vs_cpu(torch, data) -> None:
    from repro_torch.core import comms
    from repro_torch.fl import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                                FLConfig, example_association)
    from repro_torch.models import cnn

    gen = torch.Generator().manual_seed(1)
    wcfg = comms.WirelessConfig(n_bs=5)
    init = {"params": {k: v.numpy() for k, v in cnn.init_params(gen).items()},
            "dist": comms.sample_distances(wcfg, gen).numpy(),
            "h_up": comms.sample_channel(wcfg, gen).numpy(),
            "h_down": comms.sample_channel(wcfg, gen).numpy()}
    cfg = FLConfig(use_kernel_aggregation=True)
    infos, assoc = {}, None
    for dev in ("cpu", "cuda"):
        system = DTWNSystem(cfg, data, seed=1, init_state=init, device=dev)
        if assoc is None:  # one association, computed on the CPU, for both
            assoc = example_association(system).numpy()
        infos[dev] = system.run_round(
            assoc, participating_users=EXAMPLE_PARTICIPATING_USERS)
        log(f"[gpu_vs_cpu] {dev}: chosen {infos[dev]['chosen']}, loss "
            f"{infos[dev]['loss']:.7f}, verified {infos[dev]['n_verified']}")
    cpu, gpu = infos["cpu"], infos["cuda"]
    if gpu["chosen"] != cpu["chosen"]:
        raise AssertionError("GPU and CPU rounds chose different twins")
    if gpu["n_verified"] != cpu["n_verified"]:
        raise AssertionError("GPU and CPU rounds verified different counts")
    rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    if rel > 1e-4:
        raise AssertionError(f"GPU loss {gpu['loss']} vs CPU {cpu['loss']}: "
                             f"relative difference {rel:.2e} > 1e-4")
    log(f"[gpu_vs_cpu] ok (tf32 off): same chosen and n_verified, loss "
        f"relative difference {rel:.2e} <= 1e-4")


def robust_round_launches(cfg, n_leaves: int) -> int:
    """Segment-kernel launches of one robust round, as the code makes them:
    the robust Eq. 4 rule (trimmed mean: the cohort counts, per leaf a
    centre numerator and denominator a peel pass and the weighted numerator
    and denominator, then ``bs_w``; Krum: ``bs_aggregate_stacked`` on the
    surviving weights), ``suspect_counts`` (3), ``update_dispersion`` (3:
    ``segment_std``'s two moments and its counts) and the Eqs. 12 and 15
    latency bill (2)."""
    if cfg.aggregator == "trimmed_mean":
        eq4 = 2 + n_leaves * (4 * cfg.trim_k + 2)
    else:
        eq4 = 1 + n_leaves
    return eq4 + 3 + 3 + 2


def _robust_config():
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.fl import FLConfig

    return FLConfig(use_kernel_aggregation=True, aggregator="trimmed_mean",
                    trim_k=1, malicious_frac=0.2, attack="model_replacement",
                    faults=FaultConfig(),
                    consensus=ConsensusConfig(quorum_f=1, byzantine_frac=0.2))


def _verdicts(system) -> dict:
    """The last block's chain verdicts, {BS: accepted}."""
    return {t.sender: dict(t.meta).get("verified", False)
            for t in system.chain.blocks[-1].transactions
            if t.kind == "train_model"}


def _c1b_record(torch, data, cfg) -> dict:
    """ROADMAP C1b's measurement, recorded and not asserted: the first
    trimmed-mean round from one state, twice, with cuDNN's default
    algorithms (the round's ``deterministic_cudnn`` context swapped for a
    null one), with its largest parameter difference; then 5 rounds on one
    system under each setting, timed. Runs off the counted path."""
    import contextlib

    from repro_torch.fl import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                                example_association)

    server = importlib.import_module("repro_torch.fl.server")
    kept = server.deterministic_cudnn

    def rounds(system, k):
        out = []
        for _ in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.run_round(example_association(system),
                             participating_users=EXAMPLE_PARTICIPATING_USERS)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    rec = {}
    try:
        server.deterministic_cudnn = contextlib.nullcontext
        a, b = DTWNSystem(cfg, data, seed=0), DTWNSystem(cfg, data, seed=0)
        rounds(a, 1)
        rounds(b, 1)
        rec["default_max_diff"] = max(
            float(torch.max(torch.abs(a.params[k] - b.params[k])))
            for k in a.params)
        rec["default_ms"] = rounds(b, 5)
    finally:
        server.deterministic_cudnn = kept
    rec["deterministic_ms"] = rounds(b, 5)
    log(f"[robust] C1b: with cuDNN's default algorithms two first rounds "
        f"from one state differ by up to {rec['default_max_diff']:.3e}; "
        f"steady rounds {', '.join(f'{x:.1f}' for x in rec['default_ms'])} "
        f"ms default, "
        f"{', '.join(f'{x:.1f}' for x in rec['deterministic_ms'])} ms "
        f"deterministic (medians {statistics.median(rec['default_ms']):.1f} "
        f"and {statistics.median(rec['deterministic_ms']):.1f})")
    return rec


def phase_robust_round(torch, sr, fr, data, kernels) -> dict:
    """The paper's round under attack, faults and PBFT verification at full
    width: 3 trimmed-mean rounds, then 1 Krum round, with every count set
    to 0 just before and read just after."""
    from repro_torch.core import comms, latency
    from repro_torch.fl import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                                example_association)

    t_phase = time.perf_counter()
    cfg = _robust_config()
    system = DTWNSystem(cfg, data, seed=0)  # cuda by default
    n_params = sum(v.numel() for v in system.params.values())
    if n_params != CNN_PARAMS:
        raise AssertionError(f"CNN has {n_params} params, not {CNN_PARAMS}")
    down = comms.downlink_rate(system.wireless, system.h_down, system.dist)
    eq16 = float(latency.t_block_validation(system.lat, down,
                                            system._freqs_dev))
    log(f"[robust] {cfg.n_users} users, {cfg.n_bs} BSs, CNN {n_params} "
        f"params; malicious_frac {cfg.malicious_frac} "
        f"({int(system.malicious.sum())} attackers, {cfg.attack}); "
        f"{cfg.faults}; {cfg.consensus}; Eq. 16 constant {eq16:.6f} s")
    plan = [cfg] * 3 + [dataclasses.replace(cfg, aggregator="krum",
                                            krum_f=1)]
    want = sum(robust_round_launches(c, len(system.params)) for c in plan)
    # ROADMAP C1b: the same trimmed-mean round from the same state, on a
    # second system built alike, must give the same bits
    twin = DTWNSystem(cfg, data, seed=0)
    twin_info = twin.run_round(
        example_association(twin),
        participating_users=EXAMPLE_PARTICIPATING_USERS)
    twin_params = {k: v.clone() for k, v in twin.params.items()}
    del twin
    c1b = _c1b_record(torch, data, cfg)
    _reset(kernels)  # every count, just before the path
    for i, c in enumerate(plan):
        system.cfg = c
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = system.run_round(
            example_association(system),
            participating_users=EXAMPLE_PARTICIPATING_USERS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"[robust] round {info['round']} ({c.aggregator}): wall "
            f"{wall:.1f} ms, loss {info['loss']:.6f}, round_time_s "
            f"{info['round_time_s']:.6f}, consensus_time_s "
            f"{info['consensus_time_s']:.6f}, verdicts {_verdicts(system)} "
            f"({info['n_verified']}/{info['n_submitted']}), n_suspect "
            f"{info['n_suspect']}, chosen attackers "
            f"{int(system.malicious[info['chosen']].sum())}")
        if not math.isfinite(info["loss"]):
            raise AssertionError(f"loss is not finite: {info['loss']}")
        if i == 0:
            same = (info["loss"] == twin_info["loss"] and all(
                torch.equal(system.params[k], v)
                for k, v in twin_params.items()))
            log(f"[robust] the first trimmed-mean round from one state, "
                f"twice: bitwise equal {same} (loss {twin_info['loss']!r} "
                f"and {info['loss']!r})")
            if not same:
                raise AssertionError("the trimmed-mean round does not "
                                     "repeat bit for bit (ROADMAP C1b)")
        if not info["chain_valid"]:
            raise AssertionError("chain does not validate")
        if not info["consensus_time_s"] > eq16:
            raise AssertionError(
                f"PBFT term {info['consensus_time_s']} is not above the Eq. "
                f"16 constant {eq16} at byzantine fraction "
                f"{c.consensus.byzantine_frac}")
    launches = {"segment_reduce": sr.KERNEL.launches,
                "fedavg_reduce": fr.KERNEL.launches}
    log(f"[robust] kernel launches in 4 rounds: {json.dumps(launches)}; "
        f"the code makes {want} segment launches; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if launches["segment_reduce"] != want:
        raise AssertionError(f"segment kernel launched "
                             f"{launches['segment_reduce']} times, not {want}")
    if launches["fedavg_reduce"] <= 0:
        raise AssertionError("fedavg kernel never launched in the robust "
                             "rounds")
    return {**launches, "c1b": c1b}


def phase_robust_gpu_vs_cpu(torch, data) -> None:
    """A trimmed-mean round and a Krum round, each under attack, faults and
    PBFT from one shared state, on the CPU and on the card (the fault draws
    come from the CPU generator on both). Besides the round's outputs, the
    aggregators' survivor fractions are compared: Krum's must be equal
    (its scores, sums of Gram-product distances, are summed in other
    orders by cuBLAS and the CPU), the trimmed mean's may differ only at
    near-tie coordinates."""
    from repro_torch.core import comms, faults
    from repro_torch.fl import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                                example_association)
    from repro_torch.models import cnn

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(2)
    wcfg = comms.WirelessConfig(n_bs=5)
    init = {"params": {k: v.numpy() for k, v in cnn.init_params(gen).items()},
            "dist": comms.sample_distances(wcfg, gen).numpy(),
            "h_up": comms.sample_channel(wcfg, gen).numpy(),
            "h_down": comms.sample_channel(wcfg, gen).numpy()}
    cfg = _robust_config()
    plan = [cfg, dataclasses.replace(cfg, aggregator="krum", krum_f=1)]
    runs, survivors = {}, []
    aggregate = faults.robust_bs_aggregate_stacked

    def recording(*a, **k):
        out = aggregate(*a, **k)
        survivors.append(out[2].cpu())
        return out

    faults.robust_bs_aggregate_stacked = recording
    try:
        assoc = None
        for c in plan:
            for dev in ("cpu", "cuda"):
                system = DTWNSystem(c, data, seed=1, init_state=init,
                                    device=dev)
                if assoc is None:
                    assoc = example_association(system).numpy()
                info = system.run_round(
                    assoc, participating_users=EXAMPLE_PARTICIPATING_USERS)
                runs[dev, c.aggregator] = (info, _verdicts(system),
                                           survivors[-1])
                log(f"[robust_gpu_vs_cpu] {dev} {c.aggregator}: chosen "
                    f"{info['chosen']}, verdicts {_verdicts(system)}, "
                    f"n_suspect {info['n_suspect']}, loss {info['loss']:.7f}"
                    f", round_time_s {info['round_time_s']:.7f}")
    finally:
        faults.robust_bs_aggregate_stacked = aggregate
    for c in plan:
        (cpu, v_cpu, s_cpu), (gpu, v_gpu, s_gpu) = (
            runs["cpu", c.aggregator], runs["cuda", c.aggregator])
        for key in ("chosen", "n_suspect"):
            if gpu[key] != cpu[key]:
                raise AssertionError(f"GPU and CPU {c.aggregator} rounds "
                                     f"differ in {key}: {gpu[key]} vs "
                                     f"{cpu[key]}")
        if v_gpu != v_cpu:
            raise AssertionError(f"GPU and CPU {c.aggregator} verdicts "
                                 f"differ: {v_gpu} vs {v_cpu}")
        rel = {k: abs(gpu[k] - cpu[k]) / abs(cpu[k])
               for k in ("loss", "round_time_s")}
        if rel["loss"] > 1e-4 or rel["round_time_s"] > 1e-5:
            raise AssertionError(f"GPU vs CPU {c.aggregator}: relative "
                                 f"differences {rel} above 1e-4 (loss) / "
                                 f"1e-5 (round_time_s)")
        surv = float((s_gpu - s_cpu).abs().max())
        if c.aggregator == "krum" and (surv != 0.0 or s_cpu.min() > 0.0):
            raise AssertionError(f"Krum must drop the same clients on the "
                                 f"GPU ({s_gpu.tolist()}) as on the CPU "
                                 f"({s_cpu.tolist()}), and at least one")
        log(f"[robust_gpu_vs_cpu] ok {c.aggregator} (tf32 off): same chosen, "
            f"verdicts and n_suspect; loss relative difference "
            f"{rel['loss']:.2e} <= 1e-4, round_time_s "
            f"{rel['round_time_s']:.2e} <= 1e-5; survivor fractions "
            f"{s_gpu.tolist()}, max difference {surv:.3e}")
    log(f"[robust_gpu_vs_cpu] phase {time.perf_counter() - t_phase:.1f} s")


def _flash_inputs(torch, gen, B, Sq, Sk, Hq, Hkv, hd, dtype, q_std=1.0):
    def draw(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)
    return (draw((B, Sq, Hq, hd), q_std), draw((B, Sk, Hkv, hd), 1.0),
            draw((B, Sk, Hkv, hd), 1.0))


def flash_main(serve) -> dict:
    """The prefill's attention call in the serving run that
    ``phase_serve`` drives: (B, S, Hq, Hkv, hd, window)."""
    from repro_torch.configs import get_arch_config

    cfg = get_arch_config(serve.ARCH)
    return dict(B=serve.BATCH, S=serve.PROMPT_LEN, Hq=cfg.n_heads,
                Hkv=cfg.n_kv_heads, hd=cfg.head_dim, window=cfg.sliding_window)


def phase_flash_check(torch, fa) -> None:
    """Kernel vs plain version on the reference tests' six cases: in fp32
    through the CUDA-core variant at the reference tests' 2e-5, and in bf16
    through the tensor-core variant at ROADMAP B3's 3e-2 (the kernel rounds
    P to bf16 before P.V, the plain version computes in fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype, variant, tol in ((torch.float32, "fp32", FLASH_TOL_F32),
                                (torch.bfloat16, "bf16_tc", FLASH_TOL_BF16)):
        for case in FLASH_CASES:
            *shape, causal, window, cap = case
            q, k, v = _flash_inputs(torch, gen, *shape, dtype)
            kw = dict(causal=causal, window=window, logit_softcap=cap)
            before = fa.KERNEL.variant_launches[variant]
            out = fa.flash_attention(q, k, v, **kw)
            if fa.KERNEL.variant_launches[variant] != before + 1:
                raise AssertionError(f"{dtype} did not launch the {variant} "
                                     f"variant")
            plain = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((out.float() - plain.float()).abs().max())
            torch.testing.assert_close(out, plain, rtol=tol, atol=tol)
            log(f"[flash] {variant} {case}: max_abs_err={err:.3e}")
        for case in FLASH_WIDE_CASES:
            *shape, causal, window, cap = case
            q, k, v = _flash_inputs(torch, gen, *shape, dtype)
            kw = dict(causal=causal, window=window, logit_softcap=cap)
            err = _flash_close(torch, fa, variant, (q, k, v), kw, tol)
            log(f"[flash] {variant} {case}: max_abs_err={err:.3e}")
        log(f"[flash] ok: {dtype} cases within {tol} of the plain version "
            f"through the {variant} variant")
    draw = torch.Generator(device="cuda").manual_seed(7)

    def bf16(*shape):
        return torch.randn(shape, generator=draw, device="cuda").bfloat16()
    k = bf16(1, 96, 2, 32)
    views = {
        "rows at +8 bytes": (bf16(1, 96, 4, 40)[..., 4:36], k, k),
        "72-byte head stride": (bf16(1, 96, 4, 36)[..., :32], k, k),
        "hd 20, contiguous": (bf16(2, 150, 4, 20), bf16(2, 150, 2, 20),
                              bf16(2, 150, 2, 20)),
    }
    for label, qkv in views.items():
        err = _flash_close(torch, fa, "bf16_tc", qkv,
                           dict(causal=True, window=0), FLASH_TOL_BF16)
        log(f"[flash] bf16_tc unaligned view ({label}): max_abs_err="
            f"{err:.3e}")
    log(f"[flash] ok: unaligned bf16 views within {FLASH_TOL_BF16} of the "
        f"plain version through the bf16_tc variant")


def _flash_close(torch, fa, variant, qkv, kw, tol) -> float:
    """One kernel call on ``qkv``, which must launch ``variant`` once, held
    against the plain version at ``tol``; returns the largest error."""
    before = fa.KERNEL.variant_launches[variant]
    out = fa.flash_attention(*qkv, **kw)
    if fa.KERNEL.variant_launches[variant] != before + 1:
        raise AssertionError(f"{qkv[0].dtype} did not launch the {variant} "
                             f"variant")
    plain = fa.flash_attention_plain(*qkv, **kw)
    torch.cuda.synchronize()
    if out.shape != plain.shape:
        raise AssertionError(f"kernel output {tuple(out.shape)}, plain "
                             f"{tuple(plain.shape)}")
    torch.testing.assert_close(out, plain, rtol=tol, atol=tol)
    return float((out.float() - plain.float()).abs().max())


def phase_flash_main(torch, fa, m) -> dict:
    """The prefill's attention call ``m`` in bf16: the kernel held against
    its plain version, then kernel, plain and library times, on the same
    inputs. q is drawn with std 4, so the scores have std 4 and the softmax
    is peaked: outputs of order 1, where bf16's rounding shows. The row's
    ``max_abs_err`` is the kernel's largest absolute error there."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _flash_inputs(torch, gen, m["B"], m["S"], m["S"], m["Hq"],
                            m["Hkv"], m["hd"], torch.bfloat16, q_std=4.0)
    before = fa.KERNEL.variant_launches["bf16_tc"]
    out = fa.flash_attention(q, k, v, window=m["window"])
    if fa.KERNEL.variant_launches["bf16_tc"] != before + 1:
        raise AssertionError("the prefill's call did not launch the bf16 "
                             "tensor-core variant")
    plain = fa.flash_attention_plain(q, k, v, window=m["window"])
    torch.cuda.synchronize()
    err = float((out.float() - plain.float()).abs().max())
    torch.testing.assert_close(out, plain, rtol=FLASH_TOL_BF16,
                               atol=FLASH_TOL_BF16)
    differ = float((out != plain).float().mean())
    log(f"[flash] bf16 prefill shape B={m['B']} S={m['S']} Hq/Hkv={m['Hq']}/"
        f"{m['Hkv']} hd={m['hd']} window={m['window']}: max_abs_err="
        f"{err:.3e} (held to {FLASH_TOL_BF16}), max |out| "
        f"{float(plain.float().abs().max()):.3f}, {differ:.2e} of the outputs "
        f"differ from the plain version's")
    del out, plain
    torch.cuda.empty_cache()
    pairs = m["B"] * m["Hq"] * fa.band_pairs(m["S"], m["S"], causal=True,
                                             window=m["window"])
    n_ops = 4 * m["hd"] * pairs  # 2 hd for q.k and 2 hd for p.v per pair
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    pos = torch.arange(m["S"], device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - m["window"])
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(qq, kk, vv):  # (B, H, S, hd) views; a yardstick only
        return sdpa(qq.transpose(1, 2), kk.transpose(1, 2),
                    vv.transpose(1, 2), attn_mask=mask, enable_gqa=True)

    row = _timed(torch, f"flash_attention B={m['B']} S={m['S']} "
                 f"Hq/Hkv={m['Hq']}/{m['Hkv']} hd={m['hd']} bf16",
                 lambda qq, kk, vv: fa.flash_attention(
                     qq, kk, vv, window=m["window"]),
                 lambda qq, kk, vv: fa.flash_attention_plain(
                     qq, kk, vv, window=m["window"]),
                 library, [(q, k, v)], n_bytes, n_ops, BF16_OPS_PER_S,
                 batch=4, reps=3)
    row["bound_fp32_ms"] = bound_ms(n_bytes, n_ops)[0]
    row.update(pairs=pairs, ops=n_ops, bytes=n_bytes, max_abs_err=err)
    row["tflops"] = n_ops / row["ms"] / 1e9
    log(f"[timing] flash_attention: band {pairs} (q, k) pairs, {n_ops:.4e} "
        f"ops, {n_bytes} bytes; bound {row['bound_ms']:.4f} ms at the bf16 "
        f"tensor-core peak, {row['bound_fp32_ms']:.4f} ms at the fp32 peak; "
        f"kernel at {row['tflops']:.2f} TFLOP/s, "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of its bf16 bound, "
        f"{row['ms'] / row['bound_fp32_ms']:.3f} of the fp32 bound")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return row


def phase_flash_shape(torch, fa, name, shape, seed) -> dict:
    """One self-attention shape of an LM family, ``shape`` = (B, S, Hq,
    Hkv, hd, causal, window, softcap), in bf16 through the tensor-core
    variant: held against the plain version, then kernel, plain and library
    times. SDPA takes no soft-cap: where there is one, its time over the
    same mask is a yardstick only."""
    B, S, Hq, Hkv, hd, causal, window, cap = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _flash_inputs(torch, gen, B, S, S, Hq, Hkv, hd, torch.bfloat16,
                            q_std=4.0)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    err = _flash_close(torch, fa, "bf16_tc", (q, k, v), kw, FLASH_TOL_BF16)
    torch.cuda.empty_cache()
    pairs = B * Hq * fa.band_pairs(S, S, causal=causal, window=window)
    n_ops = 4 * hd * pairs
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    pos = torch.arange(S, device="cuda")
    # without a window SDPA takes its own paths, is_causal for a causal
    # call (its fastest) and no mask for a non-causal one; a window needs
    # the mask
    masking = dict(is_causal=causal, attn_mask=None)
    if window:
        ok = pos[None, :] > pos[:, None] - window
        if causal:
            ok &= pos[None, :] <= pos[:, None]
        masking = dict(attn_mask=ok)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(qq, kk, vv):  # (B, H, S, hd) views; a yardstick only
        return sdpa(qq.transpose(1, 2), kk.transpose(1, 2),
                    vv.transpose(1, 2), enable_gqa=Hq != Hkv, **masking)

    row = _timed(torch, f"flash_attention {name} shape B={B} S={S} "
                 f"Hq/Hkv={Hq}/{Hkv} hd={hd} causal={causal} window={window} "
                 f"softcap={cap} bf16", lambda *a: fa.flash_attention(*a, **kw),
                 lambda *a: fa.flash_attention_plain(*a, **kw), library,
                 [(q, k, v)], n_bytes, n_ops, BF16_OPS_PER_S, batch=4, reps=3)
    row.update(max_abs_err=err, tflops=n_ops / row["ms"] / 1e9,
               shape=dict(zip(FLASH_SHAPE_KEYS, shape)))
    log(f"[flash] {name} shape: max_abs_err={err:.3e}; kernel at "
        f"{row['tflops']:.2f} TFLOP/s, {100 * row['bound_ms'] / row['ms']:.1f}% "
        f"of its bf16 bound")
    del q, k, v, masking
    torch.cuda.empty_cache()
    return row


def _shape_row(r) -> dict:
    """The kernels line's entry of one ``phase_flash_shape`` run."""
    return {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "max_abs_err")}


def _reset(kernels) -> None:
    for k in kernels:
        k.reset()


def _attention_layers(cfg) -> int:
    """The layers whose prefill attention goes through the flash kernel:
    every GQA layer (MLA's attention takes the plain path)."""
    if cfg.use_mla:
        return 0
    return sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))


def _windows(cfg) -> dict:
    """The flash calls a prefill makes, by sliding window (0: none)."""
    out = collections.Counter()
    for i in range(cfg.n_layers):
        if cfg.use_mla or not cfg.is_attn_layer(i):
            continue
        local = cfg.attn_pattern == "swa" or (
            cfg.attn_pattern == "local_global" and not cfg.is_global_attn_layer(i))
        out[cfg.sliding_window if local else 0] += 1
    return dict(out)


@contextlib.contextmanager
def _flash_calls(calls: list):
    """Record the (window, head dim, dtype, causal) of every call the
    attention layers make to ``kernels.ops.flash_attention``; the wrapper
    counts its launches as always."""
    ops = importlib.import_module("repro_torch.kernels.ops")
    inner = ops.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((kw.get("window", 0), q.shape[-1],
                      str(q.dtype).removeprefix("torch."),
                      kw.get("causal", True)))
        return inner(q, k, v, **kw)

    ops.flash_attention = recorded
    try:
        yield
    finally:
        ops.flash_attention = inner


# the flash variant a model's dtype launches
FLASH_VARIANT = {"bfloat16": "bf16_tc", "float32": "fp32"}


def _check_calls(torch, label, cfg, launches, calls) -> dict:
    """The flash kernel launched once per GQA layer, every call in the
    model's dtype at its head dim, with the config's windows; no other
    kernel launched. Returns the windows' counts."""
    n_attn = _attention_layers(cfg)
    windows = dict(collections.Counter(w for w, *_ in calls))
    if launches.pop("flash_attention") != n_attn or len(calls) != n_attn:
        raise AssertionError(f"{label}: {len(calls)} flash calls, not one per "
                             f"GQA layer ({n_attn})")
    if any(launches.values()):
        raise AssertionError(f"{label}: other kernels launched: {launches}")
    if windows != _windows(cfg) or any(
            h != cfg.head_dim or d != cfg.param_dtype or not causal
            for _, h, d, causal in calls):
        raise AssertionError(f"{label}: flash calls {calls}, expected "
                             f"windows {_windows(cfg)} at hd {cfg.head_dim}")
    return windows


def _check_generated(torch, label, res, cfg, batch, gen) -> None:
    tokens, logits = res["tokens"], res["logits"]
    if tuple(tokens.shape) != (batch, gen):
        raise AssertionError(f"{label}: generated {tuple(tokens.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: the served logits are not finite")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: a generated token is outside the "
                             f"vocabulary")
    if not torch.equal(logits[..., :cfg.vocab_size].argmax(-1), tokens):
        raise AssertionError(f"{label}: a generated token is not its "
                             f"logits' argmax")


def phase_serve(torch, kernels, fa, serve, arch=None) -> dict:
    """The serving CLI at full width on ``arch`` (default: the main path's,
    ``serve.ARCH``), with every count set to 0 just before and read just
    after: one flash launch per GQA layer, of the model's variant, at its
    head dim and windows, and no other kernel; tokens that are their
    finite logits' argmax."""
    arch = arch or serve.ARCH
    argv = ["--arch", arch, "--full", "--batch", str(serve.BATCH),
            "--prompt-len", str(serve.PROMPT_LEN), "--gen", str(serve.GEN)]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    _reset(kernels)
    with _flash_calls(calls):
        res = serve.main(argv)
    launches = {k.source.stem: k.launches for k in kernels}
    variants = dict(fa.KERNEL.variant_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = res["cfg"]
    n = launches["flash_attention"]
    log(f"[serve] kernel launches in the serving run: {json.dumps(launches)}; "
        f"flash variants {json.dumps(variants)}; peak device memory "
        f"{peak:.2f} GiB")
    windows = _check_calls(torch, arch, cfg, dict(launches), calls)
    variant = FLASH_VARIANT[cfg.param_dtype]
    if variants[variant] != n or res["flash_launches"] != n:
        raise AssertionError(f"{arch}: flash variants {variants}, "
                             f"{res['flash_launches']} of the {n} launches in "
                             f"the prefill")
    _check_generated(torch, arch, res, cfg, serve.BATCH, serve.GEN)
    log(f"[serve] ok: {arch}, {cfg.n_layers} layers: {n} {variant} flash "
        f"launches at hd {cfg.head_dim}, by window {json.dumps(windows)}; "
        f"{serve.BATCH} x {serve.GEN} tokens, finite logits; prefill "
        f"{res['prefill_ms']:.1f} ms, decode {res['decode_s'] * 1e3:.1f} ms "
        f"for {serve.GEN - 1} steps ({res['decode_tok_s']:.1f} tok/s)")
    return {"launches": n, "variant_launches": variants,
            "windows": {str(w): c for w, c in windows.items()},
            "hd": cfg.head_dim, "prefill_ms": res["prefill_ms"],
            "decode_s": res["decode_s"], "decode_tok_s": res["decode_tok_s"],
            "peak_gib": peak}


def phase_serve_kernel_vs_plain(torch, serve, arch=None,
                                dtypes=(("bfloat16", 5e-2),
                                        ("float32", 1e-3))) -> None:
    """The first served prompt at B=1 through the flash kernel and through
    the plain attention path (``use_pallas=False``: the chunked version),
    both on the card, with the same weights; last-position logits.
    ``arch`` defaults to the main path's (``serve.ARCH``).

    * bf16, the served model: each path rounds its attention outputs to
      bf16 once, from fp32 sums taken in another order, so a few outputs a
      layer differ by one bf16 ulp (2^-8 relative), and the layers of random
      weights carry that into the logits. Held to 5% of the logits' largest
      magnitude (danube's first chip run measured 1.5%).
    * fp32 weights from the same draws: the paths differ only in the order
      of fp32 sums. Held to 1e-3 of the largest magnitude.
    """
    from repro_torch.configs import get_arch_config
    from repro_torch.models import build_model

    arch = arch or serve.ARCH
    for dtype, tol in dtypes:
        cfg = dataclasses.replace(get_arch_config(arch), param_dtype=dtype)
        with torch.inference_mode():
            model, params = serve.random_model(cfg, serve.SEED, "cuda")
            prompt = serve.random_prompts(cfg, serve.BATCH, serve.PROMPT_LEN,
                                          serve.SEED, "cuda")[:1]
            batch = serve.prompt_batch(cfg, prompt)
            got, _ = model.forward(params, batch, last_only=True)
            plain, _ = build_model(cfg, use_pallas=False).forward(
                params, batch, last_only=True)
        got, plain = got[0, -1, :cfg.vocab_size], plain[0, -1, :cfg.vocab_size]
        err = float((got - plain).abs().max())
        scale = float(plain.abs().max())
        top = torch.topk(plain, 2).values
        log(f"[serve] {arch} {dtype} B=1 last-position logits, flash kernel "
            f"vs plain path: max_abs_diff {err:.4e}, max |logit| {scale:.4f}, "
            f"relative {err / scale:.3e} (held to {tol}); argmax "
            f"{int(got.argmax())} vs {int(plain.argmax())} (plain top-2 gap "
            f"{float(top[0] - top[1]):.4e})")
        if not err <= tol * scale:
            raise AssertionError(f"{arch} {dtype}: kernel and plain paths "
                                 f"differ by {err} > {tol} of max |logit| "
                                 f"{scale}")
        del model, params
        torch.cuda.empty_cache()


def _to(tree, dev):
    """Every tensor of a nest of dicts, lists and (named) tuples moved to
    ``dev``; other leaves (host ints, None) kept."""
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: x.to(dev) if hasattr(x, "to") else x, tree)


def phase_serve_gpu_vs_cpu(torch, fa, serve) -> None:
    """h2o-danube at full width cut to 2 layers, in fp32, with the same
    weights and a 1024-token prompt: 4 greedy tokens on the GPU (flash
    kernel) and on the CPU (its plain version). Same tokens, and logits
    within 1e-4, the CPU parity tests' tolerance for fp32 (tf32 off)."""
    from repro_torch.configs import get_arch_config

    cfg = dataclasses.replace(get_arch_config(serve.ARCH), n_layers=2,
                              param_dtype="float32")
    out = {}
    with torch.inference_mode():
        model, params = serve.random_model(cfg, 1, "cpu")
        prompt = serve.random_prompts(cfg, 1, 1024, 1, "cpu")
        for dev in ("cpu", "cuda"):
            t0 = time.perf_counter()
            before = fa.KERNEL.launches
            out[dev] = serve.generate(model, _to(params, dev), prompt.to(dev),
                                      4)
            log(f"[serve_gpu_vs_cpu] {dev}: tokens "
                f"{out[dev]['tokens'].tolist()} in "
                f"{time.perf_counter() - t0:.2f} s; flash launches "
                f"{fa.KERNEL.launches - before}")
    cpu, gpu = out["cpu"], out["cuda"]
    if not torch.equal(gpu["tokens"].cpu(), cpu["tokens"]):
        raise AssertionError("GPU and CPU generated different tokens")
    err = float((gpu["logits"].cpu() - cpu["logits"]).abs().max())
    torch.testing.assert_close(gpu["logits"].cpu(), cpu["logits"], rtol=1e-4,
                               atol=1e-4)
    log(f"[serve_gpu_vs_cpu] ok (tf32 off): same 4 tokens, logits max abs "
        f"difference {err:.3e} <= 1e-4")


def _ssd_inputs(torch, gen, B, S, H, P, N, dtype, *, as_forward=False):
    """x, dt, A, Bm, Cm on the card, x, Bm and Cm in ``dtype`` (dt and A
    fp32). By default as the reference tests draw them (x, B, C normal, dt
    = softplus of a normal, A = -exp of a normal); ``as_forward``: as
    ``mamba_forward`` makes them, x, B and C out of a SiLU, dt =
    softplus(normal + dt_bias 0), A = -exp(log(linspace(1, 16, H))), the
    init's decay rates."""
    F = torch.nn.functional

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if as_forward:
        x, bm, cm = (F.silu(draw(B, S, H, P)), F.silu(draw(B, S, N)),
                     F.silu(draw(B, S, N)))
        A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device="cuda")))
    else:
        x, bm, cm = draw(B, S, H, P), draw(B, S, N), draw(B, S, N)
        A = -torch.exp(draw(H))
    dt = F.softplus(draw(B, S, H))
    return x.to(dtype), dt, A, bm.to(dtype), cm.to(dtype)


def _ssd_close(torch, out, plain, label) -> float:
    err = float((out - plain).abs().max())
    torch.testing.assert_close(out, plain, rtol=SSD_RTOL, atol=SSD_ATOL)
    log(f"[ssd] {label}: max_abs_err={err:.3e}, max |y| "
        f"{float(plain.abs().max()):.3f}")
    return err


def _ssd_hold(torch, ssd, args, chunk, label) -> float:
    """The kernel against its plain version on ``args``, at the reference
    tests' tolerance, and bitwise repeatable; returns the max abs error."""
    out = ssd.ssd_scan(*args, chunk=chunk)
    again = ssd.ssd_scan(*args, chunk=chunk)
    plain = ssd.ssd_scan_plain(*args, chunk)
    torch.cuda.synchronize()
    err = _ssd_close(torch, out, plain, label)
    if not torch.equal(out, again):
        raise AssertionError(f"SSD kernel not bitwise repeatable at {label}")
    del out, again, plain
    torch.cuda.empty_cache()
    return err


def phase_ssd_check(torch, ssd) -> None:
    """Kernel vs plain version on the reference tests' four cases, with x,
    B and C in fp32 and in bf16 (the plain version widens them, exactly),
    at the reference tests' tolerance, and bitwise repeatable."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES:
            *shape, chunk = case
            args = _ssd_inputs(torch, gen, *shape, dtype)
            _ssd_hold(torch, ssd, args, chunk, f"{case} {dtype}")
    log(f"[ssd] ok: cases within atol {SSD_ATOL} / rtol {SSD_RTOL} of the "
        f"plain version, bitwise repeatable")


def ssd_main(serve) -> dict:
    """The forward's SSD call, one per layer: (B, S, H, P, N, chunk)."""
    from repro_torch.configs import get_arch_config

    cfg = get_arch_config(serve.SSM_ARCH)
    return dict(B=serve.BATCH, S=serve.PROMPT_LEN, H=cfg.ssm_heads,
                P=cfg.ssm_head_dim, N=cfg.ssm_state, chunk=cfg.ssm_chunk)


def device_parts(torch, fn, reps: int = 3) -> dict:
    """Device ms a call of each SSD launch (``ssd_*`` kernels), from a
    torch.profiler trace of ``reps`` calls of ``fn``; empty when the
    profiler records no device time."""
    import re

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        name = re.search(r"ssd_\w+", ev.key)
        if name and getattr(ev, "device_time_total", 0):
            parts[name.group(0)] = (parts.get(name.group(0), 0.0)
                                    + ev.device_time_total / 1e3 / reps)
    return parts


def phase_ssd_main(torch, ssd, m) -> dict:
    """The forward's SSD call ``m``: the kernel held against its plain
    version on inputs drawn as the forward makes them, with x, B and C in
    fp32 and in bf16 (as the forward passes them); then kernel and plain
    times on the bf16 inputs, and the device time of each of the kernel's
    launches. No single PyTorch call computes the scan, so there is no
    library time.

    ``bound_ms`` is what the function needs: the bytes at the HBM rate
    against the scan's flops at the bf16 tensor-core peak (its inputs are
    bf16). Beside it: ``bound_tf32_form_ms``, the kernel's own form (two
    TF32 products per multiply-add on bf16 x, B and C, ``TF32_TERMS``, at
    the TF32 peak), and ``bound_fp32_ms``, the scan's flops at the fp32
    peak outside the tensor cores (the bound of a CUDA-core form)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = [m[k] for k in ("B", "S", "H", "P", "N")]
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssd_inputs(torch, gen, *shape, dtype, as_forward=True)
        err[dtype] = _ssd_hold(torch, ssd, args, m["chunk"],
                               f"forward shape {m}, {dtype}")
    dtype = torch.bfloat16
    flops = ssd.ssd_flops(*shape, m["chunk"])
    n_bytes = ssd.ssd_bytes(*shape, args[0].element_size())
    label = "ssd_scan " + " ".join(f"{k}={v}" for k, v in m.items())
    row = _timed(torch, f"{label} bf16 x/B/C",
                 lambda *a: ssd.ssd_scan(*a, chunk=m["chunk"]),
                 lambda *a: ssd.ssd_scan_plain(*a, m["chunk"]),
                 None, [args], n_bytes, flops, BF16_OPS_PER_S, batch=4,
                 reps=3)
    row["bound_tf32_form_ms"] = bound_ms(
        n_bytes, ssd.TF32_TERMS[dtype] * flops, TF32_OPS_PER_S)[0]
    row["bound_fp32_ms"] = bound_ms(n_bytes, flops)[0]
    row["bound_bf16_ms"] = row["bound_ms"]
    row["parts_ms"] = device_parts(
        torch, lambda: ssd.ssd_scan(*args, chunk=m["chunk"])) or None
    row["tflops"] = flops / row["ms"] / 1e9
    row.update(flops=flops, bytes=n_bytes, max_abs_err=err[dtype],
               max_abs_err_fp32=err[torch.float32])
    parts = ("not measured (no device events)" if row["parts_ms"] is None
             else ", ".join(f"{k} {v:.4f}" for k, v in row["parts_ms"].items()))
    log(f"[timing] ssd_scan: {flops:.4e} flops, {n_bytes} bytes; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; flops at the bf16 "
        f"tensor-core peak), {row['bound_tf32_form_ms']:.4f} for the "
        f"kernel's form ({ssd.TF32_TERMS[dtype]} TF32 products a "
        f"multiply-add at the TF32 peak), {row['bound_fp32_ms']:.4f} at the "
        f"fp32 peak; kernel at {row['tflops']:.2f} TFLOP/s of scan flops, "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of its bound, "
        f"{100 * row['bound_tf32_form_ms'] / row['ms']:.1f}% of its form's")
    log(f"[timing] ssd_scan device ms a call by launch: {parts}")
    del args
    torch.cuda.empty_cache()
    return row


def _last_logits_close(torch, got, plain, tol, label) -> None:
    got, plain = got[..., -1, :].float(), plain[..., -1, :].float()
    err = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    same = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"[logits] {label}: last-position logits max_abs_diff {err:.4e}, max "
        f"|logit| {scale:.4f}, relative {err / scale:.3e} (held to {tol}); "
        f"same argmax in {same:.2f} of the rows")
    if not err <= tol * scale:
        raise AssertionError(f"{label}: logits differ by {err} > {tol} of "
                             f"max |logit| {scale}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_mamba_forward(torch, kernels, serve) -> dict:
    """The main path: mamba2-2.7b's forward at full width through the SSD
    kernel, with every count set to 0 just before and read just after;
    then the same forward through the plain SSD (``use_pallas=False``) on
    the same weights and prompts.

    * bf16, the model as served: the two paths differ in the order of fp32
      sums inside the scan, and y is rounded to bf16, so a few values a
      layer differ by one bf16 ulp (2^-8 relative) and 64 layers of random
      weights carry that into the logits: held to 5% of their largest
      magnitude, as the flash path's check.
    * fp32 weights from the same draws, B=1: only the order of fp32 sums
      differs. Held to 1e-3 of the largest magnitude.
    """
    from repro_torch.configs import get_arch_config
    from repro_torch.models import build_model

    cfg = get_arch_config(serve.SSM_ARCH)
    with torch.inference_mode():
        model, params = serve.random_model(cfg, serve.SEED, "cuda")
        n_params = sum(v.numel() for v in _leaves(params))
        tokens = serve.random_prompts(cfg, serve.BATCH, serve.PROMPT_LEN,
                                      serve.SEED, "cuda")
        log(f"[mamba] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.ssm_heads} heads x P {cfg.ssm_head_dim}, N "
            f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab "
            f"{cfg.vocab_padded}, {cfg.param_dtype}; {n_params} parameters "
            f"(param_count {cfg.param_count()}); tokens "
            f"{tuple(tokens.shape)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        t0 = time.perf_counter()
        logits, _ = model.forward(params, {"tokens": tokens}, last_only=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k.source.stem: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[mamba] forward B={serve.BATCH} S={serve.PROMPT_LEN}: {wall:.1f} "
            f"ms (cold, host clock); kernel launches {json.dumps(launches)}; "
            f"peak device memory {peak:.2f} GiB")
        if launches["ssd_scan"] != cfg.n_layers:
            raise AssertionError(f"the forward launched the SSD kernel "
                                 f"{launches['ssd_scan']} times, not once per "
                                 f"layer ({cfg.n_layers})")
        if tuple(logits.shape) != (serve.BATCH, 1, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"forward logits {tuple(logits.shape)} not "
                                 f"finite or not (B, 1, vocab_padded)")
        t0 = time.perf_counter()
        logits2, _ = model.forward(params, {"tokens": tokens}, last_only=True)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        if not torch.equal(logits, logits2):
            raise AssertionError("two forwards gave different logits")
        log(f"[mamba] forward again: {warm:.1f} ms (warm), the same logits")
        plain, _ = build_model(cfg, use_pallas=False).forward(
            params, {"tokens": tokens}, last_only=True)
        _last_logits_close(torch, logits, plain, 5e-2,
                           f"bf16 B={serve.BATCH}, kernel vs plain-SSD "
                           f"forward")
        del model, params, plain, logits2
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        model, params = serve.random_model(cfg32, serve.SEED, "cuda")
        got, _ = model.forward(params, {"tokens": tokens[:1]}, last_only=True)
        plain, _ = build_model(cfg32, use_pallas=False).forward(
            params, {"tokens": tokens[:1]}, last_only=True)
        _last_logits_close(torch, got, plain, 1e-3,
                           "fp32 B=1, kernel vs plain-SSD forward")
        del model, params
    torch.cuda.empty_cache()
    return {"launches": launches["ssd_scan"], "cold_ms": wall,
            "warm_ms": warm, "peak_gib": peak}


def phase_mamba_gpu_vs_cpu(torch, ssd, serve) -> None:
    """mamba2-2.7b at full width cut to 2 layers, in fp32, with the same
    weights: the forward's last-position logits over a 512-token prompt (2
    chunks) on the GPU (SSD kernel) and on the CPU (its plain version),
    and 4 greedy tokens after a 16-token prompt through the serving loop
    (stepped prefill). Same tokens, logits within 1e-4, the CPU parity
    tests' tolerance for fp32 (tf32 off)."""
    from repro_torch.configs import get_arch_config

    cfg = dataclasses.replace(get_arch_config(serve.SSM_ARCH), n_layers=2,
                              param_dtype="float32")
    fwd, gen = {}, {}
    with torch.inference_mode():
        model, params = serve.random_model(cfg, 1, "cpu")
        prompt = serve.random_prompts(cfg, 1, 512, 1, "cpu")
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            before = ssd.KERNEL.launches
            fwd[dev], _ = model.forward(p, {"tokens": prompt.to(dev)},
                                        last_only=True)
            gen[dev] = serve.generate(model, p, prompt[:, :16].to(dev), 4)
            log(f"[mamba_gpu_vs_cpu] {dev}: SSD launches "
                f"{ssd.KERNEL.launches - before}; tokens "
                f"{gen[dev]['tokens'].tolist()}")
    err = float((fwd["cuda"].cpu() - fwd["cpu"]).abs().max())
    torch.testing.assert_close(fwd["cuda"].cpu(), fwd["cpu"], rtol=1e-4,
                               atol=1e-4)
    if not torch.equal(gen["cuda"]["tokens"].cpu(), gen["cpu"]["tokens"]):
        raise AssertionError("GPU and CPU generated different tokens")
    gerr = float((gen["cuda"]["logits"].cpu() - gen["cpu"]["logits"]).abs()
                 .max())
    torch.testing.assert_close(gen["cuda"]["logits"].cpu(),
                               gen["cpu"]["logits"], rtol=1e-4, atol=1e-4)
    log(f"[mamba_gpu_vs_cpu] ok (tf32 off): forward logits max abs "
        f"difference {err:.3e}, decode logits {gerr:.3e} (<= 1e-4), same 4 "
        f"tokens")


def phase_ssm_serve(torch, kernels, serve) -> None:
    """The serving CLI on mamba2 at full width with a short prompt, counts
    set to 0 just before and read just after: the prefill steps
    ``decode_step`` over the prompt (as the reference's serve does), so it
    runs ``mamba_decode`` on the card and launches no kernel."""
    B, P, G = SSM_SERVE
    argv = ["--arch", serve.SSM_ARCH, "--full", "--batch", str(B),
            "--prompt-len", str(P), "--gen", str(G)]
    log(f"[ssm_serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    _reset(kernels)
    res = serve.main(argv)
    launches = {k.source.stem: k.launches for k in kernels}
    log(f"[ssm_serve] kernel launches in the run: {json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError("the stepped SSM serve launched a kernel")
    _check_generated(torch, serve.SSM_ARCH, res, res["cfg"], B, G)
    log(f"[ssm_serve] ok: {B} x {G} tokens, finite logits; prefill "
        f"{res['prefill_ms']:.1f} ms ({P} steps), decode "
        f"{res['decode_tok_s']:.1f} tok/s")


# ---------------------------------------------------------------------------
# the other LM families (ROADMAP A11.1-A11.7)
# ---------------------------------------------------------------------------

QWEN2VL = "qwen2-vl-7b"
SEAMLESS = "seamless-m4t-large-v2"
# served at full width through the serving CLI, at the main path's shape
# (qwen2-vl through its vision stub: merged embeddings, M-RoPE positions)
LM_SERVED = ("gemma2-9b", "qwen1.5-4b", QWEN2VL)
# full-width layer cuts (arch, layers kept), each about 20 GB of bf16
# weights: mixtral 4 of 56, command-r-plus 4 of 64, deepseek-v2 its dense
# prologue and 2 MoE layers
LM_CUTS = (("mixtral-8x22b", 4), ("command-r-plus-104b", 4),
           ("deepseek-v2-236b", 3))
LM_CUT_GEN = 4
# jamba at full width needs ~90 GB of bf16 weights a period (four 16-expert
# MoE FFNs): it runs at its smoke config
JAMBA = "jamba-1.5-large-398b"
LM_ARCHS = LM_SERVED + tuple(a for a, _ in LM_CUTS) + (JAMBA, SEAMLESS)
# GPU against CPU: prompt length, generated tokens
LM_CHECK = (64, 3)
# qwen2-vl's image layout at the main path's prompt: text, an h x w block
# of merged patches, text (n_text, h, w, n_after); and the GPU-against-CPU
# check's at LM_CHECK's 64 positions; new tokens after the layout's prefill
QWEN2VL_LAYOUT = (1024, 48, 64, 512)
QWEN2VL_CHECK_LAYOUT = (16, 4, 6, 24)
QWEN2VL_LAYOUT_GEN = 4
# seamless's audio stub: decode steps from BOS over 4608 // 4 = 1152 frames
# (the CLI's P + G - 1 = 4639 cut to keep the run short)
SEAMLESS_STEPS = 32


def mrope_layout(torch, batch, n_text, h, w, n_after, device):
    """M-RoPE positions (batch, S, 3) of ``n_text`` text tokens, an ``h`` x
    ``w`` image block of merged patches, then ``n_after`` text tokens
    (arXiv:2409.12191 §2.1): text takes its index on all three axes; the
    block takes one temporal index (the next free one) and its row and
    column added to it on the height and width axes; text after it resumes
    past the largest id so far."""
    text = torch.arange(n_text, device=device)[:, None].expand(n_text, 3)
    rows, cols = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
    img = torch.stack([torch.zeros_like(rows.reshape(-1)), rows.reshape(-1),
                       cols.reshape(-1)], 1) + n_text
    start = n_text + max(h, w)
    after = (start + torch.arange(n_after, device=device))[:, None].expand(
        n_after, 3)
    pos = torch.cat([text, img, after])
    return pos[None].expand(batch, *pos.shape).contiguous()


def phase_lm_serve(torch, kernels, fa, serve, arch) -> dict:
    """``phase_serve`` on ``arch`` at the main path's shape, then its kernel
    path against the plain attention path at B=1
    (``phase_serve_kernel_vs_plain``'s bf16 check)."""
    t_phase = time.perf_counter()
    out = phase_serve(torch, kernels, fa, serve, arch)
    torch.cuda.empty_cache()
    phase_serve_kernel_vs_plain(torch, serve, arch, (("bfloat16", 5e-2),))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[lm_serve] {arch}: phase {out['seconds']:.1f} s")
    return out


def phase_lm_cuts(torch, kernels, serve) -> dict:
    """Full-width layer cuts (``LM_CUTS``: bf16, random weights from a
    seed), each serving ``serve.BATCH`` prompts of ``serve.PROMPT_LEN``
    tokens and ``LM_CUT_GEN`` new ones through ``serve.generate``, every
    count set to 0 just before and read just after: mixtral with its
    capacity router (T = 18,432 tokens, 5,760 slots an expert),
    command-r-plus with its tied 256,000-row embedding, deepseek-v2's MLA
    (the plain attention path: no flash launch) over its dense prologue
    and 160-expert MoE layers. Finite logits whose argmax is the generated
    token."""
    from repro_torch.configs import get_arch_config
    from repro_torch.models import moe

    out = {}
    for arch, n_layers in LM_CUTS:
        t_phase = time.perf_counter()
        cfg = dataclasses.replace(get_arch_config(arch), n_layers=n_layers)
        label = f"{arch} cut to {n_layers} layers"
        torch.cuda.empty_cache()
        with torch.inference_mode():
            model, params = serve.random_model(cfg, serve.SEED, "cuda")
            n_params = sum(v.numel() for v in _leaves(params))
            prompts = serve.random_prompts(cfg, serve.BATCH, serve.PROMPT_LEN,
                                           serve.SEED, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            calls = []
            _reset(kernels)
            with _flash_calls(calls):
                res = serve.generate(model, params, prompts, LM_CUT_GEN)
        launches = {k.source.stem: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated() / 2**30
        windows = _check_calls(torch, label, cfg, dict(launches), calls)
        _check_generated(torch, label, res, cfg, serve.BATCH, LM_CUT_GEN)
        T = serve.BATCH * serve.PROMPT_LEN
        slots = moe.capacity(cfg, T) if cfg.router_mode == "capacity" else None
        n_dec = serve.BATCH * (LM_CUT_GEN - 1)
        row = {"n_layers": n_layers, "params": n_params,
               "launches": launches["flash_attention"],
               "windows": {str(w): c for w, c in windows.items()},
               "prefill_ms": res["prefill_ms"],
               "decode_tok_s": n_dec / res["decode_s"], "peak_gib": peak,
               "capacity": slots}
        log(f"[lm_cuts] ok: {label}: {n_params} parameters ({cfg.param_dtype}"
            f"), {cfg.n_experts} experts top-{cfg.moe_top_k} "
            f"{cfg.router_mode}, capacity {slots} slots an expert at T={T}; "
            f"flash launches {row['launches']} by window "
            f"{json.dumps(row['windows'])}; {serve.BATCH} x {LM_CUT_GEN} "
            f"tokens, finite logits; prefill {res['prefill_ms']:.1f} ms, "
            f"decode {row['decode_tok_s']:.1f} tok/s; peak device memory "
            f"{peak:.2f} GiB")
        del model, params, prompts, res
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_phase
        log(f"[lm_cuts] {label}: {row['seconds']:.1f} s")
        out[f"{arch}/{n_layers}"] = row
    return out


def phase_jamba(torch, kernels, fa, serve) -> dict:
    """jamba's smoke config (2 layers: a mamba and an attention mixer, a
    dense and a 4-expert MoE FFN, d 256) on the card at the main path's
    ``serve.BATCH`` x ``serve.PROMPT_LEN``: ``forward(use_pallas=True)``,
    its scoring path, launches the SSD kernel once a mamba mixer and the
    flash kernel once an attention layer (counts set to 0 just before the
    bf16 forward and read just after); its last-position logits are held
    against the plain forward (``use_pallas=False``), at 5% of the largest
    logit in bf16 and 1e-3 in fp32 (``phase_mamba_forward``'s checks)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import block_layout

    t_phase = time.perf_counter()
    out = {}
    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-3)):
        cfg = dataclasses.replace(get_smoke_config(JAMBA), param_dtype=dtype)
        n_blocks = block_layout(cfg)[1]
        with torch.inference_mode():
            model, params = serve.random_model(cfg, serve.SEED, "cuda")
            tokens = serve.random_prompts(cfg, serve.BATCH, serve.PROMPT_LEN,
                                          serve.SEED, "cuda")
            torch.cuda.synchronize()
            calls = []
            _reset(kernels)
            with _flash_calls(calls):
                logits, aux = model.forward(params, {"tokens": tokens},
                                            last_only=True)
            torch.cuda.synchronize()
            launches = {k.source.stem: k.launches for k in kernels}
            variants = dict(fa.KERNEL.variant_launches)
            plain, plain_aux = build_model(cfg, use_pallas=False).forward(
                params, {"tokens": tokens}, last_only=True)
        label = f"jamba smoke {dtype} B={serve.BATCH} S={serve.PROMPT_LEN}"
        ssd_n = launches.pop("ssd_scan")
        if ssd_n != n_blocks * (cfg.attn_every - 1):
            raise AssertionError(f"{label}: {ssd_n} SSD launches, not one "
                                 f"per mamba mixer")
        variant = FLASH_VARIANT[dtype]
        _check_calls(torch, label, cfg, launches, calls)
        if variants[variant] != n_blocks:
            raise AssertionError(f"{label}: flash variants {variants}")
        if not (bool(torch.isfinite(logits).all())
                and math.isfinite(float(aux))):
            raise AssertionError(f"{label}: logits or aux not finite")
        _last_logits_close(torch, logits, plain, tol,
                           f"{label}, kernels vs plain forward")
        aux_gap = abs(float(aux) - float(plain_aux))
        log(f"[jamba] {label}: SSD launches {ssd_n}, flash {len(calls)} "
            f"({variant}); aux {float(aux):.6f}, plain {float(plain_aux):.6f}")
        if dtype == "bfloat16":
            out.update(ssd_launches=ssd_n, flash_launches=len(calls),
                       aux_gap=aux_gap)
        del model, params
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[jamba] phase {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def _router_calls(torch, calls: list):
    """Record, for every ``moe.router_probs`` call, the chosen experts and
    the router's top-k margin (the k-th probability less the next) of each
    token, on the host."""
    moe = importlib.import_module("repro_torch.models.moe")
    inner = moe.router_probs

    def recorded(cfg, p, x):
        gates, idx, aux = inner(cfg, p, x)
        probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
        top = torch.topk(probs, cfg.moe_top_k + 1, dim=-1).values
        calls.append((idx.cpu(), (top[:, -2] - top[:, -1]).cpu()))
        return gates, idx, aux

    moe.router_probs = recorded
    try:
        yield
    finally:
        moe.router_probs = inner


def phase_lm_gpu_vs_cpu(torch, serve) -> dict:
    """Each family of ``LM_ARCHS`` on the GPU against the CPU: a 2-layer
    fp32 cut at full width (jamba: its smoke config, 2 layers fp32;
    seamless: 2 encoder and 2 decoder layers), one state drawn on the card
    and copied to the CPU, ``LM_CHECK`` = (prompt, new tokens) through
    ``serve.generate`` (and the kernel forward of jamba and of seamless,
    whose ``generate`` runs only the encoder through the kernel). qwen2-vl
    serves an image layout (``QWEN2VL_CHECK_LAYOUT``), its decode steps'
    embeddings drawn on the card; seamless decodes ``G`` steps from BOS
    over ``P // 4`` frames. First the MoE routers' chosen experts, call by
    call, must be equal on both devices (a flip on a near-tie is reported
    with the router's top-k margin at that token); then the same tokens and
    logits within 1e-4, the CPU parity tests' tolerance for fp32 (tf32
    off)."""
    from repro_torch.configs import get_arch_config, get_smoke_config

    P, G = LM_CHECK
    out = {}
    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        if arch == JAMBA:
            cfg = get_smoke_config(arch)
        else:
            cfg = dataclasses.replace(get_arch_config(arch), n_layers=2,
                                      param_dtype="float32")
        if cfg.is_encoder_decoder:
            cfg = dataclasses.replace(cfg, n_enc_layers=2)
        res, fwd, routes, kw, score = {}, {}, {}, {}, None
        with torch.inference_mode():
            model, params = serve.random_model(cfg, 1, "cuda")
            prompt = serve.random_prompts(cfg, 1, P, 1, "cuda")
            if arch == QWEN2VL:
                draw = torch.Generator(device="cuda").manual_seed(2)
                kw = {"positions": mrope_layout(torch, 1, *QWEN2VL_CHECK_LAYOUT,
                                                "cuda"),
                      "step_embeds": torch.randn((1, G - 1, cfg.d_model),
                                                 generator=draw,
                                                 device="cuda")}
            if cfg.attn_every:  # the hybrid's kernel path
                score = {"tokens": prompt}
            elif cfg.is_encoder_decoder:
                draw = torch.Generator(device="cuda").manual_seed(3)
                score = {"frames": prompt, "tokens": torch.randint(
                    0, cfg.vocab_size, (1, P), generator=draw,
                    device="cuda")}
            for dev in ("cuda", "cpu"):
                p = params if dev == "cuda" else _to(params, "cpu")
                routes[dev] = []
                with _router_calls(torch, routes[dev]):
                    if score is not None:
                        fwd[dev], _ = model.forward(p, _to(score, dev),
                                                    last_only=True)
                    res[dev] = serve.generate(model, p, prompt.to(dev), G,
                                              **_to(kw, dev))
                del p
            del model, params
        torch.cuda.empty_cache()
        gpu, cpu = routes["cuda"], routes["cpu"]
        if len(gpu) != len(cpu):
            raise AssertionError(f"{arch}: {len(gpu)} router calls on the GPU, "
                                 f"{len(cpu)} on the CPU")
        margin = min((float(m.min()) for _, m in cpu), default=None)
        for call, ((gi, gm), (ci, cm)) in enumerate(zip(gpu, cpu)):
            if not torch.equal(gi, ci):
                bad = (gi != ci).any(-1).nonzero()[:, 0]
                raise AssertionError(
                    f"{arch}: router call {call} chose other experts on the "
                    f"GPU at tokens {bad.tolist()}; top-k margins there "
                    f"{cm[bad].tolist()} (CPU), {gm[bad].tolist()} (GPU)")
        if not torch.equal(res["cuda"]["tokens"].cpu(), res["cpu"]["tokens"]):
            raise AssertionError(f"{arch}: GPU and CPU generated different "
                                 f"tokens")
        err = float((res["cuda"]["logits"].cpu() - res["cpu"]["logits"])
                    .abs().max())
        torch.testing.assert_close(res["cuda"]["logits"].cpu(),
                                   res["cpu"]["logits"], rtol=1e-4, atol=1e-4)
        row = {"logits_max_abs_diff": err, "router_calls": len(gpu),
               "router_min_margin": margin}
        if fwd:
            row["forward_max_abs_diff"] = float(
                (fwd["cuda"].cpu() - fwd["cpu"]).abs().max())
            torch.testing.assert_close(fwd["cuda"].cpu(), fwd["cpu"],
                                       rtol=1e-4, atol=1e-4)
        row["seconds"] = time.perf_counter() - t0
        log(f"[lm_gpu_vs_cpu] ok (tf32 off): {cfg.name} {cfg.n_layers} layers "
            f"fp32, prompt {P}, {G} tokens {res['cpu']['tokens'].tolist()}; "
            f"logits max abs difference {err:.3e} <= 1e-4"
            + (f", forward {row['forward_max_abs_diff']:.3e}" if fwd else "")
            + (f"; {len(gpu)} router calls, the same experts, smallest top-k "
               f"margin {margin:.3e}" if gpu else "")
            + f"; {row['seconds']:.1f} s")
        out[arch] = row
    return out


def phase_qwen2vl_layout(torch, kernels, serve) -> dict:
    """qwen2-vl-7b at full width with an image layout in which the three
    M-RoPE axes differ (``QWEN2VL_LAYOUT``: 1,024 text positions, a 48 x
    64 block of merged patches, 512 text positions; the serve CLI's
    positions are equal on all three axes, where M-RoPE is RoPE):
    ``serve.generate`` prefills the ``serve.BATCH`` x ``serve.PROMPT_LEN``
    embeddings with those positions and decodes ``QWEN2VL_LAYOUT_GEN``
    tokens, every count set to 0 just before and read just after (one
    bf16 flash launch a layer); then the first prompt's last-position
    logits through the kernel and through the plain attention path (5% of
    the largest logit), and how far the layout moves them from the
    equal-axes positions."""
    from repro_torch.configs import get_arch_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_arch_config(QWEN2VL)
    label = f"{QWEN2VL} image layout {QWEN2VL_LAYOUT}"
    torch.cuda.empty_cache()
    with torch.inference_mode():
        model, params = serve.random_model(cfg, serve.SEED, "cuda")
        embeds = serve.random_prompts(cfg, serve.BATCH, serve.PROMPT_LEN,
                                      serve.SEED, "cuda")
        positions = mrope_layout(torch, serve.BATCH, *QWEN2VL_LAYOUT, "cuda")
        if positions.shape[1] != serve.PROMPT_LEN:
            raise AssertionError(f"{label}: {positions.shape[1]} positions")
        torch.cuda.synchronize()
        calls = []
        _reset(kernels)
        with _flash_calls(calls):
            res = serve.generate(model, params, embeds, QWEN2VL_LAYOUT_GEN,
                                 positions=positions)
        launches = {k.source.stem: k.launches for k in kernels}
        windows = _check_calls(torch, label, cfg, dict(launches), calls)
        _check_generated(torch, label, res, cfg, serve.BATCH,
                         QWEN2VL_LAYOUT_GEN)
        one = {"embeds": embeds[:1], "positions": positions[:1]}
        got, _ = model.forward(params, one, last_only=True)
        plain, _ = build_model(cfg, use_pallas=False).forward(
            params, one, last_only=True)
        equal, _ = model.forward(params, serve.prompt_batch(cfg, embeds[:1]),
                                 last_only=True)
    V = cfg.vocab_size
    _last_logits_close(torch, got[..., :V], plain[..., :V], 5e-2,
                       f"{label} B=1, flash kernel vs plain path")
    moved = float((got[..., :V] - equal[..., :V]).abs().max())
    n = launches["flash_attention"]
    out = {"launches": n, "windows": {str(w): c for w, c in windows.items()},
           "prefill_ms": res["prefill_ms"],
           "decode_tok_s": serve.BATCH * res["decode_steps"] / res["decode_s"],
           "layout_vs_equal_max_abs_diff": moved}
    del model, params, embeds, got, plain, equal
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[qwen2vl_layout] ok: {label}: {n} flash launches at hd "
        f"{cfg.head_dim}; {serve.BATCH} x {QWEN2VL_LAYOUT_GEN} tokens, finite "
        f"logits; prefill {res['prefill_ms']:.1f} ms, decode "
        f"{out['decode_tok_s']:.1f} tok/s; last-position logits moved by "
        f"{moved:.4e} from the equal-axes positions; {out['seconds']:.1f} s")
    return out


def phase_seamless(torch, kernels, serve) -> dict:
    """seamless-m4t-large-v2 at full width (bf16, random weights from a
    seed), every count set to 0 just before each run and read just after:

    * the audio stub through ``serve.generate``: ``serve.BATCH`` x 1,152
      frames (``serve.PROMPT_LEN // 4``) encoded through the flash kernel
      (one non-causal launch an encoder layer), the cross cache filled,
      then ``SEAMLESS_STEPS`` greedy steps from BOS (no launch);
    * one scoring forward over those frames and ``serve.BATCH`` x
      ``serve.PROMPT_LEN`` tokens (``last_only``: the full fp32 logits
      would take 18.9 GB): 24 non-causal and 24 causal launches;
    * the first row's last-position logits through the kernel and through
      the plain attention path, at 5% of the largest logit."""
    from repro_torch.configs import get_arch_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_arch_config(SEAMLESS)
    B, S, V = serve.BATCH, serve.PROMPT_LEN, cfg.vocab_size
    torch.cuda.empty_cache()

    def counted(fn):
        calls = []
        torch.cuda.synchronize()
        _reset(kernels)
        t0 = time.perf_counter()
        with _flash_calls(calls):
            got = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k.source.stem: k.launches for k in kernels}
        n = launches.pop("flash_attention")
        if any(launches.values()) or n != len(calls):
            raise AssertionError(f"{SEAMLESS}: other kernels launched "
                                 f"{launches}, or {n} flash launches for "
                                 f"{len(calls)} calls")
        if any(h != cfg.head_dim or d != cfg.param_dtype or w
               for w, h, d, _ in calls):
            raise AssertionError(f"{SEAMLESS}: flash calls {calls}")
        return got, [c for *_, c in calls], ms

    with torch.inference_mode():
        model, params = serve.random_model(cfg, serve.SEED, "cuda")
        n_params = sum(v.numel() for v in _leaves(params))
        frames = serve.random_prompts(cfg, B, S, serve.SEED, "cuda")
        draw = torch.Generator(device="cuda").manual_seed(serve.SEED + 3)
        tokens = torch.randint(0, V, (B, S), generator=draw, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        res, causal, _ = counted(lambda: serve.generate(
            model, params, frames, SEAMLESS_STEPS))
        gen_peak = torch.cuda.max_memory_allocated() / 2**30
        if (tuple(frames.shape) != (B, S // 4, cfg.d_model)
                or res["flash_launches"] != len(causal)
                or causal != [False] * cfg.n_enc_layers):
            raise AssertionError(f"{SEAMLESS}: frames {tuple(frames.shape)}; "
                                 f"the encode's flash calls (causal) "
                                 f"{causal}, {res['flash_launches']} counted "
                                 f"in it")
        _check_generated(torch, SEAMLESS, res, cfg, B, SEAMLESS_STEPS)
        torch.cuda.reset_peak_memory_stats()
        (logits, aux), causal, score_ms = counted(lambda: model.forward(
            params, {"frames": frames, "tokens": tokens}, last_only=True))
        score_peak = torch.cuda.max_memory_allocated() / 2**30
        if (causal != [False] * cfg.n_enc_layers + [True] * cfg.n_layers
                or tuple(logits.shape) != (B, 1, cfg.vocab_padded)
                or not bool(torch.isfinite(logits).all()) or aux != 0.0):
            raise AssertionError(f"{SEAMLESS} scoring forward: flash calls "
                                 f"(causal) {causal}; logits "
                                 f"{tuple(logits.shape)}, aux {aux}")
        one = {"frames": frames[:1], "tokens": tokens[:1]}
        got, _ = model.forward(params, one, last_only=True)
        plain, _ = build_model(cfg, use_pallas=False).forward(
            params, one, last_only=True)
    _last_logits_close(torch, got[..., :V], plain[..., :V], 5e-2,
                       f"{SEAMLESS} B=1, flash kernel vs plain path")
    out = {"params": n_params, "encode_launches": res["flash_launches"],
           "decode_launches": 0, "scoring_launches": len(causal),
           "encode_ms": res["prefill_ms"], "decode_s": res["decode_s"],
           "decode_tok_s": B * res["decode_steps"] / res["decode_s"],
           "scoring_ms": score_ms, "generate_peak_gib": gen_peak,
           "scoring_peak_gib": score_peak}
    del model, params, frames, tokens, logits, got, plain
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[seamless] ok: {SEAMLESS}, {n_params} parameters "
        f"({cfg.param_dtype}), "
        f"{cfg.n_enc_layers} + {cfg.n_layers} layers: encode {B} x {S // 4} "
        f"frames {res['prefill_ms']:.1f} ms with {res['flash_launches']} "
        f"non-causal flash launches, {SEAMLESS_STEPS} decode steps "
        f"({out['decode_tok_s']:.1f} tok/s) with none, peak "
        f"{gen_peak:.2f} GiB; scoring forward over {B} x {S} tokens "
        f"{score_ms:.1f} ms, {len(causal)} launches ({cfg.n_enc_layers} "
        f"non-causal, {cfg.n_layers} causal), peak {score_peak:.2f} GiB; "
        f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the MARL controller (paper Section IV)
# ---------------------------------------------------------------------------

MARL_OPTION_STEPS = 60
MARL_PROFILE_STEPS = 20
MARL_TOL = dict(rtol=1e-4, atol=1e-5)   # GPU against CPU, tf32 off
MARL_STEP_RTOL = 1e-5                   # env_step reward and info


def _marl_modules():
    """The trainer's and the env's modules (the package re-exports the
    function ``train`` under the module's name)."""
    return (importlib.import_module("repro_torch.core.marl.train"),
            importlib.import_module("repro_torch.core.marl.env"))


def _marl_options(cfg):
    """``cfg`` with migration, faults and PBFT consensus all set."""
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.migration import MigrationConfig

    return dataclasses.replace(
        cfg, migration=MigrationConfig(p_move=0.1), faults=FaultConfig(),
        consensus=ConsensusConfig(quorum_f=1, byzantine_frac=0.2))


def phase_segment_grad(torch, sr) -> float:
    """The kernel backend's gradient (a gather, no launch) and the grouped
    call on the card against the plain version's autograd, at the MARL
    update's shapes: 320 groups (64 rows x 5 agents) of 100 twins over 5
    BSs, 1,600 segments in 8 launches; then dropped ids and K > 1.
    Returns the largest gradient error."""
    lib_max = sr.KERNEL.lib().seg_reduce_max_segments()
    if lib_max != sr.MAX_SEGMENTS:
        raise AssertionError(f"the kernel takes {lib_max} segments, the "
                             f"wrapper assumes {sr.MAX_SEGMENTS}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    for tag, g, n, m, lo in (("actor-loss encode", 320, 100, 5, 0),
                             ("target encode", 64, 100, 5, 0),
                             ("dropped ids", 50, 300, 7, -2)):
        vals = torch.randn((g, n), generator=gen, device="cuda")
        ids = torch.randint(lo, m + (0 if lo == 0 else 2), (g, n),
                            generator=gen, device="cuda", dtype=torch.int32)
        w = torch.randn((g, m), generator=gen, device="cuda")
        v = vals.clone().requires_grad_()
        before = sr.KERNEL.launches
        out = sr.segment_reduce_grouped(v, ids, m)
        launched = sr.KERNEL.launches - before
        (out * w).sum().backward()
        if sr.KERNEL.launches - before != launched:
            raise AssertionError("the segment backward launched a kernel")
        want_launches = -(-g // (sr.MAX_SEGMENTS // m))
        if launched != want_launches:
            raise AssertionError(f"grouped call launched {launched}, not "
                                 f"{want_launches}")
        p = vals.clone().requires_grad_()
        plain = torch.stack([sr._seg_tiled_plain(p[i][:, None], ids[i], m)
                             [:, 0] for i in range(g)])
        (plain * w).sum().backward()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, plain, rtol=SEG_RTOL, atol=SEG_ATOL)
        err = float((v.grad - p.grad).abs().max())
        torch.testing.assert_close(v.grad, p.grad, rtol=0.0, atol=0.0)
        if lo < 0 and v.grad[(ids < 0) | (ids >= m)].any():
            raise AssertionError("a dropped id got a gradient")
        worst = max(worst, err)
        log(f"[segment_grad] {tag}: G={g} N={n} M={m} ({g * m} segments, "
            f"{launched} launches), forward max_abs_err "
            f"{float((out.detach() - plain.detach()).abs().max()):.3e}, "
            f"gradient max_abs_err "
            f"{err:.3e}, out.grad_fn {type(out.grad_fn).__name__}")
    vals = torch.randn((3000, 37), generator=gen, device="cuda")
    ids = torch.randint(-1, 15, (3000,), generator=gen, device="cuda",
                        dtype=torch.int32)
    v, p = vals.clone().requires_grad_(), vals.clone().requires_grad_()
    w = torch.randn((13, 37), generator=gen, device="cuda")
    (sr.segment_reduce_kernel(v, ids, 13) * w).sum().backward()
    (sr._seg_tiled_plain(p, ids, 13) * w).sum().backward()
    torch.testing.assert_close(v.grad, p.grad, rtol=0.0, atol=0.0)
    log(f"[segment_grad] ok: the backward gathers the plain version's "
        f"gradient exactly (N=3000 K=37 M=13 too), no launch; "
        f"grad_max_abs_err {worst:.3e}")
    return worst


def _marl_run(torch, train_mod, kernels, cfg, dcfg, tcfg, seed, tag):
    """One ``train`` run on the card, every count set to 0 just before and
    read just after; a CUDA event is recorded after every step."""
    events, last = [], {}

    def on_step(i, info):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        last.update(info)

    _reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, trace = train_mod.train(cfg, dcfg, tcfg, seed, on_step=on_step)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k.source.stem: k.launches for k in kernels}
    want = train_mod.marl_train_launches(cfg, dcfg, tcfg)
    log(f"[{tag}] kernel launches: {json.dumps(launches)}; the code makes "
        f"{want} segment launches")
    if launches["segment_reduce"] != want:
        raise AssertionError(f"segment kernel launched "
                             f"{launches['segment_reduce']} times, not {want}")
    if any(v for k, v in launches.items() if k != "segment_reduce"):
        raise AssertionError("the MARL run launched another kernel")
    trace = {k: v.cpu() for k, v in trace.items()}
    for k, v in trace.items():
        if v.shape != (tcfg.steps,) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"trace {k}: shape {tuple(v.shape)} or not "
                                 f"finite")
    w0 = min(tcfg.warmup + 2, tcfg.steps - 2)
    warm = events[w0].elapsed_time(events[-1]) / (len(events) - 1 - w0)
    log(f"[{tag}] {tcfg.steps} steps in {wall:.1f} ms: {wall / tcfg.steps:.3f}"
        f" ms a step, {1e3 * tcfg.steps / wall:.2f} steps/s (synchronized "
        f"around the run); warm steps {w0 + 1}-{tcfg.steps - 1}: "
        f"{warm:.3f} ms a step ({1e3 / warm:.2f} steps/s, CUDA events); "
        f"{launches['segment_reduce'] / tcfg.steps:.2f} segment launches a "
        f"step")
    return {"ts": ts, "trace": trace, "wall_ms": wall, "warm_ms": warm,
            "launches": launches["segment_reduce"], "last_info": last}


def phase_marl_train(torch, kernels) -> dict:
    """The MARL controller at the paper's width: ``EnvConfig()`` (100
    twins, 5 BSs, 8 sub-channels, episodes of 50), ``DDPGConfig()``
    (factorized policy, hidden (256, 256), batch 64) and ``TrainConfig()``
    (200 steps, warmup 48), seed 0; then 60 steps with migration, faults
    and PBFT consensus all set."""
    from repro_torch.core import association as assoc_mod
    from repro_torch.core.marl import (DDPGConfig, EnvConfig, TrainConfig,
                                       act, compare_with_baselines,
                                       decode_actions)

    train_mod, _ = _marl_modules()
    t_phase = time.perf_counter()
    cfg, dcfg, tcfg = EnvConfig(), DDPGConfig(), TrainConfig()
    log(f"[marl] EnvConfig(): N={cfg.n_twins} M={cfg.n_bs} "
        f"C={cfg.wl.n_subchannels} freqs {cfg.bs_freqs_ghz} GHz, episode_len "
        f"{cfg.episode_len}; DDPGConfig(): {dcfg.policy}, hidden "
        f"{dcfg.hidden}, batch {dcfg.batch_size}, gamma {dcfg.gamma}; "
        f"TrainConfig(): {tcfg.steps} steps, warmup {tcfg.warmup}, replay "
        f"{tcfg.replay_capacity}; seed 0")
    run = _marl_run(torch, train_mod, kernels, cfg, dcfg, tcfg, 0, "marl")
    ts, st = run["ts"], run["trace"]["system_time"]
    log(f"[marl] system_time mean of the first 50 steps "
        f"{float(st[:50].mean()):.4f} s, of the last 50 "
        f"{float(st[-50:].mean()):.4f} s; critic_loss last "
        f"{float(run['trace']['critic_loss'][-1]):.4f}, actor_loss last "
        f"{float(run['trace']['actor_loss'][-1]):.4f}")
    with torch.no_grad():
        a = act(cfg, ts.agent, ts.obs, policy=dcfg.policy)
        base = compare_with_baselines(cfg, ts.env, a)
        assoc, b, tau = decode_actions(cfg, a)
    checks = assoc_mod.check_constraints(cfg.lat, assoc, b, tau, cfg.n_twins,
                                         cfg.n_bs)
    log(f"[marl] compare_with_baselines on the final state: marl "
        f"{float(base['marl']):.4f} s, average {float(base['average']):.4f} "
        f"s, random {float(base['random']):.4f} s; twins a BS "
        f"{torch.bincount(assoc.long(), minlength=cfg.n_bs).tolist()}; "
        f"constraints {checks}")
    if not all(checks.values()):
        raise AssertionError(f"final decoded actions break (18b-d): {checks}")
    ocfg = _marl_options(cfg)
    otcfg = dataclasses.replace(tcfg, steps=MARL_OPTION_STEPS)
    log(f"[marl_options] {ocfg.migration}; {ocfg.faults}; {ocfg.consensus}; "
        f"{otcfg.steps} steps")
    opt = _marl_run(torch, train_mod, kernels, ocfg, dcfg, otcfg, 1,
                    "marl_options")
    info = {k: float(v) for k, v in opt["last_info"].items()
            if getattr(v, "ndim", 1) == 0}
    log(f"[marl_options] last step: {json.dumps(info)}")
    for k in ("migration_rate", "straggler_frac", "outage_frac",
              "consensus_time", "accept_frac"):
        if not math.isfinite(info[k]):
            raise AssertionError(f"{k} is not finite")
    log(f"[marl] phase {time.perf_counter() - t_phase:.1f} s")
    return {"ts": ts, "cfg": cfg, "dcfg": dcfg, "launches": run["launches"],
            "options_launches": opt["launches"], "ms_step":
            run["wall_ms"] / tcfg.steps, "warm_ms": run["warm_ms"]}


def phase_marl_profile(torch, kernels) -> None:
    """Where a warm training step's time goes, at full width: a
    torch.profiler trace of the device over 20 warm steps (device busy and
    idle share, device events a step, the largest kernels; the host is not
    traced, which would slow it many times over), then the host time of
    each part of a step (each part synchronized) over 10 warm steps."""
    from repro_torch.core.marl import DDPGConfig, EnvConfig, TrainConfig

    train_mod, env_mod = _marl_modules()
    cfg, dcfg = EnvConfig(), DDPGConfig()
    w0 = TrainConfig().warmup + 4
    tcfg = TrainConfig(steps=w0 + MARL_PROFILE_STEPS + 1)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    clock = {}

    def on_step(i, info):
        if i in (w0, w0 + MARL_PROFILE_STEPS):
            torch.cuda.synchronize()
            clock[i] = time.perf_counter()
            (prof.start if i == w0 else prof.stop)()

    train_mod.train(cfg, dcfg, tcfg, 2, on_step=on_step)
    wall = (clock[w0 + MARL_PROFILE_STEPS] - clock[w0]) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log("[marl_profile] device time: not measured (no device events)")
    else:
        busy = importlib.import_module(
            "repro_torch.launch.profile_round")._union_us(
                (e.time_range.start, e.time_range.end) for e in dev) / 1e3
        log(f"[marl_profile] {MARL_PROFILE_STEPS} warm steps (profiler on): "
            f"wall {wall:.1f} ms ({wall / MARL_PROFILE_STEPS:.3f} ms a step), "
            f"device busy {busy:.2f} ms, idle share "
            f"{100 * (1 - busy / wall):.1f}%, "
            f"{len(dev) / MARL_PROFILE_STEPS:.1f} device events a step")
        by_name = {}
        for e in dev:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
        for name, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            log(f"[marl_profile]   {ms / MARL_PROFILE_STEPS:8.4f} ms a step "
                f"{n / MARL_PROFILE_STEPS:6.1f}x  {name[:90]}")
    # host split: each part of a step synchronized before and after
    parts = {}
    active = [False]

    def timed(name, fn):
        def wrapper(*a, **k):
            if not active[0]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    targets = [(train_mod, "sample_train_draws"), (train_mod, "act"),
               (env_mod, "env_step"), (env_mod, "observe"),
               (train_mod.spaces, "encode_action"),
               (train_mod, "replay_add"), (train_mod, "maddpg_update")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    steps = 10
    ticks = []

    def tick(i, info):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())
        active[0] = i + 1 > w0

    try:
        for mod, name, fn in saved:
            setattr(mod, name, timed(name, fn))
        train_mod.train(cfg, dcfg, TrainConfig(steps=w0 + 1 + steps), 3,
                        on_step=tick)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    step_ms = (ticks[-1] - ticks[w0]) * 1e3 / steps
    split = {k: v * 1e3 / steps for k, v in parts.items()}
    log(f"[marl_profile] host split over {steps} warm steps (each part "
        f"synchronized): step {step_ms:.3f} ms; " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(split.items(),
                                             key=lambda kv: -kv[1]))
        + f"; rest {step_ms - sum(split.values()):.3f} ms")


def phase_marl_gpu_vs_cpu(torch, sr, marl) -> float:
    """One bridged state on both devices: the trained agent and 64 rows of
    its replay. One ``maddpg_update`` on the card and on the CPU (new
    parameters and both losses within ``MARL_TOL``); the actor loss's
    gradient through the kernel's backward against the CPU plain version's;
    then one ``env_step`` per config (plain, migration, faults, consensus)
    from one state and the same draws: the same association, reward and
    info within ``MARL_STEP_RTOL``. Returns the gradient's largest
    difference."""
    from repro_torch.core.marl import ddpg, replay
    from repro_torch.core.marl.spaces import Action
    from repro_torch.utils.tree import tree_leaves

    _, env_mod = _marl_modules()
    ts, cfg, dcfg = marl["ts"], marl["cfg"], marl["dcfg"]
    B = dcfg.batch_size
    idx = torch.arange(B, device="cuda") * (ts.buf.size // B)
    gpu = {"agent": ts.agent, "batch": replay.replay_sample(ts.buf, idx, B),
           "tf": ts.obs.twin_feats}
    cpu = _to(gpu, "cpu")
    (new_g, m_g), (new_c, m_c) = (
        ddpg.maddpg_update(cfg, dcfg, s["agent"], s["batch"], s["tf"])
        for s in (gpu, cpu))
    for k in m_c:
        torch.testing.assert_close(m_g[k].cpu(), m_c[k], **MARL_TOL)
    diff = 0.0
    for a, b in zip(tree_leaves(new_g), tree_leaves(new_c)):
        torch.testing.assert_close(a.cpu(), b, **MARL_TOL)
        diff = max(diff, float((a.cpu() - b).abs().max()))
    log(f"[marl_gpu_vs_cpu] maddpg_update: critic_loss "
        f"{float(m_g['critic_loss']):.6f} / {float(m_c['critic_loss']):.6f}, "
        f"actor_loss "
        f"{float(m_g['actor_loss']):.6f} / {float(m_c['actor_loss']):.6f} "
        f"(GPU / CPU); {len(tree_leaves(new_c))} leaves, max abs difference "
        f"{diff:.3e} (rtol {MARL_TOL['rtol']}, atol {MARL_TOL['atol']})")
    grads = []
    for s in (gpu, cpu):
        before = sr.KERNEL.launches
        loss, g = ddpg.actor_loss_and_grads(cfg, dcfg, s["agent"].actor,
                                            s["agent"].critic, s["batch"][0],
                                            s["tf"])
        grads.append((loss, g, sr.KERNEL.launches - before))
    (loss_g, g_g, n_g), (loss_c, g_c, n_c) = grads
    torch.testing.assert_close(loss_g.cpu(), loss_c, **MARL_TOL)
    gdiff = 0.0
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a.cpu(), b, **MARL_TOL)
        gdiff = max(gdiff, float((a.cpu() - b).abs().max()))
    if n_g <= 0 or n_c != 0:
        raise AssertionError(f"actor loss launches GPU {n_g}, CPU {n_c}")
    log(f"[marl_gpu_vs_cpu] actor-loss gradient through the kernel's "
        f"backward ({n_g} forward launches) against the CPU plain "
        f"version's: max abs difference {gdiff:.3e}")
    for name, c in (("plain", cfg), ("migration", dataclasses.replace(
            cfg, migration=_marl_options(cfg).migration)),
                    ("faults", dataclasses.replace(
                        cfg, faults=_marl_options(cfg).faults)),
                    ("consensus", dataclasses.replace(
                        cfg, consensus=_marl_options(cfg).consensus))):
        gen = torch.Generator().manual_seed(3)
        st = env_mod.env_reset(c, env_mod.sample_reset_draws(gen, c))
        draws = env_mod.sample_step_draws(gen, c)
        a = Action(torch.rand((c.n_bs, c.n_twins), generator=gen) * 2 - 1,
                   torch.rand((c.n_bs,), generator=gen) * 2 - 1,
                   torch.rand((c.n_bs, c.wl.n_subchannels), generator=gen)
                   * 2 - 1)
        nc, rc, ic = env_mod.env_step(c, st, a, draws)
        ng, rg, ig = _to(env_mod.env_step(
            c, *_to((st, a, draws), "cuda")), "cpu")
        if not torch.equal(ig["assoc"], ic["assoc"]):
            raise AssertionError(f"env_step ({name}): GPU and CPU "
                                 f"associations differ")
        worst = 0.0
        for k, want in [("reward", rc)] + [(k, v) for k, v in ic.items()
                                            if k != "assoc"]:
            got = rg if k == "reward" else ig[k]
            torch.testing.assert_close(got, want, rtol=MARL_STEP_RTOL,
                                       atol=0.0)
            rel = float(((got - want).abs() / want.abs().clamp(min=1e-30))
                        .max())
            worst = max(worst, rel)
        if not torch.equal(ng.assoc, nc.assoc):
            raise AssertionError(f"env_step ({name}): next associations "
                                 f"differ")
        log(f"[marl_gpu_vs_cpu] env_step {name}: same assoc, reward and "
            f"{len(ic) - 1} info values within rtol {MARL_STEP_RTOL} (max "
            f"relative difference {worst:.2e}); system_time "
            f"{float(ic['system_time']):.6f} s")
    return gdiff


def phase_marl_fl_hook(torch, sr, fr, data, kernels, agent) -> dict:
    """``DTWNSystem(FLConfig(...)).marl_actions`` with the trained agent,
    then one full-width round with those actions, counts set to 0 just
    before and read just after."""
    import numpy as np

    from repro_torch.core import association as assoc_mod
    from repro_torch.fl import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                                FLConfig)

    system = DTWNSystem(FLConfig(use_kernel_aggregation=True), data, seed=0)
    env_cfg = system.marl_env_config()
    _reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assoc, b, tau = system.marl_actions(agent)
    info = system.run_round(assoc, b, tau,
                            participating_users=EXAMPLE_PARTICIPATING_USERS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {"segment_reduce": sr.KERNEL.launches,
                "fedavg_reduce": fr.KERNEL.launches}
    checks = assoc_mod.check_constraints(system.lat, assoc, b, tau,
                                         env_cfg.n_twins, env_cfg.n_bs)
    per_bs = np.bincount(assoc, minlength=env_cfg.n_bs).tolist()
    log(f"[marl_fl_hook] marl_env_config(): N={env_cfg.n_twins} "
        f"M={env_cfg.n_bs} data {env_cfg.data_min}-{env_cfg.data_max}; "
        f"actions: twins a BS {per_bs}, "
        f"b {float(b.min()):.3f}-{float(b.max()):.3f}; constraints {checks}")
    log(f"[marl_fl_hook] round {info['round']}: wall {wall:.1f} ms, loss "
        f"{info['loss']:.6f}, round_time_s {info['round_time_s']:.6f}, "
        f"verified {info['n_verified']}/{info['n_submitted']}; kernel "
        f"launches {json.dumps(launches)}")
    if not all(checks.values()):
        raise AssertionError(f"hook actions break (18b-d): {checks}")
    if not (math.isfinite(info["loss"]) and info["chain_valid"]):
        raise AssertionError("hook round: loss not finite or chain invalid")
    if min(launches.values()) <= 0:
        raise AssertionError(f"hook round launched {launches}")
    return launches


# ---------------------------------------------------------------------------
# the scenario runners and the always-on service (ROADMAP A8, A9)
# ---------------------------------------------------------------------------

SCENARIOS = 256          # the runners' batch at the paper's width
POLICY_SCENARIOS = 32    # run_policy loops over its scenarios
SCENARIO_ROUNDS = 10
SCENARIO_CHECK = 8       # scenarios checked GPU against CPU
SCENARIO_REPS = 5        # timed calls of each mode (the policy: 1)
SERVE_ROUNDS = 6
SERVE_RTOL = 1e-5        # round times GPU against CPU
FL_LOSS_RTOL = 1e-4      # the streamed FL loss GPU against CPU


def _scenario_runs(cfg, agent):
    """(name, runner(batch, draws, device), draw parts, scenarios) of each
    scenario runner at the paper's width."""
    from repro_torch.core import scenario
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.migration import MigrationConfig

    r = SCENARIO_ROUNDS
    return [
        ("baselines", lambda b, d, dev: scenario.run_baselines(
            cfg, b, d, device=dev), ("realization", "random"), SCENARIOS),
        ("faults", lambda b, d, dev: scenario.run_faults(
            cfg, FaultConfig(), b, r, d, device=dev),
         ("realization", "outage_init", "faults"), SCENARIOS),
        ("migration", lambda b, d, dev: scenario.run_migration(
            cfg, MigrationConfig(p_move=0.1), b, r, d, device=dev),
         ("realization", "migration"), SCENARIOS),
        ("consensus", lambda b, d, dev: scenario.run_consensus(
            cfg, ConsensusConfig(quorum_f=1, byzantine_frac=0.2), b, r, d,
            device=dev), ("realization", "byzantine", "chain"), SCENARIOS),
        ("policy", lambda b, d, dev: scenario.run_policy(
            cfg, agent if dev == "cuda" else _to(agent, "cpu"), b, r,
            draws=d, device=dev), ("realization", "rollout"),
         POLICY_SCENARIOS),
    ]


def phase_scenarios(torch, sr, kernels, marl) -> dict:
    """The scenario runners at the paper's width (``EnvConfig()``: 100
    twins, 5 BSs) on a ``make_batch`` of 256 scenarios (the policy's
    rollouts on 32, with the trained agent), 10 rounds or steps each. Each
    runner is run once to warm up, then timed with every count set to 0
    just before and read just after, with its draws passed in and with its
    default draws, alternated; its segment launches are held to
    ``scenario_launches``. Then 8 scenarios of each on the GPU and the CPU
    from the same draws."""
    from repro_torch.core import association as assoc_mod
    from repro_torch.core import scenario
    from repro_torch.core.marl import EnvConfig

    t_phase = time.perf_counter()
    cfg = EnvConfig()
    batch = scenario.make_batch(0, SCENARIOS)
    out = {}
    for name, run, parts, s in _scenario_runs(cfg, marl["ts"].agent):
        b = scenario.ScenarioBatch(*(None if x is None else x[:s]
                                     for x in batch))
        draws = scenario.scenario_draws(b, cfg, parts, SCENARIO_ROUNDS,
                                        "cuda")
        want = scenario.scenario_launches(name, cfg, s, SCENARIO_ROUNDS)

        def timed(fn):
            _reset(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t0) * 1e3, sr.KERNEL.launches

        # the call with its draws passed in, and the default call (its
        # draws made on the card inside the span), alternated after a
        # warm-up of each; the draws alone beside them
        modes = {"given": functools.partial(run, b, draws, "cuda"),
                 "default": functools.partial(run, b, None, "cuda"),
                 "draws": functools.partial(scenario.scenario_draws, b, cfg,
                                            parts, SCENARIO_ROUNDS, "cuda")}
        modes["given"](), modes["default"]()
        walls = {mode: [] for mode in modes}
        for _ in range(SCENARIO_REPS if name != "policy" else 1):
            for mode, fn in modes.items():
                res_m, wall_m, launches = timed(fn)
                walls[mode].append(wall_m)
                if mode != "draws" and launches != want:
                    raise AssertionError(
                        f"run_{name} ({mode} draws) launched the segment "
                        f"kernel {launches} times, not {want}")
                if mode == "given":
                    res, got = res_m, launches
        wall, wall_d, wall_x = (statistics.median(walls[k])
                                for k in ("given", "default", "draws"))
        for k, v in res.items():
            if v.shape[0] != s or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"run_{name} {k}: shape "
                                     f"{tuple(v.shape)} or not finite")
        head = {k: round(float(v.float().mean()), 4) for k, v in res.items()}
        each = {k: [round(x, 2) for x in v] for k, v in walls.items()}
        log(f"[scenarios] run_{name}: S={s}, draws passed in: wall "
            f"{wall:.1f} ms ({1e3 * s / wall:.1f} scenarios/s); default "
            f"draws made in the call: {wall_d:.1f} ms "
            f"({1e3 * s / wall_d:.1f} scenarios/s); the draws alone "
            f"{wall_x:.2f} ms (medians of {len(walls['given'])}: "
            f"{json.dumps(each)}); "
            f"segment launches {got} a call (the code makes {want}); "
            f"means {json.dumps(head)}")
        out[name] = {"wall_ms": wall, "scenarios": s, "launches": got,
                     "scenarios_per_s": 1e3 * s / wall,
                     "default_wall_ms": wall_d,
                     "default_scenarios_per_s": 1e3 * s / wall_d,
                     "draws_ms": wall_x}
    # GPU against CPU on 8 scenarios, from the same draws (made on the CPU)
    b8 = scenario.ScenarioBatch(*(None if x is None else x[:SCENARIO_CHECK]
                                  for x in batch))
    parts = ("realization", "random", "rollout", "migration", "faults",
             "chain")
    dc, dh = (scenario.scenario_draws(b8, cfg, parts, SCENARIO_ROUNDS, dev)
              for dev in ("cuda", "cpu"))
    exact = ("data_u", "dist_u", "rand_assoc", "move_u", "slow_u",
             "outage_u")
    for name in dc._fields:
        got, want = getattr(dc, name), getattr(dh, name)
        if name == "steps":
            got, want = got.up, want.up
        if name in exact:
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"default draw {name} differs on the "
                                     f"GPU and the CPU")
        elif got is not None:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    log("[scenarios_gpu_vs_cpu] default draws: integer and uniform fields "
        "equal on the GPU and the CPU, the others within rtol 1e-6")
    worst = 0.0
    for name, run, parts, _ in _scenario_runs(cfg, marl["ts"].agent):
        d = scenario.scenario_draws(b8, cfg, parts, SCENARIO_ROUNDS, "cpu")
        cpu = run(b8, d, "cpu")
        gpu = run(b8, _to(d, "cuda"), "cuda")
        for k in cpu:
            got, want = gpu[k].cpu(), cpu[k]
            rtol = 1e-4 if name == "policy" else SERVE_RTOL
            torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)
            rel = float(((got - want).abs() / want.abs().clamp(
                min=1e-30)).max())
            worst = max(worst, rel if name != "policy" else 0.0)
        log(f"[scenarios_gpu_vs_cpu] run_{name}: {len(cpu)} outputs within "
            f"rtol {1e-4 if name == 'policy' else SERVE_RTOL}")
    st = scenario.scenario_env(cfg, scenario.scenario_draws(
        b8, cfg, ("realization",), 0, "cpu"), b8.data_min, b8.data_max,
        b8.skew)
    up = torch.full((8, 5), 1e8)
    greedy = [assoc_mod.greedy_association(cfg.lat, st.data_sizes.to(dev),
                                           st.freqs.to(dev), up.to(dev))
              for dev in ("cpu", "cuda")]
    if not torch.equal(greedy[0], greedy[1].cpu()):
        raise AssertionError("the batched greedy association differs on the "
                             "GPU and the CPU")
    log(f"[scenarios_gpu_vs_cpu] ok (tf32 off): the runners' outputs within "
        f"rtol {SERVE_RTOL} (largest relative difference {worst:.2e}), the "
        f"policy's within 1e-4; the greedy association of 8 scenarios "
        f"equal; phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _serve_setup(torch, data, device, *, fl=True, policy=None,
                 n_rounds=SERVE_ROUNDS):
    """The streamed round at the paper's width: ``EnvConfig()`` with
    migration (p_move 0.1), ``FaultConfig()`` and PBFT (f=1, byzantine 0.2),
    capacity 100 with churn 0.02/0.02, the CNN's FL at 10 participants x 5
    iterations x batch 32 over IID shards of the data."""
    from repro_torch.core import scenario, serve
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.marl import EnvConfig
    from repro_torch.core.migration import MigrationConfig
    from repro_torch.fl import stream
    from repro_torch.fl.partition import iid_partition

    cfg = EnvConfig(migration=MigrationConfig(p_move=0.1),
                    faults=FaultConfig(),
                    consensus=ConsensusConfig(quorum_f=1, byzantine_frac=0.2))
    fcfg = stream.FLServeConfig(model="cnn") if fl else None
    scfg = serve.ServeConfig(capacity=cfg.n_twins, join_rate=0.02,
                             leave_rate=0.02, fl=fcfg, policy=policy)
    batch = scenario.make_batch(0, 1)
    row = scenario.knob_row(scenario.stream_knobs(
        scenario.batch_to(batch, device), fcfg=cfg.faults,
        ccfg=cfg.consensus, lat=cfg.lat), 0)
    seed = int(batch.seed[0])
    plan = None
    if fl:
        plan = stream.stream_fl_plan(
            fcfg, iid_partition(data[0][0].shape[0], cfg.n_twins, seed=0),
            n_rounds)
        plan = stream.FLPlan(*(x.to(device) for x in plan))
    # made on the CPU and copied, so a GPU and a CPU run read the same bits
    draws = serve.RoundDraws(*(
        None if x is None else x.to(device)
        for x in serve.stream_draws(cfg, scfg, seed, n_rounds, "cpu")))
    init = scenario.ScenarioDraws(**scenario.make_draws(
        cfg, seed, ("realization", "outage_init", "byzantine"), device="cpu"))

    def fresh():
        st = serve.serve_init(cfg, scfg, row, draws=init, device=device)
        if fl:
            st = st._replace(fl=stream.fl_init(
                fcfg, torch.Generator().manual_seed(0), data, st.active))
        if policy:
            st = serve.attach_policy(
                cfg, st, torch.Generator(device=device).manual_seed(1))
        return st

    return cfg, scfg, row, plan, draws, fresh


def _state_tensors(st):
    """The serve state's tensors, in a fixed order, for bitwise checks."""
    env = st.env
    out = [st.active, st.bad, st.byz, env.data_sizes, env.assoc, env.freqs,
           env.h_up, env.h_down, *env.chain]
    if st.fl is not None:
        for tree in (st.fl.params, st.fl.twin_params, st.fl.twin_mom):
            out += [tree[k] for k in sorted(tree)]
    return out


def phase_serve_stream(torch, sr, kernels, data) -> dict:
    """The always-on service with streamed FL at the paper's width: (a) 6
    overlapped rounds against 6 blocking ones, bit for bit, metrics and
    final state; (b) the overlapped rounds under the sync debug mode set to
    raise; (c) device memory flat from the second round on; (d) one round
    on the GPU against the CPU from one state; (e) the segment launches of
    the overlapped rounds held to ``serve_launches``. Then a profile and a
    host split of a round, streaming against the batch runners per axis
    (churn off), the batched local SGD against the per-twin trainer, one
    round on the GPU against the CPU and 3 rounds of a policy-driven
    stream."""
    from repro_torch.core import serve

    t_phase = time.perf_counter()
    cfg, scfg, row, plan, draws, fresh = _serve_setup(torch, data, "cuda")
    step = serve.make_round_step(cfg, scfg)
    warm_state = fresh()  # one round off the clock, on a state thrown away
    serve.serve_rounds(cfg, scfg, warm_state, serve.RoundDraws(*(
        None if x is None else x[:1] for x in draws)), row, step=step,
        overlap=False, plan=type(plan)(*(x[:1] for x in plan)))
    del warm_state
    torch.cuda.synchronize()
    runs = {}
    for overlap in (True, False):
        state = fresh()
        mem, ends = [], []

        def watched(*a):
            out = step(*a)
            mem.append(torch.cuda.memory_allocated())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
            return out

        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        if overlap:
            _reset(kernels)
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            state, m = serve.serve_rounds(cfg, scfg, state, draws, row,
                                          step=watched, overlap=overlap,
                                          plan=plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        issued = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = sr.KERNEL.launches
        metrics = serve.stack_metrics(m)
        per_round = [start.elapsed_time(ends[0])] + [
            a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        runs[overlap] = (metrics, state, mem)
        log(f"[serve_stream] {'overlapped' if overlap else 'blocking'}: "
            f"{SERVE_ROUNDS} rounds, wall {wall:.1f} ms "
            f"({1e3 * SERVE_ROUNDS / wall:.2f} rounds/s), host done "
            f"issuing after {issued:.1f} ms; rounds (CUDA events) "
            f"{[round(x, 2) for x in per_round]} ms; memory_allocated after "
            f"each round {mem}")
        if overlap:
            over = {"wall_ms": wall, "rounds_per_s": 1e3 * SERVE_ROUNDS
                    / wall, "issued_ms": issued, "round_ms": per_round,
                    "launches": launches}
    log(f"[serve_stream] metrics: " + json.dumps(
        {k: [round(float(x), 5) for x in v.reshape(SERVE_ROUNDS, -1)[:, 0]]
         for k, v in runs[True][0].items()}))
    want = serve.serve_launches(cfg, scfg, SERVE_ROUNDS,
                                n_leaves=len(runs[True][1].fl.params))
    if over["launches"] != want:
        raise AssertionError(f"the stream launched the segment kernel "
                             f"{over['launches']} times, not {want}")
    (m_o, st_o, mem_o), (m_b, st_b, _) = runs[True], runs[False]
    for k in m_b:
        if not (m_o[k] == m_b[k]).all():
            raise AssertionError(f"overlapped and blocking {k} differ")
    for a, b in zip(_state_tensors(st_o), _state_tensors(st_b)):
        if not torch.equal(a, b):
            raise AssertionError("overlapped and blocking states differ")
    if len(set(mem_o[1:])) != 1:
        raise AssertionError(f"device memory not flat from the second round "
                             f"on: {mem_o}")
    for k in ("fl_loss", "round_time"):
        if not (m_o[k] == m_o[k]).all():
            raise AssertionError(f"{k} is not finite")
    log(f"[serve_stream] ok: overlapped and blocking rounds equal bit for "
        f"bit (metrics and final state); no host sync inside the overlapped "
        f"rounds (sync debug mode 'error'); memory_allocated flat from the "
        f"second round on ({mem_o[1]} B); {over['launches']} segment "
        f"launches, as the code makes them")
    del runs, st_o, st_b
    over["profile"] = _serve_profile(torch, "serve_profile", (
        cfg, scfg, row, plan, draws, fresh))
    over["stream_vs_batch"] = _stream_vs_batch(torch)
    over["local_sgd"] = _local_sgd_timing(torch, data)
    over["gpu_vs_cpu"] = _serve_gpu_vs_cpu(torch, data)
    over["policy_launches"] = _serve_policy(torch, sr, kernels, data)
    log(f"[serve_stream] phase {time.perf_counter() - t_phase:.1f} s")
    return over


def _serve_gpu_vs_cpu(torch, data) -> dict:
    """One streamed round at the paper's width from one state on the GPU
    and the CPU (the same draws, plan and initial weights)."""
    from repro_torch.core import serve

    res = {}
    for dev in ("cpu", "cuda"):
        cfg, scfg, row, plan, draws, fresh = _serve_setup(torch, data, dev,
                                                          n_rounds=1)
        t0 = time.perf_counter()
        st, m = serve.serve_rounds(cfg, scfg, fresh(), draws, row,
                                   overlap=False, plan=plan)
        res[dev] = (serve.stack_metrics(m), _to(st, "cpu"))
        log(f"[serve_gpu_vs_cpu] {dev}: round in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; round_time "
            f"{float(res[dev][0]['round_time'][0]):.6f} s, fl_loss "
            f"{float(res[dev][0]['fl_loss'][0]):.7f}")
    (mc, sc), (mg, sg) = res["cpu"], res["cuda"]
    for name, a, b in (("active", sg.active, sc.active),
                       ("assoc", sg.env.assoc, sc.env.assoc),
                       ("chain verdicts", sg.env.chain.verdicts,
                        sc.env.chain.verdicts)):
        if not torch.equal(a, b):
            raise AssertionError(f"GPU and CPU rounds differ in {name}")
    for k in ("n_active", "n_joined", "n_left", "fl_n_participants",
              "fl_accept_frac", "accept_frac"):
        if not (mg[k] == mc[k]).all():
            raise AssertionError(f"GPU and CPU rounds differ in {k}")
    rel = {k: float((abs(mg[k] - mc[k]) / abs(mc[k]).clip(min=1e-30)).max())
           for k in ("round_time", "fl_bs_weight", "fl_loss")}
    if max(rel["round_time"], rel["fl_bs_weight"]) > SERVE_RTOL or \
            rel["fl_loss"] > FL_LOSS_RTOL:
        raise AssertionError(f"GPU vs CPU relative differences {rel} above "
                             f"{SERVE_RTOL} / {FL_LOSS_RTOL}")
    log(f"[serve_gpu_vs_cpu] ok (tf32 off): the same active mask, "
        f"associations, chain verdicts, participants and accept fractions; "
        f"relative differences: round_time {rel['round_time']:.2e} and the "
        f"Eq. 4 weights {rel['fl_bs_weight']:.2e} <= {SERVE_RTOL}, fl_loss "
        f"{rel['fl_loss']:.2e} <= {FL_LOSS_RTOL}")
    return rel


def _serve_policy(torch, sr, kernels, data) -> int:
    """3 rounds of a policy-driven stream (a fresh factorized agent picks
    each round's association) at the paper's width, with every axis and
    churn, no FL."""
    from repro_torch.core import serve

    rounds = 3
    cfg, scfg, row, _, draws, fresh = _serve_setup(
        torch, data, "cuda", fl=False, policy="factorized", n_rounds=rounds)
    state = fresh()
    _reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = serve.serve_rounds(cfg, scfg, state, draws, row)
    metrics = serve.stack_metrics(m)
    wall = (time.perf_counter() - t0) * 1e3
    launches = sr.KERNEL.launches
    want = serve.serve_launches(cfg, scfg, rounds)
    log(f"[serve_policy] {rounds} rounds in {wall:.1f} ms; round_time "
        f"{[round(float(x), 3) for x in metrics['round_time']]} s; replay "
        f"rows {state.buf.size}; segment launches {launches} (the code "
        f"makes {want})")
    if launches != want or state.buf.size != rounds:
        raise AssertionError(f"policy stream: {launches} launches (want "
                             f"{want}), replay size {state.buf.size}")
    if not (metrics["round_time"] > 0).all():
        raise AssertionError("policy stream: round times not positive")
    return launches


def _local_sgd_timing(torch, data) -> dict:
    """The streamed round's local SGD against the batch round's, on the
    card: 10 participants x 5 iterations x batch 32 of the CNN, as
    ``fl.client.local_sgd_stacked`` (one batched computation on
    pre-gathered minibatches) and as ``DTWNSystem``'s trainer (one twin
    after the other, each batch drawn on the host). Median of 5
    synchronized runs after a warm one."""
    import numpy as np

    from repro_torch.fl import client
    from repro_torch.fl.partition import iid_partition
    from repro_torch.models import cnn
    from repro_torch.optim import make_optimizer

    p, iters, bs = 10, 5, 32
    params = cnn.init_params(torch.Generator().manual_seed(3), device="cuda")
    x = torch.as_tensor(data[0][0]).to("cuda")
    y = torch.as_tensor(data[0][1]).to("cuda").long()
    shards = iid_partition(x.shape[0], 100, seed=0)[:p]
    rng = np.random.RandomState(0)
    idx = torch.as_tensor(np.stack([s[rng.choice(len(s), (iters, bs))]
                                    for s in shards])).to("cuda")
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    trainer = client.make_local_trainer(cnn.loss_fn, lr=0.05)

    def stacked():
        client.local_sgd_stacked(cnn.loss_stacked, opt, params, x[idx],
                                 y[idx])

    def looped():
        for u, shard in enumerate(shards):
            trainer(params, x, y, batch_size=bs, local_iters=iters, seed=u,
                    rows=shard[:len(shard) // 2])

    out = {}
    for name, fn in (("stacked", stacked), ("per_twin", looped)):
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    log(f"[local_sgd] 10 twins x 5 iterations x batch 32 of the CNN: "
        f"batched (local_sgd_stacked) {out['stacked']:.2f} ms, one twin "
        f"after the other (DTWNSystem's trainer) {out['per_twin']:.2f} ms")
    return out


def _stream_vs_batch(torch) -> dict:
    """Streaming against the batch runners on the card, churn off: 5
    streamed rounds of scenario row 3 (``EnvConfig()``, a fixed full
    population) per axis against the runner's row 3 of a 64-scenario batch
    (one grouped launch sums 44 scenarios). The fractions of counts must be
    equal, the other floats within rtol 1e-6; returns each axis's largest
    relative difference (0: bit for bit)."""
    from repro_torch.core import scenario, serve
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.marl import EnvConfig
    from repro_torch.core.migration import MigrationConfig

    k, i = 5, 3
    batch = scenario.make_batch(0, 64)
    base = EnvConfig()
    axes = {
        "baseline": (base, lambda c: scenario.run_baselines(
            c, batch, device="cuda"),
                     [("round_time", "average")], ()),
        "faults": (dataclasses.replace(base, faults=FaultConfig()),
                   lambda c: scenario.run_faults(c, c.faults, batch, k,
                                                 device="cuda"),
                   [("round_time", "round_times")],
                   [("straggler_frac", "straggler_frac"),
                    ("outage_frac", "outage_frac")]),
        "migration": (dataclasses.replace(
            base, migration=MigrationConfig(p_move=0.1)),
            lambda c: scenario.run_migration(c, c.migration, batch, k,
                                             device="cuda"),
            [("round_time", "round_times"), ("imbalance", "imbalance")],
            [("migration_rate", "migration_rates")]),
        "consensus": (dataclasses.replace(
            base, consensus=ConsensusConfig(quorum_f=1, byzantine_frac=0.2)),
            lambda c: scenario.run_consensus(c, c.consensus, batch, k,
                                             device="cuda"),
            [("round_time", "round_times"),
             ("consensus_time", "consensus_time"),
             ("honest_stake_share", "honest_stake_share")],
            [("accept_frac", "accept_frac")]),
    }
    out = {}
    for name, (cfg, run, floats, counts) in axes.items():
        ref = {key: v[i].cpu() for key, v in run(cfg).items()}
        scfg = serve.ServeConfig(capacity=cfg.n_twins)
        row = scenario.knob_row(scenario.stream_knobs(
            scenario.batch_to(batch, "cuda"), fcfg=cfg.faults,
            ccfg=cfg.consensus, lat=cfg.lat), i)
        seed = int(batch.seed[i])
        st = serve.serve_init(cfg, scfg, row, seed=seed, device="cuda")
        _, m = serve.serve_rounds(cfg, scfg, st, serve.stream_draws(
            cfg, scfg, seed, k, "cuda"), row, n_rounds=k, overlap=False)
        m = {key: v.cpu() for key, v in m.items()}
        worst = 0.0
        for mk, rk in floats + list(counts):
            got, want = m[mk], ref[rk].expand(m[mk].shape)
            if mk == "honest_stake_share":
                got, want = got[-1], ref[rk]
            rel = float(((got - want).abs() / want.abs().clamp(
                min=1e-30)).max())
            if (mk, rk) in counts and rel != 0.0:
                raise AssertionError(f"streamed {mk} differs from the "
                                     f"runner's on the card ({name})")
            if rel > 1e-6:
                raise AssertionError(f"streamed {mk} {rel:.2e} from the "
                                     f"runner's ({name}), above rtol 1e-6")
            worst = max(worst, rel)
        out[name] = worst
        log(f"[stream_vs_batch] {name}: {k} streamed rounds of row {i} "
            f"against the runner's row {i} of 64: counts equal, largest "
            f"relative difference {worst:.2e}"
            + (" (bit for bit)" if worst == 0.0 else ""))
    return out


PROFILE_ROUNDS = 3


def _serve_profile(torch, tag, setup) -> dict:
    """Where a warm streamed round's time goes: a torch.profiler trace of
    the device over 3 overlapped rounds (device busy and idle share, device
    events a round, the largest kernels; the host is not traced), then the
    host time of each part of a round, each part synchronized, over 3
    blocking rounds: local SGD, Eq. 4 over the capacity axis, the chain
    round, churn (the env's and the FL buffers'), migration."""
    from repro_torch.core import consensus, hierarchy, migration, serve
    from repro_torch.fl import client, stream

    cfg, scfg, row, plan, draws, fresh = setup
    k = PROFILE_ROUNDS
    head = serve.RoundDraws(*(None if x is None else x[:k] for x in draws))
    plan_k = None if plan is None else type(plan)(*(x[:k] for x in plan))
    state = fresh()
    serve.serve_rounds(cfg, scfg, state, head, row, n_rounds=1,
                       overlap=False, plan=plan_k)  # warm
    state = fresh()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.start()
    serve.serve_rounds(cfg, scfg, state, head, row, n_rounds=k, plan=plan_k)
    torch.cuda.synchronize()
    prof.stop()
    wall = (time.perf_counter() - t0) * 1e3
    out = {"wall_ms": wall / k}
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log(f"[{tag}] device time: not measured (no device events)")
    else:
        busy = importlib.import_module(
            "repro_torch.launch.profile_round")._union_us(
                (e.time_range.start, e.time_range.end) for e in dev) / 1e3
        out.update(busy_ms=busy / k, idle=1 - busy / wall,
                   events=len(dev) / k)
        log(f"[{tag}] {k} warm rounds (profiler on): {wall / k:.2f} ms a "
            f"round, device busy {busy / k:.2f} ms a round, idle share "
            f"{100 * (1 - busy / wall):.1f}%, {len(dev) / k:.0f} device "
            f"events a round")
        by_name = {}
        for e in dev:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
        for name, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            log(f"[{tag}]   {ms / k:8.4f} ms a round {n / k:6.1f}x  "
                f"{name[:90]}")
    parts = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            return res
        return wrapper

    targets = [(client, "local_sgd_stacked", "local SGD"),
               (hierarchy, "bs_aggregate_stacked", "Eq. 4"),
               (consensus, "chain_round", "chain"),
               (serve, "churn_step", "churn"),
               (stream, "fl_churn_update", "FL churn"),
               (migration, "migration_step", "migration")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    state = fresh()
    try:
        for mod, name, label in targets:
            setattr(mod, name, timed(label, getattr(mod, name)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.serve_rounds(cfg, scfg, state, head, row, n_rounds=k,
                           overlap=False, plan=plan_k)
        torch.cuda.synchronize()
        step = (time.perf_counter() - t0) * 1e3 / k
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    split = {name: v * 1e3 / k for name, v in parts.items()}
    out.update(split_round_ms=step, split=split)
    log(f"[{tag}] host split over {k} blocking rounds (each part "
        f"synchronized): round {step:.2f} ms; " + ", ".join(
            f"{name} {v:.2f}" for name, v in sorted(
                split.items(), key=lambda kv: -kv[1]))
        + f"; rest {step - sum(split.values()):.2f} ms")
    return out


def _cli_setup(torch):
    """The serving CLI's stream at ``CLI_ARGV``: capacity 10,000 over 10
    BSs, churn 0.01/0.01, the tiny model's FL (10 participants x 5
    iterations x batch 8 on cyclic shards of 128 of 4,096 samples)."""
    from repro_torch.core import scenario, serve
    from repro_torch.core.marl import EnvConfig
    from repro_torch.data import cifar10
    from repro_torch.fl import stream

    cfg = EnvConfig(n_twins=10000, n_bs=10)
    fcfg = stream.FLServeConfig(model="tiny", batch_size=8, verify=False)
    scfg = serve.ServeConfig(capacity=10000, join_rate=0.01, leave_rate=0.01,
                             fl=fcfg)
    data = cifar10.load(max_train=4096, max_test=512)
    batch = scenario.make_batch(0, 1)
    row = scenario.knob_row(scenario.stream_knobs(
        scenario.batch_to(batch, "cuda")), 0)
    seed = int(batch.seed[0])
    plan = stream.stream_fl_plan(fcfg, stream.cyclic_shards(4096, 10000, 128),
                                 PROFILE_ROUNDS)
    plan = stream.FLPlan(*(x.to("cuda") for x in plan))
    draws = serve.stream_draws(cfg, scfg, seed, PROFILE_ROUNDS, "cuda")

    def fresh():
        st = serve.serve_init(cfg, scfg, row, seed=seed, device="cuda")
        return st._replace(fl=stream.fl_init(
            fcfg, torch.Generator().manual_seed(2), data, st.active))

    return cfg, scfg, row, plan, draws, fresh


CLI_ARGV = ["--capacity", "10000", "--rounds", "20", "--fl", "--fl-model",
            "tiny", "--join", "0.01", "--leave", "0.01"]


def phase_serve_cli(torch, sr, kernels) -> dict:
    """``python -m repro_torch.launch.serve_dtwn`` at the README's example
    (capacity 10,000, 20 rounds, the tiny model's FL, churn 0.01/0.01; its
    own warm-up round first), with every count set to 0 just before and
    read just after."""
    import contextlib
    import io
    import re

    from repro_torch.core import serve
    from repro_torch.core.marl import EnvConfig
    from repro_torch.fl.stream import FLServeConfig
    from repro_torch.launch import serve_dtwn

    log(f"[serve_cli] python -m repro_torch.launch.serve_dtwn "
        f"{' '.join(CLI_ARGV)}")
    _reset(kernels)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_dtwn.main(CLI_ARGV)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[serve_cli] | {line}")
    launches = sr.KERNEL.launches
    cfg = EnvConfig(n_twins=10000, n_bs=10)
    scfg = serve.ServeConfig(capacity=10000, join_rate=0.01, leave_rate=0.01,
                             fl=FLServeConfig(model="tiny"))
    want = serve.serve_launches(cfg, scfg, 21, n_leaves=4)
    rate = re.search(r"\(([\d.]+) rounds/s\)", text)
    loss = re.search(r"fl_loss\s+([\d.]+) -> ([\d.]+)", text)
    log(f"[serve_cli] rc {rc}, {wall:.1f} s in all; segment launches "
        f"{launches} (the code makes {want}: the warm-up round and 20)")
    if rc != 0 or rate is None or loss is None:
        raise AssertionError("the serving CLI failed")
    if launches != want:
        raise AssertionError(f"the CLI launched the segment kernel "
                             f"{launches} times, not {want}")
    return {"rounds_per_s": float(rate.group(1)), "launches": launches,
            "fl_loss": [float(loss.group(1)), float(loss.group(2))],
            "profile": _serve_profile(torch, "serve_cli_profile",
                                      _cli_setup(torch))}


# ---------------------------------------------------------------------------
# the twin mesh: 2 gloo ranks on the one card
# ---------------------------------------------------------------------------

# docs/SCALING.md's sizes for the sharded path: the segment backend at a
# ragged N over K = 1 and 16 lanes, the latency model and the env at 10^6
# twins, the trainer, the runners and the serve loop at the paper's width
SHARD_SEG = (1_000_003, 16, 5)
SHARD_LAT_N = 1_000_000
SHARD_ENV_N = 1_000_000
SHARD_TRAIN_STEPS = 60
SHARD_SCENARIOS, SHARD_ROUNDS = 256, 10
SHARD_RTOL = 1e-5


def _sharded_inputs(torch):
    """The phase's global inputs, made alike in every process from seed 0
    on the CPU."""
    gen = torch.Generator().manual_seed(0)
    n, k, m = SHARD_SEG
    nl = SHARD_LAT_N
    return {
        "seg_values": torch.randn((n, k), generator=gen),
        "seg_assoc": torch.randint(0, m, (n,), generator=gen,
                                   dtype=torch.int32),
        "lat_assoc": torch.randint(0, m, (nl,), generator=gen,
                                   dtype=torch.int32),
        "lat_b": 0.05 + 0.95 * torch.rand((nl,), generator=gen),
        "lat_data": 100.0 + 700.0 * torch.rand((nl,), generator=gen),
        "lat_freqs": 1e9 + 3e9 * torch.rand((m,), generator=gen),
        "lat_up": 1e6 + 1e8 * torch.rand((m,), generator=gen),
    }


def _sharded_body(mesh, env_scores=None) -> dict:
    """Every sharded call of the phase on this rank of ``mesh``, each with
    the segment kernel's launches and the all-reduce counts set to 0 just
    before it and read just after (all but the trainer after one untimed
    warm call); one shard is the same calls on one rank
    (the plain functions, by the entry points' fast path). Blocked results
    are gathered to their global extent, so ranks and the one-rank run
    compare directly. ``env_scores`` (the one-rank run's action scores)
    drive the env step; the rank's own ``act`` is compared to them."""
    import contextlib

    import torch

    from repro_torch.core import latency, scenario
    from repro_torch.core import sharding as sh
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.marl import env as env_mod
    from repro_torch.core.marl.ddpg import DDPGConfig, act, maddpg_init
    from repro_torch.core.migration import MigrationConfig

    sr = importlib.import_module("repro_torch.kernels.segment_reduce")
    train_mod = importlib.import_module("repro_torch.core.marl.train")
    ts = sh.TwinSharding(mesh)
    dev = ts.device
    inp = {k: v.to(dev) for k, v in _sharded_inputs(torch).items()}
    out = {"results": {}, "wall_ms": {}, "launches": {}, "all_reduce": {}}

    def scoped(n):
        return ts.scope(n) if ts.n_shards > 1 else contextlib.nullcontext()

    def gather(x, n, axis=0):
        if ts.n_shards == 1:
            return x
        spec = ts.twin_spec(axis % x.ndim, x.ndim)
        with ts.scope(n):
            return sh.unshard_tree(x, spec, n)

    def run(name, fn, warm):
        if warm:  # an untimed, uncounted first call
            fn()
        sr.KERNEL.reset()
        sh.ALL_REDUCE.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        out["wall_ms"][name] = (time.perf_counter() - t0) * 1e3
        out["launches"][name] = sr.KERNEL.launches
        out["all_reduce"][name] = [sh.ALL_REDUCE.calls, sh.ALL_REDUCE.bytes]
        out["results"][name] = res

    n, _, m = SHARD_SEG

    def segment():
        x, a = inp["seg_values"], inp["seg_assoc"]
        with scoped(n):
            xl = sh.localize(x)
            al = sh.localize(a, fill=m)
            return {"k16": sr.segment_reduce(xl, al, m),
                    "k1": sr.segment_reduce(xl[:, 0].contiguous(), al, m),
                    "max": sr.segment_max(xl, al, m),
                    "min": sr.segment_min(xl, al, m)}

    lp = latency.LatencyParams()
    args = (inp["lat_assoc"], inp["lat_b"], inp["lat_data"],
            inp["lat_freqs"], inp["lat_up"], inp["lat_up"])

    def lat():
        return {
            "t_cmp": sh.sharded_t_cmp(ts, lp, *args[:4]),
            "t_local_agg": sh.sharded_t_local_agg(ts, lp, args[0], args[3]),
            "t_broadcast": sh.sharded_t_broadcast(ts, lp, args[0], args[4],
                                                  m),
            "round_time": sh.sharded_round_time(ts, lp, *args),
            "round_time_per_bs": sh.sharded_round_time_per_bs(ts, lp,
                                                              *args),
            "total_time": sh.sharded_total_time(ts, lp, *args)}

    ecfg = env_mod.EnvConfig(n_twins=SHARD_ENV_N)
    gen = torch.Generator(device=dev).manual_seed(0)
    reset = env_mod.sample_reset_draws(gen, ecfg)
    step = env_mod.sample_step_draws(gen, ecfg)
    agent = maddpg_init(ecfg, DDPGConfig(), gen)

    def env():
        st = env_mod.sharded_env_reset(ts, ecfg, reset)
        obs = env_mod.sharded_observe(ts, ecfg, st)
        with scoped(ecfg.n_twins), torch.no_grad():
            a = act(ecfg, agent, obs)
        scores = gather(a.scores, ecfg.n_twins, axis=1)
        drive = scores if env_scores is None else env_scores.to(dev)
        st2, r, info = env_mod.sharded_env_step(
            ts, ecfg, st, a._replace(scores=drive), step)
        obs2 = env_mod.sharded_observe(ts, ecfg, st2)
        return {"scores": scores, "bs_feats": obs.bs_feats,
                "twin_feats": gather(obs.twin_feats, ecfg.n_twins),
                "reward": r, "system_time": info["system_time"],
                "assoc": gather(info["assoc"], ecfg.n_twins),
                "bs_feats2": obs2.bs_feats}

    def train():
        tcfg = train_mod.TrainConfig(steps=SHARD_TRAIN_STEPS)
        st, trace = train_mod.train_sharded(ts, env_mod.EnvConfig(),
                                            DDPGConfig(), tcfg, 0)
        sh.assert_replicated([st.agent, st.buf], ts)
        return {"trace": trace, "actor": st.agent.actor}

    rcfg = env_mod.EnvConfig()
    batch = scenario.make_batch(0, SHARD_SCENARIOS)

    def runners():
        return {
            "baselines": scenario.run_baselines_sharded(ts, rcfg, batch),
            "migration": scenario.run_migration_sharded(
                ts, rcfg, MigrationConfig(), batch, SHARD_ROUNDS),
            "faults": scenario.run_faults_sharded(
                ts, rcfg, FaultConfig(), batch, SHARD_ROUNDS),
            "consensus": scenario.run_consensus_sharded(
                ts, rcfg, ConsensusConfig(quorum_f=1, byzantine_frac=0.2),
                batch, SHARD_ROUNDS)}

    for name, fn in (("segment", segment), ("latency", lat), ("env", env),
                     ("train", train), ("runners", runners)):
        run(name, fn, warm=name != "train")
    return out


def _worst(torch, got, want, tol, path="") -> list:
    """(ratio, path) of every leaf pair of two result trees, the ratio the
    largest elementwise |got - want| / (atol + rtol * |want|) with
    ``(rtol, atol) = tol(path)``: torch.allclose's rule, so a leaf is
    within its tolerance where its ratio is at most 1. Infinities must
    sit at the same places with the same signs."""
    if isinstance(want, dict):
        return [e for k in want
                for e in _worst(torch, got[k], want[k], tol, f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        return [e for i, (g, w) in enumerate(zip(got, want))
                for e in _worst(torch, g, w, tol, f"{path}/{i}")]
    g = torch.as_tensor(got).double().cpu()
    w = torch.as_tensor(want).double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"{path}: shape {tuple(g.shape)} against "
                             f"{tuple(w.shape)}")
    finite = torch.isfinite(w)
    if not (torch.equal(torch.isfinite(g), finite)
            and torch.equal(g[~finite], w[~finite])):
        raise AssertionError(f"{path}: infinities differ")
    rtol, atol = tol(path)
    diff = torch.abs(g[finite] - w[finite])
    bound = atol + rtol * torch.abs(w[finite])
    ratio = torch.where(diff == 0, 0.0, diff / bound)
    return [(float(torch.max(ratio)) if ratio.numel() else 0.0, path)]


# (rtol, atol) of the sharded comparisons, elementwise: the reference
# gate's (benchmarks/bench_scale.py: rtol 1e-5, atol 0; the observations'
# atol 1e-7; the trainer's trace rtol 2e-3 / atol 1e-5). The segment sums
# add 2*10^5 unit normals a segment in another order on two ranks, sums of
# about 450 whose fp32 ulp is 3e-5: their atol is 1e-3, some 30 ulps (the
# kernel and its plain version differ by up to 1.5e-3 at N = 10^5 in
# phase_segment_check); the env's action scores come out of the actor
# after pooled sums, atol 1e-6.
SHARD_TOLS = {"segment": (SHARD_RTOL, 1e-3), "latency": (SHARD_RTOL, 0.0),
              "env": (SHARD_RTOL, 1e-7), "runners": (SHARD_RTOL, 0.0),
              "train": (2e-3, 1e-5), "cli": (SHARD_RTOL, 0.0)}


def _shard_tol(name):
    def tol(path):
        if name == "env" and path == "/scores":
            return SHARD_RTOL, 1e-6
        return SHARD_TOLS[name]
    return tol


def phase_sharded(torch, sr) -> dict:
    """The twin mesh on the card: 2 ranks on the one H100 with gloo (NCCL
    cannot put two ranks on one card), every sharded entry point at the
    sizes of docs/SCALING.md against the same calls on one rank, and the
    serving CLI ``--shards 2 --dist-backend gloo`` against ``--shards 1``.
    Per rank and sub-phase: the segment kernel's launches (equal to the
    one-rank run's: each rank's local reductions run the kernel) and the
    all-reduce calls and bytes."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve_dtwn
    from repro_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    one = _sharded_body(mesh_mod.make_twin_mesh(1, device="cuda"))
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn_twin_ranks(
        _sharded_body, 2, backend="gloo", device="cuda",
        args=(one["results"]["env"]["scores"].cpu(),))
    spawn_s = time.perf_counter() - t0
    errs, actor_diff, bad = {}, 0.0, []
    for name in one["results"]:
        want = one["results"][name]
        worst = []
        for r, rank in enumerate(ranks):
            got = rank["results"][name]
            if name == "train":
                diff = max(float(torch.max(torch.abs(a.cpu() - b.cpu())))
                           for a, b in zip(tree_leaves(got["actor"]),
                                           tree_leaves(want["actor"])))
                if not diff < 1e-4:
                    bad.append(f"actor parameters differ by {diff} on rank "
                               f"{r}")
                actor_diff = max(actor_diff, diff)
                got, want_r = got["trace"], want["trace"]
            else:
                want_r = want
            if name == "env":
                if not torch.equal(got["assoc"].cpu(),
                                   want["assoc"].cpu()):
                    bad.append(f"env associations differ on rank {r}")
            pairs = _worst(torch, got, want_r, _shard_tol(name))
            bad += [f"{name}{path} rank {r}: {e:.3e} times the tolerance "
                    f"{_shard_tol(name)(path)}" for e, path in pairs if e > 1]
            worst += pairs
        errs[name] = max(worst)[0] if worst else 0.0
        launches = [rk["launches"][name] for rk in ranks]
        if launches != [one["launches"][name]] * 2 or (
                name != "latency" and one["launches"][name] <= 0):
            bad.append(f"{name}: segment launches {launches} on the ranks, "
                       f"{one['launches'][name]} on one rank")
        actor = (f", actor within {actor_diff:.3e}" if name == "train"
                 else "")
        log(f"[sharded] {name}: worst elementwise error {errs[name]:.3e} "
            f"of the tolerance {SHARD_TOLS[name]}{actor}; wall "
            f"{max(rk['wall_ms'][name] for rk in ranks):.1f} ms on 2 ranks "
            f"against {one['wall_ms'][name]:.1f} ms on one; segment "
            f"launches per rank {launches}; all-reduce calls/bytes per rank "
            f"{[rk['all_reduce'][name] for rk in ranks]}")
    if one["launches"]["latency"] <= 0:
        bad.append("the latency wrappers launched no segment kernel")
    log(f"[sharded] 2 gloo ranks spawned and run in {spawn_s:.1f} s; NCCL "
        f"was not run (one card; NCCL needs one card per rank)")

    argv = CLI_ARGV + ["--dist-backend", "gloo"]
    cli_one = serve_dtwn.run(argv + ["--shards", "1"], final_state=True)
    cli_two = serve_dtwn.run(argv + ["--shards", "2"], final_state=True)
    if cli_one["rc"] != 0 or cli_two["rc"] != 0:
        raise AssertionError("the serving CLI failed")
    worst = _worst(torch, {k: torch.as_tensor(v) for k, v in
                           cli_two["metrics"].items()},
                   {k: torch.as_tensor(v) for k, v in
                    cli_one["metrics"].items()}, _shard_tol("cli"))
    cli_err = max(worst)[0]
    bad += [f"CLI metric {path}: {e:.3e} times the tolerance "
            f"{SHARD_TOLS['cli']}" for e, path in worst if e > 1]
    for k in ("active", "assoc"):
        if not torch.equal(cli_two["state"][k].cpu(),
                           cli_one["state"][k].cpu()):
            bad.append(f"CLI {k} differs")
    buf_err = max(float(torch.max(torch.abs(cli_two["state"][b][k].cpu()
                                            - cli_one["state"][b][k].cpu())))
                  for b in ("twin_params", "twin_mom")
                  for k in cli_one["state"][b])
    if not buf_err <= 2e-6:
        bad.append(f"CLI FL buffers differ by {buf_err}")
    log(f"[sharded] serve_dtwn {' '.join(argv)} --shards 2 against "
        f"--shards 1: metrics worst elementwise error {cli_err:.3e} of "
        f"the tolerance {SHARD_TOLS['cli']}, FL "
        f"buffers {buf_err:.3e}, masks and associations equal; "
        f"{cli_two['counts']['wall_s']:.2f} s against "
        f"{cli_one['counts']['wall_s']:.2f} s for 20 rounds; rank 0 "
        f"segment launches {cli_two['counts']['segment_launches']} "
        f"(one rank {cli_one['counts']['segment_launches']}), all-reduce "
        f"calls/bytes {cli_two['counts']['all_reduce']}")
    if (cli_two["counts"]["segment_launches"]
            != cli_one["counts"]["segment_launches"]):
        bad.append("CLI segment launches differ")
    log(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise AssertionError("[sharded] " + "; ".join(bad))
    return {
        "launches": {k: [rk["launches"][k] for rk in ranks]
                     for k in one["launches"]},
        "one_rank_launches": one["launches"],
        "all_reduce": {k: [rk["all_reduce"][k] for rk in ranks]
                       for k in one["launches"]},
        "wall_ms": {k: [rk["wall_ms"][k] for rk in ranks]
                    for k in one["wall_ms"]},
        "one_rank_wall_ms": one["wall_ms"], "tol_ratio": errs,
        "actor_max_abs_diff": actor_diff,
        "cli": {"tol_ratio": cli_err, "fl_buffer_err": buf_err,
                "wall_s": [cli_two["counts"]["wall_s"],
                           cli_one["counts"]["wall_s"]],
                "launches_rank0": cli_two["counts"]["segment_launches"],
                "all_reduce_rank0": cli_two["counts"]["all_reduce"]},
    }


# ---------------------------------------------------------------------------
# the LM trainer: loss, optimizers, steps, checkpoints, the train CLI
# ---------------------------------------------------------------------------

# the main path: h2o-danube-1.8b at full width (24 layers, d 2560, bf16,
# remat on, adamw), 4 steps of 2 x 4,096 tokens (train_4k's global batch
# of 256 cut to 2), at lr 1e-5: the CLI's default 3e-4 is constant from the
# first step (the reference builds its warmup schedule and never applies
# it), and adamw's first sign-like steps of 3e-4 on a fresh 1.83 B model
# raised the loss by 1.55 in 4 steps (PERF.md, section 6)
TRAIN_FULL_ARGV = ["--arch", "h2o-danube-1.8b", "--full", "--steps", "4",
                   "--batch", "2", "--seq", "4096", "--log-every", "1",
                   "--lr", "1e-5"]
TRAIN_REMAT = (2, 1, 1024)  # danube's layers kept at full width, batch, seq
# every registered architecture at its smoke config: batch, sequence (a
# multiple of the SSM chunk, 32), steps
TRAIN_CHECK = (2, 64, 3)
TRAIN_LR = 3e-4               # the train CLI's default
TRAIN_LOSS_RTOL = 1e-5        # the CPU parity tests' (test_torch_loss.py)
TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# parameters after an adamw step (tests/test_torch_steps.py): an element
# whose gradient nearly cancels carries fp32 noise into its update
TRAIN_PARAM_TOL = dict(rtol=1e-4, atol=0.05 * TRAIN_LR)
POD_TOL = 5e-3                # the reference's, tests/test_distributed.py


def _loss_grads(torch, model, params, batch):
    """``model.loss`` and its gradient over every parameter leaf (zeros for
    a leaf the loss does not reach)."""
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = model.loss(tree_unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def _worst_ratio(torch, got, want, rtol, atol) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` over leaf pairs
    (<= 1 where ``assert_close`` passes), computed on the CPU in fp64."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        worst = max(worst, float(((g - w).abs() / (atol + rtol * w.abs()))
                                 .max()))
    return worst


def phase_kernel_grad_refused(torch, fa, ssd) -> None:
    """The flash and SSD kernels have no backward (nor have the reference's
    Pallas kernels): on CUDA inputs that require grad their wrappers raise,
    each input in turn, and launch nothing; so does a model built with
    ``use_pallas=True`` asked for a loss under autograd. The model's loss
    trains on the plain path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 256, 4, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kv = torch.randn((1, 256, 2, 64), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    x, dt, A, bm, cm = _ssd_inputs(torch, gen, 1, 256, 2, 16, 8,
                                   torch.float32)
    before = (fa.KERNEL.launches, ssd.KERNEL.launches)
    refused = 0
    for fn, inputs, kw in ((fa.flash_attention, (q, kv, kv), {}),
                           (ssd.ssd_scan, (x, dt, A, bm, cm), {"chunk": 64})):
        for i in range(len(inputs)):
            args = [t.clone().requires_grad_(j == i)
                    for j, t in enumerate(inputs)]
            try:
                fn(*args, **kw)
            except RuntimeError as e:
                if "no backward" not in str(e):
                    raise
                refused += 1
            else:
                raise AssertionError(f"{fn.__name__} took input {i} that "
                                     f"requires grad")
    cfg = get_smoke_config("h2o-danube-1.8b")
    model = build_model(cfg, use_pallas=True)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                           device="cuda")
    try:
        _loss_grads(torch, model, params, {"tokens": tokens})
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        raise AssertionError("a use_pallas model's loss took gradients "
                             "through the flash kernel")
    if (fa.KERNEL.launches, ssd.KERNEL.launches) != before:
        raise AssertionError("a refused call launched a kernel")
    plain, _ = _loss_grads(torch, build_model(cfg), params,
                           {"tokens": tokens})
    with torch.no_grad():
        kern = model.loss(params, {"tokens": tokens})
    torch.cuda.synchronize()
    log(f"[kernel_grad_refused] ok: flash (3 inputs) and SSD (5 inputs) "
        f"refused {refused} calls with an input that requires grad, "
        f"launching nothing; a use_pallas model's loss refused under "
        f"autograd; its no-grad loss {float(kern):.6f} through the kernel, "
        f"the plain path's {float(plain):.6f} with gradients")


def phase_train_full(torch, kernels) -> dict:
    """The train CLI at full width (``TRAIN_FULL_ARGV``), every count set
    to 0 just before and read just after: no kernel launches (the model
    trains on the plain path), finite losses, the last under the first +
    0.5 (the reference's ``test_smoke_train_step`` rule); the warm step's
    CUDA-event ms, tokens/s and the peak device memory."""
    train = importlib.import_module("repro_torch.launch.train")
    log(f"[train_full] python -m repro_torch.launch.train "
        f"{' '.join(TRAIN_FULL_ARGV)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset(kernels)
    t0 = time.perf_counter()
    res = train.main(TRAIN_FULL_ARGV)
    wall = time.perf_counter() - t0
    launches = {k.source.stem: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg, losses = res["cfg"], res["losses"]
    del res["params"], res["opt_state"]
    torch.cuda.empty_cache()
    B, S = (int(TRAIN_FULL_ARGV[TRAIN_FULL_ARGV.index(f) + 1])
            for f in ("--batch", "--seq"))
    log(f"[train_full] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} at hd {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, {cfg.param_dtype}, remat {cfg.remat}, "
        f"{cfg.optimizer}; {res['n_params']:,} parameters; batch {B} x {S}")
    log(f"[train_full] losses {losses}; step ms (CUDA events) "
        f"{[round(x, 4) for x in res['step_ms']]}; warm tokens/s "
        f"{res['tokens_per_s']:.1f}; peak device memory {peak:.2f} GiB; "
        f"kernel launches during the steps {json.dumps(launches)}; "
        f"{wall:.1f} s in all")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0] + 0.5:
        raise AssertionError(f"the loss exploded: {losses}")
    if any(launches.values()):
        raise AssertionError(f"the training path launched a kernel: "
                             f"{launches}")
    warm = res["step_ms"][1:]
    log(f"[train_full] ok: {len(losses)} steps, finite losses, last "
        f"{losses[-1]:.4f} < first {losses[0]:.4f} + 0.5, no kernel launch; "
        f"warm step {statistics.median(warm):.1f} ms (median of "
        f"{len(warm)})")
    return {"arch": cfg.name, "n_params": res["n_params"], "batch": B,
            "seq": S, "losses": losses, "step_ms": res["step_ms"],
            "warm_step_ms": statistics.median(warm),
            "tokens_per_s": res["tokens_per_s"], "peak_gib": peak,
            "launches": launches, "wall_s": wall}


def _kind(name: str) -> str:
    """A device kernel's kind, from its name."""
    n = name.lower()
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matrix products"
    if "softmax" in n or "reduce" in n:
        return "reductions and softmax"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def phase_train_profile(torch) -> dict:
    """The main path's training step (``TRAIN_FULL_ARGV``'s model, batch
    and lr) after a warm step, split by CUDA events into its forward (the
    loss), backward (``autograd.grad``: the blocks' and the attention's
    recomputes and the gradients) and optimizer update; then one more step
    under torch.profiler: device busy time, idle share, and device time by
    kernel kind and by kernel."""
    from repro_torch.configs import get_arch_config
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

    arg = {f: TRAIN_FULL_ARGV[TRAIN_FULL_ARGV.index(f) + 1]
           for f in ("--arch", "--batch", "--seq", "--lr")}
    B, S = int(arg["--batch"]), int(arg["--seq"])
    cfg = get_arch_config(arg["--arch"])
    model = build_model(cfg)
    params = model.init(
        torch.Generator(device="cuda").manual_seed(train.SEED))
    opt = make_optimizer(cfg.optimizer, lr=float(arg["--lr"]))
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda")}
    step = steps.make_train_step(model, opt)
    params, state, _ = step(params, state, batch)  # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    ev[0].record()
    loss = model.loss(tree_unflatten_like(params, leaves), batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    ev[2].record()
    params, state = opt.update(
        tree_unflatten_like(params, [x.detach() for x in leaves]),
        tree_unflatten_like(params, grads), state)
    ev[3].record()
    torch.cuda.synchronize()
    del leaves, grads, loss
    split = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in
             enumerate(("forward", "backward", "update"))}
    log(f"[train_profile] {cfg.name} B={B} S={S}: a warm step split (CUDA "
        f"events, ms): {json.dumps(split)}")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.start()
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    prof.stop()
    wall = (time.perf_counter() - t0) * 1e3
    del params, state
    torch.cuda.empty_cache()
    out = {"split_ms": split, "wall_ms": wall}
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log("[train_profile] device time: not measured (no device events)")
        return out
    union = importlib.import_module("repro_torch.launch.profile_round")._union_us
    busy = union((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    kinds, by_name = collections.Counter(), {}
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        kinds[_kind(e.name)] += ms
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + ms, n + 1)
    out.update(busy_ms=busy, idle=1 - busy / wall, events=len(dev),
               kinds_ms=dict(kinds))
    log(f"[train_profile] a step under the profiler: {wall:.1f} ms, device "
        f"busy {busy:.1f} ms, idle share {100 * (1 - busy / wall):.1f}%, "
        f"{len(dev)} device events; device ms by kind "
        f"{json.dumps({k: round(v, 1) for k, v in kinds.most_common()})}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, n) in top:
        log(f"[train_profile]   {ms:10.2f} ms {n:7d}x  {name[:90]}")
    return out


def phase_train_remat(torch) -> dict:
    """danube at full width cut to ``TRAIN_REMAT``'s layers (bf16), one
    batch: the loss and the bf16 gradients with remat on and off. The loss
    within rtol 1e-6, each gradient leaf within one bf16 rounding step
    (2^-8) of its largest value (the card's atomic adds may sum in another
    order); whether they are bit-equal and the largest relative difference
    are printed, with each run's peak memory."""
    from repro_torch.configs import get_arch_config
    from repro_torch.models import build_model

    n_layers, B, S = TRAIN_REMAT
    cfg = dataclasses.replace(get_arch_config("h2o-danube-1.8b"),
                              n_layers=n_layers)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = build_model(cfg).init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda")}
    runs = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(dataclasses.replace(cfg, remat=remat))
        loss, grads = _loss_grads(torch, model, params, batch)
        torch.cuda.synchronize()
        runs[remat] = (loss, grads, torch.cuda.max_memory_allocated() / 2**30)
    (l1, g1, m1), (l0, g0, m0) = runs[True], runs[False]
    rel = max(float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30))
              for a, b in zip(g1, g0))
    equal = sum(bool(torch.equal(a, b)) for a, b in zip(g1, g0))
    log(f"[train_remat] {cfg.name} cut to {n_layers} layers, "
        f"{cfg.param_dtype}, batch {B} x {S}: loss remat on {float(l1)!r}, "
        f"off {float(l0)!r}; "
        f"gradients bit-equal in {equal} of {len(g0)} leaves, largest "
        f"relative difference {rel:.3e}; peak memory {m1:.2f} GiB on, "
        f"{m0:.2f} off")
    if not abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0)):
        raise AssertionError(f"remat changed the loss: {float(l1)} against "
                             f"{float(l0)}")
    if not rel <= 2.0 ** -8:
        raise AssertionError(f"remat changed the gradients by {rel:.3e} of "
                             f"their largest value")
    log("[train_remat] ok: remat on equals remat off")
    return {"loss": float(l1), "loss_equal": bool(torch.equal(l1, l0)),
            "grad_max_rel_diff": rel,
            "grad_leaves_equal": equal, "grad_leaves": len(g0),
            "peak_gib_remat": m1, "peak_gib_no_remat": m0}


def phase_train_gpu_vs_cpu(torch) -> dict:
    """Every registered architecture at its smoke config (fp32), with its
    config's optimizer (adafactor for mixtral, command-r-plus, deepseek-v2
    and jamba, adamw for the rest) and the train CLI's data and stub
    inputs (``train.train_batch``): ``TRAIN_CHECK``'s steps on the card
    (finite losses, the last under the first + 0.5); then, from the card's
    state and the next batch, the loss and gradients on the card against
    the CPU (the CPU tests' tolerances); the state saved to a checkpoint
    on the card, loaded, carried back by ``bridge`` (bit for bit) and
    stepped once, equal to the step without the save (loss rtol 1e-6,
    parameters ``TRAIN_PARAM_TOL``: the card's atomic adds may sum in
    another order; bit-equality is reported); and 2 pods (half the batch
    each, sgd at lr 0.1 without momentum, as the reference's test) synced
    after one step, against the synced step on the whole batch (<
    ``POD_TOL``)."""
    import tempfile

    from repro_torch import bridge
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.data.tokens import batches, synthetic_tokens
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    B, S, n_steps = TRAIN_CHECK
    out = {}
    for arch in sorted(ARCH_NAMES):
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR)
        step = steps.make_train_step(model, opt)
        gen = torch.Generator(device="cuda").manual_seed(1)
        it = batches(synthetic_tokens(cfg.vocab_size, 200_000, seed=0),
                     2 * B, S, seed=1)
        data = [train.train_batch(cfg, torch.from_numpy(next(it)["tokens"])
                                  .to("cuda", torch.int64), gen)
                for _ in range(n_steps + 1)]
        data, whole = [tree_map(lambda x: x[:B], b) for b in data], data[-1]
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        state = opt.init(params)
        losses = []
        for b in data[:n_steps]:
            params, state, loss = step(params, state, b)
            losses.append(float(loss))
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0] + 0.5):
            raise AssertionError(f"{arch}: losses {losses}")
        # the card against the CPU, from the card's state
        b = data[n_steps]
        lg, gg = _loss_grads(torch, model, params, b)
        lc, gc = _loss_grads(torch, model, _to(params, "cpu"), _to(b, "cpu"))
        loss_gap = abs(float(lg) - float(lc)) / abs(float(lc))
        grad_ratio = _worst_ratio(torch, gg, gc, **TRAIN_GRAD_TOL)
        if not (loss_gap <= TRAIN_LOSS_RTOL and grad_ratio <= 1.0):
            raise AssertionError(f"{arch}: GPU against CPU loss {float(lg)} / "
                                 f"{float(lc)}, gradients at {grad_ratio:.3f} "
                                 f"of the tolerance")
        # a checkpoint written on the card, reloaded, stepped once
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, n_steps, {"params": params, "opt_state": state,
                                         "step": n_steps})
            tree, at = load_checkpoint(d)
        p2 = bridge.lm_params_from_numpy(tree["params"], "cuda")
        s2 = bridge.opt_state_from_numpy(tree["opt_state"], "cuda")
        if at != n_steps or not all(
                a.dtype == c.dtype and torch.equal(a, c) for a, c in
                zip(tree_leaves([p2, s2]), tree_leaves([params, state]))):
            raise AssertionError(f"{arch}: the checkpoint did not reload the "
                                 f"state it saved")
        pa, _, la = step(params, state, b)
        pb, _, lb = step(p2, s2, b)
        resume_ratio = _worst_ratio(torch, tree_leaves(pb), tree_leaves(pa),
                                    **TRAIN_PARAM_TOL)
        if not (abs(float(la) - float(lb)) <= 1e-6 * abs(float(la))
                and resume_ratio <= 1.0):
            raise AssertionError(f"{arch}: the step after the reload: loss "
                                 f"{float(lb)} against {float(la)}, params at "
                                 f"{resume_ratio:.3f} of the tolerance")
        resume_equal = all(torch.equal(a, c) for a, c in
                           zip(tree_leaves(pb), tree_leaves(pa)))
        # 2 pods synced after one step against the synced whole-batch step
        sgd = make_optimizer("sgd", lr=0.1, momentum=0.0)
        p_ref, _, _ = steps.make_train_step(model, sgd)(
            params, sgd.init(params), whole)
        stack = lambda t: tree_map(  # noqa: E731
            lambda x: torch.stack([x, x]) if torch.is_tensor(x) else x, t)
        pods = {k: v.reshape((2, B) + v.shape[1:]) for k, v in whole.items()}
        ps, _, _ = steps.make_pod_local_train_step(model, sgd, 2)(
            stack(params), stack(sgd.init(params)), pods)
        ps = steps.make_cross_pod_sync(2)(ps)
        pod_diff = max(float((a - c[0]).abs().max()) for a, c in
                       zip(tree_leaves(p_ref), tree_leaves(ps)))
        if not pod_diff < POD_TOL:
            raise AssertionError(f"{arch}: 2 synced pods {pod_diff:.3e} from "
                                 f"the synced step")
        row = {"optimizer": cfg.optimizer, "losses": losses,
               "loss_rel_gap": loss_gap, "grad_tol_ratio": grad_ratio,
               "resume_tol_ratio": resume_ratio,
               "resume_bit_equal": resume_equal, "pod_max_abs_diff": pod_diff,
               "seconds": time.perf_counter() - t0}
        log(f"[train_gpu_vs_cpu] ok (tf32 off): {cfg.name}, {cfg.optimizer}: "
            f"{n_steps} steps on the card, losses "
            f"{[round(x, 4) for x in losses]}; GPU against CPU loss "
            f"{loss_gap:.2e} relative, gradients at {grad_ratio:.3f} of rtol "
            f"1e-4 / atol 1e-5; the step after a checkpoint reload at "
            f"{resume_ratio:.3f} of its tolerance (bit-equal: "
            f"{resume_equal}); 2 synced pods {pod_diff:.2e} from the synced "
            f"step (< {POD_TOL}); {row['seconds']:.1f} s")
        out[arch] = row
        del model, params, state, p2, s2, pa, pb, ps, p_ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the LM meshes (ROADMAP A11.9): 4 gloo ranks sharing the card, a (2, 2)
# ("data", "model") debug mesh (nccl needs a card per rank)
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_DEVICE = "cuda"
# (a) mixtral-8x22b at full width cut to 2 layers: one prefill forward of
# B x S under activation_mesh(mesh, "2d"), capacity factor 1.25 (the
# config's; the main run, counted and timed) and 8.0 (no drop: held to one
# rank at the flash tests' bf16 tolerance)
MESH_MIXTRAL = ("mixtral-8x22b", 2, 4, 4096)
MESH_CFS = (8.0, 1.25)
MESH_BF16_TOL = 3e-2      # the flash tests' bf16 tolerance, of max |logit|
MESH_FP32_TOL = 1e-4      # fp32 logits (the CPU parity tests' TOL)
# (b) the train CLI on the synced mesh, danube at full width; 2 steps (a
# cold and a warm one): a mesh step of 2 x 2,048 tokens moves ~16.8 GB a
# rank through the host and took ~48 s on 4 gloo ranks (PERF.md, section 6)
TRAIN_MESH_ARGV = ["--arch", "h2o-danube-1.8b", "--full", "--steps", "2",
                   "--batch", "2", "--seq", "2048", "--log-every", "1",
                   "--lr", "1e-5"]
TRAIN_MESH_LOSS_RTOL = 5e-3   # bf16 partial sums reduced in another order
# (d) --hierarchical 1 on the (2, 1, 2) pod mesh, danube's smoke config
POD_ARGV = ["--arch", "h2o-danube-1.8b", "--steps", "1", "--batch", "4",
            "--seq", "64", "--log-every", "1"]


def _mesh_forward(torch, kernels, model, params, batch, mesh=None) -> dict:
    """One ``last_only`` forward, every count set to 0 just before and read
    just after: the logits (fp32, on the CPU), the flash and SSD launches,
    the dropped (token, slot) pairs of each capacity layer (this rank's
    source shard under expert parallelism), the host-staged collectives,
    CUDA-event ms and the peak device memory."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives
    from repro_torch.sharding.act import activation_mesh

    dev = torch.device(MESH_DEVICE)
    _reset(kernels)
    collectives.reset_counts()
    moe.DROP_LOG = []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ctx = activation_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with torch.no_grad(), ctx:
        t0.record()
        logits, aux = model.forward(params, batch, last_only=True)
        t1.record()
        logits, aux = (x.full_tensor() if hasattr(x, "full_tensor") else x
                       for x in (logits, aux))
    torch.cuda.synchronize(dev)
    out = {"logits": logits.float().cpu(), "aux": float(aux),
           "launches": {k.source.stem: k.launches for k in kernels},
           "drops": [int(d) for d in moe.DROP_LOG],
           "host_staged": dict(collectives.HOST_STAGED),
           "ms": t0.elapsed_time(t1),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    moe.DROP_LOG = None
    return out


def _mesh_case_runs(name):
    if name == "mixtral":
        return [(f"cf{cf}", {"capacity_factor": cf}) for cf in MESH_CFS]
    return [("smoke", {})]


def _mesh_cases():
    """(name, config, batch, seq): (a) and (c)."""
    from repro_torch.configs import get_arch_config, get_smoke_config

    arch, layers, B, S = MESH_MIXTRAL
    serve = importlib.import_module("repro_torch.launch.serve")
    return [("mixtral", dataclasses.replace(get_arch_config(arch),
                                            n_layers=layers), B, S),
            ("jamba", get_smoke_config(JAMBA), serve.BATCH,
             serve.PROMPT_LEN)]


def _mesh_lm_body(mesh) -> dict:
    """One rank of phases (a) and (c). The ranks draw the full weights one
    at a time (each keeps its block and frees the rest), then run each
    case's forwards under ``activation_mesh(mesh, "2d")``."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import build_model
    from repro_torch.sharding import batch_pspec, param_pspecs, place_tree
    from repro_torch.sharding.specs import place

    serve = importlib.import_module("repro_torch.launch.serve")
    kernels = [importlib.import_module(f"repro_torch.kernels.{m}").KERNEL
               for m in ("flash_attention", "ssd_scan")]
    out = {"coords": mesh.coords}
    for name, cfg, B, S in _mesh_cases():
        placed = None
        for r in range(mesh.size):
            if r == mesh.rank:
                _, params = serve.random_model(cfg, serve.SEED, MESH_DEVICE)
                placed = place_tree(params, param_pspecs(params, mesh), mesh)
                del params
                torch.cuda.empty_cache()
            dist.barrier()
        tokens = serve.random_prompts(cfg, B, S, serve.SEED, MESH_DEVICE)
        batch = {"tokens": place(tokens, batch_pspec(mesh, 2), mesh)}
        for tag, over in _mesh_case_runs(name):
            model = build_model(dataclasses.replace(cfg, **over),
                                use_pallas=True)
            dist.barrier()
            out[f"{name}/{tag}"] = _mesh_forward(torch, kernels, model,
                                                 placed, batch, mesh)
        del placed
        torch.cuda.empty_cache()
    return out


def _close_ratio(torch, got, want, atol, rtol) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 within tolerance."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def phase_mesh_lm(torch, kernels) -> dict:
    """(a) mixtral-8x22b at full width (d 6144, 48/8 heads of hd 128, 8
    experts of ff 16,384, vocab 32,768) cut to 2 layers, and (c) jamba's
    smoke config, on 4 gloo ranks of a (2, 2) mesh sharing the card: one
    prefill forward each under ``activation_mesh(mesh, "2d")``, through the
    flash kernel on each rank's local heads (mixtral 24 of 48, B 2 of 4),
    mixtral's MoE through ``moe_capacity_ep_a2a`` (4 experts a rank, EP
    over data, ff over model) and jamba's mamba mixer through the SSD
    kernel on local heads. Held against the same cut on one rank: mixtral
    at capacity factor 8.0 (no drop) within 3e-2 of the largest logit
    (bf16; the elementwise ratio at atol = rtol = 3e-2 is reported), jamba
    within 1e-4 of it (fp32); at 1.25 each layer's dropped slots on the
    mesh (per source shard, summed) and on one rank (global capacity)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import build_model

    serve = importlib.import_module("repro_torch.launch.serve")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_mod.spawn_lm_ranks(_mesh_lm_body, MESH_RANKS,
                                    backend="gloo", device=MESH_DEVICE)
    spawn_s = time.perf_counter() - t0
    out = {"spawn_s": spawn_s, "runs": {}}
    for name, cfg, B, S in _mesh_cases():
        model0, params = serve.random_model(cfg, serve.SEED, MESH_DEVICE)
        tokens = serve.random_prompts(cfg, B, S, serve.SEED, MESH_DEVICE)
        for tag, over in _mesh_case_runs(name):
            key = f"{name}/{tag}"
            model = build_model(dataclasses.replace(cfg, **over),
                                use_pallas=True)
            one = _mesh_forward(torch, kernels, model, params,
                                {"tokens": tokens})
            mesh_runs = [r[key] for r in ranks]
            got = mesh_runs[0]["logits"]
            for r, run in enumerate(mesh_runs[1:], 1):
                if not torch.equal(run["logits"], got):
                    raise AssertionError(f"[mesh] {key}: rank {r}'s gathered "
                                         f"logits differ from rank 0's")
            if not bool(torch.isfinite(got).all()) or \
                    got.shape != one["logits"].shape:
                raise AssertionError(f"[mesh] {key}: logits {got.shape} not "
                                     f"finite or not {one['logits'].shape}")
            err = float((got - one["logits"]).abs().max())
            # EP drops are per source shard: sum the data ranks of model 0
            mesh_drops = [sum(d) for d in zip(*(
                run["drops"] for r, run in zip(ranks, mesh_runs)
                if r["coords"][-1] == 0))]
            row = {"B": B, "S": S, "max_abs_diff": err,
                   "mesh_launches": [run["launches"] for run in mesh_runs],
                   "one_rank_launches": one["launches"],
                   "mesh_drops": mesh_drops, "one_rank_drops": one["drops"],
                   "host_staged": [run["host_staged"] for run in mesh_runs],
                   "mesh_ms": [run["ms"] for run in mesh_runs],
                   "one_rank_ms": one["ms"],
                   "mesh_peak_gib": [run["peak_gib"] for run in mesh_runs],
                   "one_rank_peak_gib": one["peak_gib"],
                   "aux": mesh_runs[0]["aux"], "one_rank_aux": one["aux"]}
            if tag != "cf1.25":  # the held comparisons
                tol = MESH_BF16_TOL if name == "mixtral" else MESH_FP32_TOL
                # elementwise atol = rtol = tol, reported; held: tol of the
                # largest logit (bf16 partial sums are all-reduced in bf16,
                # as GSPMD reduces a bf16 product's partials)
                row["elementwise_ratio"] = _close_ratio(
                    torch, got, one["logits"], tol, tol)
                row["max_abs_logit"] = float(one["logits"].abs().max())
                log(f"[mesh] {key}: elementwise |diff| / ({tol} + {tol} "
                    f"|logit|) up to {row['elementwise_ratio']:.3f}; mean "
                    f"|diff| {float((got - one['logits']).abs().mean()):.4e}")
                _last_logits_close(torch, got, one["logits"], tol,
                                   f"mesh {key} vs one rank")
                if name == "mixtral" and (sum(mesh_drops) or sum(one["drops"])):
                    raise AssertionError(f"[mesh] {key}: slots dropped at "
                                         f"cf 8.0: {mesh_drops}, "
                                         f"{one['drops']}")
            n_attn = _attention_layers(cfg)
            for r, run in enumerate(mesh_runs):
                n = run["launches"]
                if n["flash_attention"] != n_attn or n["ssd_scan"] != \
                        one["launches"]["ssd_scan"]:
                    raise AssertionError(f"[mesh] {key}: rank {r} launched "
                                         f"{n}, one rank {one['launches']}")
            if name == "mixtral" and MESH_DEVICE == "cuda" and not all(
                    run["host_staged"].get("all_to_all_calls")
                    for run in mesh_runs):
                raise AssertionError(f"[mesh] {key}: no expert-parallel "
                                     f"all-to-all on some rank")
            log(f"[mesh] {key} B={B} S={S}: max_abs_diff vs one rank "
                f"{err:.4e}; launches a rank {row['mesh_launches'][0]}; "
                f"dropped slots a layer mesh {mesh_drops}, one rank "
                f"{one['drops']}; aux {row['aux']:.6f} / one rank "
                f"{row['one_rank_aux']:.6f}")
            log(f"[mesh] {key}: forward ms (CUDA events) a rank "
                f"{[round(x, 3) for x in row['mesh_ms']]}, one rank "
                f"{one['ms']:.3f}; peak GiB a rank "
                f"{[round(x, 3) for x in row['mesh_peak_gib']]}, one rank "
                f"{one['peak_gib']:.3f}")
            log(f"[mesh] {key}: host-staged collectives a rank "
                f"{json.dumps(row['host_staged'])}")
            out["runs"][key] = row
            del model
        del model0, params, tokens
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase {out['seconds']:.1f} s (the ranks {spawn_s:.1f} s)")
    return out


def phase_train_mesh(torch) -> dict:
    """(b) the train CLI at full width on the synced mesh:
    ``train.main(TRAIN_MESH_ARGV + ["--devices", "4"])`` (4 gloo ranks on
    the card, parameters and adamw state placed by ``param_pspecs``,
    batches by ``batch_pspec``), its losses against the one-device CLI on
    the same batches (rtol 5e-3: bf16 partial sums reduced in another
    order), ms a step (CUDA events), peak memory and host-staged bytes a
    rank. (d) ``--hierarchical 1 --devices 4`` at danube's smoke config on
    the (2, 1, 2) pod mesh against the synced one-device step, within the
    reference test's 5e-3."""
    from repro_torch.utils.tree import tree_leaves

    train = importlib.import_module("repro_torch.launch.train")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    argv = TRAIN_MESH_ARGV + ["--devices", str(MESH_RANKS)]
    log(f"[train_mesh] python -m repro_torch.launch.train {' '.join(argv)}")
    t0 = time.perf_counter()
    mesh = train.main(argv, trees=False)
    mesh_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    one = train.main(TRAIN_MESH_ARGV, trees=False)
    torch.cuda.empty_cache()
    gap = max(abs(a - b) / abs(b) for a, b in zip(mesh["losses"],
                                                  one["losses"]))
    log(f"[train_mesh] losses mesh {mesh['losses']}, one device "
        f"{one['losses']}; largest relative gap {gap:.3e} (held to "
        f"{TRAIN_MESH_LOSS_RTOL})")
    log(f"[train_mesh] ms a step (CUDA events, rank 0) "
        f"{[round(x, 1) for x in mesh['step_ms']]}, one device "
        f"{[round(x, 1) for x in one['step_ms']]}; warm tokens/s mesh "
        f"{mesh['tokens_per_s']:.1f}, one device {one['tokens_per_s']:.1f}")
    log(f"[train_mesh] peak MiB a rank {mesh['rank_peak_mb']}; host-staged "
        f"collectives a rank {json.dumps(mesh['rank_host_bytes'])}; "
        f"{mesh_s:.1f} s in all")
    if not all(math.isfinite(x) for x in mesh["losses"]) or \
            gap > TRAIN_MESH_LOSS_RTOL:
        raise AssertionError(f"[train_mesh] losses {mesh['losses']} against "
                             f"{one['losses']}")
    if mesh["mesh"] != {"data": 2, "model": 2}:
        raise AssertionError(f"[train_mesh] mesh {mesh['mesh']}")
    # (d)
    pod = train.main(POD_ARGV + ["--devices", str(MESH_RANKS),
                                 "--hierarchical", "1"])
    synced = train.main(POD_ARGV)
    diff = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(
        tree_leaves(pod["params"]), tree_leaves(synced["params"])))
    log(f"[train_mesh] --hierarchical 1 --devices {MESH_RANKS} on "
        f"{pod['mesh']}: pod 0's parameters against the synced one-device "
        f"step, max_abs_diff {diff:.4e} (held to {POD_TOL}); losses "
        f"{pod['losses']} / {synced['losses']}")
    if not diff < POD_TOL or pod["mesh"] != {"pod": 2, "data": 1,
                                             "model": 2}:
        raise AssertionError(f"[train_mesh] hierarchical: {diff}, "
                             f"{pod['mesh']}")
    out = {"losses": mesh["losses"], "one_device_losses": one["losses"],
           "loss_rel_gap": gap, "step_ms": mesh["step_ms"],
           "one_device_step_ms": one["step_ms"],
           "tokens_per_s": mesh["tokens_per_s"],
           "one_device_tokens_per_s": one["tokens_per_s"],
           "rank_peak_mb": mesh["rank_peak_mb"],
           "rank_host_staged": mesh["rank_host_bytes"],
           "pod_max_abs_diff": diff,
           "seconds": time.perf_counter() - t_phase}
    log(f"[train_mesh] phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the dry run (ROADMAP A11.10): the production meshes as meta DTensors on a
# fake process group, and the roofline against the card
# ---------------------------------------------------------------------------

# (arch, shape, multi-pod, the layout choose_layout must give): the CLI on
# the production mesh at full width. On 512 ranks danube's 256 rows do not
# split over every rank, so the rule gives "2d". mixtral's 8 experts do not
# divide the 16-rank FSDP axis, so the reference's rule runs its capacity
# router without expert parallelism; deepseek-v2's 160 experts take the EP
# all-to-all.
DRYRUN_COMBOS = (("h2o-danube-1.8b", "train_4k", False, "dp"),
                 ("mixtral-8x22b", "train_4k", False, "2d"),
                 ("deepseek-v2-236b", "train_4k", False, "2d"),
                 ("deepseek-v2-236b", "decode_32k", False, "decode"),
                 ("h2o-danube-1.8b", "train_4k", True, "2d"))
DRYRUN_EP = ("deepseek-v2-236b", "train_4k")
DRYRUN_TIMEOUT_S = 300
# one placed product on a fake (16, 16) mesh: x (256 x 512, 1024) split over
# "data", w (1024, 4096) over "model"; rank 0's product is (8192, 1024) x
# (1024, 256). Then danube's full-width training step (2 x 4,096, as
# phase_train_full) and prefill (4 x 4,608, as the served prompts) traced
# on one rank for their roofline.
DRYRUN_ONE_RANK = """
import json
import torch
from repro_torch.configs import SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.sharding.specs import P, place

out = {}
with dryrun.fake_world(256):
    mesh = make_lm_mesh((16, 16), ("data", "model"), backend="fake",
                        device="cpu")
    x = place(torch.empty((256 * 512, 1024), dtype=torch.bfloat16,
                          device="meta"), P("data", None), mesh)
    w = place(torch.empty((1024, 4096), dtype=torch.bfloat16,
                          device="meta"), P(None, "model"), mesh)
    cost = dryrun.RankCost()
    with cost:
        y = x @ w
    out["deferral"] = {"dot_flops": cost.dot_flops,
                       "local": list(y.to_local().shape),
                       "collectives": cost.collectives}
for name, (S, B, mode) in {"chip_train": (4096, 2, "train"),
                           "chip_prefill": (4608, 4, "prefill")}.items():
    SHAPES[name] = ShapeConfig(name, S, B, mode)
    with dryrun.fake_world(1):
        mesh = make_lm_mesh((1, 1), ("data", "model"), backend="fake",
                            device="cpu")
        out[name] = dryrun.lower_one("h2o-danube-1.8b", name, mesh=mesh)
print(json.dumps(out))
"""


def _warm_prefill_ms(torch, serve, reps: int = 3) -> list:
    """danube's served prefill (``serve.BATCH`` x ``serve.PROMPT_LEN``,
    bf16, the flash kernel, last-position logits) after one warm-up: CUDA
    event ms of each of ``reps`` calls."""
    from repro_torch.configs import get_arch_config

    cfg = get_arch_config(serve.ARCH)
    ms = []
    with torch.inference_mode():
        model, params = serve.random_model(cfg, serve.SEED, "cuda")
        prompts = serve.random_prompts(cfg, serve.BATCH, serve.PROMPT_LEN,
                                       serve.SEED, "cuda")
        batch = serve.prompt_batch(cfg, prompts)
        for i in range(reps + 1):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            model.forward(params, batch, last_only=True)
            b.record()
            torch.cuda.synchronize()
            if i:
                ms.append(a.elapsed_time(b))
    del model, params
    torch.cuda.empty_cache()
    return ms


def _dryrun_record(arch, shape, pod) -> Path:
    """The dry run CLI's record of (arch, shape) on the production mesh."""
    tag = "2x16x16" if pod else "16x16"
    return ROOT / "results" / "dryrun_torch" / f"{arch}__{shape}__{tag}.json"


def _dryrun_line(rec) -> str:
    roof, cost = rec["roofline"], rec["op_cost"]
    colls = {k: f"{int(v['count'])} / {v['bytes'] / 1e9:.3f} GB"
             for k, v in cost["collectives"].items()}
    return (f"compute {roof['compute_s']:.6f} s, memory "
            f"{roof['memory_s']:.6f} s, collective {roof['collective_s']:.6f}"
            f" s, dominant {roof['dominant']}; hbm/device "
            f"{rec['bytes']['hbm_per_device'] / 1e9:.3f} GB; dot FLOPs a "
            f"rank {cost['dot_flops_per_device']:.4e}; collectives (count / "
            f"bytes a rank) {json.dumps(colls)}; useful "
            f"{rec['useful_flops_ratio']:.4f}; traced n_layers "
            f"{rec['trace_depths']} in {rec['trace_s']} s")


def phase_dryrun(torch, serve, trained, served, device) -> dict:
    """The dry run's CLI (``python -m repro_torch.launch.dryrun``) on the
    production meshes at full width (``DRYRUN_COMBOS``), each in its own
    process on the CPU (a fake process group of 256 or 512 ranks; no card),
    all started together; its records must be ``ok`` with the layouts
    ``choose_layout`` gives, and the EP all-to-all must appear where the
    experts divide the FSDP axis. Beside them, in one more process: the
    counting mode's deferral on this torch (one placed product's count is
    the local product's, with no collective), and the one-rank roofline of
    danube's training step and prefill, each below the time this run
    measured for it (``phase_train_full``'s warm step; the prefill warm,
    timed here, and as served, cold)."""
    t0 = time.perf_counter()
    warm = _warm_prefill_ms(torch, serve)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    try:
        for arch, shape, pod, _ in DRYRUN_COMBOS:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape] + (
                        ["--multi-pod"] if pod else [])
            log(f"[dryrun] {' '.join(argv[1:])}")
            procs[(arch, shape, pod)] = subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        procs["one_rank"] = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_ONE_RANK], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        outs = {}
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            if proc.returncode:
                rec = {}
                if key != "one_rank":
                    rec = json.loads(_dryrun_record(*key).read_text())
                raise AssertionError(
                    f"dry run {key} failed ({proc.returncode}): "
                    f"{rec.get('traceback', '')[-3000:]}{err[-3000:]}")
            outs[key] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    records = {}
    for arch, shape, pod, layout in DRYRUN_COMBOS:
        tag = "2x16x16" if pod else "16x16"
        rec = json.loads(_dryrun_record(arch, shape, pod).read_text())
        log(f"[dryrun] {arch} {shape} on {tag} ({rec['layout']}): "
            f"{_dryrun_line(rec)}")
        if not rec["ok"] or rec["layout"] != layout \
                or rec["n_chips"] != (512 if pod else 256):
            raise AssertionError(f"dry run {arch} {shape} {tag}: ok "
                                 f"{rec['ok']}, layout {rec['layout']} "
                                 f"(want {layout}), {rec['n_chips']} ranks")
        records[f"{arch}|{shape}|{tag}"] = rec
    ep = records["|".join(DRYRUN_EP) + "|16x16"]
    a2a = ep["op_cost"]["collectives"].get("all-to-all", {"count": 0})
    if not a2a["count"]:
        raise AssertionError(f"{DRYRUN_EP}: no all-to-all in the dry run's "
                             f"collectives {ep['op_cost']['collectives']}")
    one = json.loads(outs["one_rank"].strip().splitlines()[-1])
    dfr = one["deferral"]
    hand = 2.0 * 8192 * 1024 * 256
    log(f"[dryrun] deferral on torch {torch.__version__}: one placed product "
        f"on a fake (16, 16) mesh counts {dfr['dot_flops']:.6e} FLOPs on "
        f"rank 0, local result {dfr['local']}, collectives "
        f"{dfr['collectives']}; the local product by hand {hand:.6e}")
    if dfr["dot_flops"] != hand or dfr["local"] != [8192, 256] \
            or dfr["collectives"]:
        raise AssertionError(f"the counting mode's deferral: {dfr}")
    measured = {"train": (trained["warm_step_ms"],
                          "phase_train_full's warm step, CUDA events"),
                "prefill": (statistics.median(warm),
                            "warm, CUDA events, median of 3"),
                "prefill_served": (served["prefill_ms"],
                                   "the serve CLI's cold prefill, host clock")}
    shares = {}
    for key, rec_key in (("train", "chip_train"), ("prefill", "chip_prefill"),
                         ("prefill_served", "chip_prefill")):
        rec = one[rec_key]
        bound_ms = rec["roofline"]["roofline_step_s"] * 1e3
        ms, what = measured[key]
        shares[key] = {"roofline_ms": bound_ms, "measured_ms": ms,
                       "share": bound_ms / ms,
                       "dominant": rec["roofline"]["dominant"]}
        log(f"[dryrun] roofline of danube's {key} on one rank: "
            f"{bound_ms:.3f} ms ({rec['roofline']['dominant']}; "
            f"{_dryrun_line(rec)}); measured {ms:.3f} ms ({what}): share "
            f"of the roofline {bound_ms / ms:.4f} on {device['smi']}")
        if not bound_ms < ms:
            raise AssertionError(f"danube {key}: the roofline {bound_ms} ms "
                                 f"is not below the measured {ms} ms")
    wall = time.perf_counter() - t0
    log(f"[dryrun] ok: {len(records)} production-mesh records, deferral "
        f"exact, roofline shares train {shares['train']['share']:.4f}, "
        f"prefill {shares['prefill']['share']:.4f} (served "
        f"{shares['prefill_served']['share']:.4f}); warm prefill ms "
        f"{[round(x, 3) for x in warm]}; {wall:.1f} s in all")
    return {"records": {k: {"roofline": r["roofline"],
                            "hbm_per_device": r["bytes"]["hbm_per_device"],
                            "collectives": r["op_cost"]["collectives"],
                            "dot_flops_per_device":
                                r["op_cost"]["dot_flops_per_device"],
                            "trace_s": r["trace_s"]}
                        for k, r in records.items()},
            "deferral": dfr, "shares": shares, "wall_s": wall}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sr = importlib.import_module("repro_torch.kernels.segment_reduce")
    fr = importlib.import_module("repro_torch.kernels.fedavg_reduce")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    build = importlib.import_module("repro_torch.kernels._build")
    serve = importlib.import_module("repro_torch.launch.serve")
    from repro_torch.data import cifar10

    kernels = [sr.KERNEL, fr.KERNEL, fa.KERNEL, ssd.KERNEL]
    t_start = time.perf_counter()
    device = phase_device(torch)
    phase_build(kernels, build)
    seg_err = phase_segment_check(torch, sr)
    grad_err = phase_segment_grad(torch, sr)
    fed_err = phase_fedavg_check(torch, fr)
    phase_flash_check(torch, fa)
    main_call = flash_main(serve)
    flash = phase_flash_main(torch, fa, main_call)
    gemma = phase_flash_shape(torch, fa, "gemma2-9b", FLASH_GEMMA, 8)
    qwen = phase_flash_shape(torch, fa, "qwen1.5-4b", FLASH_QWEN, 9)
    qwen2vl = phase_flash_shape(torch, fa, QWEN2VL, FLASH_QWEN2VL, 10)
    seamless_enc = phase_flash_shape(torch, fa, f"{SEAMLESS} encoder",
                                     FLASH_SEAMLESS_ENC, 11)
    seamless_dec = phase_flash_shape(torch, fa, f"{SEAMLESS} decoder",
                                     FLASH_SEAMLESS_DEC, 12)
    phase_ssd_check(torch, ssd)
    ssd_call = ssd_main(serve)
    scan = phase_ssd_main(torch, ssd, ssd_call)
    timing = phase_timing(torch, sr, fr)
    t0 = time.perf_counter()
    data = cifar10.load()
    log(f"[data] {data[2]} {data[0][0].shape[0]}/{data[1][0].shape[0]} made "
        f"in {time.perf_counter() - t0:.1f} s")
    launches = phase_slice(torch, sr, fr, data, kernels)
    phase_gpu_vs_cpu(torch, data)
    robust = phase_robust_round(torch, sr, fr, data, kernels)
    phase_robust_gpu_vs_cpu(torch, data)
    marl = phase_marl_train(torch, kernels)
    phase_marl_profile(torch, kernels)
    marl_grad_gap = phase_marl_gpu_vs_cpu(torch, sr, marl)
    hook = phase_marl_fl_hook(torch, sr, fr, data, kernels, marl["ts"].agent)
    scen = phase_scenarios(torch, sr, kernels, marl)
    stream = phase_serve_stream(torch, sr, kernels, data)
    del data
    cli = phase_serve_cli(torch, sr, kernels)
    sharded = phase_sharded(torch, sr)
    torch.cuda.empty_cache()
    served = phase_serve(torch, kernels, fa, serve)
    phase_serve_kernel_vs_plain(torch, serve)
    phase_serve_gpu_vs_cpu(torch, fa, serve)
    forward = phase_mamba_forward(torch, kernels, serve)
    phase_mamba_gpu_vs_cpu(torch, ssd, serve)
    phase_ssm_serve(torch, kernels, serve)
    lm_served = {arch: phase_lm_serve(torch, kernels, fa, serve, arch)
                 for arch in LM_SERVED}
    lm_cuts = phase_lm_cuts(torch, kernels, serve)
    jamba = phase_jamba(torch, kernels, fa, serve)
    qwen2vl_layout = phase_qwen2vl_layout(torch, kernels, serve)
    seamless = phase_seamless(torch, kernels, serve)
    lm_gpu_cpu = phase_lm_gpu_vs_cpu(torch, serve)
    lm_runs = {**lm_served, **lm_cuts, f"{JAMBA} smoke": jamba,
               f"{QWEN2VL} image layout": qwen2vl_layout, SEAMLESS: seamless,
               "gpu_vs_cpu": lm_gpu_cpu}
    log(f"[lm] runs: {json.dumps(lm_runs, default=str)}")
    torch.cuda.empty_cache()
    trained = phase_train_full(torch, kernels)
    profile = phase_train_profile(torch)
    remat = phase_train_remat(torch)
    train_gpu_cpu = phase_train_gpu_vs_cpu(torch)
    phase_kernel_grad_refused(torch, fa, ssd)
    runs = {"full": trained, "profile": profile, "remat": remat,
            "gpu_vs_cpu": train_gpu_cpu}
    log(f"[train] runs: {json.dumps(runs, default=str)}")
    train_launches = trained["launches"]
    torch.cuda.empty_cache()
    mesh_lm = phase_mesh_lm(torch, kernels)
    train_mesh = phase_train_mesh(torch)
    log(f"[mesh] runs: {json.dumps({'lm': mesh_lm, 'train': train_mesh}, default=str)}")
    dry = phase_dryrun(torch, serve, trained, served, device)
    log(f"[dryrun] runs: {json.dumps(dry, default=str)}")
    mesh_launches = {
        k.source.stem: {key: [n[k.source.stem] for n in run["mesh_launches"]]
                        for key, run in mesh_lm["runs"].items()
                        if key != "mixtral/cf8.0"}
        for k in (fa.KERNEL, ssd.KERNEL)}

    fc1 = timing["segment"][EQ4_K.index(2_097_152)]
    fed = timing["fedavg"]
    eq4c = timing["eq4_capacity"]
    kernels = [
        {"name": "segment_reduce", "route": "cuda",
         "train_launches": train_launches["segment_reduce"],
         "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
         "replaces": "src/repro/kernels/segment_reduce.py:212",
         "launches": launches["segment_reduce"],
         "robust_launches": robust["segment_reduce"],
         "marl_launches": marl["launches"],
         "marl_options_launches": marl["options_launches"],
         "marl_hook_launches": hook["segment_reduce"],
         "scenario_launches": {k: v["launches"] for k, v in scen.items()},
         "serve_launches": stream["launches"],
         "serve_policy_launches": stream["policy_launches"],
         "serve_cli_launches": cli["launches"],
         "sharded_launches": sharded["launches"],
         "sharded_one_rank_launches": sharded["one_rank_launches"],
         "sharded_all_reduce": sharded["all_reduce"],
         "sharded_cli": sharded["cli"],
         "sharded_tol_ratio": sharded["tol_ratio"],
         "sharded_actor_max_abs_diff": sharded["actor_max_abs_diff"],
         "max_abs_err": seg_err, "grad_max_abs_err": grad_err,
         "marl_actor_grad_gpu_vs_cpu": marl_grad_gap,
         "ms": fc1["ms"], "plain_ms": fc1["plain_ms"],
         "bound_ms": fc1["bound_ms"], "bound_by": fc1["bound_by"],
         "library_ms": fc1["library_ms"], "call_ms": fc1["call_ms"],
         "shape": {"N": fc1["N"], "K": fc1["K"], "M": fc1["M"]},
         "eq4_capacity": {"shape": {"N": eq4c["N"], "K": eq4c["K"],
                                    "M": eq4c["M"]},
                          "ms": eq4c["ms"], "plain_ms": eq4c["plain_ms"],
                          "bound_ms": eq4c["bound_ms"],
                          "bound_by": eq4c["bound_by"],
                          "library_ms": eq4c["library_ms"]}},
        {"name": "fedavg_reduce", "route": "cuda",
         "train_launches": train_launches["fedavg_reduce"],
         "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
         "replaces": "src/repro/kernels/fedavg_reduce.py:19",
         "launches": launches["fedavg_reduce"],
         "robust_launches": robust["fedavg_reduce"],
         "marl_hook_launches": hook["fedavg_reduce"], "max_abs_err": fed_err,
         "ms": fed["ms"], "plain_ms": fed["plain_ms"],
         "bound_ms": fed["bound_ms"], "bound_by": fed["bound_by"],
         "library_ms": fed["library_ms"], "call_ms": fed["call_ms"],
         "shape": {"C": fed["C"], "N": fed["N"]}},
        {"name": "flash_attention", "route": "cuda",
         "train_launches": train_launches["flash_attention"],
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:32",
         "variant": "bf16_tc",
         "launches": served["launches"],
         "variant_launches": served["variant_launches"],
         "max_abs_err": flash["max_abs_err"],
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"], "call_ms": flash["call_ms"],
         "bound_fp32_ms": flash["bound_fp32_ms"], "tflops": flash["tflops"],
         "shape": {**main_call, "dtype": "bfloat16", "causal": True},
         "hd256": _shape_row(gemma), "hd128_g1": _shape_row(qwen),
         "hd128_g7": _shape_row(qwen2vl),
         "hd64_noncausal": _shape_row(seamless_enc),
         "hd64_causal": _shape_row(seamless_dec),
         "lm_launches": {
             **{arch: {k: r[k] for k in ("launches", "windows", "hd")}
                for arch, r in lm_served.items()},
             **{arch: {k: r[k] for k in ("launches", "windows")}
                for arch, r in lm_cuts.items()},
             f"{JAMBA} smoke": jamba["flash_launches"],
             f"{QWEN2VL} image layout": qwen2vl_layout["launches"],
             SEAMLESS: {k: seamless[k] for k in (
                 "encode_launches", "decode_launches",
                 "scoring_launches")}},
         "mesh_launches": mesh_launches["flash_attention"]},
        {"name": "ssd_scan", "route": "cuda",
         "train_launches": train_launches["ssd_scan"],
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:21",
         "launches": forward["launches"],
         "jamba_smoke_launches": jamba["ssd_launches"],
         "mesh_launches": mesh_launches["ssd_scan"],
         "max_abs_err": scan["max_abs_err"],
         "ms": scan["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
         "library_ms": None, "call_ms": scan["call_ms"],
         "bound_tf32_form_ms": scan["bound_tf32_form_ms"],
         "bound_fp32_ms": scan["bound_fp32_ms"],
         "bound_bf16_ms": scan["bound_bf16_ms"],
         "max_abs_err_fp32": scan["max_abs_err_fp32"],
         "parts_ms": scan["parts_ms"], "tflops": scan["tflops"],
         "shape": {**ssd_call, "dtype": "bfloat16 x, B, C; fp32 dt, A"}},
    ]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"on {device['smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

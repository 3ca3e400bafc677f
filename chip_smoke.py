#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the port's hand-written kernels from the checkout's
sources, in parallel, and drives the port's three paths:

* the DTWN federated round: the segment-reduce and FedAvg kernels are held
  against their plain PyTorch versions at the round's shapes and timed,
  three full-width rounds run through ``DTWNSystem``, and one GPU round is
  checked against the same round on the CPU;
* the LM serving path: the flash-attention kernel is held against its plain
  version on the reference tests' cases and at the prefill's shape, and
  timed there; ``repro_torch.launch.serve`` serves h2o-danube-1.8b at full
  width (random weights from a seed, 4 prompts of 4608 tokens, 32 new
  tokens each); its last-position logits are checked against the plain
  attention path on the card, and a 2-layer cut of it on the GPU against
  the CPU;
* mamba2-2.7b's scoring forward: the SSD-scan kernel is held against its
  plain version on the reference tests' cases and at the forward's shape,
  and timed there; ``build_model(cfg, use_pallas=True).forward`` runs at
  full width (random bf16 weights from a seed, 4 prompts of 4608 tokens,
  last-position logits) with one kernel launch per layer; its logits are
  checked against the plain-SSD forward on the card, a 2-layer fp32 cut on
  the GPU against the CPU, and the serving CLI steps a short SSM prompt.

Any failure raises and exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

Output: one line per check and per timing, then a ``{"kernels": [...]}``
line, then ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside the
# tensor cores (the rate of the kernels' adds and multiply-adds) and dense
# bf16 on the tensor cores (the least time of the bf16 attention's products)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# the CNN's Eq. 4 leaves (fc2_b, conv1_b, conv2_b, fc1_b, conv1_w, fc2_w,
# conv2_w, fc1_w) and the Eq. 4 weights (K=1): N=10 twins over M=5 BSs
EQ4_K = (1, 10, 32, 64, 512, 2400, 5120, 51200, 2_097_152)
CNN_PARAMS = 2_156_490
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
]
FLASH_TOL_F32, FLASH_TOL_BF16 = 2e-5, 3e-2
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
    calls = seg_rows + [seg_rows[-1]]  # the N=100 K=1 call is made twice
    log(f"[timing] segment_reduce, one round's 11 calls (the weights and 8 "
        f"leaves of Eq. 4, Eqs. 12 and 15): kernel "
        f"{sum(r['ms'] for r in calls):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in calls):.4f} ms")
    return {"segment": seg_rows, "fedavg": fed}


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
    """Kernel vs plain version on the reference tests' six cases, in fp32
    at their tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for case in FLASH_CASES:
        *shape, causal, window, cap = case
        q, k, v = _flash_inputs(torch, gen, *shape, torch.float32)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        out = fa.flash_attention(q, k, v, **kw)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        torch.testing.assert_close(out, plain, rtol=FLASH_TOL_F32,
                                   atol=FLASH_TOL_F32)
        log(f"[flash] fp32 {case}: max_abs_err={err:.3e}")
    log(f"[flash] ok: fp32 cases within {FLASH_TOL_F32} of the plain version")


def phase_flash_main(torch, fa, m) -> dict:
    """The prefill's attention call ``m`` in bf16: the kernel held against
    its plain version, then kernel, plain and library times, on the same
    inputs. q is drawn with std 4, so the scores have std 4 and the softmax
    is peaked: outputs of order 1, where bf16's rounding shows. The row's
    ``max_abs_err`` is the kernel's largest absolute error there."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _flash_inputs(torch, gen, m["B"], m["S"], m["S"], m["Hq"],
                            m["Hkv"], m["hd"], torch.bfloat16, q_std=4.0)
    out = fa.flash_attention(q, k, v, window=m["window"])
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
    log(f"[timing] flash_attention: band {pairs} (q, k) pairs, {n_ops:.4e} "
        f"ops, {n_bytes} bytes; bound {row['bound_ms']:.4f} ms at the bf16 "
        f"tensor-core peak, {row['bound_fp32_ms']:.4f} ms at the fp32 peak; "
        f"kernel at {n_ops / row['ms'] / 1e9:.2f} TFLOP/s")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return row


def _reset(kernels) -> None:
    for k in kernels:
        k.launches = 0


def phase_serve(torch, kernels, serve) -> dict:
    """The serving CLI at full width, with every count set to 0 just
    before and read just after."""
    argv = ["--arch", serve.ARCH, "--full", "--batch", str(serve.BATCH),
            "--prompt-len", str(serve.PROMPT_LEN), "--gen", str(serve.GEN)]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    _reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(argv)
    launches = {k.source.stem: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_layers = res["cfg"].n_layers
    log(f"[serve] kernel launches in the serving run: {json.dumps(launches)}; "
        f"peak device memory {peak:.2f} GiB")
    if launches["flash_attention"] != n_layers or res["flash_launches"] != n_layers:
        raise AssertionError(f"the prefill launched the flash kernel "
                             f"{res['flash_launches']} times "
                             f"({launches['flash_attention']} in the run), "
                             f"not once per layer ({n_layers})")
    tokens, logits = res["tokens"], res["logits"]
    if tuple(tokens.shape) != (serve.BATCH, serve.GEN):
        raise AssertionError(f"generated {tuple(tokens.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("the served logits are not finite")
    if int(tokens.min()) < 0 or int(tokens.max()) >= res["cfg"].vocab_size:
        raise AssertionError("a generated token is outside the vocabulary")
    if not torch.equal(logits[..., :res["cfg"].vocab_size].argmax(-1), tokens):
        raise AssertionError("a generated token is not its logits' argmax")
    log(f"[serve] ok: {serve.BATCH} x {serve.GEN} tokens, finite logits; "
        f"prefill {res['prefill_ms']:.1f} ms, decode "
        f"{res['decode_s'] * 1e3:.1f} ms for {serve.GEN - 1} steps ({res['decode_tok_s']:.1f} tok/s)")
    return {"launches": launches["flash_attention"],
            "prefill_ms": res["prefill_ms"], "decode_s": res["decode_s"],
            "decode_tok_s": res["decode_tok_s"], "peak_gib": peak}


def phase_serve_kernel_vs_plain(torch, serve) -> None:
    """The first served prompt at B=1 through the flash kernel and through
    the plain attention path (``use_pallas=False``: the chunked version),
    both on the card, with the same weights; last-position logits.

    * bf16, the served model: each path rounds its attention outputs to
      bf16 once, from fp32 sums taken in another order, so a few outputs a
      layer differ by one bf16 ulp (2^-8 relative), and 24 layers of random
      weights carry that into the logits. Held to 5% of the logits' largest
      magnitude (the first chip run measured 1.5%).
    * fp32 weights from the same draws: the paths differ only in the order
      of fp32 sums. Held to 1e-3 of the largest magnitude.
    """
    from repro_torch.configs import get_arch_config
    from repro_torch.models import build_model

    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-3)):
        cfg = dataclasses.replace(get_arch_config(serve.ARCH),
                                  param_dtype=dtype)
        with torch.inference_mode():
            model, params = serve.random_model(cfg, serve.SEED, "cuda")
            prompt = serve.random_prompts(cfg, serve.BATCH, serve.PROMPT_LEN,
                                          serve.SEED, "cuda")[:1]
            got, _ = model.forward(params, {"tokens": prompt}, last_only=True)
            plain, _ = build_model(cfg, use_pallas=False).forward(
                params, {"tokens": prompt}, last_only=True)
        got, plain = got[0, -1, :cfg.vocab_size], plain[0, -1, :cfg.vocab_size]
        err = float((got - plain).abs().max())
        scale = float(plain.abs().max())
        top = torch.topk(plain, 2).values
        log(f"[serve] {dtype} B=1 last-position logits, flash kernel vs plain "
            f"path: max_abs_diff {err:.4e}, max |logit| {scale:.4f}, relative "
            f"{err / scale:.3e} (held to {tol}); argmax {int(got.argmax())} vs "
            f"{int(plain.argmax())} (plain top-2 gap "
            f"{float(top[0] - top[1]):.4e})")
        if not err <= tol * scale:
            raise AssertionError(f"{dtype}: kernel and plain paths differ by "
                                 f"{err} > {tol} of max |logit| {scale}")
        del model, params
        torch.cuda.empty_cache()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


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


def _ssd_inputs(torch, gen, B, S, H, P, N, *, as_forward=False):
    """x, dt, A, Bm, Cm on the card. By default as the reference tests draw
    them (x, B, C normal, dt = softplus of a normal, A = -exp of a normal);
    ``as_forward``: as ``mamba_forward`` makes them, x, B and C out of a
    SiLU, dt = softplus(normal + dt_bias 0), A = -exp(log(linspace(1, 16,
    H))), the init's decay rates."""
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
    return x, F.softplus(draw(B, S, H)), A, bm, cm


def _ssd_close(torch, out, plain, label) -> float:
    err = float((out - plain).abs().max())
    torch.testing.assert_close(out, plain, rtol=SSD_RTOL, atol=SSD_ATOL)
    log(f"[ssd] {label}: max_abs_err={err:.3e}, max |y| "
        f"{float(plain.abs().max()):.3f}")
    return err


def phase_ssd_check(torch, ssd) -> None:
    """Kernel vs plain version on the reference tests' four cases, at
    their tolerance, and bitwise repeatable."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for case in SSD_CASES:
        *shape, chunk = case
        args = _ssd_inputs(torch, gen, *shape)
        out = ssd.ssd_scan(*args, chunk=chunk)
        again = ssd.ssd_scan(*args, chunk=chunk)
        plain = ssd.ssd_scan_plain(*args, chunk)
        torch.cuda.synchronize()
        _ssd_close(torch, out, plain, f"{case}")
        if not torch.equal(out, again):
            raise AssertionError(f"SSD kernel not bitwise repeatable at {case}")
    log(f"[ssd] ok: cases within atol {SSD_ATOL} / rtol {SSD_RTOL} of the "
        f"plain version, bitwise repeatable")


def ssd_main(serve) -> dict:
    """The forward's SSD call, one per layer: (B, S, H, P, N, chunk)."""
    from repro_torch.configs import get_arch_config

    cfg = get_arch_config(serve.SSM_ARCH)
    return dict(B=serve.BATCH, S=serve.PROMPT_LEN, H=cfg.ssm_heads,
                P=cfg.ssm_head_dim, N=cfg.ssm_state, chunk=cfg.ssm_chunk)


def phase_ssd_main(torch, ssd, m) -> dict:
    """The forward's SSD call ``m``, on inputs drawn as the forward makes
    them: the kernel held against its plain version, then kernel and plain
    times on the same inputs. No single PyTorch call computes the scan, so
    there is no library time."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = [m[k] for k in ("B", "S", "H", "P", "N")]
    args = _ssd_inputs(torch, gen, *shape, as_forward=True)
    out = ssd.ssd_scan(*args, chunk=m["chunk"])
    plain = ssd.ssd_scan_plain(*args, m["chunk"])
    torch.cuda.synchronize()
    err = _ssd_close(torch, out, plain, f"forward shape {m}")
    del out, plain
    torch.cuda.empty_cache()
    n_ops = ssd.ssd_flops(*shape, m["chunk"])
    n_bytes = sum(t.numel() * t.element_size() for t in args) + \
        args[0].numel() * 4  # y, written once
    row = _timed(torch, "ssd_scan " + " ".join(f"{k}={v}" for k, v in
                                                m.items()),
                 lambda *a: ssd.ssd_scan(*a, chunk=m["chunk"]),
                 lambda *a: ssd.ssd_scan_plain(*a, m["chunk"]),
                 None, [args], n_bytes, n_ops, batch=4, reps=3)
    row["bound_bf16_ms"] = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)[0]
    row.update(ops=n_ops, bytes=n_bytes, max_abs_err=err)
    log(f"[timing] ssd_scan: {n_ops:.4e} ops, {n_bytes} bytes; bound "
        f"{row['bound_ms']:.4f} ms at the fp32 peak ({row['bound_by']}), "
        f"{row['bound_bf16_ms']:.4f} ms at the bf16 tensor-core peak; "
        f"kernel at {n_ops / row['ms'] / 1e9:.2f} TFLOP/s")
    del args
    torch.cuda.empty_cache()
    return row


def _last_logits_close(torch, got, plain, tol, label) -> None:
    got, plain = got[..., -1, :].float(), plain[..., -1, :].float()
    err = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    same = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"[mamba] {label}: last-position logits max_abs_diff {err:.4e}, max "
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
    tokens, logits = res["tokens"], res["logits"]
    if tuple(tokens.shape) != (B, G) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"generated {tuple(tokens.shape)}, or logits "
                             f"not finite")
    if not torch.equal(logits[..., :res["cfg"].vocab_size].argmax(-1), tokens):
        raise AssertionError("a generated token is not its logits' argmax")
    log(f"[ssm_serve] ok: {B} x {G} tokens, finite logits; prefill "
        f"{res['prefill_ms']:.1f} ms ({P} steps), decode "
        f"{res['decode_tok_s']:.1f} tok/s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
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
    fed_err = phase_fedavg_check(torch, fr)
    phase_flash_check(torch, fa)
    main_call = flash_main(serve)
    flash = phase_flash_main(torch, fa, main_call)
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
    del data
    served = phase_serve(torch, kernels, serve)
    phase_serve_kernel_vs_plain(torch, serve)
    phase_serve_gpu_vs_cpu(torch, fa, serve)
    forward = phase_mamba_forward(torch, kernels, serve)
    phase_mamba_gpu_vs_cpu(torch, ssd, serve)
    phase_ssm_serve(torch, kernels, serve)

    fc1 = timing["segment"][EQ4_K.index(2_097_152)]
    fed = timing["fedavg"]
    kernels = [
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
         "replaces": "src/repro/kernels/segment_reduce.py:212",
         "launches": launches["segment_reduce"], "max_abs_err": seg_err,
         "ms": fc1["ms"], "plain_ms": fc1["plain_ms"],
         "bound_ms": fc1["bound_ms"], "bound_by": fc1["bound_by"],
         "library_ms": fc1["library_ms"], "call_ms": fc1["call_ms"],
         "shape": {"N": fc1["N"], "K": fc1["K"], "M": fc1["M"]}},
        {"name": "fedavg_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
         "replaces": "src/repro/kernels/fedavg_reduce.py:19",
         "launches": launches["fedavg_reduce"], "max_abs_err": fed_err,
         "ms": fed["ms"], "plain_ms": fed["plain_ms"],
         "bound_ms": fed["bound_ms"], "bound_by": fed["bound_by"],
         "library_ms": fed["library_ms"], "call_ms": fed["call_ms"],
         "shape": {"C": fed["C"], "N": fed["N"]}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:32",
         "launches": served["launches"], "max_abs_err": flash["max_abs_err"],
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"], "call_ms": flash["call_ms"],
         "bound_fp32_ms": flash["bound_fp32_ms"],
         "shape": {**main_call, "dtype": "bfloat16", "causal": True}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:21",
         "launches": forward["launches"], "max_abs_err": scan["max_abs_err"],
         "ms": scan["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
         "library_ms": None, "call_ms": scan["call_ms"],
         "bound_bf16_ms": scan["bound_bf16_ms"],
         "shape": {**ssd_call, "dtype": "float32"}},
    ]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"on {device['smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

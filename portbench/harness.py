"""One run of one cell: set-up, the measured window, the check, the result.

Set-up draws the weights and every prompt of the run from ``--seed`` on the
card, builds the program's model and serves warm-up requests of the cell's
own shape (the first run in a checkout builds the port's kernels with nvcc
into ``build/kernels/``; later runs load them). The window then drives the
cell's entry back to back, one request in flight, for ``--seconds``: a
request's latency runs from its dispatch until its result is on the host.
With ``--trace 1`` the window runs under ``torch.profiler`` and the result
holds the per-layer metrics instead of the end-to-end ones.

Once the window has closed and the memory peak is read, the program is
freed and a sample of the window's requests is compared with the
configuration's fp32 reference (:mod:`portbench.check`): the request kind's
``SAMPLE`` requests, drawn from the seed: one of the window's first
``EARLY``, the rest uniform over the window (a reservoir, since the window
is timed), and its last.
"""
from __future__ import annotations

import contextlib
import random
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from portbench import (check, counts, program, seeds, spec, trace, traffic,
                       weights)
from portbench.reference.common import strict_fp32

WARMUP = 2  # requests of the cell's shape served before the window
EARLY = 4  # the sample holds one of the window's first EARLY requests
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def card(device) -> dict:
    """The card's name and power limit (``nvidia-smi``), or the CPU's."""
    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": "not read"}
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        limit = out.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return {"kind": name, "power_limit": limit}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def leaked_modules() -> list:
    """Top-level module names of the JAX side that this process holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Sample:
    """The records of the requests the check compares, ``size`` of them,
    drawn from ``seed``: one of the first ``EARLY`` requests, a reservoir
    of ``size - 2`` uniform over the rest, and the last one offered."""

    def __init__(self, size: int, seed: int):
        self.rng = random.Random(seeds.sub(seed, "sample"))
        self.early = self.rng.randrange(EARLY)
        self.room = max(size - 2, 0)
        self.seen = 0
        self.pool: list = []  # the reservoir: (index, record)
        self.first = self.last = None

    def offer(self, i: int, rec: dict) -> None:
        self.last = (i, rec)
        if i == self.early:
            self.first = (i, rec)
            return
        self.seen += 1
        if len(self.pool) < self.room:
            self.pool.append((i, rec))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.room:
                self.pool[j] = (i, rec)

    def records(self) -> dict:
        """Index -> record of the sample (none before any request)."""
        out = dict(self.pool)
        for item in (self.first, self.last):
            if item is not None:
                out[item[0]] = item[1]
        return out


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float, sizes: dict | None = None, control: bool = False) -> dict:
    """The result of one run (the last line's object, ``check`` last).
    ``sizes`` replaces the configuration's (the CPU tests' small models);
    ``control`` puts the fp8 reference in the program's place for the
    check (a reading for the limits, never a benchmark run)."""
    device = torch.device(device)
    strict_fp32()
    config, traf = cell.config, cell.traffic
    traffic.validate(traf)
    s = sizes if sizes is not None else config["sizes"]
    kind = spec.kind(traf["kind"], cell.root)
    ref = check.reference(config)
    work = counts.request_work(ref, kind, s, traf)
    flops = counts.flops(work)
    model, _ = program.build(config, sizes)
    params, count = weights.make(ref.param_spec(s), seed, device)
    if sizes is None and count != config["parameters"]:
        raise ValueError(f"{config['name']}: drew {count} parameters, the "
                         f"configuration states {config['parameters']}")
    least = counts.least_seconds(flops["total"], 0)
    n = traffic.n_drawn(seconds, least, WARMUP)
    prompts = traffic.draw(traf, s, seed, n, device)
    n_window = n - WARMUP
    sample = Sample(kind.SAMPLE, seed)
    entry = kind.Entry(model, params)
    info = card(device)

    lat = []
    failed, attempted = 0, 0
    red = None
    launches = {}
    with torch.inference_mode():
        for w in range(WARMUP):
            entry(prompts[n_window + w])
        sync(device)
        setup_s = time.time() - t0
        before = program.launch_counters()
        prof = trace.profiled(device) if traced else contextlib.nullcontext()
        with prof as holder:
            with torch.profiler.record_function(trace.WINDOW):
                start = time.perf_counter()
                while time.perf_counter() - start < seconds:
                    i = attempted
                    attempted += 1
                    t_d = time.perf_counter()
                    try:
                        with torch.profiler.record_function(trace.REQUEST):
                            rec = entry(prompts[i % n_window])
                    except RuntimeError:
                        failed += 1
                        traceback.print_exc()
                        break
                    lat.append(time.perf_counter() - t_d)
                    sample.offer(i, rec)
                    del rec
                window_s = time.perf_counter() - start
        after = program.launch_counters()
        launches = {k: after[k] - before[k] for k in after}
        if traced:
            red = trace.reduce(holder.events)
    done = len(lat)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    kept = sample.records()
    del sample, entry, model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window, outside set-up
    t_check = time.perf_counter()
    readings = []
    with torch.inference_mode():
        for i in sorted(kept):
            p = prompts[i % n_window]
            rec = kind.control_record(ref, s, params, p) if control \
                else kept[i]
            readings.append(kind.numbers(ref, s, params, p, rec))
            kept[i] = rec = None
    found = check.worst(readings)
    correct, compared = check.judge(found, cell.limits)
    correct = correct and failed == 0 and done > 0
    check_s = time.perf_counter() - t_check

    B, P = traf["batch"], traf["prompt_len"]
    if traced:
        ctx = {"trace": red, "flops": flops,
               "least_s": counts.least_by_part(work),
               "sizes": s, "traffic": traf, "launches": launches}
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"], cell.root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        known = {
            "tokens_per_s": done * B * P / window_s,
            "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3
            if lat else None,
            "mfu": 100 * done * flops["total"] / window_s
            / counts.PEAK_BF16_FLOPS,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": known[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if known[m["name"]] is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": info["kind"], "count": 1, "memory_peak_bytes": peak,
           "power_limit": info["power_limit"]}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and red is not None:
        dev["busy_s"], dev["window_s"] = red["busy_s"], red["window_s"]
        out["breakdown"] = trace.breakdown(red)
    out["info"] = {"requests": done, "window_s": window_s,
                   "sample": sorted(kept), "check_s": check_s,
                   "launches": launches, "flops_per_request": flops["total"],
                   "control": control,
                   "latency_ms": [round(x * 1e3, 3) for x in lat]}
    out["check"] = compared
    return out

"""Where the time of one DTWN federated round goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_round

Builds the round that ``chip_smoke.py`` drives (``FLConfig()`` defaults with
``use_kernel_aggregation=True``, ``fl.example_association`` and
``fl.EXAMPLE_PARTICIPATING_USERS`` participating twins, cifar10-sim
50k/10k), warms it up with ``WARMUP_ROUNDS`` rounds, and then reports:

1. the round's wall time (association and ``run_round``, as ``chip_smoke.py``
   times it) and its split over the round's steps, each step timed on the
   host between ``torch.cuda.synchronize()`` calls (so the steps do not
   overlap; this pass is slower than an unsynchronized round). It raises if
   a step it wraps was never called, so a renamed step cannot fall silently
   into "rest";
2. a ``torch.profiler`` trace of one unsynchronized round: wall time, device
   busy time (the union of kernel and copy intervals), the idle share, and
   the ``TOP_KERNELS`` largest items of device time. When the profiler
   records no device events, the device numbers are printed as "not
   measured".

Needs a CUDA device; prints nothing it did not measure.
"""
from __future__ import annotations

import collections
import importlib
import subprocess
import time

import torch

from repro_torch.core import hierarchy, latency
from repro_torch.data import cifar10
from repro_torch.fl import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                            FLConfig, example_association)

WARMUP_ROUNDS = 2
TOP_KERNELS = 15


class _StepClock:
    """Synchronized host timers around the round's steps, keyed by step."""

    def __init__(self):
        self.ms = collections.defaultdict(float)
        self.names = set()  # every step wrapped

    def wrap(self, name, fn):
        self.names.add(name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return timed


def step_split(system) -> None:
    clock = _StepClock()
    patches = [(hierarchy, "bs_aggregate_stacked", "Eq. 4 aggregation"),
               (hierarchy, "fedavg_flat_kernel", "Eq. 3 global model"),
               (latency, "round_time", "latency bill (Eqs. 12-17)")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    trainer = system.trainer
    chain_methods = ("submit_model", "verify_round", "produce_block",
                     "validate_chain")
    for mod, attr, name in patches:
        setattr(mod, attr, clock.wrap(name, getattr(mod, attr)))
    system.trainer = clock.wrap("local training", trainer)
    system.holdout_loss = clock.wrap("holdout losses", system.holdout_loss)
    for attr in chain_methods:
        setattr(system.chain, attr, clock.wrap(
            "chain (hashes, verify, audit)", getattr(system.chain, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assoc = clock.wrap("greedy association", example_association)(system)
        system.run_round(assoc,
                         participating_users=EXAMPLE_PARTICIPATING_USERS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:  # the wrappers shadow the originals; drop them
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        system.trainer = trainer
        del system.holdout_loss
        for attr in chain_methods:
            delattr(system.chain, attr)
    missing = sorted(clock.names - clock.ms.keys())
    if missing:
        raise RuntimeError(f"round steps never called through their "
                           f"wrappers (renamed?): {missing}")
    print(f"[split] synchronized round: {wall:.1f} ms")
    for name, ms in sorted(clock.ms.items(), key=lambda kv: -kv[1]):
        print(f"[split]   {name}: {ms:.1f} ms ({100 * ms / wall:.1f}%)")
    rest = wall - sum(clock.ms.values())
    print(f"[split]   rest (sampling, stacking, host glue): {rest:.1f} ms "
          f"({100 * rest / wall:.1f}%)")


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profiled(fn, tag: str = "profile") -> dict:
    """Run ``fn()`` once under ``torch.profiler`` after a synchronize, and
    print its wall time, device busy time (the union of kernel and copy
    intervals), idle share and ``TOP_KERNELS`` largest items of device time.
    Returns ``{kernel name: [device ms, count]}`` (empty when the profiler
    recorded no device events: the device numbers are then printed as "not
    measured")."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"[{tag}] wall {wall_ms:.1f} ms (profiler on)")
    if not dev_events:
        print(f"[{tag}] device time: not measured (no device events)")
        return {}
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in dev_events) / 1e3
    span_ms = (max(e.time_range.end for e in dev_events)
               - min(e.time_range.start for e in dev_events)) / 1e3
    print(f"[{tag}] device busy {busy_ms:.2f} ms over a {span_ms:.1f} ms "
          f"device span; idle share of the wall time "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; {len(dev_events)} device "
          f"events")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
        print(f"[{tag}]   {ms:8.3f} ms {count:5d}x  {name[:100]}")
    return dict(by_name)


def profiled_round(system) -> None:
    profiled(lambda: system.run_round(
        example_association(system),
        participating_users=EXAMPLE_PARTICIPATING_USERS))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = cifar10.load()
    system = DTWNSystem(FLConfig(use_kernel_aggregation=True), data, seed=0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"[setup] {smi}; tf32 off; "
          f"{data[2]} {data[0][0].shape[0]}/{data[1][0].shape[0]}")
    for _ in range(WARMUP_ROUNDS):
        system.run_round(example_association(system),
                         participating_users=EXAMPLE_PARTICIPATING_USERS)
    torch.cuda.synchronize()
    step_split(system)
    profiled_round(system)
    sr = importlib.import_module("repro_torch.kernels.segment_reduce")
    fr = importlib.import_module("repro_torch.kernels.fedavg_reduce")
    print(f"[kernels] launches since start: segment_reduce "
          f"{sr.KERNEL.launches}, fedavg_reduce {fr.KERNEL.launches}")


if __name__ == "__main__":
    main()

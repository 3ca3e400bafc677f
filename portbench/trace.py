"""The traced run's reduction: ``torch.profiler``'s device operations and
host spans over the measured window, turned into device time by kernel,
busy and idle time, and the host activity behind each idle gap.

The window is the harness's ``portbench.window`` span. Device operations
(kernels, copies, fills) are clipped to it; ``busy_s`` is the length of
their union, ``window_s`` the span's.
"""
from __future__ import annotations

import bisect
import collections
import contextlib

import torch

SPAN = "portbench."  # the harness's host spans
WINDOW = SPAN + "window"
REQUEST = SPAN + "request"
TOP = 10
IDLE_HOST = "host outside any traced operation"


@contextlib.contextmanager
def profiled(device: torch.device):
    """A ``torch.profiler`` run over the block; yields a holder whose
    ``events`` are filled on exit: ``(device, cpu)`` lists of ``(name,
    start_ns, end_ns)``, the host's from the thread that opened the
    window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    holder = type("Trace", (), {"events": None})()
    with torch.profiler.profile(activities=acts, record_shapes=False,
                                with_stack=False, profile_memory=False) as prof:
        yield holder
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (e.name(), start, start + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not item[0].startswith(SPAN):  # the spans' device-side copies
                dev.append(item)
        else:
            cpu.append((*item, e.start_thread_id()))
    main = [t for n, _, _, t in cpu if n == WINDOW]
    holder.events = (dev, [(n, s, e) for n, s, e, t in cpu
                           if main and t == main[0]])


def union_length(spans) -> int:
    """Total length of the union of ``(start, end)`` spans."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(spans, lo: int, hi: int):
    """The idle ``(start, end)`` intervals of [lo, hi] that no span
    covers."""
    out, at = [], lo
    for s, e in sorted(spans):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _label(stack) -> str:
    inner = stack[-1][0]
    outer = next((n for n, _ in reversed(stack) if n.startswith(SPAN)),
                 None)
    return inner if outer in (None, inner) else f"{outer} > {inner}"


def host_timeline(cpu):
    """The host thread's nested spans flattened into ``(starts, labels)``:
    from ``starts[i]`` on, the host was in ``labels[i]``, the innermost
    harness span and the innermost operation, ``"outer > inner"``."""
    starts, labels, stack = [], [], []

    def mark(t):
        starts.append(t)
        labels.append(_label(stack) if stack else IDLE_HOST)

    for n, s, e in sorted(cpu, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            end = stack.pop()[1]
            mark(end)
        stack.append((n, e))
        mark(s)
    while stack:
        end = stack.pop()[1]
        mark(end)
    return starts, labels


def host_activity(timeline, t: int) -> str:
    """What the host was doing at ``t`` (:func:`host_timeline`)."""
    starts, labels = timeline
    i = bisect.bisect_right(starts, t) - 1
    return labels[i] if i >= 0 else IDLE_HOST


def reduce(events) -> dict | None:
    """``window_s``, ``busy_s``, ``by_name`` (device seconds by operation
    name), ``idle_by_host`` (idle seconds by host activity) and
    ``requests`` (requests whose span ended inside the window), or None
    without a window span."""
    dev, cpu = events
    win = [(s, e) for n, s, e in cpu if n == WINDOW]
    if not win:
        return None
    lo, hi = win[0]
    clipped = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
               if e > lo and s < hi]
    by_name = collections.Counter()
    for n, s, e in clipped:
        by_name[n] += (e - s) * 1e-9
    spans = [(s, e) for _, s, e in clipped]
    idle = collections.Counter()
    timeline = host_timeline(cpu)
    for s, e in gaps(spans, lo, hi):
        idle[host_activity(timeline, (s + e) // 2)] += (e - s) * 1e-9
    requests = sum(1 for n, s, e in cpu if n == REQUEST and lo <= e <= hi)
    return {"window_s": (hi - lo) * 1e-9, "busy_s": union_length(spans) * 1e-9,
            "by_name": dict(by_name), "idle_by_host": dict(idle),
            "requests": requests}


def breakdown(red: dict) -> dict:
    """The result line's ``breakdown``: the ``TOP`` device operations that
    took most time, and the idle time by what the host was doing."""
    top = collections.Counter(red["by_name"]).most_common(TOP)
    idle = collections.Counter(red["idle_by_host"]).most_common(TOP)
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}

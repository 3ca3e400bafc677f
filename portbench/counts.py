"""The benchmark's own yardstick: the card's peaks, and the work a request
needs, counted from the configuration's sizes and the traffic's shapes.

Each configuration's reference module (``reference/<name>.py``) counts its
own architecture (``work``): a request's FLOPs by part, and the bytes of
each part that a kernel's roofline is read against. It refuses sizes it
does not know, so a new architecture brings its count with its reference.
Here are what every count shares: the peaks, the causal window's pairs and
a part's least time, max(FLOPs / bf16 peak, bytes / HBM bandwidth).
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense rates without sparsity, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BF16, F32_BYTES = 2, 4


def band_pairs(seq: int, window: int) -> int:
    """The (query, key) pairs a causal mask with a sliding ``window`` (0:
    none) allows in one sequence: sum over i of min(i + 1, window)."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def least_seconds(flops: float, nbytes: float) -> float:
    """The card's least time for the work: max of its compute and its
    memory term."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def request_work(ref, kind, sizes: dict, traffic: dict) -> dict:
    """One request's work by part (``ref.work``): the traffic's batch and
    prompt length, the LM head at the positions the request ``kind``
    computes. Raises for sizes the reference does not know."""
    S = traffic["prompt_len"]
    return ref.work(sizes, traffic["batch"], S, kind.head_positions(S))


def flops(work: dict) -> dict:
    """FLOPs by part, and their ``total``."""
    out = {part: w["flops"] for part, w in work.items()}
    out["total"] = sum(out.values())
    return out


def least_by_part(work: dict) -> dict:
    """The least time of each part whose bytes are counted."""
    return {part: least_seconds(w["flops"], w["bytes"])
            for part, w in work.items() if "bytes" in w}

"""Sub-seeds of a run's ``--seed``, one per stream (weights, prompts,
sample), so that the streams never share a generator."""
from __future__ import annotations

import hashlib


def sub(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` under ``seed`` (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1

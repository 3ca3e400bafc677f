"""Carry a system's initial state into the port.

torch cannot repeat ``jax.random`` draws, so a port system that must start
where a reference system starts takes that system's state as arrays:
``{k: np.asarray(v)}`` of its CNN params, and its BS distances and up/down
channel gains. The CNN keeps the reference's layout, so nothing is
transposed.
"""
from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(params_np, dist, h_up, h_down, device) -> dict:
    """Arrays -> the ``init_state`` dict ``DTWNSystem`` takes, as fp32
    tensors on ``device``: ``{"params", "dist", "h_up", "h_down"}``."""
    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"params": {k: put(v) for k, v in params_np.items()},
            "dist": put(dist), "h_up": put(h_up), "h_down": put(h_down)}

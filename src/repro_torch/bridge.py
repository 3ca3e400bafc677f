"""Carry a reference system's initial state or model weights into the port.

torch cannot repeat ``jax.random`` draws, so a port system that must start
where a reference system starts takes that system's state as arrays:
``{k: np.asarray(v)}`` of its CNN params, and its BS distances and up/down
channel gains; an LM takes the reference's parameter tree, leaf by leaf as
numpy. Both models keep the reference's layout, so nothing is transposed.
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


def lm_params_from_numpy(tree, device, dtype=None):
    """A reference LM parameter tree, its leaves converted to numpy (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``), -> the port's parameter
    dict with the same keys and shapes, on ``device``.

    ``np.asarray`` of a bf16 array gives an ``ml_dtypes.bfloat16`` array,
    which ``torch.from_numpy`` refuses; every leaf goes through float32,
    which holds bf16 exactly, and is then cast to ``dtype`` (default: the
    leaf's own dtype when it is float32, else bfloat16).
    """
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    want = dtype or (torch.float32 if a.dtype == np.float32 else torch.bfloat16)
    return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=want)

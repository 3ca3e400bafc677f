"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` names
    another one.

    Raises ``RuntimeError`` when CUDA is asked for, explicitly or by
    default, and no card is present: the port never carries on silently on
    the CPU. Pass ``device="cpu"`` to run there on purpose.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev

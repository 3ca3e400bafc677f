"""Device selection for the port's entry points, and the deterministic
cuDNN context of local training."""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms for the enclosed code.
    With TF32 off, cuDNN's default convolution backward algorithms on the
    H100 do not repeat bit for bit (ROADMAP C1b); under this context a
    round of local training gives the same bits on every run."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev

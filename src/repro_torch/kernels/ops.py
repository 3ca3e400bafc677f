"""Public entry to the port's FedAvg kernel (port of
``repro/kernels/ops.py``).

The reference jits its Pallas wrappers here; PyTorch runs eagerly, so the
entry is the kernel wrapper itself. ``flash_attention`` and ``ssd_scan``
wait for ROADMAP B3/B4; the segment reduction is reached through
``repro_torch.kernels.segment_reduce``.
"""
from repro_torch.kernels.fedavg_reduce import fedavg_reduce

__all__ = ["fedavg_reduce"]

"""Public entries to the port's kernels (port of ``repro/kernels/ops.py``).

The reference jits its Pallas wrappers here; PyTorch runs eagerly, so each
entry is the kernel wrapper itself. ``ssd_scan`` waits for ROADMAP B4; the
segment reduction is reached through ``repro_torch.kernels.segment_reduce``.
"""
from repro_torch.kernels.fedavg_reduce import fedavg_reduce
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["fedavg_reduce", "flash_attention"]

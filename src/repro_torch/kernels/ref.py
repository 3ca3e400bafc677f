"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``). The SSD-scan reference comes with ROADMAP B4."""
from repro_torch.kernels.fedavg_reduce import \
    fedavg_reduce_plain as fedavg_reduce_ref
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as flash_attention_ref

__all__ = ["fedavg_reduce_ref", "flash_attention_ref"]

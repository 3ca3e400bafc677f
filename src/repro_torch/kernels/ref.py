"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``). The flash-attention and SSD-scan references come
with ROADMAP B3/B4."""
from repro_torch.kernels.fedavg_reduce import \
    fedavg_reduce_plain as fedavg_reduce_ref

__all__ = ["fedavg_reduce_ref"]

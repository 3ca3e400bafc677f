"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``)."""
from repro_torch.kernels.fedavg_reduce import \
    fedavg_reduce_plain as fedavg_reduce_ref
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as flash_attention_ref
from repro_torch.kernels.ssd_scan import ssd_scan_plain


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int = 128):
    return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)


__all__ = ["fedavg_reduce_ref", "flash_attention_ref", "ssd_scan_ref"]

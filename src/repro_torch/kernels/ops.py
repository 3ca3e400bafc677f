"""Public entries to the port's kernels (port of ``repro/kernels/ops.py``).

The reference jits its Pallas wrappers here; PyTorch runs eagerly, so each
entry is the kernel wrapper itself. On an LM mesh the flash and SSD entries
take DTensors: each rank's launch sees its own batch rows and heads
(``sharding.act.on_local_shards``), as a Pallas call sees one shard. The
segment reduction is reached through ``repro_torch.kernels.segment_reduce``.
"""
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.fedavg_reduce import fedavg_reduce
from repro_torch.sharding.act import on_local_shards

__all__ = ["fedavg_reduce", "flash_attention", "ssd_scan"]

_BH = {"b": 0, "h": 2}
_BG = {"b": 0, "g": 2}  # grouped-query key/value heads


def flash_attention(q, k, v, **kw):
    """:func:`repro_torch.kernels.flash_attention.flash_attention`; DTensor
    q, k, v run on each rank's (batch, heads) block."""
    return on_local_shards(_flash.flash_attention, (q, k, v),
                           (_BH, _BG, _BG), _BH, **kw)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """:func:`repro_torch.kernels.ssd_scan.ssd_scan`; DTensor inputs run on
    each rank's (batch, heads) block of x and dt, its heads of A and its
    batch rows of Bm and Cm."""
    return on_local_shards(_ssd.ssd_scan, (x, dt, A, Bm, Cm),
                           (_BH, _BH, {"h": 0}, {"b": 0}, {"b": 0}), _BH,
                           chunk=chunk)

"""Mamba-2 SSD chunked scan (port of ``repro/kernels/ssd_scan.py``).

:func:`ssd_scan` launches the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) on CUDA tensors, or raises; on CPU tensors it runs
:func:`ssd_scan_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, stream_ptr
from repro_torch.models.mamba import ssd_chunked_ref

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
KERNEL = CudaKernel("ssd_scan.cu", {
    "ssd_scan_fwd": (_I, (_P,) * 7 + (_I,) * 6 + (_L,) * 10 + (_P,)),
    "ssd_scan_padded_chunk": (_I, (_I,)),
})

MAX_STATE = 128
MAX_CHUNK = 1024

# the kernel's plain version: the reference's ssd_chunked_ref (its
# ssd_scan_ref), materializing the (B, n_chunks, Q, Q, H) decay
ssd_scan_plain = ssd_chunked_ref


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """The operations the scan needs: per (batch, chunk, head) 2·P·Q(Q+1)/2
    for the intra-chunk term, 2·Q·N·P for the inter-chunk term and 2·Q·N·P
    for the state update; per (batch, chunk) 2·Q²·N for C·Bᵀ."""
    Q, nc = chunk, S // chunk
    per_head = P * Q * (Q + 1) + 4 * Q * N * P
    return B * nc * (H * per_head + 2 * Q * Q * N)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N) -> y (B,S,H,P).

    Needs ``S % chunk == 0``. On CUDA: fp32 throughout, ``N <= 128``,
    ``chunk <= 1024``, the last stride of x, dt, Bm and Cm 1 (other strides
    are read as they are), A contiguous. Anything else raises; there is no
    fallback.
    """
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 3 or \
            Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan takes x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"Bm/Cm (B,S,N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) or \
            tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan needs S % chunk == 0, got S={S}, "
                         f"chunk={chunk}")
    tensors = (x, dt, A, Bm, Cm)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"SSD kernel needs x, dt, A, Bm, Cm on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"SSD kernel takes fp32 inputs, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if N > MAX_STATE or chunk > MAX_CHUNK or min(B, S, H, P, N) == 0:
        raise ValueError(f"SSD kernel takes 1 <= N <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK} and non-empty inputs, got N={N}, "
                         f"chunk={chunk}, x {tuple(x.shape)}")
    if x.stride(3) != 1 or dt.stride(2) != 1 or Bm.stride(2) != 1 or \
            Cm.stride(2) != 1 or A.stride(0) != 1:
        raise ValueError("SSD kernel takes x, dt, Bm, Cm whose last axis is "
                         "contiguous, and a contiguous A")
    lib = KERNEL.lib()
    qp = lib.ssd_scan_padded_chunk(chunk)
    cb = torch.empty((B * (S // chunk), qp, qp), dtype=torch.float32,
                     device=x.device)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    rc = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), cb.data_ptr(), y.data_ptr(), B, S, H, P, N, chunk,
        *x.stride()[:3], *dt.stride()[:3], *Bm.stride()[:2],
        *Cm.stride()[:2], stream_ptr())
    KERNEL.launches += 1
    KERNEL.check(rc, "ssd_scan kernel")
    return y

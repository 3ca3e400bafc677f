"""Mamba-2 SSD chunked scan (port of ``repro/kernels/ssd_scan.py``).

:func:`ssd_scan` launches the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) on CUDA tensors, or raises; on CPU tensors it runs
:func:`ssd_scan_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (CudaKernel, refuse_grad, row_strides,
                                       stream_ptr)
from repro_torch.models.mamba import ssd_chunked_ref

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
KERNEL = CudaKernel("ssd_scan.cu", {
    "ssd_scan_fwd": (_I, (_I,) + (_P,) * 11 + (_I,) * 6 + (_L,) * 10
                     + (_P,)),
    "ssd_scan_padded_chunk": (_I, (_I,)),
})

MAX_STATE = 128
MAX_CHUNK = 1024
# x, Bm and Cm come in one of these dtypes (the C entry's code); dt and A
# are fp32
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# TF32 products the kernel issues per multiply-add of the scan: 3xTF32, or 2
# when x, B and C are bf16 (exact in TF32, their lo terms skipped)
TF32_TERMS = {torch.float32: 3, torch.bfloat16: 2}


def ssd_scan_plain(x, dt, A, Bm, Cm, chunk: int):
    """The kernel's plain version: the reference's ``ssd_chunked_ref`` (its
    ``ssd_scan_ref``), materializing the (B, n_chunks, Q, Q, H) decay. bf16
    x, Bm and Cm are widened to fp32 first, which is exact, so it computes
    the function the kernel computes on them."""
    f32 = torch.float32
    return ssd_chunked_ref(x.to(f32), dt, A, Bm.to(f32), Cm.to(f32), chunk)


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """The operations the scan needs: per (batch, chunk, head) 2·P·Q(Q+1)/2
    for the intra-chunk term, 2·Q·N·P for the inter-chunk term and 2·Q·N·P
    for the state update; per (batch, chunk) 2·Q²·N for C·Bᵀ."""
    Q, nc = chunk, S // chunk
    per_head = P * Q * (Q + 1) + 4 * Q * N * P
    return B * nc * (H * per_head + 2 * Q * Q * N)


def ssd_bytes(B: int, S: int, H: int, P: int, N: int, in_bytes: int) -> int:
    """The bytes the scan must move: x, Bm and Cm (``in_bytes`` an element)
    and dt, A read once, and the fp32 y written once."""
    return (B * S * (H * P + 2 * N) * in_bytes + (B * S * H + H) * 4
            + B * S * H * P * 4)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N) -> y (B,S,H,P),
    fp32.

    Needs ``S % chunk == 0``. On CUDA: x, Bm and Cm all fp32 or all bf16
    (read as they are, widened in registers), dt and A fp32, ``N <= 128``,
    ``chunk <= 1024``, the last stride of x, dt, Bm and Cm 1 (other strides
    are read as they are), A contiguous, no input that requires grad under
    autograd (the kernel has no backward). Anything else raises; there is
    no fallback.
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
    refuse_grad("SSD scan", *tensors)
    if x.dtype not in _IN_DTYPES or Bm.dtype != x.dtype or \
            Cm.dtype != x.dtype or dt.dtype != torch.float32 or \
            A.dtype != torch.float32:
        raise TypeError(f"SSD kernel takes fp32 or bf16 x, Bm, Cm of one "
                        f"dtype and fp32 dt, A, got "
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
    units = B * (S // chunk) * H
    f32, dev = torch.float32, x.device
    # scratch: C·Bᵀ per (batch, chunk); per (batch, chunk, head) the fp64
    # cumsum (as fp32 hi + lo), dt / exp(cum) / exp(total - cum)·dt,
    # exp(total) and the state
    cb = torch.empty((B * (S // chunk), qp, qp), dtype=f32, device=dev)
    cum = torch.empty((units, qp, 2), dtype=f32, device=dev)
    aux = torch.empty((3, units, qp), dtype=f32, device=dev)
    etot = torch.empty((units,), dtype=f32, device=dev)
    states = torch.empty((units, N, P), dtype=f32, device=dev)
    y = torch.empty((B, S, H, P), dtype=f32, device=dev)
    rc = lib.ssd_scan_fwd(
        _IN_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), cb.data_ptr(), cum.data_ptr(),
        aux.data_ptr(), etot.data_ptr(), states.data_ptr(), y.data_ptr(),
        B, S, H, P, N, chunk, *row_strides(x, 3), *row_strides(dt, 3),
        *row_strides(Bm, 2), *row_strides(Cm, 2), stream_ptr())
    KERNEL.launches += 1
    KERNEL.check(rc, "ssd_scan kernel")
    return y

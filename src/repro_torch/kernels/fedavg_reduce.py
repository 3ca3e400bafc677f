"""FedAvg reduce for the Eq. 3 flat average (port of
``repro/kernels/fedavg_reduce.py``): the normalized weighted average of C
stacked flat client parameter vectors.

:func:`fedavg_reduce` launches the hand-written Hopper kernel
(``csrc/fedavg_reduce.cu``) on a CUDA tensor, or raises; on a CPU tensor it
runs :func:`fedavg_reduce_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, refuse_grad, stream_ptr

KERNEL = CudaKernel("fedavg_reduce.cu", {
    "fedavg_reduce_f32": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)),
})


def stack_rows(flats):
    """Stack C flat fp32 vectors of one length N into the (C, N) layout the
    kernel reads fastest: a view of a buffer whose row stride is N rounded
    up to a multiple of 4 floats, so on the card every row starts 16-byte
    aligned and the kernel reads it with 16-byte loads."""
    n = flats[0].shape[0]
    buf = torch.empty((len(flats), n + (-n) % 4), dtype=torch.float32,
                      device=flats[0].device)
    stacked = buf[:, :n]
    for i, f in enumerate(flats):
        stacked[i].copy_(f)
    return stacked


def fedavg_reduce_plain(stacked, weights):
    """``(w / sum(w)) @ stacked`` in fp32, cast to the stack's dtype."""
    w = weights.to(torch.float32)
    w = w / torch.sum(w)
    return (w @ stacked.to(torch.float32)).to(stacked.dtype)


def fedavg_reduce(stacked, weights):
    """``stacked`` (C, N) flat client params, ``weights`` (C,) -> (N,) the
    normalized weighted average (the weights are normalized inside).

    On CUDA the stack must be fp32 with contiguous rows; its row stride may
    exceed N, as in a stack built by :func:`stack_rows`, which lets the
    kernel use 16-byte loads. The result is fp32. The kernel has no
    backward: under autograd it refuses inputs that require grad (the FL
    rounds call it on models their optimizer updated under no-grad).
    """
    if stacked.device.type == "cpu" and weights.device.type == "cpu":
        return fedavg_reduce_plain(stacked, weights)
    if stacked.device.type != "cuda" or weights.device != stacked.device:
        raise ValueError(f"fedavg kernel needs stacked and weights on one "
                         f"CUDA device, got {stacked.device} and "
                         f"{weights.device}")
    refuse_grad("FedAvg reduce", stacked, weights)
    if stacked.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"fedavg kernel takes fp32 stacked and weights, got "
                        f"{stacked.dtype} and {weights.dtype}")
    if stacked.ndim != 2 or weights.shape != (stacked.shape[0],):
        raise ValueError(f"fedavg kernel takes stacked (C, N) and weights "
                         f"(C,), got {tuple(stacked.shape)} and "
                         f"{tuple(weights.shape)}")
    c, n = stacked.shape
    if c == 0 or n == 0:
        raise ValueError(f"fedavg kernel needs C >= 1 and N >= 1, got "
                         f"{tuple(stacked.shape)}")
    if stacked.stride(1) != 1 or (c > 1 and stacked.stride(0) < n):
        raise ValueError("fedavg kernel takes a stack with contiguous rows")
    if not weights.is_contiguous():
        raise ValueError("fedavg kernel takes contiguous weights")
    ld = stacked.stride(0) if c > 1 else n
    out = torch.empty((n,), dtype=torch.float32, device=stacked.device)
    rc = KERNEL.lib().fedavg_reduce_f32(
        stacked.data_ptr(), ld, weights.data_ptr(), c, out.data_ptr(), n,
        stream_ptr())
    KERNEL.launches += 1
    KERNEL.check(rc, "fedavg_reduce kernel")
    return out

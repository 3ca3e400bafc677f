"""Flash attention (port of ``repro/kernels/flash_attention.py``).

Block-wise softmax(Q·Kᵀ)·V with online max/sum rescaling in fp32, with the
reference's attention flavours: causal or not, a sliding window, a logit
soft-cap and GQA (G query heads share one KV head), plus ``q_offset`` and
ragged Sq / Sk.

:func:`flash_attention` launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) on CUDA tensors, or raises: bf16 inputs go to
its tensor-core variant (``bf16_tc``), fp32 inputs to its CUDA-core variant
(``fp32``), each counted in ``KERNEL.variant_launches``. On CPU tensors it
runs :func:`flash_attention_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels._build import (CudaKernel, refuse_grad, row_strides,
                                       stream_ptr)
from repro_torch.models.layers import attention_reference

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
KERNEL = CudaKernel("flash_attention.cu", {
    "flash_attention_fwd": (_I, (
        _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L,
        ctypes.c_float, ctypes.c_float, _I, _I, _I, _P)),
}, variants=("bf16_tc", "fp32"))

# dtype -> (the C entry's dtype code, the variant it launches)
_DTYPES = {torch.float32: (0, "fp32"), torch.bfloat16: (1, "bf16_tc")}
MAX_HEAD_DIM = 256


# the kernel's plain version: materialized fp32 scores, the port of the
# reference's attention_reference (its flash_attention_ref)
flash_attention_plain = attention_reference


def band_pairs(sq: int, sk: int, *, causal: bool = True, window: int = 0,
               q_offset: int = 0) -> int:
    """The (query, key) pairs that the mask allows, per (batch, head): the
    work the kernel must do, which the card's bound is computed from."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap=None, q_offset: int = 0, scale=None):
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd). Returns (B, Sq, Hq, hd) in
    q's dtype.

    On CUDA: fp32 or bf16, one dtype for all three, ``vd == hd <= 256``,
    ``Hq % Hkv == 0``, the head-dim stride 1 (other strides are read as
    they are), non-empty, no input that requires grad under autograd (the
    kernel has no backward). Anything else raises; there is no fallback. The
    tensor-core variant copies 16-byte chunks: a bf16 q, k or v whose rows
    are not 16-byte aligned (its data pointer, or a batch, sequence or head
    stride of an axis longer than 1 not a multiple of 8 elements) is first
    copied into a fresh buffer with the head dim zero-padded to a multiple
    of 8, and the output is sliced back. Zero columns add nothing to q·k
    and give zero output columns, so the result is the same function; the
    scale comes from the true hd.
    """
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_softcap=logit_softcap,
                                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    refuse_grad("flash attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes fp32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash kernel takes q (B, Sq, Hq, hd) and k, v "
                         f"(B, Sk, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, kd = k.shape
    if k.shape[0] != B or kd != hd or hd > MAX_HEAD_DIM or Hq % Hkv:
        raise ValueError(f"flash kernel needs one batch, vd == hd <= "
                         f"{MAX_HEAD_DIM} and Hq % Hkv == 0, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if min(q.numel(), k.numel()) == 0:
        raise ValueError("flash kernel takes non-empty q, k, v")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel takes q, k, v whose head dim is "
                         "contiguous")
    code, variant = _DTYPES[q.dtype]
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be positive, got {logit_softcap}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    width = hd  # the head dim the kernel sees
    if variant == "bf16_tc":
        unaligned = [t.data_ptr() % 16 != 0 or any(st % 8 for st in
                                                   row_strides(t, 3))
                     for t in (q, k, v)]
        if any(unaligned):
            width = -(-hd // 8) * 8
            q, k, v = (_aligned_copy(t, width) if bad or width != hd else t
                       for t, bad in zip((q, k, v), unaligned))
    strides = [row_strides(t, 3) for t in (q, k, v)]
    out = torch.empty((B, Sq, Hq, width), dtype=q.dtype, device=q.device)
    rc = KERNEL.lib().flash_attention_fwd(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, Hq, Hkv, width, *strides[0], *strides[1],
        *strides[2], float(scale), float(logit_softcap or 0.0),
        int(bool(causal)), int(window), int(q_offset), stream_ptr())
    KERNEL.check(rc, "flash_attention kernel")
    KERNEL.count(variant)
    return out if width == hd else out[..., :hd].contiguous()


def _aligned_copy(t, width: int):
    """A fresh contiguous copy of ``t`` (B, S, H, hd) with the head dim
    zero-padded to ``width``, a multiple of 8: every row 16-byte aligned
    in bf16."""
    buf = t.new_zeros((*t.shape[:3], width))
    buf[..., :t.shape[3]] = t
    return buf

"""Plain fp32 building blocks shared by the benchmark's references.

Nothing here imports the program: the references follow the published
equations and read the weights the benchmark drew, in the program's layout
(a dense weight is ``(d_in, d_out)`` and is applied as ``x @ W``; a stack of
layers carries a leading layer axis). Every product runs in fp32 with TF32
off (:func:`strict_fp32`).

``quant`` is the control's lower precision: a function applied to both
operands of every linear layer's product (:func:`fp8_rows`), or None.

Each reference also counts a request's work (``work``), and refuses sizes
it was not written for (``known``, :func:`require`).
"""
from __future__ import annotations

import torch

F32 = torch.float32
FP8_MAX = 448.0  # the largest float8_e4m3fn value


def strict_fp32() -> None:
    """fp32 products in fp32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with one scale for each slice along
    ``dim`` (its absolute maximum maps to 448), returned in fp32: an fp8
    product's operand with per-row activation and per-column weight
    scales."""
    t = t.to(F32)
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """``x @ w`` in fp32; with ``quant``, x rounded per row and w per output
    column first."""
    x, w = x.to(F32), w.to(F32)
    if quant is not None:
        x, w = quant(x, -1), quant(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        scale.to(F32)


def require(s: dict, name: str, keys: frozenset, values: dict) -> None:
    """Raise unless ``s`` holds exactly the sizes ``keys`` and each key of
    ``values`` takes one of its listed values: a shape that the reference
    ``name`` and its count were not written for (experts, latent attention,
    a hybrid trunk, a tied head) is refused, never computed or counted
    wrong."""
    extra, missing = set(s) - keys, keys - set(s)
    if extra or missing:
        raise ValueError(f"{name} does not know the sizes {sorted(extra)} "
                         f"and lacks {sorted(missing)}")
    wrong = {k: s[k] for k, ok in values.items() if s[k] not in ok}
    if wrong:
        raise ValueError(f"{name} was not written for {wrong}")

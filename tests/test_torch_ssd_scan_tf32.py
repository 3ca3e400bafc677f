"""The precision design of the port's SSD-scan kernel, and its bf16 inputs,
on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``) runs only on
the card. Its arithmetic is emulated here in plain PyTorch, step by step as
the kernel takes it, in the chunk-parallel form: the in-chunk cumsum of
dt·A in fp64 with each exponent rounded to fp32 once; C·Bᵀ in fp32; each
chunk's own state, (Bᵀ·diag(exp(total − cum)·dt))·x; the states passed
from chunk to chunk in fp32; then exp(cum_q)·(C_q·h) plus W·x with the
weights W = (C·Bᵀ)·exp(cum_q − cum_k)·dt_k masked before the exp. Every
product runs as the tensor cores run it in 3xTF32: each fp32 operand split
into hi = tf32(a) and lo = tf32(a − hi) (rounded to nearest, ties away from
zero, as the kernel's integer rounding does), a·b ≈ hi·hi + hi·lo + lo·hi,
each TF32 product exact in fp32. A bf16 input widened to fp32 is exact in
TF32 (its lo is 0), so the same emulation covers the kernel's bf16 path,
which skips those terms. The emulation is held against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.ssd_scan``) and its
oracle (``ref.ssd_scan_ref``) at the reference tests' atol 2e-4 / rtol 2e-3,
on their cases (``SSD_CASES``), with fp32 inputs and with bf16-valued x, B
and C: the tolerance holds for the numerics the kernel chose, independently
of a run on the card.

The rest checks the bf16 path around the kernel on CPU tensors, where the
wrapper runs the plain version: bf16 x, B and C give bitwise the result of
their fp32 casts; the forward's new D skip, ``y + D * x`` on bf16 x, is
bitwise the old ``y + D * x.float()``; ``mamba_forward(use_pallas=True)``
hands the kernel bf16 x, B and C, matches its plain path bitwise, and in
fp32 still matches the reference layer at ``tests/test_torch_mamba.py``'s
1e-4. Inputs are made with numpy from a seed.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import mamba as JM
from repro_torch.kernels import ops as tops
from repro_torch.models import mamba as TM
from test_torch_mamba import smoke  # noqa: F401  (the module's fixture)
from test_torch_ssd_scan import SSD_CASES, _inputs

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

ATOL, RTOL = 2e-4, 2e-3


def tf32(a):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: (bits + 0x1000) & ~0x1fff, as the kernel rounds."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a, b):
    """a @ b in 3xTF32: hi·hi + hi·lo + lo·hi, the lo·lo term dropped. Each
    TF32 x TF32 product is exact in fp32; the sums run in fp32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def emulate(x, dt, A, Bm, Cm, chunk, product=mm3):
    """The kernel's arithmetic on fp32 tensors (x (B,S,H,P), dt (B,S,H), A
    (H,), Bm/Cm (B,S,N)); returns y (B,S,H,P) fp32. ``product`` is how a
    matrix product runs (the control test passes plain TF32)."""
    Bsz, S, H, P = x.shape
    N, Q, nc = Bm.shape[-1], chunk, S // chunk
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, Q, H, P).permute(0, 1, 3, 2, 4)  # (B,nc,H,Q,P)
    dtc = dt.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2)      # (B,nc,H,Q)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    # 1. cum in fp64; exp(cum), exp(total - cum)·dt, exp(total), each
    # exponent rounded to fp32 once
    cum = torch.cumsum((dtc * A[None, None, :, None]).to(torch.float64), -1)
    total = cum[..., -1:]
    ecum = torch.exp(cum.to(f32))
    edt = torch.exp((total - cum).to(f32)) * dtc
    etot = torch.exp(total[..., 0].to(f32))
    # 2. C·Bᵀ in fp32 on the CUDA cores
    cb = Cc @ Bc.transpose(-1, -2)                            # (B,nc,Q,Q)
    # 3. each chunk's own state: (Bᵀ·diag(edt)) · x
    states = product(Bc.transpose(-1, -2)[:, :, None] * edt[..., None, :],
                     xc)                                      # (B,nc,H,N,P)
    # 4. the states passed in chunk order, fp32; h_in[c] enters chunk c
    h = torch.zeros((Bsz, H, N, P), dtype=f32)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * etot[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, 1)
    # 5. exp(cum_q)·(C_q·h) + W·x, W masked before the exp
    y = product(Cc[:, :, None], h_in) * ecum[..., None]
    q = torch.arange(Q)
    keep = q[None, :] <= q[:, None]
    diff = (cum[..., :, None] - cum[..., None, :]).to(f32)   # (B,nc,H,Q,Q)
    w = torch.where(keep, cb[:, :, None] * torch.exp(torch.where(
        keep, diff, 0.0)) * dtc[..., None, :], 0.0)
    y = y + product(w, xc)
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)


def _bf16_valued(a):
    """numpy fp32 values rounded to bf16 and widened back (exact)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("inputs", ["fp32", "bf16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_tf32x3_emulation_matches_reference(case, inputs):
    *shape, chunk = case
    x, dt, A, Bm, Cm = _inputs(*shape, seed=sum(case) + 1)
    if inputs == "bf16":
        x, Bm, Cm = (_bf16_valued(a) for a in (x, Bm, Cm))
    args = (x, dt, A, Bm, Cm)
    got = emulate(*(torch.from_numpy(a) for a in args), chunk)
    for want in (ops.ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk),
                 ref.ssd_scan_ref(*(jnp.asarray(a) for a in args),
                                  chunk=chunk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_plain_tf32_breaks_the_tolerance():
    """The control: with one TF32 product (operands rounded at 2⁻¹¹) the
    same steps miss the oracle's tolerance at the case with N=128 and |y|
    up to ~350 (by ~20x on this draw), where the 3xTF32 split stays inside
    it. The split is what the tolerance rests on."""
    B, S, H, P, N, chunk = SSD_CASES[-1]
    args = _inputs(B, S, H, P, N, seed=7)
    want = np.asarray(ref.ssd_scan_ref(*(jnp.asarray(a) for a in args),
                                       chunk=chunk))
    limit = ATOL + RTOL * np.abs(want)
    t = [torch.from_numpy(a) for a in args]
    split = emulate(*t, chunk).numpy()
    plain_tf32 = emulate(*t, chunk,
                         product=lambda a, b: tf32(a) @ tf32(b)).numpy()
    assert (np.abs(split - want) <= limit).all()
    assert (np.abs(plain_tf32 - want) > limit).any()


def test_tf32_rounding_is_to_nearest_ties_away():
    # a TF32 ulp is 2^-10 in [1, 2) and 2^-9 in [2, 4): ties go away from 0
    tie = 1.0 + 2.0 ** -11
    vals = torch.tensor([1.0, tie, -tie, 1.0 + 2.0 ** -12, 3.0 + 2.0 ** -10,
                         3.0 + 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         3.0 + 2.0 ** -9, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    bf = torch.randn(1000).bfloat16().float()  # a bf16 value is a TF32 value
    assert torch.equal(tf32(bf), bf)


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_scan_bf16_inputs_equal_their_fp32_casts(case):
    """On CPU tensors the wrapper runs the plain version, which widens bf16
    x, B and C first: bitwise the result of the fp32 casts, in fp32."""
    *shape, chunk = case
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs(*shape, seed=sum(case) + 2))
    xb, bb, cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    got = tops.ssd_scan(xb, dt, A, bb, cb, chunk=chunk)
    want = tops.ssd_scan(xb.float(), dt, A, bb.float(), cb.float(),
                         chunk=chunk)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(ssd.ssd_scan_plain(xb, dt, A, bb, cb, chunk), want)


def test_d_skip_on_bf16_x_is_the_fp32_form():
    """``y + D * x`` with bf16 x promotes to fp32 from the widened x: bit for
    bit what the fp32 copy gave."""
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.standard_normal((2, 64, 8, 16), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 64, 8, 16),
                                             dtype=np.float32)).bfloat16()
    D = torch.from_numpy(rng.standard_normal(8, dtype=np.float32))
    got = y + D[None, None, :, None] * x
    assert got.dtype == torch.float32
    assert torch.equal(got, y + D[None, None, :, None] * x.to(torch.float32))


def _layer(smoke, dtype):
    tp = {k: v[0] for k, v in smoke["tparams"]["blocks"]["mixer"].items()}
    keep_fp32 = ("A_log", "D", "dt_bias")
    return {k: v if k in keep_fp32 else v.to(dtype) for k, v in tp.items()}


def test_kernel_path_gets_bf16_and_matches_plain_path(smoke, monkeypatch):
    """A bf16 mamba layer: ``use_pallas=True`` hands the kernel wrapper the
    bf16 x, B and C slices (fp32 dt and A), with no fp32 copy, and on the
    CPU gives bitwise the ``use_pallas=False`` result."""
    from repro_torch.kernels import ops as kops

    seen = []
    real = kops.ssd_scan

    def spy(x, dt, A, Bm, Cm, *, chunk):
        seen.append(tuple(t.dtype for t in (x, dt, A, Bm, Cm)))
        return real(x, dt, A, Bm, Cm, chunk=chunk)

    monkeypatch.setattr(kops, "ssd_scan", spy)
    tcfg, tp = smoke["tcfg"], _layer(smoke, torch.bfloat16)
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 64, tcfg.d_model), dtype=np.float32)).bfloat16()
    got = TM.mamba_forward(tcfg, tp, u, use_pallas=True)
    bf, f32 = torch.bfloat16, torch.float32
    assert seen == [(bf, f32, f32, bf, bf)]
    assert torch.equal(got, TM.mamba_forward(tcfg, tp, u, use_pallas=False))


def test_mamba_forward_kernel_path_matches_reference(smoke):
    """One fp32 mamba layer through the kernel path (``use_pallas=True``;
    the plain version on the CPU, the Pallas kernel in interpret mode in
    the reference) against the reference at 1e-4."""
    cfg, p = smoke["cfg"], smoke["jparams"]["blocks"]["mixer"]
    jp = {k: v[0] for k, v in p.items()}
    u = np.random.default_rng(8).standard_normal((2, 64, cfg.d_model),
                                                 dtype=np.float32)
    want = JM.mamba_forward(cfg, jp, jnp.asarray(u), use_pallas=True)
    got = TM.mamba_forward(smoke["tcfg"], _layer(smoke, torch.float32),
                           torch.from_numpy(u), use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

"""The port's hand-written CUDA kernels against their plain versions, on the
card. Marked ``cuda``: each test skips where no CUDA device is present
(decided inside the fixture, never at import). On a machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda_kernels.py

(``--noconftest`` because ``tests/conftest.py`` imports jax, which a
machine for the port need not have.)
"""
import importlib

import pytest
import torch

sr = importlib.import_module("repro_torch.kernels.segment_reduce")
fr = importlib.import_module("repro_torch.kernels.fedavg_reduce")
fa = importlib.import_module("repro_torch.kernels.flash_attention")
ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k,m", [(10, 2_097_152, 5), (10, 1, 5),
                                   (100, 1, 5), (100_000, 1, 8),
                                   (3000, 37, 13), (5, 3, 1)])
def test_segment_kernel_matches_plain_and_repeats(cuda, n, k, m):
    gen = torch.Generator().manual_seed(n + k + m)
    vals = torch.randn((n, k), generator=gen).to(cuda)
    ids = torch.randint(-1, m + 2, (n,), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = sr.KERNEL.launches
    out = sr.segment_reduce_kernel(vals, ids, m)
    again = sr.segment_reduce_kernel(vals, ids, m)
    assert sr.KERNEL.launches == before + 2
    torch.cuda.synchronize()
    torch.testing.assert_close(out, sr._seg_tiled_plain(vals, ids, m),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)  # fixed summation order


@pytest.mark.parametrize("m", [sr.MAX_SEGMENTS, sr.MAX_SEGMENTS + 1, 500])
def test_per_bs_sums_past_the_kernel_ceiling_match_the_cpu(cuda, m):
    """ROADMAP C1a: past MAX_SEGMENTS = 223 the card launches the kernel
    once per window of at most 223 segment ids; held against the plain
    version on the card and the same call on the CPU. ``migration_flows``
    at n_bs = 15 (225 pair ids) takes two windows and matches the CPU."""
    from repro_torch.core import migration

    gen = torch.Generator().manual_seed(m)
    vals = torch.randn((5000, 3), generator=gen)
    ids = torch.randint(-1, m + 2, (5000,), generator=gen, dtype=torch.int32)
    windows = -(-m // sr.MAX_SEGMENTS)
    before = sr.KERNEL.launches
    got = sr.segment_reduce(vals.to(cuda), ids.to(cuda), m)
    assert sr.KERNEL.launches == before + windows
    torch.testing.assert_close(
        got, sr._seg_tiled_plain(vals.to(cuda), ids.to(cuda), m),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.cpu(), sr.segment_reduce(vals, ids, m),
                               rtol=1e-5, atol=1e-5)
    # two groups of m segments: one call each
    gids = ids.reshape(2, 2500).to(cuda)
    before = sr.KERNEL.launches
    grouped = sr.segment_reduce_grouped(vals[:, 0].reshape(2, 2500).to(cuda),
                                        gids, m)
    assert sr.KERNEL.launches == before + 2 * windows
    for g in range(2):
        torch.testing.assert_close(
            grouped[g], sr._seg_tiled_plain(
                vals[g * 2500:(g + 1) * 2500, :1].to(cuda), gids[g], m)[:, 0],
            rtol=1e-5, atol=1e-5)
    old = torch.randint(0, 15, (1000,), generator=gen)
    new = torch.randint(0, 15, (1000,), generator=gen)
    before = sr.KERNEL.launches
    flows = migration.migration_flows(old.to(cuda), new.to(cuda), 15)
    assert sr.KERNEL.launches == before + 2
    assert torch.equal(flows.cpu(), migration.migration_flows(old, new, 15))


def test_segment_kernel_refuses_what_it_does_not_take(cuda):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sr.segment_reduce_kernel(torch.ones((4, 2), dtype=torch.float64,
                                            device=cuda), ids, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sr.segment_reduce_kernel(torch.ones((2, 4), device=cuda).T, ids, 2)
    out = sr.segment_reduce_kernel(torch.ones((0, 3), device=cuda),
                                   ids[:0], 2)
    assert out.shape == (2, 3) and not out.any()


@pytest.mark.parametrize("n,k,m", [(100, 1, 5), (6400, 1, 220),
                                   (3000, 37, 13)])
def test_segment_kernel_gradient_matches_plain(cuda, n, k, m):
    """The kernel backend's autograd output on a CUDA tensor: a grad_fn, the
    plain version's gradient, zero for dropped ids."""
    gen = torch.Generator().manual_seed(n + m)
    vals = torch.randn((n, k), generator=gen).to(cuda)
    ids = torch.randint(-1, m + 2, (n,), generator=gen,
                        dtype=torch.int32).to(cuda)
    w = torch.randn((m, k), generator=gen).to(cuda)
    v = vals.clone().requires_grad_()
    before = sr.KERNEL.launches
    out = sr.segment_reduce(v, ids, m)
    assert sr.KERNEL.launches == before + 1 and out.grad_fn is not None
    (out * w).sum().backward()
    assert sr.KERNEL.launches == before + 1  # the backward is a gather
    p = vals.clone().requires_grad_()
    (sr._seg_tiled_plain(p, ids, m) * w).sum().backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(v.grad, p.grad, rtol=1e-6, atol=1e-6)
    dropped = (ids < 0) | (ids >= m)
    assert dropped.any() and not v.grad[dropped].any()


def test_segment_grouped_at_the_scenario_runners_shape(cuda):
    """The scenario runners' grouped call: S=256 scenarios of N=100 twins
    over M=5 BSs, 44 scenarios a launch (6 launches), against the plain
    version row by row."""
    s, n, m = 256, 100, 5
    gen = torch.Generator().manual_seed(11)
    vals = torch.rand((s, n), generator=gen).to(cuda) * 1000
    ids = torch.randint(0, m + 1, (s, n), generator=gen,
                        dtype=torch.int32).to(cuda)  # m: a padding row
    before = sr.KERNEL.launches
    out = sr.segment_reduce_grouped(vals, ids, m)
    assert sr.KERNEL.launches == before + -(-s // (sr.MAX_SEGMENTS // m))
    plain = torch.stack([sr._seg_tiled_plain(vals[i][:, None], ids[i], m)[:, 0]
                         for i in range(s)])
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)


def test_segment_kernel_at_the_capacity_axis_eq4_shape(cuda):
    """The streamed round's largest Eq. 4 call: the CNN's ``fc1_w`` over a
    capacity of N=100 twins (K=2,097,152, M=5), 10 rows weighted and
    associated, the rest on the padding id."""
    n, k, m = 100, 2_097_152, 5
    gen = torch.Generator().manual_seed(12)
    vals = torch.randn((n, k), generator=gen).to(cuda)
    ids = torch.full((n,), m, dtype=torch.int32)
    ids[torch.randperm(n, generator=gen)[:10]] = torch.randint(
        0, m, (10,), generator=gen, dtype=torch.int32)
    ids = ids.to(cuda)
    out = sr.segment_reduce_kernel(vals, ids, m)
    again = sr.segment_reduce_kernel(vals, ids, m)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, sr._seg_tiled_plain(vals, ids, m),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)


def test_twin_scatter_rows_is_in_place_and_sync_free(cuda):
    """The streamed round's row scatter: in place, no copy of the buffer,
    nothing read back to the host (dropped ids included)."""
    from repro_torch.core import sharding

    gen = torch.Generator().manual_seed(13)
    x = torch.randn((100, 3, 4), generator=gen).to(cuda)
    want = x.clone()
    idx = torch.tensor([7, -1, 42, 100, 3, -1], device=cuda)
    rows = torch.randn((6, 3, 4), generator=gen).to(cuda)
    ptr = x.data_ptr()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sharding.twin_scatter_rows(x, idx, rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got is x and x.data_ptr() == ptr
    for j, r in ((7, 0), (42, 2), (3, 4)):
        want[j] = rows[r]
    torch.testing.assert_close(x, want, rtol=0, atol=0)


def test_serve_rounds_overlap_is_sync_free(cuda):
    """Two overlapped streamed rounds with churn, every workload axis and
    the tiny model's FL on the card raise nothing under the sync debug
    mode, and equal two blocking rounds bit for bit."""
    from repro_torch.core import scenario, serve
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.marl.env import EnvConfig
    from repro_torch.core.migration import MigrationConfig
    from repro_torch.data import cifar10
    from repro_torch.fl import stream

    cfg = EnvConfig(n_twins=64, migration=MigrationConfig(p_move=0.1),
                    faults=FaultConfig(),
                    consensus=ConsensusConfig(quorum_f=1, byzantine_frac=0.2))
    fcfg = stream.FLServeConfig(model="tiny", participants=6, local_iters=2,
                                batch_size=8)
    scfg = serve.ServeConfig(capacity=64, join_rate=0.05, leave_rate=0.05,
                             fl=fcfg)
    data = cifar10.load(max_train=1024, max_test=256)
    batch = scenario.make_batch(0, 1)
    row = scenario.knob_row(scenario.stream_knobs(
        scenario.batch_to(batch, cuda), fcfg=cfg.faults, ccfg=cfg.consensus),
        0)
    seed = int(batch.seed[0])
    plan = stream.stream_fl_plan(fcfg, stream.cyclic_shards(1024, 64, 64), 2)
    plan = stream.FLPlan(*(x.to(cuda) for x in plan))
    draws = serve.stream_draws(cfg, scfg, seed, 2, cuda)
    out = {}
    for overlap in (True, False):
        st = serve.serve_init(cfg, scfg, row, seed=seed, device=cuda)
        st = st._replace(fl=stream.fl_init(
            fcfg, torch.Generator().manual_seed(1), data, st.active))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if overlap else 0)
        try:
            _, m = serve.serve_rounds(cfg, scfg, st, draws, row,
                                      overlap=overlap, plan=plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[overlap] = serve.stack_metrics(m)
    for k in out[True]:
        assert (out[True][k] == out[False][k]).all(), k


def test_default_draws_match_the_cpu(cuda):
    """The scenario runners' default draws on the card: integer and uniform
    draws are the CPU's bits, the transcendental ones within rtol 1e-6."""
    from repro_torch.core import scenario

    seeds = torch.tensor([0, 7, 2**33 + 5])
    fields = [(k, (64, 100))
              for k in (5, "uniform", "exponential", "gumbel", "normal")]
    got = scenario.RowStream(seeds, 3, cuda).draw(fields, 4)
    want = scenario.RowStream(seeds, 3, "cpu").draw(fields, 4)
    for (kind, _), g, w in zip(fields, got, want):
        if kind in (5, "uniform"):
            assert torch.equal(g.cpu(), w), kind
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g,n,m", [(64, 100, 5), (320, 100, 5),
                                   (7, 50, 223)])
def test_segment_kernel_grouped_matches_plain(cuda, g, n, m):
    """More than 223 segments in all: one launch per run of 223 // M
    groups, each against the plain version per group."""
    gen = torch.Generator().manual_seed(g + m)
    vals = torch.randn((g, n), generator=gen).to(cuda)
    ids = torch.randint(-1, m + 1, (g, n), generator=gen,
                        dtype=torch.int32).to(cuda)
    assert sr.KERNEL.lib().seg_reduce_max_segments() == sr.MAX_SEGMENTS
    v = vals.clone().requires_grad_()
    before = sr.KERNEL.launches
    out = sr.segment_reduce_grouped(v, ids, m)
    assert sr.KERNEL.launches - before == -(-g // (sr.MAX_SEGMENTS // m))
    w = torch.randn(out.shape, generator=torch.Generator(device="cuda")
                    .manual_seed(0), device="cuda")
    (out * w).sum().backward()
    p = vals.clone().requires_grad_()
    want = torch.stack([sr._seg_tiled_plain(p[i][:, None], ids[i], m)[:, 0]
                        for i in range(g)])
    (want * w).sum().backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v.grad, p.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,n,main_path", [(5, 2_156_490, True),
                                           (5, 2_156_490, False),
                                           (3, 65_537, False),
                                           (16, 4096, False)])
def test_fedavg_kernel_matches_plain(cuda, c, n, main_path):
    """On a stack laid out by ``stack_rows`` (16-byte loads) and on
    contiguous stacks, whose rows are 16-byte aligned only when 4 | N."""
    gen = torch.Generator().manual_seed(c + n)
    x = torch.randn((c, n), generator=gen).to(cuda)
    if main_path:
        x = fr.stack_rows(list(x))
    w = torch.rand((c,), generator=gen).to(cuda) + 0.1
    out = fr.fedavg_reduce(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fr.fedavg_reduce_plain(x, w),
                               rtol=1e-5, atol=1e-5)


# the cases of tests/test_kernels.py:
# B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap
FLASH_CASES = [
    (1, 64, 64, 4, 2, 32, True, 0, None),
    (2, 128, 128, 8, 8, 64, True, 32, None),
    (1, 96, 96, 4, 1, 48, True, 0, 50.0),
    (2, 64, 256, 4, 2, 32, False, 0, None),
    (1, 200, 200, 2, 2, 16, True, 64, None),
    (1, 64, 64, 8, 2, 128, True, 0, None),
    # qwen2-vl's 7 query heads a KV head at hd 128, and seamless's
    # non-causal encoder self-attention at hd 64
    (1, 128, 128, 14, 2, 128, True, 0, None),
    (2, 144, 144, 4, 4, 64, False, 0, None),
]


def _flash_inputs(case, dtype, cuda, seed):
    B, Sq, Sk, Hq, Hkv, hd = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(cuda, dtype)
            for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_fp32(cuda, case):
    """At the reference tests' fp32 tolerance, 2e-5."""
    *_, causal, window, cap = case
    q, k, v = _flash_inputs(case, torch.float32, cuda, sum(case[:6]))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.KERNEL.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_bf16(cuda, case):
    """bf16 through the tensor-core variant, at ROADMAP B3's bf16
    tolerance, 3e-2: the kernel rounds P to bf16 before P.V, the plain
    version computes in fp32; both round the output once."""
    *_, causal, window, cap = case
    q, k, v = _flash_inputs(case, torch.bfloat16, cuda, sum(case[:6]))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = dict(fa.KERNEL.variant_launches)
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.KERNEL.variant_launches == {
        "bf16_tc": before["bf16_tc"] + 1, "fp32": before["fp32"]}
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                               rtol=3e-2, atol=3e-2)


def test_flash_kernel_bf16_gqa_window_strided(cuda):
    """bf16 at the serving path's head dim, GQA 4, window shorter than the
    sequence, q_offset, and q, k, v as views of one fused projection (the
    kernel reads their strides). The kernel rounds P to bf16, the plain
    version does not; both round the output once: 3e-2, ROADMAP B3's bf16
    tolerance."""
    B, S, Hq, Hkv, hd = 2, 700, 8, 2, 80
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn((B, S, Hq + 2 * Hkv, hd), generator=gen).to(
        cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    assert not q.is_contiguous()
    before = fa.KERNEL.variant_launches["bf16_tc"]
    for kw in (dict(window=256), dict(window=100, q_offset=0),
               dict(window=0, causal=False)):
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                                   rtol=3e-2, atol=3e-2)
    tail = q[:, -60:]  # the last 60 queries over all keys
    kw = dict(window=256, q_offset=S - 60)
    torch.testing.assert_close(fa.flash_attention(tail, k, v, **kw),
                               fa.flash_attention_plain(tail, k, v, **kw),
                               rtol=3e-2, atol=3e-2)
    assert fa.KERNEL.variant_launches["bf16_tc"] == before + 4


@pytest.mark.parametrize("sq,sk,q_offset,causal,window", [
    (77, 333, 256, True, 0), (77, 333, 200, True, 90), (130, 201, 71, True, 64),
    (45, 150, 30, False, 0)])
def test_flash_kernel_bf16_ragged_q_offset(cuda, sq, sk, q_offset, causal,
                                           window):
    """hd 80 with Sq and Sk not multiples of 64 and the queries starting at
    q_offset > 0 (a chunk of a longer prompt), through the tensor-core
    variant, at 3e-2."""
    B, Hq, Hkv, hd = 2, 4, 2, 80
    gen = torch.Generator().manual_seed(sq + sk + q_offset)
    q = torch.randn((B, sq, Hq, hd), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((B, sk, Hkv, hd), generator=gen).to(
        cuda, torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.KERNEL.variant_launches["bf16_tc"]
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.KERNEL.variant_launches["bf16_tc"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                               rtol=3e-2, atol=3e-2)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.ones((1, 8, 4, 32), device=cuda)
    k = torch.ones((1, 8, 2, 32), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), k)
    wide = torch.ones((1, 8, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="hd"):
        fa.flash_attention(torch.ones((1, 8, 4, 264), device=cuda), wide, wide)
    strided = torch.ones((1, 8, 32, 2), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, strided, strided)


def test_flash_kernel_bf16_head_dim_not_multiple_of_8(cuda):
    """hd 20 as a view of 24-wide rows: the rows are 16-byte aligned, the
    last 16-byte chunk of each holds 4 values (the copy zero-fills the
    rest) and the output rows, 40 bytes, are written element by element."""
    gen = torch.Generator().manual_seed(20)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, torch.bfloat16)
               [..., :20] for shape in ((2, 150, 4, 24), (2, 150, 2, 24),
                                        (2, 150, 2, 24)))
    kw = dict(causal=True, window=70)
    before = fa.KERNEL.variant_launches["bf16_tc"]
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.KERNEL.variant_launches["bf16_tc"] == before + 1
    torch.cuda.synchronize()
    assert out.shape == (2, 150, 4, 20) and out.is_contiguous()
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                               rtol=3e-2, atol=3e-2)


def test_flash_kernel_bf16_unaligned_rows_match_plain(cuda):
    """The tensor-core variant copies 16-byte chunks: a bf16 view whose rows
    do not start on 16 bytes is copied by the wrapper into a fresh buffer
    (head dim zero-padded to a multiple of 8) for the same kernel, one
    launch of bf16_tc, and gives the plain version's result at 3e-2."""
    gen = torch.Generator().manual_seed(21)

    def bf16(*shape):
        return torch.randn(shape, generator=gen).to(cuda, torch.bfloat16)
    k = bf16(1, 8, 2, 32)
    shifted = bf16(1, 8, 4, 40)[..., 4:36]  # rows at +8 bytes
    narrow = bf16(1, 8, 4, 36)[..., :32]    # 72-byte head stride
    hd20 = (bf16(2, 150, 4, 20), bf16(2, 150, 2, 20), bf16(2, 150, 2, 20))
    for q, kk, vv in ((shifted, k, k), (narrow, k, k),
                      (k, narrow[:, :, :2], narrow[:, :, 2:]), hd20):
        assert q.stride(3) == 1
        before = dict(fa.KERNEL.variant_launches)
        out = fa.flash_attention(q, kk, vv, window=5)
        assert fa.KERNEL.variant_launches == {
            "bf16_tc": before["bf16_tc"] + 1, "fp32": before["fp32"]}
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, kk, vv, window=5)
        assert out.shape == want.shape and out.is_contiguous()
        torch.testing.assert_close(out, want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", [(1, 128, 128, 4, 2, 256, True, 0, 50.0),
                                  (2, 200, 200, 4, 4, 256, True, 64, None),
                                  (1, 70, 70, 2, 1, 144, False, 0, None)])
def test_flash_kernel_wide_head_dims_match_plain(cuda, dtype, tol, case):
    """hd 144 and 256 (gemma2's), the fp32 variant at 2e-5 and the bf16
    tensor-core variant at 3e-2, the tolerances of the hd <= 128 cases."""
    *_, causal, window, cap = case
    q, k, v = _flash_inputs(case, dtype, cuda, sum(case[:6]))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    variant = "fp32" if dtype == torch.float32 else "bf16_tc"
    before = fa.KERNEL.variant_launches[variant]
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.KERNEL.variant_launches[variant] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v, **kw),
                               rtol=tol, atol=tol)


# the cases of tests/test_kernels.py: B, S, H, P, N, chunk
SSD_CASES = [
    (1, 64, 2, 8, 4, 16),
    (2, 128, 4, 16, 8, 32),
    (1, 256, 8, 32, 16, 64),
    (2, 96, 2, 64, 128, 32),
]


def _ssd_inputs(B, S, H, P, N, cuda, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
    A = -torch.exp(torch.randn((H,), generator=gen))
    bm = torch.randn((B, S, N), generator=gen)
    cm = torch.randn((B, S, N), generator=gen)
    return [t.to(cuda) for t in (x, dt, A, bm, cm)]


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_kernel_matches_plain(cuda, case):
    """At the reference tests' tolerance, atol 2e-4 / rtol 2e-3, and
    bitwise repeatable (no atomics)."""
    *shape, chunk = case
    args = _ssd_inputs(*shape, cuda, sum(case))
    before = ssd.KERNEL.launches
    out = ssd.ssd_scan(*args, chunk=chunk)
    again = ssd.ssd_scan(*args, chunk=chunk)
    assert ssd.KERNEL.launches == before + 2
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ssd.ssd_scan_plain(*args, chunk),
                               rtol=2e-3, atol=2e-4)
    assert torch.equal(out, again)


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_kernel_bf16_inputs_match_plain(cuda, case):
    """bf16 x, B and C (the forward's dtype; dt and A fp32), widened in
    registers: within atol 2e-4 / rtol 2e-3 of the plain version on the same
    bf16 inputs, bitwise repeatable, one launch a call, fp32 y."""
    *shape, chunk = case
    x, dt, A, bm, cm = _ssd_inputs(*shape, cuda, sum(case) + 1)
    args = (x.bfloat16(), dt, A, bm.bfloat16(), cm.bfloat16())
    before = ssd.KERNEL.launches
    out = ssd.ssd_scan(*args, chunk=chunk)
    again = ssd.ssd_scan(*args, chunk=chunk)
    assert ssd.KERNEL.launches == before + 2
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ssd.ssd_scan_plain(*args, chunk),
                               rtol=2e-3, atol=2e-4)
    assert torch.equal(out, again)


def test_ssd_kernel_bf16_strided_odd_widths(cuda):
    """bf16 x, Bm and Cm as views of one conv output with rows that are not
    16-byte aligned (the tiles are then copied element by element), P = 7,
    N = 5, a chunk of 64."""
    B, S, H, P, N, chunk = 2, 192, 3, 7, 5, 64
    gen = torch.Generator().manual_seed(10)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen).to(
        cuda, torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
    A = -torch.linspace(1.0, 16.0, H)
    dt, A = dt.to(cuda), A.to(cuda)
    out = ssd.ssd_scan(x, dt, A, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ssd.ssd_scan_plain(x, dt, A, bm, cm, chunk),
                               rtol=2e-3, atol=2e-4)


def test_ssd_kernel_strided_ragged(cuda):
    """x, Bm and Cm as views of one conv output, as mamba_forward makes
    them; P = 80 (a second, partial column slice), N = 100 (not a multiple
    of 16) and a chunk of 100 (not a multiple of 64)."""
    B, S, H, P, N, chunk = 2, 300, 3, 80, 100, 100
    gen = torch.Generator().manual_seed(9)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen).to(cuda)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not x.is_contiguous() and not bm.is_contiguous()
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
    A = -torch.linspace(1.0, 16.0, H)
    dt, A = dt.to(cuda), A.to(cuda)
    out = ssd.ssd_scan(x, dt, A, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ssd.ssd_scan_plain(x, dt, A, bm, cm, chunk),
                               rtol=2e-3, atol=2e-4)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, bm, cm = _ssd_inputs(1, 64, 2, 8, 4, cuda, 0)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.double(), dt, A, bm, cm, chunk=32)
    with pytest.raises(TypeError):  # x, Bm, Cm of one dtype
        ssd.ssd_scan(x.bfloat16(), dt, A, bm, cm, chunk=32)
    with pytest.raises(TypeError):  # dt stays fp32
        ssd.ssd_scan(x, dt.bfloat16(), A, bm, cm, chunk=32)
    with pytest.raises(ValueError, match="S % chunk"):
        ssd.ssd_scan(x, dt, A, bm, cm, chunk=48)
    wide = torch.ones((1, 64, 200), device=cuda)
    with pytest.raises(ValueError, match="N"):
        ssd.ssd_scan(x, dt, A, wide, wide, chunk=32)
    strided = torch.ones((1, 4, 64), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x, dt, A, strided, strided, chunk=32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_refuse_inputs_that_require_grad(cuda, dtype):
    """The flash, SSD and FedAvg kernels have no backward (nor have the
    reference's Pallas kernels): on CUDA inputs that require grad they
    raise, where a result with no ``grad_fn`` would drop the inputs'
    gradients without a word. Under ``torch.no_grad()`` they launch."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=gen, device=cuda, dtype=dtype)
    kv = torch.randn((1, 64, 2, 64), generator=gen, device=cuda, dtype=dtype)
    for grad_on in range(3):
        args = [t.clone().requires_grad_(i == grad_on)
                for i, t in enumerate((q, kv, kv))]
        before = fa.KERNEL.launches
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention(*args)
        assert fa.KERNEL.launches == before
        with torch.no_grad():
            fa.flash_attention(*args)
        assert fa.KERNEL.launches == before + 1
    x, dt, A, bm, cm = _ssd_inputs(1, 64, 2, 8, 4, cuda, 0)
    for i in range(5):
        args = [t.clone().requires_grad_(j == i)
                for j, t in enumerate((x, dt, A, bm, cm))]
        with pytest.raises(RuntimeError, match="no backward"):
            ssd.ssd_scan(*args, chunk=32)
        with torch.no_grad():
            ssd.ssd_scan(*args, chunk=32)
    stacked = torch.ones((3, 16), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fr.fedavg_reduce(stacked, torch.ones(3, device=cuda))
    torch.cuda.synchronize()

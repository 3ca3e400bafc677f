"""The references against the program's CPU path at each configuration's
smoke size, and the benchmark's weights in the program's layout."""
import dataclasses
import math

import pytest
import torch

from portbench import check, program, weights
from portbench.tests import small

CONFIGS = ["danube-prefill-7680", "mamba2-score-2048"]


def _setup(name, dtype):
    c, s = small.cell(name)
    s = {**s, "param_dtype": dtype}
    model, _ = program.build(c.config, s)
    ref = check.reference(c.config)
    params, _ = weights.make(ref.param_spec(s), 5, "cpu")
    tokens = torch.randint(0, s["vocab_size"], (2, small.PROMPT_LEN),
                           generator=torch.Generator().manual_seed(3))
    return c, s, model, ref, params, tokens


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_matches_program_init(name):
    c, s = small.cell(name)
    model, _ = program.build(c.config, s)
    ref = check.reference(c.config)
    ours, count = weights.make(ref.param_spec(s), 1, "cpu")
    theirs = model.init(torch.Generator().manual_seed(0))

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tuple(tree.shape), tree.dtype

    assert sorted(leaves(ours)) == sorted(leaves(theirs))
    assert count == sum(math.prod(shape) for _, shape, _ in leaves(theirs))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_program_fp32(name):
    """In fp32 the program's CPU path (the kernels' plain versions) and the
    reference compute the same function: logits agree to rounding."""
    c, s, model, ref, params, tokens = _setup(name, "float32")
    with torch.inference_mode():
        if c.traffic["kind"] == "first_token":
            got, _, cache = model.forward(params, {"tokens": tokens},
                                          return_cache=True, last_only=True)
            kv = []
            want = ref.forward(s, params, tokens,
                               on_kv=lambda i, k, v: kv.append((k, v)))
            got = got[:, -1, :s["vocab_size"]]
            for i, (k, v) in enumerate(kv):
                torch.testing.assert_close(cache["blocks"][0][i], k,
                                           rtol=1e-4, atol=1e-4)
                torch.testing.assert_close(cache["blocks"][1][i], v,
                                           rtol=1e-4, atol=1e-4)
        else:
            got, _ = model.forward(params, {"tokens": tokens})
            got = got[..., :s["vocab_size"]]
            want = ref.forward(s, params, tokens)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_ssd_reference_is_the_recurrence():
    """The chunked scan equals the step-by-step recurrence h_t = exp(dt_t
    A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t."""
    from portbench.reference.mamba2_lm import ssd

    g = torch.Generator().manual_seed(0)
    B, S, H, P, N, Q = 2, 48, 3, 4, 5, 16
    x = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(B, S, H, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    Bm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    h = torch.zeros(B, H, N, P, dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[:, :, None, None] + torch.einsum(
            "bn,bhp,bh->bhnp", Bm[:, t], x[:, t], dt[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
    want = torch.stack(ys, 1)
    got = ssd(x.float(), dt.float(), A.float(), Bm.float(), Cm.float(), Q)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)


def test_attention_reference_window():
    """The blockwise windowed attention equals the dense masked softmax."""
    from portbench.reference import gqa_lm

    g = torch.Generator().manual_seed(1)
    B, S, Hq, Hkv, hd, W = 2, 1100, 4, 2, 8, 300
    q = torch.randn(B, S, Hq, hd, generator=g)
    k = torch.randn(B, S, Hkv, hd, generator=g)
    v = torch.randn(B, S, Hkv, hd, generator=g)
    got = gqa_lm.attention(q, k, v, W)
    kk = k.repeat_interleave(Hq // Hkv, dim=2)
    vv = v.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / hd ** 0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill(~((j <= i) & (j > i - W)), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_program_sizes_must_agree():
    c, s = small.cell("danube-prefill-7680")
    with pytest.raises(ValueError, match="differs"):
        program.build(c.config, {**s, "vocab_padded": s["vocab_padded"] + 1})
    assert dataclasses.is_dataclass(c)

"""Rematerialisation in the port's training path, on the CPU: ``cfg.remat``
(one block, one encoder or decoder layer, checkpointed at a time, as the
reference's ``jax.checkpoint(body)``) and the chunked attention's
checkpointed q blocks (the reference's ``jax.checkpoint`` on
``_q_block_inner``).

Remat on and off compute the same function: loss and gradients are held
bit for bit (the recomputed forward repeats the same CPU arithmetic). The
chunked attention's gradients are held to the plain attention's (rtol
1e-5, atol 1e-6) and the reference's chunked attention's (rtol 1e-4, atol
1e-5: two frameworks' fp32 orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from torch_train_helpers import (GRAD_TOL, batch_for, port_loss_and_grads,
                                 saved_shapes, smoke, tbatch)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-9b",
                                  "deepseek-v2-236b", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_remat_on_equals_remat_off(arch):
    """Uniform, pair_lg, the dense prologue, the jamba8 hybrid and the
    encoder-decoder: the same loss and gradients with remat on, and the
    outer graph keeps fewer tensors for the backward."""
    jcfg, tcfg, _, tp = smoke(arch)
    b = tbatch(batch_for(jcfg))
    runs = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(tcfg, remat=remat))
        (loss, grads), shapes = saved_shapes(
            lambda: port_loss_and_grads(lambda p: model.loss(p, b), tp))
        runs[remat] = loss, grads, len(shapes)
    (l0, g0, n0), (l1, g1, n1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))
    assert n1 < n0 / 2, (n1, n0)


ATTN_CASES = [  # (Sq, Hq, Hkv, hd, causal, window, softcap)
    (100, 4, 2, 16, True, 0, None),
    (96, 4, 1, 8, True, 40, 20.0),
    (70, 2, 2, 16, False, 0, None),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_chunked_attention_gradients_through_checkpointed_q_blocks(case):
    """Under autograd each q block is checkpointed: its gradients equal the
    plain attention's and the reference's chunked attention's, and the
    backward keeps no (q, k) block's fp32 score tile."""
    S, Hq, Hkv, hd, causal, window, cap = case
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((2, S, h, hd), dtype=np.float32)
               for h in (Hq, Hkv, Hkv))
    ct = rng.standard_normal((2, S, Hq, hd), dtype=np.float32)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    blocks = dict(block_q=32, block_k=32)

    def port(fn, **extra):
        args = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out, shapes = saved_shapes(lambda: fn(*args, **kw, **extra))
        grads = torch.autograd.grad(out, args, torch.tensor(ct))
        return out.detach(), grads, shapes

    out, grads, shapes = port(TL.attention_chunked, **blocks)
    ref_out, ref_grads, _ = port(TL.attention_reference)
    tile = (2, Hkv, Hq // Hkv, 32, 32)
    assert tile not in shapes
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-6)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)

    def jfn(qq, kk, vv):
        return jnp.sum(JL.attention_chunked(qq, kk, vv, **kw, **blocks)
                       * jnp.asarray(ct))

    jg = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_chunked_attention_without_grad_takes_no_checkpoint():
    """The serving path (no grad) runs the loop as it was: same output as
    under autograd."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 80, 2, 8),
                                                dtype=np.float32))
               for _ in range(3))
    with torch.no_grad():
        plain = TL.attention_chunked(q, k, v, block_q=32, block_k=32)
    got = TL.attention_chunked(q.requires_grad_(), k, v, block_q=32,
                               block_k=32)
    assert got.grad_fn is not None
    assert torch.equal(got.detach(), plain)

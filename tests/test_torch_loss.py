"""The training objective of the port (``transformer.loss_fn`` /
``chunked_xent``, ``encdec.loss_fn``, ``Model.loss``) against the
reference's, on the CPU, for every registered architecture at its smoke
config (fp32).

Parameters are the reference's smoke init with biases and norm scales drawn
off their 0 / 1 inits (``torch_lm_helpers.perturbed``), carried over by
``bridge.lm_params_from_numpy``; inputs are numpy draws from a seed.
Gradients: ``torch.autograd.grad`` over the parameter leaves against
``jax.grad``. Tolerances: loss rtol 1e-5; gradients rtol 1e-4, atol 1e-5
(two frameworks' fp32 matmul and transcendental orders through a backward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from torch_train_helpers import (ARCHS, LOSS_TOL, B, S, assert_grads_close,
                                 batch_for, jbatch, port_loss_and_grads,
                                 saved_shapes, smoke, tbatch)

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``Model.loss`` (``loss_fn``: the shifted-token labels, or the vision
    stub's ``labels``; the MoE aux term) and its gradients, both
    assemblies."""
    jcfg, tcfg, jp, tp = smoke(arch)
    b = batch_for(jcfg)
    want, jg = jax.value_and_grad(JM.build_model(jcfg).loss)(
        jax.tree_util.tree_map(jnp.asarray, jp), jbatch(b))
    got, grads = port_loss_and_grads(
        lambda p: build_model(tcfg).loss(p, tbatch(b)), tp)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert_grads_close(grads, jg)


@pytest.mark.parametrize("arch,chunk", [("h2o-danube-1.8b", 24),
                                        ("gemma2-9b", 24),
                                        ("command-r-plus-104b", 64),
                                        ("seamless-m4t-large-v2", 40)])
def test_chunked_xent_ragged_chunks_and_masked_labels(arch, chunk):
    """``chunked_xent`` with S = 64 not a multiple of the chunk (the last
    chunk padded with label -1), labels -1 and labels in [vocab_size,
    vocab_padded) and past it (masked; the index clipped), gemma's final
    soft-cap, command-r's tied head: loss and gradients over the head and
    the hidden states."""
    jcfg, tcfg, jp, tp = smoke(arch)
    # 500 real tokens in the 512-row padded vocabulary
    jcfg, tcfg = (dataclasses.replace(c, vocab_size=500) for c in (jcfg, tcfg))
    assert tcfg.vocab_padded == 512
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    labels = rng.integers(0, 500, (B, S))
    labels[0, :7] = -1
    labels[1, 3] = 505   # in the padding: masked
    labels[1, 9] = 4000  # past the padded vocab: clipped, masked
    head = "embed" if jcfg.tie_embeddings else "lm_head"

    def jloss(h, xx):
        return JT.chunked_xent(jcfg, {head: h}, xx, jnp.asarray(labels),
                               chunk=chunk)

    want, (jgh, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(jp[head]), jnp.asarray(x))
    got, (gh, gx) = port_loss_and_grads(
        lambda p: TT.chunked_xent(tcfg, {head: p[0]}, p[1],
                                  torch.tensor(labels), chunk=chunk),
        [tp[head], torch.tensor(x)])
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert_grads_close([gh, gx], [jgh, jgx])


def test_chunked_xent_of_only_masked_labels_is_zero():
    """No label in range: the mean over max(count, 1) is 0, not NaN."""
    _, tcfg, _, tp = smoke("h2o-danube-1.8b")
    x = torch.randn((B, 8, tcfg.d_model))
    labels = torch.full((B, 8), -1)
    assert float(TT.chunked_xent(tcfg, tp, x, labels)) == 0.0


def test_chunked_xent_keeps_no_logits_for_the_backward():
    """Each chunk is checkpointed (the reference's ``jax.checkpoint``): the
    backward keeps no chunk's (B, chunk, V) fp32 logits or log-softmax,
    which the plain loop keeps for every chunk."""
    _, tcfg, _, tp = smoke("h2o-danube-1.8b")
    x = torch.randn((B, 256, tcfg.d_model), requires_grad=True)
    labels = torch.randint(0, tcfg.vocab_size, (B, 256))
    head = tp["lm_head"].clone().requires_grad_()
    logits_shape = (B, 32, tcfg.vocab_padded)
    loss, shapes = saved_shapes(
        lambda: TT.chunked_xent(tcfg, {"lm_head": head}, x, labels, chunk=32))
    assert logits_shape not in shapes
    _, plain = saved_shapes(lambda: TT._xent_chunk(
        tcfg, head, x[:, :32], labels[:, :32]))
    assert logits_shape in plain  # what the checkpoint spares
    loss.backward()
    assert x.grad is not None and head.grad is not None

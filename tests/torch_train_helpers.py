"""Shared helpers of the training-path parity tests
(``tests/test_torch_{loss,remat,steps,train}.py``): every registered
architecture's smoke parameters (the reference's init with biases and norm
scales drawn off their 0 / 1 inits, carried over by
``bridge.lm_params_from_numpy``), train batches made with numpy from a
seed, the port's loss and gradients over every parameter leaf, and the
shapes autograd keeps for a backward."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
from torch_lm_helpers import perturbed

ARCHS = tuple(sorted(jconfigs.ARCH_NAMES))
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 64  # S a multiple of the SSM chunk (32), under the xent chunk


@functools.lru_cache(maxsize=None)
def smoke(arch: str):
    """(reference cfg, port cfg, reference params as numpy, port params)."""
    cfg = jconfigs.get_smoke_config(arch)
    params = perturbed(jax.tree_util.tree_map(
        np.asarray, JM.build_model(cfg).init(jax.random.PRNGKey(0))),
        np.random.default_rng(7))
    return (cfg, tconfigs.get_smoke_config(arch), params,
            bridge.lm_params_from_numpy(params, "cpu"))


def batch_for(cfg, seed: int = 1, s: int = S):
    """numpy inputs: tokens; the vision stub's embeds, M-RoPE positions
    whose axes differ and labels (with -1 and out-of-vocab entries); the
    encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s))
    if cfg.modality == "vision_stub":
        labels = tokens.copy()
        labels[:, -3:] = -1
        labels[0, 5] = cfg.vocab_size + 3
        pos = np.stack([np.arange(s), np.arange(s) // 4, np.arange(s) % 4],
                       -1)
        return {"embeds": rng.standard_normal((B, s, cfg.d_model),
                                              dtype=np.float32),
                "positions": np.broadcast_to(pos, (B, s, 3)).copy(),
                "labels": labels}
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal((B, max(s // 4, 8), cfg.d_model),
                                              dtype=np.float32),
                "tokens": tokens}
    return {"tokens": tokens}


def jbatch(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else
                           jnp.float32) for k, v in b.items()}


def tbatch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def port_loss_and_grads(fn, params):
    """``fn(params)`` and its gradient over every leaf (zeros for a leaf it
    does not reach, as ``jax.grad`` gives)."""
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss = fn(tree_unflatten_like(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def assert_grads_close(got, want_tree):
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)



def saved_shapes(fn):
    """``fn()`` and the shapes of the tensors autograd keeps for its
    backward in the outer graph (a checkpoint keeps its inputs there, and
    recomputes the rest)."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes

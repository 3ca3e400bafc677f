"""The six decoder-only families of ROADMAP A11.1-A11.5 against the
reference, on the CPU: qwen1.5-4b (QKV bias), command-r-plus-104b (tied
embeddings), gemma2-9b (local/global pairs, ``1 + scale`` norms, gelu,
soft-caps), mixtral-8x22b (MoE, window), deepseek-v2-236b (MLA, shared
experts, the dense prologue) and jamba-1.5-large-398b (mamba + attention
hybrid, MoE every other layer).

Per architecture, at its smoke config (2 layers, d 256, fp32): the configs,
the parameter and cache layouts, and the prefill forward's logits, MoE aux
loss and cache, the port with ``use_pallas=True`` (its kernel wrappers run
their plain versions on CPU tensors) against the reference on its plain
attention and SSD path. The reference's parameters are carried over through
``bridge.lm_params_from_numpy`` with biases and norm scales drawn off their
inits (``torch_lm_helpers.perturbed``). Inputs are made with numpy from a
seed. Tolerance: rtol = atol = 1e-4 on fp32 logits (two frameworks' fp32
matmul and transcendental orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from torch_lm_helpers import ARCHS, close, flat, smoke

B, S = 2, 96  # longer than the smoke window (64), 3 SSM chunks of 32


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get in ("get_arch_config", "get_smoke_config"):
        port = getattr(tconfigs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(want)
        assert port.param_count() == want.param_count()
    full = tconfigs.get_arch_config(arch)
    assert TT.block_layout(full) == JT.block_layout(
        jconfigs.get_arch_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_layout_match_reference(arch):
    """Keys, shapes and dtypes of a bf16 smoke model and of its cache: the
    MoE router stays fp32, mamba's A_log, D and dt_bias too, and the
    cache's ssm state; gemma's norm scales start at zero."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               param_dtype="bfloat16")
    want = dict(flat(jax.eval_shape(
        functools.partial(JT.init_params, jcfg), jax.random.PRNGKey(0))))
    got = dict(flat(TT.init_params(tcfg, torch.Generator().manual_seed(0))))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype) == f"torch.{want[name].dtype}", name
        if name.split("/")[-1] in ("norm_scale", "post_norm_scale",
                                   "final_norm_scale"):
            fill = 0.0 if arch.startswith("gemma") else 1.0
            assert bool((leaf == fill).all()), name
    want_cache = dict(flat(JT.init_cache(jcfg, 3, 10)))
    got_cache = dict(flat(TT.init_cache(tcfg, 3, 10)))
    assert sorted(got_cache) == sorted(want_cache)
    for name, leaf in got_cache.items():
        assert tuple(leaf.shape) == want_cache[name].shape, name
        assert str(leaf.dtype) == f"torch.{want_cache[name].dtype}", name
        assert not leaf.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_forward_matches_reference(arch):
    """All logits, the aux loss, the cache (its structure and values), the
    last position alone, and the hidden states."""
    jcfg, tcfg, jparams, tparams = smoke(arch)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    want, waux, wcache = JT.forward(jcfg, jparams, jbatch, return_cache=True)
    model = build_model(tcfg, use_pallas=True)
    got, aux, gcache = model.forward(tparams, tbatch, return_cache=True)
    assert got.shape == (B, S, jcfg.vocab_padded)
    close(got, want)
    close(torch.as_tensor(aux), waux)
    if jcfg.n_experts:
        assert float(waux) > 0.5  # E * sum(me * ce) is ~1 per MoE layer
    else:
        assert aux == 0.0
    wc, gc = dict(flat(wcache)), dict(flat(gcache))
    assert sorted(gc) == sorted(wc), (sorted(gc), sorted(wc))
    for name, leaf in gc.items():
        assert tuple(leaf.shape) == wc[name].shape, name
        close(leaf, wc[name])
    last, _ = model.forward(tparams, tbatch, last_only=True)
    close(last, np.asarray(want)[:, -1:])
    hidden, haux = TT.forward_hidden(tcfg, tparams, tbatch)
    whidden, _ = JT.forward_hidden(jcfg, jparams, jbatch)
    close(hidden, whidden)
    close(torch.as_tensor(haux), waux)

"""The port's mamba2 against the reference, on the CPU.

mamba2's smoke config (2 layers, d_model 256, d_inner 512, 16 SSM heads of
P=32, N=16, chunk 32, fp32) with the reference's ``init_params`` carried
over through ``bridge.lm_params_from_numpy`` (the fp32 leaves ``A_log``,
``D``, ``dt_bias`` stay fp32): the config, the parameter layout, one mamba
layer and the whole forward with ``use_pallas=True`` (the reference's Pallas
SSD kernel in interpret mode; the port's wrapper runs its plain version on
CPU tensors), the recurrent decode, and the serve CLI's SSM branch (prefill
by stepping ``decode_step``) against the reference's stepped loop. Inputs
are made with numpy from a seed. Tolerance: rtol = atol = 1e-4 on fp32
outputs, logits and states, as the LM tests of ``tests/test_torch_lm.py``
(two frameworks' fp32 matmul and transcendental orders).
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as TT

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")

ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 64


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def smoke():
    cfg = jconfigs.get_smoke_config(ARCH)
    params_np = jax.tree_util.tree_map(
        np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))
    # move D, dt_bias and the norm scales off their 1 / 0 inits, so that a
    # mixed-up leaf shows
    rng = np.random.default_rng(11)
    for name in ("D", "dt_bias", "conv_b", "gate_norm_scale", "norm_scale"):
        leaf = params_np["blocks"]["mixer"][name]
        params_np["blocks"]["mixer"][name] = (
            leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    return {"cfg": cfg, "tcfg": tconfigs.get_smoke_config(ARCH),
            "jparams": params_np,
            "tparams": bridge.lm_params_from_numpy(params_np, "cpu"),
            "tokens": tokens}


def test_configs_match_reference():
    for get in ("get_arch_config", "get_smoke_config"):
        port = getattr(tconfigs, get)(ARCH)
        want = getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(port) == dataclasses.asdict(want)
        assert port.param_count() == want.param_count()
    full = tconfigs.get_arch_config(ARCH)
    assert abs(full.param_count() - 2.83e9) < 0.01e9
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_heads,
            full.ssm_head_dim, full.ssm_state, full.ssm_conv, full.ssm_chunk,
            full.vocab_padded) == (64, 2560, 5120, 80, 64, 128, 4, 256, 50304)
    smoke = tconfigs.get_smoke_config(ARCH)
    assert smoke.n_layers == 2 and smoke.d_model <= 512
    assert (smoke.ssm_state, smoke.ssm_head_dim, smoke.ssm_chunk,
            smoke.param_dtype) == (16, 32, 32, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_reference(dtype):
    """Keys, shapes and dtypes, with A_log, D and dt_bias fp32 in a bf16
    model; the cache's as well (its ssm state fp32)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               param_dtype=dtype)
    want = dict(_flat(jax.eval_shape(
        functools.partial(JT.init_params, jcfg), jax.random.PRNGKey(0))))
    got = dict(_flat(TT.init_params(tcfg, torch.Generator().manual_seed(0))))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype) == f"torch.{want[name].dtype}", name
    for name in ("A_log", "D", "dt_bias"):
        assert got[f"blocks/mixer/{name}"].dtype == torch.float32
    np.testing.assert_allclose(got["blocks/mixer/A_log"][0].numpy(),
                               np.log(np.linspace(1, 16, jcfg.ssm_heads)),
                               rtol=1e-6)
    want_cache = dict(_flat(JT.init_cache(jcfg, 3, 10)))
    got_cache = dict(_flat(TT.init_cache(tcfg, 3, 10)))
    assert sorted(got_cache) == sorted(want_cache) == ["blocks/conv",
                                                       "blocks/ssm"]
    for name, leaf in got_cache.items():
        assert tuple(leaf.shape) == want_cache[name].shape, name
        assert str(leaf.dtype) == f"torch.{want_cache[name].dtype}", name
        assert not leaf.any()


def test_bridge_keeps_fp32_leaves_of_a_bf16_tree():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               param_dtype="bfloat16")
    p = jax.tree_util.tree_map(np.asarray,
                               JM.mamba_init(jcfg, jax.random.PRNGKey(4),
                                             jnp.bfloat16))
    got = bridge.lm_params_from_numpy(p, "cpu")
    for name, leaf in got.items():
        want = torch.float32 if name in ("A_log", "D", "dt_bias") else \
            torch.bfloat16
        assert leaf.dtype == want, name
    np.testing.assert_array_equal(got["A_log"].numpy(), p["A_log"])


def test_mamba_forward_matches_reference(smoke):
    """One mamba layer, the SSD through the kernels (use_pallas=True) and
    through the plain versions."""
    cfg, p = smoke["cfg"], smoke["jparams"]["blocks"]["mixer"]
    tp = {k: v[0] for k, v in smoke["tparams"]["blocks"]["mixer"].items()}
    jp = {k: v[0] for k, v in p.items()}
    u = np.random.default_rng(5).standard_normal((B, S, cfg.d_model),
                                                 dtype=np.float32)
    for use_pallas in (True, False):
        want = JM.mamba_forward(cfg, jp, jnp.asarray(u), use_pallas=use_pallas)
        before = ssd.KERNEL.launches
        got = TM.mamba_forward(smoke["tcfg"], tp, _t(u), use_pallas=use_pallas)
        assert ssd.KERNEL.launches == before  # CPU: the plain version
        _close(got, want)


def test_forward_matches_reference(smoke):
    """The whole model at B=2, S=64 (two chunks of 32): all logits, the
    last position's, the (absent) cache and the hidden states."""
    cfg, tokens = smoke["cfg"], smoke["tokens"]
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    want, _, wcache = JT.forward(cfg, smoke["jparams"], jbatch,
                                 return_cache=True, use_pallas=True)
    model = build_model(smoke["tcfg"], use_pallas=True)
    got, aux, gcache = model.forward(smoke["tparams"], tbatch,
                                     return_cache=True)
    assert aux == 0.0 and got.shape == (B, S, cfg.vocab_padded)
    assert wcache == {"blocks": None} and gcache == {"blocks": None}
    _close(got, want)
    last, _ = model.forward(smoke["tparams"], tbatch, last_only=True)
    _close(last, np.asarray(want)[:, -1:])
    plain, _ = build_model(smoke["tcfg"]).forward(smoke["tparams"], tbatch)
    _close(plain, want)
    hidden, _ = TT.forward_hidden(smoke["tcfg"], smoke["tparams"], tbatch,
                                  use_pallas=True)
    whidden, _ = JT.forward_hidden(cfg, smoke["jparams"], jbatch,
                                   use_pallas=True)
    _close(hidden, whidden)


@pytest.mark.parametrize("pos", [0, 37])
def test_decode_step_matches_reference(smoke, pos):
    """One recurrent step of the model: from a zero state at pos 0, from a
    random state at pos 37. The port writes the new state in place."""
    cfg = smoke["cfg"]
    rng = np.random.default_rng(pos + 1)
    jcache = JT.init_cache(cfg, B, 8)
    if pos:
        jcache = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.5,
                                  a.dtype), jcache)
    tok = rng.integers(0, cfg.vocab_size, (B, 1))
    tcache = {"blocks": {k: _t(v) for k, v in jcache["blocks"].items()}}
    want, wcache = JT.decode_step(cfg, smoke["jparams"], jcache,
                                  {"token": jnp.asarray(tok, jnp.int32)},
                                  jnp.int32(pos))
    got, gcache = TT.decode_step(smoke["tcfg"], smoke["tparams"], tcache,
                                 {"token": torch.from_numpy(tok)}, pos)
    assert gcache is tcache
    _close(got, want)
    for name in ("conv", "ssm"):
        _close(gcache["blocks"][name], wcache["blocks"][name])


def test_serve_ssm_branch_matches_reference(smoke):
    """``serve.generate`` on mamba2 (prefill by stepping ``decode_step``
    over the prompt, then greedy decoding) against the reference serve's
    SSM loop, composed here from its ``decode_step``: identical tokens,
    logits at 1e-4, every step's top-2 gap wider than the tolerance."""
    cfg, params = smoke["cfg"], smoke["jparams"]
    P, G = 16, 6
    prompts = smoke["tokens"][:, :P]
    decode = jax.jit(functools.partial(JT.decode_step, cfg))
    cache = JT.init_cache(cfg, B, P + G)
    for t in range(P):
        logits, cache = decode(params, cache,
                               {"token": jnp.asarray(prompts[:, t:t + 1],
                                                     jnp.int32)},
                               jnp.int32(t))
    toks = [jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]]
    steps = [logits[:, -1]]
    for t in range(P, P + G - 1):
        logits, cache = decode(params, cache, {"token": toks[-1]},
                               jnp.int32(t))
        toks.append(jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None])
        steps.append(logits[:, -1])
    want_tokens = np.asarray(jnp.concatenate(toks, 1))
    want_logits = np.asarray(jnp.stack(steps, 1))

    model = build_model(smoke["tcfg"], use_pallas=True)
    got = serve.generate(model, smoke["tparams"], torch.from_numpy(prompts), G)
    assert got["flash_launches"] == 0
    np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    _close(got["logits"], want_logits)
    top2 = np.sort(want_logits[..., :cfg.vocab_size], -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert (gap > 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[..., 1]))).all()


def test_serve_cli_ssm_on_cpu(capsys):
    before = ssd.KERNEL.launches
    res = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "12",
                      "--gen", "3", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3) and ssd.KERNEL.launches == before
    assert torch.isfinite(res["logits"]).all()
    assert "mamba2-2.7b-smoke on cpu: prefill 12 tokens x 2 seqs" in \
        capsys.readouterr().out

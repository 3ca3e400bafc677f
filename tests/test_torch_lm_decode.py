"""Decoding the six decoder-only families of ROADMAP A11.1-A11.5 against the
reference, on the CPU, at their smoke configs (2 layers, d 256, fp32) with
the reference's parameters (biases and norm scales drawn off their inits,
``torch_lm_helpers.smoke``).

* ``decode_step`` from a zero cache at every position of a 16-token prompt:
  each step's logits against the reference's step at rtol = atol = 1e-4,
  and against the prefill forward's logits at that position at 5e-4
  (``tests/test_archs.py``'s decode-vs-forward tolerance); the final cache,
  in the reference's structure, against the reference's.
* ``serve.generate``: a 40-token prompt and 6 greedy tokens. An attention
  model's prefill cache is placed into the decode cache (gemma2's
  ``{"local", "global"}``, MLA's ``{"ckv", "krope"}``, deepseek's
  ``prologue``); the reference's own ``repro.launch.serve`` crashes there
  (ROADMAP C2), so its loop is composed here from ``forward`` and
  ``decode_step`` with the same placement. jamba, a hybrid, steps
  ``decode_step`` over the prompt in both. Same tokens, logits at 1e-4.
* The serving CLI on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from torch_lm_helpers import ARCHS, DECODE_TOL, close, flat, smoke

B, P = 2, 16


@functools.lru_cache(maxsize=None)
def _jit_decode(arch):
    return jax.jit(functools.partial(JT.decode_step, smoke(arch)[0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    jcfg, tcfg, jparams, tparams = smoke(arch)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, P))
    full, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    decode = _jit_decode(arch)
    jcache = JT.init_cache(jcfg, B, P)
    tcache = TT.init_cache(tcfg, B, P)
    for pos in range(P):
        tok = tokens[:, pos:pos + 1]
        want, jcache = decode(jparams, jcache,
                              {"token": jnp.asarray(tok, jnp.int32)},
                              jnp.int32(pos))
        got, out = TT.decode_step(tcfg, tparams, tcache,
                                  {"token": torch.from_numpy(tok)}, pos)
        assert out is tcache  # written in place
        close(got, want)
        close(got[:, 0], np.asarray(full)[:, pos], **DECODE_TOL)
    wc, gc = dict(flat(jcache)), dict(flat(tcache))
    assert sorted(gc) == sorted(wc)
    for name, leaf in gc.items():
        close(leaf, wc[name])


def _ref_place(cache, entry, axis):
    """The port's ``serve.place_prefill`` on the reference's numpy trees."""
    if isinstance(entry, dict):
        for name, sub in entry.items():
            _ref_place(cache[name], sub, axis)
        return
    names = ("ckv", "krope") if "ckv" in cache else ("k", "v")
    for name, a in zip(names, entry):
        index = [slice(None)] * cache[name].ndim
        index[axis] = slice(0, a.shape[axis])
        cache[name][tuple(index)] = np.asarray(a)


def _ref_generate(arch, prompts, gen):
    jcfg, _, jparams, _ = smoke(arch)
    Bn, Pn = prompts.shape
    decode = _jit_decode(arch)
    cache = JT.init_cache(jcfg, Bn, Pn + gen)
    if serve.steps_prefill(jcfg):
        for t in range(Pn):
            logits, cache = decode(jparams, cache, {"token": jnp.asarray(
                prompts[:, t:t + 1], jnp.int32)}, jnp.int32(t))
    else:
        logits, _, pc = JT.forward(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompts, jnp.int32)},
                                   return_cache=True, last_only=True)
        cache = jax.tree_util.tree_map(np.array, cache)
        _ref_place(cache["blocks"], pc["blocks"], 2)
        if "prologue" in pc:
            _ref_place(cache["prologue"], pc["prologue"], 1)
        cache = jax.tree_util.tree_map(jnp.asarray, cache)
    toks = [jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None]]
    steps = [logits[:, -1]]
    for t in range(Pn, Pn + gen - 1):
        logits, cache = decode(jparams, cache, {"token": toks[-1]},
                               jnp.int32(t))
        toks.append(jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None])
        steps.append(logits[:, -1])
    return np.asarray(jnp.concatenate(toks, 1)), np.asarray(jnp.stack(steps, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_reference(arch):
    _, tcfg, _, tparams = smoke(arch)
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, 40))
    want_tokens, want_logits = _ref_generate(arch, prompts, 6)
    got = serve.generate(build_model(tcfg, use_pallas=True), tparams,
                         torch.from_numpy(prompts), 6)
    assert got["flash_launches"] == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    close(got["logits"], want_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "20",
                      "--gen", "3", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3) and res["flash_launches"] == 0
    assert torch.isfinite(res["logits"]).all()
    assert torch.equal(res["logits"][..., :res["cfg"].vocab_size].argmax(-1),
                       res["tokens"])
    assert "prefill 20 tokens x 2 seqs" in capsys.readouterr().out

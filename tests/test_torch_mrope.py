"""qwen2-vl-7b's M-RoPE and vision stub (ROADMAP A11.6) against the
reference, on the CPU.

* ``layers.apply_mrope`` against ``repro.models.layers.apply_mrope`` at
  atol 1e-5, with the three position axes equal (the reference serve's
  law, where M-RoPE is RoPE) and with an image-grid layout in which they
  differ (text, then an h x w block of merged patches at one temporal
  index, then text, as arXiv:2409.12191 §2.1 lays them out), so that a
  mix-up of the sections would show.
* The smoke model (2 layers, d 256, 4/2 heads, hd 64, sections (8, 12,
  12), fp32) with the reference's parameters, QKV biases and norm scales
  drawn off their inits (``torch_lm_helpers.smoke``): ``forward({"embeds",
  "positions"})`` with its cache against the reference's plain path at
  rtol = atol = 1e-4, decode steps ``{"embed", "positions"}`` against the
  reference's at 1e-4 and against the forward at 5e-4
  (``tests/test_archs.py``), and ``serve.generate``'s vision stub against a
  reference loop from ``forward`` and ``decode_step`` fed the same draws.
* The serving CLI at the smoke config on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from torch_lm_helpers import DECODE_TOL, close, flat, smoke, t

ARCH = "qwen2-vl-7b"
B = 2


def image_layout(batch, n_text, h, w, n_after):
    """M-RoPE positions (batch, S, 3) of ``n_text`` text tokens, an ``h`` x
    ``w`` image block of merged patches, then ``n_after`` text tokens: text
    takes its index on all three axes; the block takes one temporal index
    (the next free one) and its row and column added to it on the height
    and width axes; text after it resumes past the largest id so far."""
    text = np.repeat(np.arange(n_text)[:, None], 3, 1)
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = np.stack([np.zeros(h * w, np.int64), rows.ravel(), cols.ravel()],
                   1) + n_text
    start = img.max() + 1
    after = np.repeat(start + np.arange(n_after)[:, None], 3, 1)
    pos = np.concatenate([text, img, after]).astype(np.int32)
    return np.broadcast_to(pos, (batch, *pos.shape)).copy()


def equal_layout(batch, length):
    pos = np.repeat(np.arange(length)[:, None], 3, 1).astype(np.int32)
    return np.broadcast_to(pos, (batch, length, 3)).copy()


LAYOUTS = {"equal": lambda: equal_layout(B, 24),
           "image": lambda: image_layout(B, 5, 3, 4, 7)}  # 24 positions


def test_config_matches_reference():
    for get in ("get_arch_config", "get_smoke_config"):
        port = getattr(tconfigs, get)(ARCH)
        ref = getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert sum(port.mrope_sections) == port.head_dim // 2


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("theta,sections,hd", [(1e6, (8, 12, 12), 64),
                                               (1e6, (16, 24, 24), 128),
                                               (1e4, (2, 3, 3), 16)])
def test_apply_mrope_matches_reference(layout, theta, sections, hd):
    pos = LAYOUTS[layout]()
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, pos.shape[1], 3, hd), dtype=np.float32)
    got = TL.apply_mrope(t(x), torch.from_numpy(pos), theta, sections)
    close(got, JL.apply_mrope(x, jnp.asarray(pos), theta, sections),
          rtol=1e-5, atol=1e-5)
    rope = TL.apply_rope(t(x), torch.from_numpy(pos[..., 0]), theta)
    assert torch.allclose(got, rope, atol=1e-5) == (layout == "equal")


def test_apply_mrope_refuses_sections_off_half_the_head_dim():
    with pytest.raises(ValueError, match="head_dim // 2"):
        TL.apply_mrope(torch.zeros(1, 2, 1, 64), torch.zeros(1, 2, 3), 1e6,
                       (8, 12, 8))


def _inputs(layout, seed=3):
    jcfg = smoke(ARCH)[0]
    pos = LAYOUTS[layout]()
    embeds = np.random.default_rng(seed).standard_normal(
        (B, pos.shape[1], jcfg.d_model), dtype=np.float32)
    return embeds, pos


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_matches_reference(layout):
    jcfg, tcfg, jparams, tparams = smoke(ARCH)
    embeds, pos = _inputs(layout)
    want, _, wcache = JT.forward(
        jcfg, jparams, {"embeds": jnp.asarray(embeds),
                        "positions": jnp.asarray(pos)}, return_cache=True)
    model = build_model(tcfg, use_pallas=True)
    batch = {"embeds": t(embeds), "positions": torch.from_numpy(pos)}
    got, aux, gcache = model.forward(tparams, batch, return_cache=True)
    assert aux == 0.0 and got.shape == (B, pos.shape[1], jcfg.vocab_padded)
    close(got, want)
    for (gp, g), (wp, w) in zip(flat(gcache), flat(wcache)):
        assert gp == wp and tuple(g.shape) == w.shape
        close(g, w)
    last, _ = model.forward(tparams, batch, last_only=True)
    close(last, np.asarray(want)[:, -1:])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_steps_match_reference_and_forward(layout):
    """Every position from a zero cache, each step ``{"embed",
    "positions"}``: against the reference's step at 1e-4 and the forward at
    that position at 5e-4; the final cache against the reference's."""
    jcfg, tcfg, jparams, tparams = smoke(ARCH)
    embeds, pos = _inputs(layout, seed=4)
    S = pos.shape[1]
    full, _ = TT.forward(tcfg, tparams, {"embeds": t(embeds),
                                         "positions": torch.from_numpy(pos)})
    jcache = JT.init_cache(jcfg, B, S)
    tcache = TT.init_cache(tcfg, B, S)
    for p in range(S):
        want, jcache = JT.decode_step(
            jcfg, jparams, jcache, {"embed": jnp.asarray(embeds[:, p:p + 1]),
                                    "positions": jnp.asarray(pos[:, p:p + 1])},
            jnp.int32(p))
        got, out = TT.decode_step(
            tcfg, tparams, tcache, {"embed": t(embeds[:, p:p + 1]),
                                    "positions": torch.from_numpy(
                                        pos[:, p:p + 1])}, p)
        assert out is tcache
        close(got, want)
        close(got[:, 0], full[:, p], **DECODE_TOL)
    for (gp, g), (wp, w) in zip(flat(tcache), flat(jcache)):
        assert gp == wp
        close(g, w)


def _reference_generate(jcfg, jparams, embeds, pos, step_embeds, gen):
    """The vision stub's serving loop on the reference: prefill forward,
    the cache placed into slots [0, P), then ``gen - 1`` decode steps with
    ``step_embeds`` at the next text positions after the prompt's
    largest."""
    P = pos.shape[1]
    logits, _, pc = JT.forward(jcfg, jparams, {"embeds": jnp.asarray(embeds),
                                               "positions": jnp.asarray(pos)},
                               return_cache=True, last_only=True)
    k, v = pc["blocks"]
    c = JT.init_cache(jcfg, B, P + gen)["blocks"]
    cache = {"blocks": {"k": c["k"].at[:, :, :P].set(k),
                        "v": c["v"].at[:, :, :P].set(v)}}
    shift = pos.max(axis=(1, 2)) + 1 - P
    toks = [jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None]]
    steps = [logits[:, -1]]
    for i, s in enumerate(range(P, P + gen - 1)):
        p3 = np.repeat((shift + s)[:, None, None], 3, 2).astype(np.int32)
        logits, cache = JT.decode_step(
            jcfg, jparams, cache, {"embed": jnp.asarray(step_embeds[i]),
                                   "positions": jnp.asarray(p3)},
            jnp.int32(s))
        toks.append(jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None])
        steps.append(logits[:, -1])
    return (np.asarray(jnp.concatenate(toks, 1)),
            np.asarray(jnp.stack(steps, 1)))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_generate_matches_reference_loop(layout):
    """``serve.generate`` on the vision stub against the reference loop on
    the same draws (the prompt embeddings from ``serve.random_prompts``, the
    decode steps' from numpy): same tokens, logits at 1e-4. With equal axes
    the decode positions are the reference serve's ``t``; with the image
    layout they resume past the image block."""
    jcfg, tcfg, jparams, tparams = smoke(ARCH)
    gen = 5
    pos = LAYOUTS[layout]()
    P = pos.shape[1]
    prompts = serve.random_prompts(tcfg, B, P, 11, "cpu")
    step_embeds = np.random.default_rng(12).standard_normal(
        (B, gen - 1, tcfg.d_model), dtype=np.float32)
    want_tokens, want_logits = _reference_generate(
        jcfg, jparams, prompts.numpy(), pos,
        [step_embeds[:, i:i + 1] for i in range(gen - 1)], gen)
    model = build_model(tcfg, use_pallas=True)
    got = serve.generate(model, tparams, prompts, gen,
                         positions=torch.from_numpy(pos),
                         step_embeds=t(step_embeds))
    assert got["flash_launches"] == 0 and got["decode_steps"] == gen - 1
    np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    close(got["logits"], want_logits)


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "20",
                      "--gen", "3", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3) and res["flash_launches"] == 0
    assert res["cfg"].modality == "vision_stub"
    assert torch.isfinite(res["logits"]).all()
    assert "prefill 20 tokens x 2 seqs" in capsys.readouterr().out

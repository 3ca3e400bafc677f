"""seamless-m4t-large-v2's encoder-decoder (ROADMAP A11.7) against the
reference, on the CPU, at its smoke config (2 encoder and 2 decoder layers,
d 256, 4 heads, hd 64, LayerNorm, fp32).

The reference's ``encdec.init_params`` comes over through
``bridge.lm_params_from_numpy`` with every LayerNorm scale and bias drawn
off its 1 / 0 init, so that a swapped leaf shows. Inputs are made with
numpy from a seed; the reference runs its plain attention path, the port
``use_pallas=True`` (on CPU tensors the flash wrapper runs its plain
version). Tolerances: rtol = atol = 1e-4 on fp32 logits, hidden states and
caches (two frameworks' fp32 matmul and transcendental orders), and 5e-4
for decode against the forward (``tests/test_archs.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import encdec as JE
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from torch_lm_helpers import DECODE_TOL, close, flat, perturbed, t

ARCH = "seamless-m4t-large-v2"
B, F, S = 2, 12, 20  # batch, encoder frames, decoder tokens


@functools.lru_cache(maxsize=None)
def _smoke():
    """(reference cfg, port cfg, reference params as numpy, port params)."""
    cfg = jconfigs.get_smoke_config(ARCH)
    params = perturbed(jax.tree_util.tree_map(
        np.asarray, JE.init_params(cfg, jax.random.PRNGKey(0))),
        np.random.default_rng(7))
    return (cfg, tconfigs.get_smoke_config(ARCH), params,
            bridge.lm_params_from_numpy(params, "cpu"))


@functools.lru_cache(maxsize=None)
def _inputs(seed=3):
    jcfg = _smoke()[0]
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, F, jcfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    return frames, tokens


def _jbatch(frames, tokens):
    return {"frames": jnp.asarray(frames),
            "tokens": jnp.asarray(tokens, jnp.int32)}


def _tbatch(frames, tokens):
    return {"frames": t(frames), "tokens": torch.from_numpy(tokens)}


def test_config_matches_reference():
    for get in ("get_arch_config", "get_smoke_config"):
        port = getattr(tconfigs, get)(ARCH)
        ref = getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    assert tconfigs.get_smoke_config(ARCH).n_enc_layers == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_reference(dtype):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                               param_dtype=dtype)
    want = dict(flat(jax.eval_shape(functools.partial(JE.init_params, jcfg),
                                    jax.random.PRNGKey(0))))
    got = dict(flat(TE.init_params(tcfg, torch.Generator().manual_seed(0))))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype) == f"torch.{want[name].dtype}", name
    assert (got["dec_blocks/xattn/norm_scale"] == 1).all()
    assert (got["enc_norm_bias"] == 0).all()
    # drawn at the reference's scale, 1 / sqrt(d_model)
    assert abs(float(got["enc_blocks/attn/wq"].float().std()) - 1 / 16) < 5e-3


def test_bridge_carries_the_encdec_tree():
    _, _, jparams, tparams = _smoke()
    got, want = dict(flat(tparams)), dict(flat(jparams))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[name])


def test_encode_and_cross_cache_match_reference():
    jcfg, tcfg, jparams, tparams = _smoke()
    frames, _ = _inputs()
    want = JE.encode(jcfg, jparams, jnp.asarray(frames))
    got = TE.encode(tcfg, tparams, t(frames), use_pallas=True)
    close(got, want)
    wcross = JE.prefill_cross_cache(jcfg, jparams, want)
    gcross = TE.prefill_cross_cache(tcfg, tparams, got)
    for name in ("k", "v"):
        assert tuple(gcross[name].shape) == wcross[name].shape == (
            jcfg.n_layers, B, F, jcfg.n_kv_heads, jcfg.head_dim)
        close(gcross[name], wcross[name])


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_reference(last_only):
    jcfg, tcfg, jparams, tparams = _smoke()
    frames, tokens = _inputs()
    want, waux = JE.forward(jcfg, jparams, _jbatch(frames, tokens),
                            last_only=last_only)
    model = build_model(tcfg, use_pallas=True)
    got, aux = model.forward(tparams, _tbatch(frames, tokens),
                             last_only=last_only)
    assert aux == waux == 0.0
    assert got.dtype == torch.float32
    assert got.shape == (B, 1 if last_only else S, jcfg.vocab_padded)
    close(got, want)
    hidden, _ = TE.forward_hidden(tcfg, tparams, _tbatch(frames, tokens))
    whidden, _ = JE.forward_hidden(jcfg, jparams, _jbatch(frames, tokens))
    close(hidden, whidden)


@pytest.mark.parametrize("enc_frames", [None, 9])
def test_init_cache_matches_reference(enc_frames):
    jcfg, tcfg = _smoke()[:2]
    want = JM.build_model(jcfg).init_cache(B, 40, enc_frames)
    got = build_model(tcfg).init_cache(B, 40, enc_frames)
    wflat, gflat = dict(flat(want)), dict(flat(got))
    assert sorted(gflat) == sorted(wflat) == [
        "cross/k", "cross/v", "self/k", "self/v"]
    for name, leaf in gflat.items():
        assert tuple(leaf.shape) == wflat[name].shape, name
        assert str(leaf.dtype) == f"torch.{wflat[name].dtype}", name
        assert not leaf.any()


def test_decode_steps_match_reference_and_forward():
    """Greedy-free decoding of the prompt's tokens from a zero self cache
    and the filled cross cache: each step's logits against the reference's
    step at 1e-4 and the forward at that position at 5e-4; the caches,
    leaf by leaf, against the reference's (the cross cache never
    written)."""
    jcfg, tcfg, jparams, tparams = _smoke()
    frames, tokens = _inputs(seed=4)
    full, _ = TE.forward(tcfg, tparams, _tbatch(frames, tokens))
    decode = jax.jit(functools.partial(JE.decode_step, jcfg))
    jcache = JE.init_cache(jcfg, B, S, F)
    jcache["cross"] = JE.prefill_cross_cache(
        jcfg, jparams, JE.encode(jcfg, jparams, jnp.asarray(frames)))
    model = build_model(tcfg, use_pallas=True)
    tcache = model.init_cache(B, S, F)
    tcache["cross"] = TE.prefill_cross_cache(
        tcfg, tparams, model.encode(tparams, t(frames)))
    cross = {k: v.clone() for k, v in tcache["cross"].items()}
    for pos in range(S):
        tok = tokens[:, pos:pos + 1]
        want, jcache = decode(jparams, jcache,
                              {"token": jnp.asarray(tok, jnp.int32)},
                              jnp.int32(pos))
        got, out = model.decode_step(tparams, tcache,
                                     {"token": torch.from_numpy(tok)}, pos)
        assert out is tcache  # written in place
        assert got.shape == (B, 1, jcfg.vocab_padded)
        close(got, want)
        close(got[:, 0], full[:, pos], **DECODE_TOL)
    gflat, wflat = dict(flat(tcache)), dict(flat(jcache))
    assert sorted(gflat) == sorted(wflat)
    for name, leaf in gflat.items():
        close(leaf, wflat[name])
    for name in ("k", "v"):
        assert torch.equal(tcache["cross"][name], cross[name])


def _reference_loop(jcfg, jparams, frames, steps):
    """The reference serve's audio-stub loop: encode, fill the cross cache,
    then ``steps`` greedy decode steps from BOS 0."""
    enc_out = JE.encode(jcfg, jparams, jnp.asarray(frames))
    cache = JE.init_cache(jcfg, frames.shape[0], steps + 1, enc_out.shape[1])
    cache["cross"] = JE.prefill_cross_cache(jcfg, jparams, enc_out)
    decode = jax.jit(functools.partial(JE.decode_step, jcfg))
    out = [jnp.zeros((frames.shape[0], 1), jnp.int32)]
    logits_t = []
    for i in range(steps):
        logits, cache = decode(jparams, cache, {"token": out[-1]},
                               jnp.int32(i))
        out.append(jnp.argmax(logits[:, -1, :jcfg.vocab_size], -1)[:, None]
                   .astype(jnp.int32))
        logits_t.append(logits[:, -1])
    return (np.asarray(jnp.concatenate(out[1:], 1)),
            np.asarray(jnp.stack(logits_t, 1)))


def test_generate_matches_reference_loop():
    """``serve.generate`` on the audio stub: 10 steps from BOS over the
    prompt's frames; same tokens, logits at 1e-4."""
    jcfg, tcfg, jparams, tparams = _smoke()
    frames, _ = _inputs(seed=5)
    want_tokens, want_logits = _reference_loop(jcfg, jparams, frames, 10)
    model = build_model(tcfg, use_pallas=True)
    got = serve.generate(model, tparams, t(frames), 10)
    assert got["flash_launches"] == 0 and got["decode_steps"] == 10
    np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    close(got["logits"], want_logits)


def test_serve_cli_matches_reference_loop(capsys):
    """The CLI at the smoke config (prompt length 36: 9 frames, 36 + 3 - 1
    = 38 decode steps, as the reference's serve), its random weights and
    frames carried to the reference loop: same tokens, logits at 1e-4."""
    argv = ["--arch", ARCH, "--batch", "2", "--prompt-len", "36", "--gen",
            "3", "--device", "cpu"]
    res = serve.main(argv)
    assert "encode 9 frames x 2 seqs" in capsys.readouterr().out
    assert res["tokens"].shape == (2, 38) and res["flash_launches"] == 0
    cfg = res["cfg"]
    _, params = serve.random_model(cfg, serve.SEED, "cpu")
    frames = serve.random_prompts(cfg, 2, 36, serve.SEED, "cpu")
    assert frames.shape == (2, 9, cfg.d_model)
    jparams = jax.tree_util.tree_map(lambda x: x.numpy(), params)
    want_tokens, want_logits = _reference_loop(
        jconfigs.get_smoke_config(ARCH), jparams, frames.numpy(), 38)
    np.testing.assert_array_equal(res["tokens"].numpy(), want_tokens)
    close(res["logits"], want_logits)


def test_loss_matches_reference():
    """``Model.loss`` of the encoder-decoder (A11.8): the decoder's
    next-token cross-entropy over ``transformer.chunked_xent``, with remat
    on as off (gradients: ``tests/test_torch_loss.py``)."""
    jcfg, tcfg, jp, tp = _smoke()
    frames, tokens = _inputs()
    want = JM.build_model(jcfg).loss(
        jax.tree_util.tree_map(jnp.asarray, jp), _jbatch(frames, tokens))
    for remat in (False, True):
        model = build_model(dataclasses.replace(tcfg, remat=remat),
                            use_pallas=True)
        close(model.loss(tp, _tbatch(frames, tokens)), want,
              rtol=1e-5, atol=0)

"""The port's LM serving path against the reference, on the CPU.

Configs, the layers, and the h2o-danube smoke model (2 layers, d 256, 4/2
heads, hd 64, window 64, fp32) with the reference's ``init_params`` carried
over through ``bridge.lm_params_from_numpy``: the prefill forward with
``use_pallas=True`` (the reference's Pallas kernel in interpret mode; the
port's kernel wrapper runs its plain version on CPU tensors), one decode
step, and a whole greedy generation of 8 tokens after a 96-token prompt,
longer than the window. The reference's own ``repro.launch.serve`` crashes
when it places the prefill K/V (ROADMAP C), so the reference loop is
composed here from ``transformer.forward`` and ``decode_step``. Inputs are
made with numpy from a seed. Tolerance: rtol = atol = 1e-4 on fp32 logits
and caches (two frameworks' fp32 matmul and transcendental orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ARCH = "h2o-danube-1.8b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, P, G = 2, 96, 8


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    for get in ("get_arch_config", "get_smoke_config"):
        port = getattr(tconfigs, get)(ARCH)
        ref = getattr(jconfigs, get)(ARCH)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    full = tconfigs.get_arch_config(ARCH)
    assert abs(full.param_count() - 1.83e9) < 0.01e9


def test_registry_lists_only_ported_archs():
    """Every architecture of the reference is ported: the port's registry
    holds the same names, and an unknown one is refused."""
    assert set(tconfigs.ARCH_NAMES) == set(jconfigs.ARCH_NAMES)
    assert len(tconfigs.ARCH_NAMES) == len(jconfigs.ARCH_NAMES) == 10
    for name in jconfigs.ARCH_NAMES:
        assert tconfigs.get_arch_config(name).name == name
        assert tconfigs.get_smoke_config(name).name == f"{name}-smoke"
    with pytest.raises(KeyError):
        tconfigs.get_arch_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    _close(TL.rmsnorm(_t(x), _t(scale)), JL.rmsnorm(x, scale), rtol=1e-5,
           atol=1e-5)
    pos = rng.integers(0, 5000, (2, 7))
    _close(TL.apply_rope(_t(x), torch.from_numpy(pos), 10000.0),
           JL.apply_rope(x, jnp.asarray(pos, jnp.int32), 10000.0))


@pytest.mark.parametrize("d,ff", [(32, 48), (64, 16)])
def test_mlp_apply_matches_reference(d, ff):
    rng = np.random.default_rng(d + ff)
    p = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in
         (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d)))}
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    _close(TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x)),
           JL.mlp_apply(p, x), rtol=1e-5, atol=1e-5)


ATTN_CASES = [  # Sq, Sk, Hq, Hkv, hd, causal, window, softcap, q_offset
    (80, 80, 4, 2, 16, True, 0, None, 0),
    (80, 80, 4, 1, 16, True, 24, None, 0),
    (40, 72, 4, 2, 16, True, 0, 30.0, 32),
    (50, 70, 2, 2, 8, False, 0, None, 0),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_attention_reference_and_chunked_match_reference(case):
    sq, sk, hq, hkv, hd, causal, window, cap, off = case
    rng = np.random.default_rng(sq + sk + window)
    q = rng.standard_normal((2, sq, hq, hd), dtype=np.float32)
    k = rng.standard_normal((2, sk, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((2, sk, hkv, hd), dtype=np.float32)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off)
    want = JL.attention_reference(q, k, v, **kw)
    _close(TL.attention_reference(_t(q), _t(k), _t(v), **kw), want)
    blocks = dict(block_q=32, block_k=16)
    got = TL.attention_chunked(_t(q), _t(k), _t(v), **kw, **blocks)
    _close(got, JL.attention_chunked(q, k, v, **kw, **blocks))
    _close(got, want)
    _close(TL.attend(_t(q), _t(k), _t(v), use_pallas=True, **kw), want)


@pytest.mark.parametrize("kv_len,window,cap", [(30, 0, None), (40, 16, None),
                                               (25, 8, 20.0)])
def test_attention_decode_matches_reference(kv_len, window, cap):
    rng = np.random.default_rng(kv_len)
    q = rng.standard_normal((2, 1, 4, 16), dtype=np.float32)
    kc = rng.standard_normal((2, 40, 2, 16), dtype=np.float32)
    vc = rng.standard_normal((2, 40, 2, 16), dtype=np.float32)
    kw = dict(kv_len=kv_len, window=window, logit_softcap=cap)
    _close(TL.attention_decode(_t(q), _t(kc), _t(vc), **kw),
           JL.attention_decode(q, kc, vc, **kw))


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke params (numpy), the port's copy, prompts."""
    cfg = jconfigs.get_smoke_config(ARCH)
    params_np = jax.tree_util.tree_map(
        np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, P))
    return {"cfg": cfg, "jparams": params_np,
            "tparams": bridge.lm_params_from_numpy(params_np, "cpu"),
            "tcfg": tconfigs.get_smoke_config(ARCH), "prompts": prompts}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_reference(dtype):
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
    # drawn at the reference's scale, 1 / sqrt(d_model)
    assert abs(float(got["blocks/mixer/wq"].float().std()) - 1 / 16) < 5e-3


def test_bridge_carries_bf16_leaves():
    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4),
                    jnp.bfloat16)
    got = bridge.lm_params_from_numpy({"w": {"x": np.asarray(a)}}, "cpu")
    assert got["w"]["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"]["x"].float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_prefill_forward_matches_reference(smoke):
    cfg, tokens = smoke["cfg"], smoke["prompts"]
    want, _, wcache = JT.forward(cfg, smoke["jparams"],
                                 {"tokens": jnp.asarray(tokens, jnp.int32)},
                                 return_cache=True, use_pallas=True)
    model = build_model(smoke["tcfg"], use_pallas=True)
    got, aux, gcache = model.forward(
        smoke["tparams"], {"tokens": torch.from_numpy(tokens)},
        return_cache=True)
    assert aux == 0.0 and got.shape == (B, P, cfg.vocab_padded)
    _close(got, want)
    for g, w in zip(gcache["blocks"], wcache["blocks"]):
        assert tuple(g.shape) == w.shape == (2, B, P, 2, 64)
        _close(g, w)
    last, _ = model.forward(smoke["tparams"],
                            {"tokens": torch.from_numpy(tokens)},
                            last_only=True)
    _close(last, np.asarray(want)[:, -1:])
    hidden, _ = TT.forward_hidden(smoke["tcfg"], smoke["tparams"],
                                  {"tokens": torch.from_numpy(tokens)})
    whidden, _ = JT.forward_hidden(cfg, smoke["jparams"],
                                   {"tokens": jnp.asarray(tokens, jnp.int32)})
    _close(hidden, whidden)


def _jax_cache(cfg, k, v, pos, total):
    """The reference's {"k","v"} cache with slots [0, pos) from (k, v)."""
    c = JT.init_cache(cfg, k.shape[1], total)["blocks"]
    return {"blocks": {"k": c["k"].at[:, :, :pos].set(k[:, :, :pos]),
                       "v": c["v"].at[:, :, :pos].set(v[:, :, :pos])}}


@pytest.mark.parametrize("pos", [P, 10])
def test_decode_step_matches_reference(smoke, pos):
    """At pos 96 the window slice ends at the new token. At pos 10 < 63 its
    start, 10 - 63, wraps to the cache's tail in the reference (jax's
    dynamic_slice rule), so it holds unwritten slots; the port does the
    same."""
    cfg = smoke["cfg"]
    rng = np.random.default_rng(pos)
    kv = rng.standard_normal((2, 2, B, P + G, 2, 64), dtype=np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, 1))
    jcache = _jax_cache(cfg, jnp.asarray(kv[0]), jnp.asarray(kv[1]), pos, P + G)
    want, wcache = JT.decode_step(cfg, smoke["jparams"], jcache,
                                  {"token": jnp.asarray(tok, jnp.int32)},
                                  jnp.int32(pos))
    tcache = {"blocks": {n: torch.from_numpy(np.array(jcache["blocks"][n]))
                         for n in ("k", "v")}}
    got, gcache = TT.decode_step(smoke["tcfg"], smoke["tparams"], tcache,
                                 {"token": torch.from_numpy(tok)}, pos)
    assert gcache is tcache  # written in place
    _close(got, want)
    for n in ("k", "v"):
        _close(gcache["blocks"][n], wcache["blocks"][n])


def test_greedy_generation_matches_reference(smoke):
    """Prompt 96 > window 64, then 8 tokens: identical tokens, logits at
    1e-4, and every step's top-2 gap wider than the tolerance."""
    cfg, prompts = smoke["cfg"], smoke["prompts"]
    params = smoke["jparams"]
    logits, _, pc = JT.forward(cfg, params,
                               {"tokens": jnp.asarray(prompts, jnp.int32)},
                               return_cache=True, use_pallas=True,
                               last_only=True)
    k, v = pc["blocks"]
    cache = _jax_cache(cfg, k, v, P, P + G)
    decode = jax.jit(functools.partial(JT.decode_step, cfg))
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
    assert got["flash_launches"] == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
    _close(got["logits"], want_logits)
    top2 = np.sort(want_logits[..., :cfg.vocab_size], -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert (gap > 2 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[..., 1]))).all()


# the uniform pattern's other flags, all at once on the smoke model
FLAGS = dict(qkv_bias=True, norm_type="layernorm", post_attn_norm=True,
             tie_embeddings=True, embed_scale=True, attn_logit_softcap=30.0,
             final_logit_softcap=20.0)


def _perturbed(tree, rng):
    """Biases and norm params moved off their 0 / 1 inits, so that a
    mixed-up key shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ("bq", "bk", "bv") or k.endswith(("_scale", "_bias")):
            out[k] = v + 0.1 * rng.standard_normal(v.shape, dtype=np.float32)
        else:
            out[k] = v
    return out


def test_config_flags_match_reference():
    """QKV bias, layernorm, post-norms, tied embeddings, embedding scale
    and both soft-caps: prefill and one decode step against the reference."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **FLAGS)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), **FLAGS)
    rng = np.random.default_rng(5)
    jparams = _perturbed(jax.tree_util.tree_map(
        np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1))), rng)
    tparams = bridge.lm_params_from_numpy(jparams, "cpu")
    assert "lm_head" not in tparams and "norm_bias" in tparams["blocks"]["ffn"]
    tokens = rng.integers(0, jcfg.vocab_size, (B, 40))
    want, _, wcache = JT.forward(jcfg, jparams,
                                 {"tokens": jnp.asarray(tokens, jnp.int32)},
                                 return_cache=True, use_pallas=True)
    got, _, gcache = TT.forward(tcfg, tparams,
                                {"tokens": torch.from_numpy(tokens)},
                                return_cache=True, use_pallas=True)
    _close(got, want)
    k, v = wcache["blocks"]
    jc = _jax_cache(jcfg, k, v, 40, 48)
    tc = {"blocks": {n: torch.from_numpy(np.array(jc["blocks"][n]))
                     for n in ("k", "v")}}
    tok = tokens[:, -1:]
    want, _ = JT.decode_step(jcfg, jparams, jc,
                             {"token": jnp.asarray(tok, jnp.int32)},
                             jnp.int32(40))
    got, _ = TT.decode_step(tcfg, tparams, tc, {"token": torch.from_numpy(tok)},
                            40)
    _close(got, want)


@pytest.mark.parametrize("pattern", ["swa", "full"])
def test_gqa_layers_match_reference(pattern):
    """``gqa_forward`` / ``gqa_decode`` alone, with a window of 16 that
    masks a 40-token sequence and a 48-slot cache, and without a window."""
    over = dict(attn_pattern=pattern, sliding_window=16)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), **over)
    p = jax.tree_util.tree_map(np.asarray,
                               JA.gqa_init(jcfg, jax.random.PRNGKey(2),
                                           jnp.float32))
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 40, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(40), (B, 40))
    want, _ = JA.gqa_forward(jcfg, p, x, jnp.asarray(pos, jnp.int32),
                             use_pallas=True)
    got, _ = TA.gqa_forward(tcfg, tp, _t(x), torch.from_numpy(pos.copy()),
                            use_pallas=True)
    _close(got, want)
    kc, vc = rng.standard_normal((2, B, 48, 2, 64), dtype=np.float32)
    x1 = x[:, :1]
    want, _, _ = JA.gqa_decode(jcfg, p, x1, kc, vc, jnp.int32(30),
                               jnp.full((B, 1), 30, jnp.int32))
    got, _, _ = TA.gqa_decode(tcfg, tp, _t(x1), _t(kc), _t(vc), 30,
                              torch.full((B, 1), 30))
    _close(got, want)


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "20",
                      "--gen", "3", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3) and res["flash_launches"] == 0
    assert torch.isfinite(res["logits"]).all()
    assert "prefill 20 tokens x 2 seqs" in capsys.readouterr().out


def test_unported_paths_raise(monkeypatch):
    """What the LM meshes (ROADMAP A11.9) still refuse: a production mesh
    on a world that is not its 256 (512 with pods) ranks, as
    ``jax.make_mesh`` refuses one that does not match the devices, the
    dry run's fake world of the wrong size too, the fake backend on CUDA
    (it is admitted off CUDA only, A11.10), and an nccl mesh with more
    ranks than cards. Training itself (``Model.loss``, A11.8) runs for the
    decoder-only and the encoder-decoder models alike."""
    from repro_torch.launch import dryrun, mesh, train

    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True)
    mesh.check_backend("fake", 256, torch.device("cpu"))
    with pytest.raises(ValueError, match="off CUDA only"):
        mesh.check_backend("fake", 1, torch.device("cuda"))
    with dryrun.fake_world(16):
        with pytest.raises(ValueError, match="needs 256 ranks, the world "
                                             "has 16"):
            mesh.make_production_mesh(backend="fake", device="cpu")
        assert mesh.make_debug_mesh(backend="fake", device="cpu").sizes == \
            (8, 2)
    monkeypatch.setattr(train, "default_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="needs 256 ranks, the world has 4"):
        train.main(["--arch", ARCH, "--steps", "1", "--full"])
    with pytest.raises(ValueError, match="one card per rank"):
        mesh.spawn_lm_ranks(print, 8, backend="nccl", device="cuda")
    monkeypatch.undo()
    cfg = tconfigs.get_smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 16))
    assert torch.isfinite(model.loss(params, {"tokens": tokens}))
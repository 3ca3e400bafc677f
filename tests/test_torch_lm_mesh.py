"""The LM mesh (ROADMAP A11.9) against one device and against the reference,
on the CPU: the port's sharded forward under ``activation_mesh``, its loss,
its gradients and one train step, on 4 gloo ranks of a (2, 2) ``("data",
"model")`` mesh (``torch_mesh_helpers.lm_mesh_ranks``, one spawn for every
case), for the smoke configs of danube (in the pure data-parallel layout
"dp" too, with 3 query heads and 1 KV head, which "model" does not
split, and with 4 query heads and 1 KV head), gemma2, mixtral (capacity router:
expert parallel), deepseek (MLA, capacity: expert parallel), jamba (the SSD
and flash kernels' wrappers on local heads, capacity: expert parallel),
qwen2-vl (M-RoPE) and seamless (encoder-decoder), and mixtral with 3
experts (capacity router, no expert parallelism). The same spawn runs one
decode step of three smoke configs in the "decode" layout against one
device.

Both sides take the same weights and batches, made here with numpy from a
seed. The
reference runs its own code, unedited, once in a subprocess with 4 host
devices, on a (2, 2) mesh the test builds with Auto axes
(``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)``; on jax 0.9 a
default mesh is Explicit and the reference's constraints refuse it, ROADMAP
C3), at the same time as the port's ranks; ``.npz`` files carry the inputs
and its results.

Tolerances (fp32): mesh against one device rtol 1e-5 / atol 2e-5 on logits
and losses, 1e-4 / 1e-6 on gradients (sums over ranks in another order);
port against reference 1e-4 / 1e-4 on logits and losses, 1e-3 / 2e-6 on
gradients (two frameworks' orders, as ``tests/torch_lm_helpers.py``). The
expert-parallel forward at capacity factor 8.0 is within the reference
test's 5e-4 of the dense oracle; its aux loss is each source shard's,
averaged (the reference's law), so its loss and gradients are held to the
reference's, not to one device's.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro_torch.launch.mesh import spawn_lm_ranks
from torch_mesh_helpers import STEP_OPT, flat as flatten, lm_mesh_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 4, 64
CF8 = dict(router_mode="capacity", capacity_factor=8.0)
CASES = {
    "danube": ("h2o-danube-1.8b", {}),
    "danube_dp": ("h2o-danube-1.8b", {}),  # the pure data-parallel layout
    # "model" (2) splits the flat projections (192, 64) but not the heads
    # (3 and 1): the heads reach their (heads, head_dim) form replicated
    "danube_odd_heads": ("h2o-danube-1.8b", dict(n_heads=3, n_kv_heads=1,
                                                 head_dim=64)),
    # one KV head for the 4 query heads, which "model" splits: each rank
    # attends its 2 query heads to the one KV head
    "danube_one_kv_head": ("h2o-danube-1.8b", dict(n_kv_heads=1)),
    "gemma2": ("gemma2-9b", {}),
    "mixtral": ("mixtral-8x22b", CF8),
    "mixtral_cf1.25": ("mixtral-8x22b", dict(router_mode="capacity",
                                              capacity_factor=1.25)),
    # 3 experts do not divide "data" (2): the capacity router without
    # expert parallelism, its buffer's slots split over "data"
    "mixtral_no_ep": ("mixtral-8x22b", dict(CF8, n_experts=3)),
    "deepseek": ("deepseek-v2-236b", CF8),
    "jamba": ("jamba-1.5-large-398b", CF8),
    "qwen2vl": ("qwen2-vl-7b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
EP = ("mixtral", "mixtral_cf1.25", "deepseek", "jamba")
# one decode step of each, in the "decode" layout, B x S = 4 x 16
DECODE_ARCHS = ("h2o-danube-1.8b", "deepseek-v2-236b", "jamba-1.5-large-398b")
LAYOUTS = {"danube_dp": "dp"}

REFERENCE = """
import dataclasses
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.sharding import batch_pspec, param_pspecs, to_shardings
from repro.sharding.act import activation_mesh

cases, layouts = {cases!r}, {layouts!r}
inputs, out = np.load({inputs!r}), {{}}


def unflat(prefix):
    tree = {{}}
    for key in inputs.files:
        if key.startswith(prefix):
            *head, last = key[len(prefix):].split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {{}})
            node[last] = inputs[key]
    return tree


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{{prefix}}{{k}}/")
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)


mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:4])
for name, (arch, over) in cases.items():
    model = build_model(dataclasses.replace(get_smoke_config(arch), **over))
    params = unflat(f"{{name}}|param|")
    batch = unflat(f"{{name}}|batch|")
    layout = layouts.get(name, "2d")
    p_s = jax.device_put(params, to_shardings(
        param_pspecs(params, mesh, layout), mesh))
    b_s = {{k: jax.device_put(v, NamedSharding(
        mesh, batch_pspec(mesh, v.ndim, layout=layout)))
        for k, v in batch.items()}}
    with activation_mesh(mesh, layout):
        (loss, g), (logits, aux) = jax.jit(lambda p, b: (
            jax.value_and_grad(model.loss)(p, b), model.forward(p, b)))(p_s, b_s)
    flat(g, f"{{name}}|grad|")
    flat({{"logits": logits, "aux": aux, "loss": loss}}, f"{{name}}|")
np.savez({outputs!r}, **out)
"""


def _numpy_init(tree, rng):
    """Weights of the reference's shapes, drawn with numpy: matrices and
    stacks N(0, 1 / fan_in), vectors (norm scales, biases, A_log, D,
    dt_bias) 1 + N(0, 0.1^2)."""
    if isinstance(tree, dict):
        return {k: _numpy_init(v, rng) for k, v in tree.items()}
    shape = tuple(tree.shape)
    if len(shape) >= 2:
        w = rng.standard_normal(shape) / np.sqrt(shape[-2])
    else:
        w = 1.0 + 0.1 * rng.standard_normal(shape)
    return w.astype(np.float32)


def _case_inputs(arch, over):
    """Weights of the reference's smoke shapes and a batch, as numpy from a
    seed."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    shapes = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    params = _numpy_init(shapes, np.random.default_rng(7))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.modality == "vision_stub":
        pos = np.arange(S, dtype=np.int32)[None, :, None]
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                               dtype=np.float32),
                 "positions": np.broadcast_to(pos, (B, S, 3)).copy(),
                 "labels": np.pad(toks[:, 1:], ((0, 0), (0, 1)),
                                  constant_values=-1)}
    elif cfg.is_encoder_decoder:
        batch = {"frames": rng.standard_normal((B, S // 4, cfg.d_model),
                                               dtype=np.float32),
                 "tokens": toks}
    else:
        batch = {"tokens": toks}
    return flatten(params), batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, the port's rank-0 results) of every case. The
    reference's subprocess and the port's ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    inputs, outputs = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    cases, arrays = [], {}
    for name, (arch, over) in CASES.items():
        params, batch = _case_inputs(arch, over)
        cases.append(dict(name=name, arch=arch, overrides=over,
                          params=params, batch=batch,
                          oracle=name == "deepseek",
                          layout=LAYOUTS.get(name, "2d")))
        arrays.update({f"{name}|param|{k}": v for k, v in params.items()})
        arrays.update({f"{name}|batch|{k}": v for k, v in batch.items()})
    np.savez(inputs, **arrays)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = REFERENCE.format(cases=CASES, layouts=LAYOUTS, inputs=inputs,
                            outputs=outputs)
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        port = spawn_lm_ranks(lm_mesh_ranks, 4, backend="gloo", device="cpu",
                              args=(cases, (DECODE_ARCHS, 4, 16)))[0]
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    npz = np.load(outputs)
    ref = {c["name"]: {"params": c["params"], "grads": {}} for c in cases}
    for key in npz.files:
        name, kind, *rest = key.split("|")
        if kind == "grad":
            ref[name]["grads"][rest[0]] = npz[key]
        else:
            ref[name][kind] = npz[key]
    return ref, port


MESH_TOL = dict(rtol=1e-5, atol=2e-5)
MESH_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
REF_GRAD_TOL = dict(rtol=1e-3, atol=2e-6)


def _grads_close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward_matches_one_device_and_reference(runs, name):
    ref, port = runs
    got = port[name]
    np.testing.assert_allclose(got["mesh"]["logits"], ref[name]["logits"],
                               **REF_TOL)
    if name != "mixtral_cf1.25":  # per-shard capacity drops other slots
        np.testing.assert_allclose(got["mesh"]["logits"],
                                   got["one"]["logits"], **MESH_TOL)
    np.testing.assert_allclose(got["mesh"]["aux"], ref[name]["aux"],
                               **REF_TOL)
    assert (got["ep"] > 0) == (name in EP)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_loss_grads_and_step(runs, name):
    """Loss and gradients against the reference's on its mesh, and against
    one device where the aux law is the same; one sgd step (``STEP_OPT``)
    is p - lr * g of the sharded gradients."""
    ref, port = runs
    got = port[name]["mesh"]
    np.testing.assert_allclose(got["loss"], ref[name]["loss"], **REF_TOL)
    np.testing.assert_allclose(got["step_loss"], got["loss"], **MESH_TOL)
    _grads_close(got["grads"], ref[name]["grads"], REF_GRAD_TOL)
    if name not in EP:
        np.testing.assert_allclose(got["loss"], port[name]["one"]["loss"],
                                   **MESH_TOL)
        _grads_close(got["grads"], port[name]["one"]["grads"], MESH_GRAD_TOL)
    for k, p in ref[name]["params"].items():
        np.testing.assert_allclose(
            got["step"][k], p - STEP_OPT["lr"] * got["grads"][k],
            rtol=1e-6, atol=1e-6, err_msg=k)
    assert all(np.isfinite(g).all() for g in got["grads"].values())


def test_ep_against_dense_oracle_and_drop_law(runs):
    """deepseek at capacity factor 8.0: the EP forward within 5e-4 of the
    dense oracle (the reference test's bound). mixtral at 1.25: slots are
    dropped (per source shard and expert) and the output is the
    reference's EP output (checked above)."""
    _, port = runs
    err = np.abs(port["deepseek"]["mesh"]["logits"]
                 - port["deepseek"]["oracle"]).max()
    assert err < 5e-4, err
    assert sum(port["deepseek"]["mesh"]["drops"]) == 0
    assert sum(port["mixtral_cf1.25"]["mesh"]["drops"]) > 0


def test_host_staged_collectives(runs):
    """The host-staged kernels that DTensor's functional collectives take
    on gloo with CUDA tensors (``sharding.collectives``), called on CPU
    tensors over the data group: equal to gloo's own collectives, each
    call and its bytes counted."""
    staged = runs[1]["staged"]
    counts = staged.pop("counts")
    staged.pop("rank_in_group")
    assert all(v == 0.0 for v in staged.values()), staged
    assert counts["calls"] == 6 and counts["all_gather_bytes"] == 32
    assert counts["bytes"] == 6 * 32


def test_kernels_run_on_local_shards(runs):
    """The flash and SSD wrappers see each rank's batch rows and heads:
    (B / 2, S, H / 2, hd) where the heads split over "model"."""
    _, port = runs
    for name, arch in (("danube", "h2o-danube-1.8b"),
                       ("jamba", "jamba-1.5-large-398b")):
        from repro_torch.configs import get_smoke_config

        cfg = get_smoke_config(arch)
        want = (B // 2, S, cfg.n_heads // 2, cfg.head_dim)
        assert port[name]["flash"] and set(port[name]["flash"]) == {want}
    cfg = get_smoke_config("jamba-1.5-large-398b")
    assert set(port["jamba"]["ssd"]) == {
        (B // 2, S, cfg.ssm_heads // 2, cfg.ssm_head_dim)}


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_one_device(runs, arch):
    """One decode step on the (2, 2) mesh in the "decode" layout equals one
    device's (fp32, MESH_TOL): GQA's KV caches split on the head dim,
    MLA's compressed caches split on the sequence (the new token written
    into the block that holds its slot), and jamba's mamba state and MoE
    layers."""
    one, mesh = runs[1]["decode"][arch]
    np.testing.assert_allclose(mesh, one, **MESH_TOL)

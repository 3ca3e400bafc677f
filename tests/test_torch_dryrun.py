"""The port's dry run (``repro_torch.launch.dryrun``, ROADMAP A11.10) on
fake meshes, on the CPU.

- Every registered architecture's smoke config runs its forward, its train
  step and a decode step on a fake (2, 8) mesh of meta DTensors to the end.
- Against the reference: ``repro.launch.dryrun.lower_one`` on an Auto-axis
  (8, 2) mesh of 16 host devices (a subprocess; on jax 0.9 a default mesh
  is Explicit and the reference's constraints refuse it, ROADMAP C3) and
  the port's ``lower_one`` on a fake (8, 2) mesh, for danube's smoke
  config: a prefill of 16 x 4,096 (the chunked attention) in the "2d"
  layout and a training step of 16 x 1,024 in "dp". The port's dot FLOPs a
  rank are within 1% of the reference's ``dot_flops_per_device``. The
  training shape has two chunks of the cross-entropy: with one, the
  reference's scan has a trip count of 1, XLA inlines it and merges the
  recomputed logits with the forward's, where the port recomputes them
  (ROADMAP C2). Both sides' collective kinds are reported; the port's
  counts and bytes are held to what its placement rules imply, written out
  below from the rules.
- The trace: the count extrapolated from 1 and 2 periods of the layer
  pattern (a train step's optimizer update traced whole) equals a direct
  trace at 3: danube's and gemma2's (local/global pairs) train steps and
  jamba's (its attention/mamba period) prefill.
- Against the config: one rank's count of a prefill equals the hand count
  of its products, and ``useful_flops_ratio`` is the config's
  ``model_flops_per_token`` over the count.
- ``choose_layout`` agrees with the reference's for every arch x shape on
  256 and 512 ranks; the CLI writes its record under
  ``results/dryrun_torch/`` (here redirected to a temporary folder), and a
  combination that fails is recorded with ``ok: false`` and a non-zero
  exit.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_arch_config,
                                 get_smoke_config)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.launch.specs import params_shapes
from repro_torch.models import build_model
from repro_torch.sharding import MeshShape, param_pspecs
from repro_torch.sharding.specs import leaves_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "h2o-danube-1.8b"
SMOKE_SHAPES = {"train": ShapeConfig("smoke_train", 64, 16, "train"),
                "prefill": ShapeConfig("smoke_prefill", 64, 16, "prefill"),
                "decode": ShapeConfig("smoke_decode", 64, 16, "decode")}
# the shapes both sides run, registered in both SHAPES dicts
PARITY = {"dry_prefill": (ShapeConfig("dry_prefill", 4096, 16, "prefill"),
                          "2d"),
          "dry_train": (ShapeConfig("dry_train", 1024, 16, "train"), "dp")}
MESH = (8, 2)

REFERENCE = """
import dataclasses, json
import jax
from jax.sharding import AxisType
from repro.configs import ARCH_NAMES, SHAPES, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import dryrun

parity = {parity!r}
for name, (S, B, mode, _) in parity.items():
    SHAPES[name] = ShapeConfig(name, S, B, mode)
cfg = get_smoke_config({arch!r})
over = {{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}}
mesh = jax.make_mesh({mesh!r}, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {{"cost": {{}}, "layouts": {{}}}}
for name, (_, _, _, layout) in parity.items():
    rec = dryrun.lower_one({arch!r}, name, mesh=mesh, config_overrides=over,
                           layout=layout)
    out["cost"][name] = rec["hlo_cost"]
for n in (256, 512):
    for a in ARCH_NAMES:
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            out["layouts"][f"{{a}}|{{s}}|{{n}}"] = dryrun.choose_layout(a, s, n)
json.dump(out, open({path!r}, "w"))
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module so it runs while
    the port's tests do; ``reference()`` waits for its results."""
    path = str(tmp_path_factory.mktemp("dryrun") / "ref.json")
    parity = {k: (s.seq_len, s.global_batch, s.mode, lay)
              for k, (s, lay) in PARITY.items()}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    code = REFERENCE.format(parity=parity, arch=ARCH, mesh=MESH, path=path)
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    done = {}

    def reference():
        if not done:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            done.update(json.load(open(path)))
        return done

    yield reference
    proc.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference_run):
    yield


def _smoke_fields(arch):
    cfg = get_smoke_config(arch)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _fake_mesh(sizes):
    return make_lm_mesh(sizes, ("data", "model"), backend="fake",
                        device="cpu")


@pytest.mark.parametrize("mode", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_config_runs_on_fake_mesh(arch, mode):
    """(2, 8): "model" (8) splits every smoke config's flat projections
    but not its 4 query heads (ROADMAP C1d)."""
    with dryrun.fake_world(16):
        mesh = _fake_mesh((2, 8))
        layout = "decode" if mode == "decode" else "2d"
        cost = dryrun.trace_step(get_smoke_config(arch), SMOKE_SHAPES[mode],
                                 mesh, layout).as_dict()
    assert cost["dot_flops_per_device"] > 0
    assert cost["collectives"]


@pytest.fixture(scope="module")
def port_costs():
    """The port's ``op_cost`` of each shape of :data:`PARITY`."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (shape, layout) in PARITY.items():
            mp.setitem(SHAPES, name, shape)
            with dryrun.fake_world(math.prod(MESH)):
                out[name] = dryrun.lower_one(
                    ARCH, name, mesh=_fake_mesh(MESH),
                    config_overrides=_smoke_fields(ARCH),
                    layout=layout)["op_cost"]
    return out


@pytest.mark.parametrize("name", list(PARITY))
def test_dot_flops_match_reference(name, port_costs, reference_run):
    port = port_costs[name]
    ref = reference_run()["cost"][name]
    print(f"{name}: port {port['dot_flops_per_device']:.6e} "
          f"{json.dumps(port['collectives'])}; reference "
          f"{ref['dot_flops_per_device']:.6e} {json.dumps(ref['collectives'])}")
    assert port["dot_flops_per_device"] == pytest.approx(
        ref["dot_flops_per_device"], rel=0.01)
    assert port["dot_bytes_per_device"] == pytest.approx(
        ref["dot_bytes_per_device"], rel=0.01)


def _weights(cfg, layout):
    """(uses, bytes of one use, split over "model") of every weight the
    placement rules split, and the count and bytes of the replicated
    leaves: a leaf stacked over the blocks is used once a block."""
    mesh = MeshShape(("data", "model"), MESH)
    ps = params_shapes(build_model(cfg))
    specs = dict(leaves_with_path(param_pspecs(ps, mesh, layout)))
    split, whole = [], []
    for path, leaf in leaves_with_path(ps):
        nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
        if any(p is not None for p in specs[path]):
            n = leaf.shape[0] if path[0] == "['blocks']" else 1
            model = any("model" in ((p,) if isinstance(p, str) else p or ())
                        for p in specs[path])
            split.append((n, nbytes // n, model))
        else:
            whole.append(nbytes)
    return split, whole


def test_prefill_collectives_follow_placements(port_costs):
    """2d prefill: each weight the rules split over "data" (FSDP) is
    gathered over "data" once where it is used (its "model" split kept);
    the embedding's output, whose d_model "model" splits, is gathered once;
    each layer's two out-projections sum their partial products over
    "model" (``act.row_parallel``): (B / 8, S, d) fp32 a sum."""
    cfg = get_smoke_config(ARCH)
    shape, layout = PARITY["dry_prefill"]
    act = shape.global_batch // MESH[0] * shape.seq_len * cfg.d_model * 4
    split, _ = _weights(cfg, layout)
    want = {"all-gather": {"count": sum(n for n, _, _ in split) + 1,
                           "bytes": sum(n * b // (2 if m else 1)
                                        for n, b, m in split) + act},
            "all-reduce": {"count": 2 * cfg.n_layers,
                           "bytes": 2 * cfg.n_layers * act}}
    got = port_costs["dry_prefill"]["collectives"]
    assert got == want


def test_train_collectives_follow_placements(port_costs):
    """dp train step: each weight is split over ("data", "model") on one
    dim; DTensor gathers it one axis at a time ("model" then "data":
    results 1/8 and all of it) where it is used, and reduce-scatters its
    gradient one axis at a time ("data" then "model": 1/8 and 1/16). The
    replicated leaves' (norm scales') gradients and the loss's two sums
    (the cross-entropy's total and count) are all-reduced one axis at a
    time."""
    cfg = get_smoke_config(ARCH)
    split, whole = _weights(cfg, "dp")
    uses = sum(n for n, _, _ in split)
    total = sum(n * b for n, b, _ in split)
    want = {"all-gather": {"count": 2 * uses, "bytes": total // 8 + total},
            "reduce-scatter": {"count": 2 * uses,
                               "bytes": total // 8 + total // 16},
            "all-reduce": {"count": 2 * len(whole) + 2 * 2,
                           "bytes": 2 * sum(whole) + 2 * 2 * 4}}
    got = port_costs["dry_train"]["collectives"]
    assert got == want


@pytest.mark.parametrize("arch, mode", [(ARCH, "train"),
                                        ("gemma2-9b", "train"),
                                        ("jamba-1.5-large-398b", "prefill")])
def test_extrapolation_equals_third_depth(arch, mode):
    """``op_cost`` at 3 periods (extrapolated from 1 and 2; a train step's
    optimizer update traced whole) equals the whole step traced at 3."""
    cfg = dryrun.at_depth(get_smoke_config(arch), 3)
    with dryrun.fake_world(16):
        mesh = _fake_mesh((2, 8))
        got, depths = dryrun.op_cost(cfg, SMOKE_SHAPES[mode], mesh, "2d")
        want = dryrun.trace_step(cfg, SMOKE_SHAPES[mode], mesh,
                                 "2d").as_dict()
    assert got == want
    per = cfg.n_layers // 3
    assert depths == [per, 2 * per]


def test_one_rank_count_by_hand(monkeypatch):
    """One rank, danube's smoke prefill of 2 x 64: the products' FLOPs by
    hand from the config (q, k, v, o, the SwiGLU, the materialized scores
    and their values, the head on the last position), and the useful ratio
    from ``model_flops_per_token``."""
    B, S = 2, 64
    monkeypatch.setitem(SHAPES, "one", ShapeConfig("one", S, B, "prefill"))
    with dryrun.fake_world(1):
        rec = dryrun.lower_one(ARCH, "one", mesh=_fake_mesh((1, 1)),
                               config_overrides=_smoke_fields(ARCH))
    cfg = get_smoke_config(ARCH)
    T, d = B * S, cfg.d_model
    layer = (2 * T * d * (2 * cfg.q_dim + 2 * cfg.kv_dim)
             + 2 * T * d * 3 * cfg.d_ff
             + 4 * B * S * S * cfg.n_heads * cfg.head_dim)
    hand = cfg.n_layers * layer + 2 * B * d * cfg.vocab_padded
    assert rec["op_cost"]["dot_flops_per_device"] == hand
    assert rec["model_flops"] == pytest.approx(
        cfg.model_flops_per_token() / 3 * T, rel=1e-12)
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops"] / hand, rel=1e-12)
    assert rec["op_cost"]["collectives"] == {}


def test_choose_layout_matches_reference(reference_run):
    ref = reference_run()["layouts"]
    for n in (256, 512):
        for a in ARCH_NAMES:
            for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
                assert dryrun.choose_layout(a, s, n) == \
                    ref[f"{a}|{s}|{n}"], (a, s, n)


def test_cli_writes_record(monkeypatch, tmp_path):
    """The CLI on the production mesh (a fake world of 256 ranks), danube
    at full width on a short training shape: ``dp`` (under 12e9
    parameters, the batch a multiple of the ranks), the H100 roofline
    terms, written under results/dryrun_torch/."""
    default = os.path.dirname(dryrun.result_path(ARCH, "x", "16x16"))
    assert os.path.realpath(default).endswith(
        os.path.join("results", "dryrun_torch"))
    monkeypatch.setitem(SHAPES, "cli", ShapeConfig("cli", 32, 256, "train"))
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert dryrun.main(["--arch", ARCH, "--shape", "cli"]) == 0
    rec = json.load(open(tmp_path / f"{ARCH}__cli__16x16.json"))
    cfg = get_arch_config(ARCH)
    assert rec["ok"] and rec["layout"] == "dp" and rec["n_chips"] == 256
    assert rec["trace_depths"] == [1, 2] and rec["mode"] == "train"
    assert rec["param_count"] == cfg.param_count()
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "roofline_step_s"}
    assert rec["roofline"]["compute_s"] == pytest.approx(
        rec["op_cost"]["dot_flops_per_device"] / 989e12, rel=1e-12)
    assert rec["roofline"]["collective_s"] == pytest.approx(
        rec["op_cost"]["collective_bytes_per_device"] / 50e9, rel=1e-12)
    assert "memory_analysis" not in rec and "hlo_cost" not in rec
    assert not torch.cuda.is_initialized()


def test_cli_records_failure(monkeypatch, tmp_path):
    def fail(*a, **k):
        raise RuntimeError("placement refused")

    monkeypatch.setattr(dryrun, "lower_one", fail)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match="1 dry-run combination"):
        dryrun.main(["--arch", ARCH, "--shape", "train_4k"])
    rec = json.load(open(tmp_path / f"{ARCH}__train_4k__16x16.json"))
    assert rec["ok"] is False and rec["error"] == "placement refused"
    assert "RuntimeError" in rec["traceback"]

"""The port's roofline model and HLO parsers (ROADMAP A11.10) against the
reference.

- ``repro_torch.launch.roofline.analytic_memory_bytes`` is the reference's
  arithmetic: equal to ``repro.launch.roofline``'s exactly over a grid of
  modes and sizes.
- ``roofline_terms`` divides by the H100 SXM constants of
  ``repro_torch.launch.mesh``: checked against hand arithmetic, with the
  link bandwidth NVLink's up to 8 ranks (one node) and the NIC's beyond.
- ``repro_torch.utils.hlo_parse`` and ``hlo_cost`` are copies of the
  reference's: equal to them field by field on the scan HLO of
  ``tests/test_distributed.py::test_hlo_cost_parser_on_scan`` (L = 3 and 9,
  each within 1% of 2·64·32·32·L), on the literal collective text of
  ``test_collective_parser_counts_allreduce``, and on the compiled HLO of
  danube's smoke prefill on an Auto-axis (8, 2) mesh of 16 host devices
  (compiled in a subprocess, so the device count applies).
"""
import dataclasses
import itertools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest

import repro.launch.roofline as jroof
import repro.utils.hlo_cost as jcost
import repro.utils.hlo_parse as jparse
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.utils import collective_breakdown, collective_bytes_from_hlo
from repro_torch.utils import hlo_cost as tcost

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

COLLECTIVE_TEXT = """
  %all-reduce.1 = f32[128,256]{1,0} all-reduce(%x), replica_groups={}
  %all-gather.2 = bf16[64]{0} all-gather(%y), dimensions={0}
  %all-reduce.3-done = f32[4]{0} all-reduce-done(%z)
"""


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_analytic_memory_bytes_matches_reference(mode):
    grid = itertools.product((0.0, 3.6e9, 7.3e11), (0.0, 1.2e10),
                             (0.0, 5.4e9), (1, 4096, 1_048_576),
                             (256, 2560, 12288), (1, 24, 96), (2, 4))
    for p, o, c, t, d, n, a in grid:
        kw = dict(params_bytes=p, opt_bytes=o, cache_bytes=c, tokens=t,
                  d_model=d, n_layers=n, act_bytes=a)
        assert troof.analytic_memory_bytes(mode, **kw) == \
            jroof.analytic_memory_bytes(mode, **kw), kw


@pytest.mark.parametrize("n_chips", [1, 4, 8, 9, 256, 512])
def test_roofline_terms_by_hand(n_chips):
    flops, mem, coll = 3.1e15, 2.2e12, 7.7e11
    got = troof.roofline_terms(n_chips, flops, mem, coll)
    link = 450e9 if n_chips <= 8 else 50e9
    want = {"compute_s": flops / (n_chips * 989e12),
            "memory_s": mem / (n_chips * 3.35e12),
            "collective_s": coll / (n_chips * link)}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    assert got["dominant"] == max(want, key=want.get)
    assert got["roofline_step_s"] == max(want.values())
    assert tmesh.link_bw(n_chips) == link


def test_h100_constants():
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_TF32,
            tmesh.PEAK_FLOPS_FP32, tmesh.HBM_BW) == (989e12, 495e12, 67e12,
                                                     3.35e12)
    assert (tmesh.NVLINK_BW_PER_GPU, tmesh.NIC_BW_PER_GPU,
            tmesh.NODE_GPUS) == (450e9, 50e9, 8)


def _same_cost(hlo: str):
    got, want = tcost.hlo_cost(hlo), jcost.hlo_cost(hlo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert collective_breakdown(hlo) == jparse.collective_breakdown(hlo)
    assert collective_bytes_from_hlo(hlo) == \
        jparse.collective_bytes_from_hlo(hlo)
    return got


@pytest.mark.parametrize("L", [3, 9])
def test_parsers_on_scan_hlo(L):
    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        c, _ = jax.lax.scan(body, x, ws)
        return c.sum()

    x = jax.ShapeDtypeStruct((64, 32), jnp.float32)
    ws = jax.ShapeDtypeStruct((L, 32, 32), jnp.float32)
    cost = _same_cost(jax.jit(f).lower(x, ws).compile().as_text())
    expect = 2 * 64 * 32 * 32 * L
    assert abs(cost.dot_flops - expect) / expect < 0.01, (L, cost.dot_flops)


def test_parsers_on_collective_text():
    out = collective_breakdown(COLLECTIVE_TEXT)
    assert out == jparse.collective_breakdown(COLLECTIVE_TEXT)
    assert out["all-reduce"] == {"count": 1, "bytes": 128 * 256 * 4}
    assert out["all-gather"] == {"count": 1, "bytes": 64 * 2}
    _same_cost(COLLECTIVE_TEXT)


MESH_HLO = """
import dataclasses, sys
import jax
from jax.sharding import AxisType
from repro.configs import SHAPES, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_one

SHAPES["mesh_hlo"] = ShapeConfig("mesh_hlo", 256, 16, "prefill")
cfg = get_smoke_config("h2o-danube-1.8b")
over = {{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}}
mesh = jax.make_mesh((8, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
lower_one("h2o-danube-1.8b", "mesh_hlo", mesh=mesh, config_overrides=over,
          hlo_dir={hlo_dir!r})
"""


def test_parsers_on_mesh_hlo(tmp_path):
    """danube's smoke prefill compiled on an Auto-axis (8, 2) mesh: the
    same collectives, FLOPs and bytes from both parsers."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    out = subprocess.run(
        [sys.executable, "-c",
         textwrap.dedent(MESH_HLO.format(hlo_dir=str(tmp_path)))],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    hlo = (tmp_path / "h2o-danube-1.8b__mesh_hlo__8x2.hlo").read_text()
    cost = _same_cost(hlo)
    assert cost.dot_flops > 0
    assert set(cost.collectives) >= {"all-gather", "all-reduce"}

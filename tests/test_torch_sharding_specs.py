"""The LM meshes' placement rules against the reference, on one CPU:
``repro_torch.sharding.specs`` (``param_pspecs``, ``state_pspecs``,
``cache_pspecs``, ``batch_pspec``) and ``repro_torch.launch.specs`` against
``repro.sharding.specs`` and ``repro.launch.specs``.

Every registered architecture at its full config, shapes only: the
reference's ``jax.eval_shape`` trees on a ``jax.sharding.AbstractMesh``
(no devices), the port's ``meta``-device trees on a ``MeshShape``. The
meshes are the production ones, (16, 16) and (2, 16, 16), and the debug
meshes of 8 and 4 ranks, (4, 2) and (2, 1, 2); layouts "2d" and "dp". The
specs must be equal leaf for leaf, exactly.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import repro.configs as jconfigs
import repro.launch.specs as jspecs
import repro.sharding.specs as jsh
from repro.models import build_model as jbuild
from repro.optim import make_optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import debug_mesh_shape
from repro_torch.models import build_model as tbuild
from repro_torch.optim import make_optimizer as topt
from repro_torch.sharding import specs as tsh

ARCHS = jconfigs.ARCH_NAMES
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          debug_mesh_shape(8), debug_mesh_shape(4, multi_pod=True))


def meshes():
    for sizes, names in MESHES:
        yield AbstractMesh(sizes, names), tsh.MeshShape(names, sizes)


def ref_flat(tree):
    """{path: parts} of a reference tree of PartitionSpecs."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"".join(str(k) for k in path): tuple(s) for path, s in leaves}


def port_flat(tree):
    return {"".join(path): tuple(s)
            for path, s in tsh.leaves_with_path(tree)}


def shapes_flat(tree, ref: bool):
    if ref:
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        return {"".join(str(k) for k in p): (tuple(x.shape), str(x.dtype))
                for p, x in leaves}
    return {"".join(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tsh.leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference params, port params) at the full config, shapes only."""
    want = jspecs.params_shapes(jbuild(jconfigs.get_arch_config(arch)))
    got = tspecs.params_shapes(tbuild(tconfigs.get_arch_config(arch)))
    return want, got


def test_arch_list_is_the_registry():
    assert set(ARCHS) == set(tconfigs.ARCH_NAMES)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_shapes_and_param_pspecs_match_reference(arch):
    want, got = trees(arch)
    assert shapes_flat(got, ref=False) == shapes_flat(want, ref=True)
    for jm, tm in meshes():
        for layout in ("2d", "dp"):
            assert port_flat(tsh.param_pspecs(got, tm, layout)) == \
                ref_flat(jsh.param_pspecs(want, jm, layout)), \
                (tm, layout)


@pytest.mark.parametrize("opt", ("adamw", "adafactor"))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_pspecs_match_reference(arch, opt):
    """``state_pspecs`` and the CLI's ``param_pspecs(opt_state)`` on the
    optimizer state's shapes."""
    want, got = trees(arch)
    jstate = jax.eval_shape(jopt(opt).init, want)
    tstate = tspecs.as_specs(topt(opt).init(tspecs.as_meta(got)))
    assert shapes_flat(tstate, ref=False) == shapes_flat(jstate, ref=True)
    for jm, tm in meshes():
        jps, tps = jsh.param_pspecs(want, jm), tsh.param_pspecs(got, tm)
        assert port_flat(tsh.state_pspecs(tstate, got, tps, tm)) == \
            ref_flat(jsh.state_pspecs(jstate, want, jps, jm)), tm
        assert port_flat(tsh.param_pspecs(tstate, tm)) == \
            ref_flat(jsh.param_pspecs(jstate, jm)), tm


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_match_reference(arch):
    """At every registered shape: the train and decode inputs, the decode
    cache's shapes and its ``cache_pspecs``."""
    jcfg, tcfg = jconfigs.get_arch_config(arch), tconfigs.get_arch_config(arch)
    jm_, tm_ = jbuild(jcfg), tbuild(tcfg)
    for name, shape in jconfigs.SHAPES.items():
        tshape = tconfigs.SHAPES[name]
        for f in ("train_inputs", "decode_inputs"):
            assert shapes_flat(getattr(tspecs, f)(tcfg, tshape), ref=False) \
                == shapes_flat(getattr(jspecs, f)(jcfg, shape), ref=True)
        if shape.mode != "decode":
            continue
        jc = jspecs.cache_shapes(jm_, jcfg, shape)
        tc = tspecs.cache_shapes(tm_, tcfg, tshape)
        assert shapes_flat(tc, ref=False) == shapes_flat(jc, ref=True)
        for jm, tm in meshes():
            assert port_flat(tsh.cache_pspecs(tc, tm, tshape.global_batch)) \
                == ref_flat(jsh.cache_pspecs(jc, jm, shape.global_batch)), tm


def test_batch_pspec_matches_reference():
    for jm, tm in meshes():
        for ndim in (1, 2, 3):
            for div in (True, False):
                for layout in ("2d", "dp"):
                    assert tuple(tsh.batch_pspec(tm, ndim, div, layout)) == \
                        tuple(jsh.batch_pspec(jm, ndim, div, layout))


def test_spec_placements():
    """A spec's DTensor placements: a dim over (pod, data) is sharded on
    both mesh dims, in mesh order; a tuple out of mesh order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    tm = tsh.MeshShape(("pod", "data", "model"), (2, 1, 2))
    assert tsh.spec_placements(tsh.P(("pod", "data"), None, "model"), tm) \
        == (Shard(0), Shard(0), Shard(2))
    assert tsh.spec_placements(tsh.P(), tm) == (Replicate(),) * 3
    assert tsh.to_placements({"a": tsh.P(None, "model"), "b": None}, tm) == \
        {"a": (Replicate(), Replicate(), Shard(1)), "b": None}
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.spec_placements(tsh.P(("data", "pod")), tm)
    x = torch.arange(24.0).reshape(4, 6)

    class Coords(tsh.MeshShape):
        coords = (1, 0, 1)

    got = tsh.local_shard(x, tsh.spec_placements(tsh.P(("pod", "data"),
                                                       "model"), tm),
                          Coords(tm.axis_names, tm.sizes))
    assert torch.equal(got, x[2:4, 3:6])

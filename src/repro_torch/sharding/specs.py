"""PartitionSpec rules for every architecture (port of
``repro/sharding/specs.py``): 2-D FSDP x TP sharding, as pure rules on
shapes.

Convention:
  - TP axis      = "model": attention/FFN projection output dims, expert
                   hidden dims, the vocab dim of embed/lm_head.
  - FSDP axis    = "data" (and "pod" when the mesh has one): the other
                   matmul dim of each weight, so parameters and optimizer
                   state are fully sharded (ZeRO-3 style).
  - batch        = ("pod", "data") for activations.

An axis is applied only when the dim divides evenly; otherwise that dim
stays replicated, so every architecture places on the same mesh.

The rules need only a leaf's key and shape and the mesh's ``.shape`` (axis
name -> size) and ``.axis_names``: a :class:`MeshShape` describes a mesh
with no process group, so the production meshes' specs are computed on one
CPU. :func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh`` whose dim names are the axis names, and :func:`place_tree`
puts a tree of global tensors there, each rank keeping its own shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

# weights whose LAST dim is the "output" of a projection -> TP on last dim,
# FSDP on second-to-last
_IN_PROJ = {
    "wq", "wk", "wv", "w_gate", "w_up", "q_down", "q_up", "kv_down", "kv_up",
    "in_proj", "lm_head", "embed", "wg", "wu", "fc1_w", "fc2_w",
}
# weights whose last dim is d_model (residual write-back) -> TP on the
# contracting (second-to-last) dim, FSDP on last
_OUT_PROJ = {"wo", "w_down", "out_proj", "wd"}
_REPLICATED = {
    "A_log", "D", "dt_bias", "gate_norm_scale", "norm_scale", "norm_bias",
    "post_norm_scale", "final_norm_scale", "final_norm_bias",
    "enc_norm_scale", "enc_norm_bias", "q_norm_scale", "kv_norm_scale",
    "conv_b",
}


class P(tuple):
    """A partition spec: one part per leading dim of an array, each an axis
    name, a tuple of axis names (the dim sharded over their product, the
    first major) or None (replicated). Trailing dims not named are
    replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh described by its axes alone: ``axis_names`` in order and
    their sizes. The spec rules read nothing else."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return mesh.shape[name]


def _fsdp_axis(mesh):
    """FSDP spans ("pod","data") when a pod axis exists, else "data"."""
    if "pod" in mesh.axis_names:
        return ("pod", "data")
    return "data"


def _fits(dim: int, mesh, axis) -> bool:
    return axis is not None and dim % _axis_size(mesh, axis) == 0


def _leaf_spec(key: str, shape: Tuple[int, ...], mesh, fsdp) -> P:
    nd = len(shape)
    lead = (None,) * max(nd - 2, 0)
    if key in _REPLICATED or nd == 0:
        return P()
    if nd == 1:
        return P("model") if _fits(shape[0], mesh, "model") else P()
    d_in, d_out = shape[-2], shape[-1]
    if key in ("wg", "wu", "wd") and nd >= 3:
        # MoE expert stacks (.., E, d_in, d_out): expert-parallel over fsdp
        # when E divides; else FSDP the matmul dim
        e_dim = shape[-3]
        if _fits(e_dim, mesh, fsdp):
            tp_pos = -1 if key in ("wg", "wu") else -2
            parts = [None] * nd
            parts[-3] = fsdp
            parts[tp_pos] = ("model" if _fits(shape[tp_pos], mesh, "model")
                             else None)
            return P(*parts)
        # fall through to the IN/OUT rules on the last two dims
    if key == "conv_w":  # (conv_dim, K): shard channels over fsdp
        return P(*lead, fsdp if _fits(d_in, mesh, fsdp) else None, None)
    if key == "router":  # (d, E): keep the expert dim whole for exact top-k
        return P(*lead, fsdp if _fits(d_in, mesh, fsdp) else None, None)
    if key in _OUT_PROJ:
        tp = "model" if _fits(d_in, mesh, "model") else None
        fs = fsdp if _fits(d_out, mesh, fsdp) else None
        return P(*lead, tp, fs)
    # default: IN_PROJ-style (covers unknown 2-D+ leaves conservatively)
    tp = "model" if _fits(d_out, mesh, "model") else None
    fs = fsdp if _fits(d_in, mesh, fsdp) else None
    if tp is None and fs is None and _fits(d_out, mesh, fsdp):
        return P(*lead, None, fsdp)  # at least FSDP the big dim
    return P(*lead, fs, tp)


def param_pspecs(params, mesh, layout: str = "2d"):
    """A tree of :class:`P` matching ``params`` (leaves: anything with a
    ``.shape``). Layout "dp" drops the tensor-parallel axis: weights shard
    over all axes combined on their FSDP dim, activations carry the whole
    batch split."""
    fsdp = tuple(mesh.axis_names) if layout == "dp" else _fsdp_axis(mesh)

    def leaf(key, shape):
        spec = _leaf_spec(key, shape, mesh, fsdp)
        if layout == "dp":
            spec = P(*[None if s == "model" else s for s in spec])
        return spec

    def rec_keyed(key, node):
        if isinstance(node, dict):
            return {k: rec_keyed(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec_keyed(key, v) for v in node)
        if node is None:
            return None
        return leaf(key, tuple(getattr(node, "shape", ())))

    return rec_keyed("", params)


def _path_key(k) -> str:
    """A path entry as the reference's ``str`` of a jax key path entry:
    ``['name']`` for a dict key, ``[i]`` for a sequence index."""
    return f"[{k!r}]"


def leaves_with_path(tree, path=()):
    """(path, leaf) pairs of a nest of dicts, lists and tuples; dict keys in
    sorted order (as a jax pytree flattens them), None an empty subtree,
    every other node a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], path + (_path_key(k),))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_path(v, path + (_path_key(i),))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (_path_key(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_paths(fn, v, path + (_path_key(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def state_pspecs(opt_state, params, param_specs, mesh):
    """Optimizer-state specs: moments mirror their parameter's spec;
    factored adafactor moments drop the corresponding axis; scalars
    replicate."""
    flat_s = dict(leaves_with_path(param_specs))
    flat_p = {path: (leaf, flat_s[path])
              for path, leaf in leaves_with_path(params)}

    def find_param(tail):
        for start in range(len(tail)):
            if tail[start:] in flat_p:
                return flat_p[tail[start:]]
            # factored states append 'vr'/'vc'/'v' INSIDE the param path
            if tail[start:-1] in flat_p:
                return flat_p[tail[start:-1]]
        return None

    fsdp = _fsdp_axis(mesh)

    def spec_of(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0:
            return P()
        hit = find_param(path)
        if hit is not None:
            p_leaf, p_spec = hit
            p_shape = tuple(p_leaf.shape)
            if shape == p_shape:
                return p_spec
            parts = tuple(p_spec) + (None,) * (len(p_shape) - len(p_spec))
            if shape == p_shape[:-1]:  # adafactor vr (drop last)
                return P(*parts[:-1])
            if shape == p_shape[:-2] + p_shape[-1:]:  # vc
                return P(*(parts[:-2] + parts[-1:]))
        # fallback by shape
        last = path[-1] if path else ""
        return _leaf_spec(last, shape, mesh, fsdp)

    return _map_paths(spec_of, opt_state)


def batch_pspec(mesh, ndim: int, batch_divisible: bool = True,
                layout: str = "2d") -> P:
    """Activations/batch arrays: dim 0 (batch) over (pod?, data), or over
    every axis in the pure-DP layout."""
    if not batch_divisible:
        return P(*((None,) * ndim))
    fsdp = tuple(mesh.axis_names) if layout == "dp" else _fsdp_axis(mesh)
    return P(fsdp, *((None,) * (ndim - 1)))


def cache_pspecs(cache, mesh, batch: int):
    """KV/state cache specs, keyed by cache-component name.

    The seq dim of attention K/V caches is never sharded (a decode step
    writes its entry at a position only known when it runs):

      k/v   (.., B, S, H, hd): batch@fsdp, head_dim@model (else heads)
      ckv/krope (.., B, S, r): batch@fsdp, S@model (MLA's payload a step is
             (B, 1, r))
      conv  (.., B, K, conv_dim): batch@fsdp, conv_dim@model
      ssm   (.., B, H, N, P): batch@fsdp, H@model (else P)

    batch=1 leaves the fsdp axis unused: the cache replicates over data but
    stays model-sharded."""
    fsdp = _fsdp_axis(mesh)
    dp = _axis_size(mesh, fsdp)
    msz = _axis_size(mesh, "model")

    def spec_for(key: str, shape) -> P:
        nd = len(shape)
        parts: list = [None] * nd
        b_dim = None
        for i, s in enumerate(shape):
            if s == batch and i <= 2:
                b_dim = i
                break
        if b_dim is not None and batch % dp == 0:
            parts[b_dim] = fsdp

        def try_model(*dims):
            for i in dims:
                if 0 <= i < nd and parts[i] is None and shape[i] % msz == 0 \
                        and shape[i] >= msz:
                    parts[i] = "model"
                    return

        if key in ("k", "v"):
            try_model(nd - 1, nd - 2)          # head_dim, then n_kv_heads
        elif key in ("ckv", "krope"):
            try_model(nd - 2)                  # seq
        elif key == "conv":
            try_model(nd - 1)                  # conv channels
        elif key == "ssm":
            try_model(nd - 3, nd - 1)          # heads, then head_dim
        else:
            try_model(nd - 1)
        return P(*parts)

    def rec(key, node):
        if isinstance(node, dict):
            return {k: rec(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(key, v) for v in node)
        if node is None:
            return None
        return spec_for(key, tuple(node.shape))

    return rec("", cache)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def spec_placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh axis:
    ``Shard(d)`` on each axis that dim ``d`` names, ``Replicate()`` on the
    others. A dim over several axes names them in mesh order (major
    first), which is DTensor's order for one dim sharded twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _map_specs(fn, specs, *trees):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)) and not isinstance(specs, P):
        return type(specs)(_map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    if specs is None:
        return None
    return fn(specs, *trees)


def to_placements(specs, mesh):
    """The tree of DTensor placements of a tree of specs (the reference's
    ``to_shardings``)."""
    return _map_specs(lambda s: spec_placements(s, mesh), specs)


def local_shard(x: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``placements``
    (a contiguous copy; no communication). Dims that several mesh axes
    shard are split axis by axis, in mesh order."""
    coords = mesh.coords
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.sizes[i]
            size = x.shape[pl.dim]
            if size % n:
                raise ValueError(f"dim {pl.dim} of size {size} does not "
                                 f"split over {n} ranks")
            x = x.narrow(pl.dim, coords[i] * (size // n), size // n)
    return x.contiguous()


def place(x: torch.Tensor, spec: P, mesh):
    """The global tensor ``x`` as a DTensor placed by ``spec``: each rank
    keeps its own block of its own copy of ``x`` (every rank holds the same
    global values, as SPMD ranks drawn from one seed do). A DTensor is
    redistributed to the spec."""
    from torch.distributed.tensor import DTensor

    pl = spec_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh.device_mesh, pl)
    return DTensor.from_local(local_shard(x, pl, mesh), mesh.device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def place_tree(tree, specs, mesh):
    """:func:`place` leaf by leaf over a tree and its specs. Leaves that are
    not tensors (a host step count) are kept as they are."""
    return _map_specs(lambda s, x: place(x, s, mesh)
                      if isinstance(x, torch.Tensor) else x, specs, tree)

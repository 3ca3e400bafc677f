"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): prove the
distribution config is coherent, and count one rank's work.

For every (architecture x input shape) combination this runs the step the
shape calls for (the train step for train_4k, the forward for
prefill_32k, the serve step for the decode shapes) on the production mesh
-- 16x16 ("data", "model"), 256 ranks, or 2x16x16 ("pod", "data",
"model"), 512 ranks -- with nothing allocated: the process poses as rank 0
of a ``"fake"`` process group of that size (collectives that do nothing),
and every parameter, optimizer state, batch and cache is a ``meta``
DTensor placed by the port's rules (``sharding.param_pspecs``,
``state_pspecs``, ``batch_pspec``, ``cache_pspecs``) under
``activation_mesh``. A step that runs to its end proves the placements
compose; one that raises is recorded as failed.

What the reference reads from XLA, the port counts from the aten ops rank
0 runs (:class:`RankCost`, a ``TorchDispatchMode`` that lets DTensor
handle its own ops and sees the rank-local ops and collectives DTensor
issues):

  - dot FLOPs: ``torch.utils.flop_counter``'s formulas on the local
    shapes of every matrix product (mm, addmm, bmm, baddbmm), the
    reference's ``dot`` instructions; dot bytes: their operands and
    results;
  - collectives by kind (all-gather / all-reduce / reduce-scatter /
    all-to-all / broadcast), each with its count and the bytes of its
    result, the convention of ``utils/hlo_parse.py``. On a CPU mesh
    DTensor replaces a shard-to-shard all-to-all by an all-gather and a
    chunk (gloo has no all-to-all); the dry run sends it to the all-to-all
    a CUDA mesh runs (:func:`cuda_shard_alltoall`);
  - the roofline terms (``launch/roofline.py``, H100 constants) and
    ``model_flops`` / ``useful_flops_ratio``, as the reference derives
    them.

The reference multiplies each while-loop body by its trip count. The
port's layers are a Python loop, so it traces the stack at two depths one
layer-pattern period apart (``trace_depths``: 1 and 2 periods above
deepseek's dense prologue; gemma2's local/global pair and jamba's period
of ``attn_every`` layers are one period; seamless's period is an encoder
and a decoder layer) and extrapolates linearly to ``n_layers``: the blocks
of one pattern cost the same, so the extrapolation is exact.

The record keeps the reference's keys where the quantity is the same.
``op_cost`` takes the place of ``hlo_cost`` (the same sub-keys) and
``trace_s`` that of ``lower_s`` / ``compile_s``. XLA's
``memory_analysis`` and ``cost_analysis_raw`` have no form on ``meta``
and are absent; ``bytes.hbm_per_device`` counts the resident parameters,
optimizer state and cache a rank holds, not its activations. Torch emits
no HLO, so there is no ``--hlo-dir``.

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json, never
in the reference's results/dryrun/.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_arch_config,
                                 supports_shape)
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.launch.roofline import analytic_memory_bytes, roofline_terms
from repro_torch.launch.specs import (as_meta, as_specs, cache_shapes,
                                      decode_inputs, params_shapes,
                                      train_inputs)
from repro_torch.launch.steps import (make_forward_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.transformer import block_layout
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding import (batch_pspec, cache_pspecs, param_pspecs,
                                  place_tree, state_pspecs)
from repro_torch.sharding.act import activation_mesh, placed_like
from repro_torch.sharding.specs import place
from repro_torch.utils.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# collective kinds, by a fragment of the op's name (c10d's in-place ops,
# the functional ops DTensor issues, their autograd forms, and DTensor's
# shard-to-shard all-to-all)
_COLLECTIVE_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("broadcast", "broadcast"))
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor")


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


class RankCost(TorchDispatchMode):
    """Counts the ops one rank runs: dot FLOPs and bytes, and each
    collective's count and result bytes, by kind.

    An op with a DTensor among its arguments is handed on to DTensor
    (``NotImplemented``), which runs its rank-local ops and collectives
    under this mode again: every count is of local shapes. (Counting the
    DTensor ops themselves, as ``FlopCounterMode`` does, gives the global
    product's count, not a rank's.) DTensor's sharding propagation runs an
    op once on global-shaped fake tensors to learn its output's shape;
    those calls pass through here too and are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        aten = torch.ops.aten
        self._flops = {op: flop_registry[op] for op in (
            aten.mm, aten.addmm, aten.bmm, aten.baddbmm)}
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.collective_bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}

    def _collective(self, func) -> Optional[str]:
        ns, name = func.namespace, func.__name__
        if ns not in _COLLECTIVE_NS:
            return None
        return next((kind for frag, kind in _COLLECTIVE_NAMES
                     if frag in name), None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves

        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in leaves):
            return NotImplemented
        if func is torch.ops.aten.equal.default \
                and all(a.is_meta for a in args):
            # DTensor checks a masked partial's mask (the vocab-split
            # embedding's, on a dim two mesh axes split) against the one it
            # holds; meta tensors hold no values and aten.equal has no meta
            # kernel. A real run compares the same mask.
            return True
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in leaves):
            return out
        packet = func.overloadpacket
        if packet in self._flops:
            self.dot_flops += float(self._flops[packet](*args, **kwargs,
                                                        out_val=out))
            self.dot_bytes += _nbytes(out) + sum(
                _nbytes(a) for a in args if isinstance(a, torch.Tensor))
            return out
        kind = self._collective(func)
        if kind is not None:
            # the result's bytes; an in-place c10d op returns (tensors, work)
            n = _nbytes(out[0] if isinstance(out, tuple) else out)
            slot = self.collectives.setdefault(kind, {"count": 0.0,
                                                      "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += n
            self.collective_bytes += n
        return out

    def as_dict(self) -> dict:
        return {"dot_flops_per_device": self.dot_flops,
                "dot_bytes_per_device": self.dot_bytes,
                "collective_bytes_per_device": self.collective_bytes,
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())}}


@contextlib.contextmanager
def fake_world(world_size: int):
    """``torch.distributed`` initialised on the ``"fake"`` backend as rank
    0 of ``world_size`` (its collectives do nothing); the group is
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own process group; one "
                           "is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def cuda_shard_alltoall():
    """DTensor's shard-to-shard redistribution as one all-to-all (its CUDA
    path) on the dry run's CPU mesh, where DTensor otherwise all-gathers and
    chunks (gloo has no all-to-all)."""
    from torch.distributed.tensor import placement_types

    real = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = real


def _tree_bytes(tree) -> int:
    """Bytes of a tree of ``TensorSpec`` (or anything with a shape and a
    dtype)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if tree is None or not hasattr(tree, "shape"):
        return 0
    return math.prod(tree.shape) * tree.dtype.itemsize


def _placed_batch(specs, mesh, layout, batch_divisible=True):
    return {k: place(as_meta(s), batch_pspec(mesh, len(s.shape),
                                             batch_divisible=batch_divisible,
                                             layout=layout), mesh)
            for k, s in specs.items()}


def period_layers(cfg) -> tuple:
    """(layers a period of the layer pattern, prologue layers): 1 for a
    uniform stack, 2 for gemma2's local/global pair, ``attn_every`` for
    jamba; deepseek's dense layer 0 is a prologue, kept whole."""
    if cfg.is_encoder_decoder:
        if cfg.n_enc_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: the dry run extrapolates an "
                             f"encoder-decoder with as many encoder layers "
                             f"as decoder layers, not {cfg.n_enc_layers} "
                             f"and {cfg.n_layers}")
        return 1, 0
    pattern, n_blocks, prologue = block_layout(cfg)
    return (cfg.n_layers - prologue) // n_blocks, prologue


def at_depth(cfg, n_periods: int):
    """``cfg`` cut to ``n_periods`` periods of its layer pattern (and its
    prologue)."""
    per, prologue = period_layers(cfg)
    over = {"n_layers": prologue + n_periods * per}
    if cfg.is_encoder_decoder:
        over["n_enc_layers"] = n_periods
    return dataclasses.replace(cfg, **over)


def _placed(cfg, mesh, layout):
    """(model, meta parameters, their specs, the parameters placed)."""
    model = build_model(cfg)
    ps = as_meta(params_shapes(model))
    p_specs = param_pspecs(ps, mesh, layout=layout)
    return model, ps, p_specs, place_tree(ps, p_specs, mesh)


def _placed_state(opt, ps, p_specs, mesh):
    state = opt.init(ps)
    return place_tree(state, state_pspecs(state, ps, p_specs, mesh), mesh)


def trace_step(cfg, shape, mesh, layout: str, *,
               update: bool = True) -> RankCost:
    """One step of ``shape``'s mode on ``cfg`` over ``mesh``, every input a
    placed ``meta`` DTensor; returns rank 0's counts. ``update=False``
    leaves the train step's optimizer update out (:func:`trace_update`
    counts it)."""
    model, ps, p_specs, params = _placed(cfg, mesh, layout)
    if shape.mode == "train":
        opt = make_optimizer(cfg.optimizer)
        state = _placed_state(opt, ps, p_specs, mesh)
        args = (params, state, _placed_batch(train_inputs(cfg, shape), mesh,
                                             layout))
        if not update:
            opt = Optimizer(opt.init, lambda p, g, s, lr_now=None: (p, s))
        step = make_train_step(model, opt)
    elif shape.mode == "prefill":
        batch = train_inputs(cfg, shape)
        batch.pop("labels", None)
        args = (params, _placed_batch(batch, mesh, layout))
        step = make_forward_step(model)
    else:
        cache_sds = cache_shapes(model, cfg, shape)
        cache = place_tree(as_meta(cache_sds),
                           cache_pspecs(cache_sds, mesh, shape.global_batch),
                           mesh)
        fsdp = mesh.shape["data"] * mesh.shape.get("pod", 1)
        batch = _placed_batch(decode_inputs(cfg, shape), mesh, layout,
                              shape.global_batch % fsdp == 0)
        # decode position: the last cache slot
        args = (params, cache, batch, shape.seq_len - 1)
        step = make_serve_step(model)
    cost = RankCost()
    with activation_mesh(mesh, layout), cuda_shard_alltoall(), cost:
        step(*args)
    return cost


def trace_update(cfg, mesh, layout: str) -> RankCost:
    """The train step's optimizer update of the whole stack, its gradients
    placed as its parameters (as the step leaves them), and the new trees
    placed as the old; returns rank 0's counts."""
    _, ps, p_specs, params = _placed(cfg, mesh, layout)
    opt = make_optimizer(cfg.optimizer)
    state = _placed_state(opt, ps, p_specs, mesh)
    grads = place_tree(ps, p_specs, mesh)
    cost = RankCost()
    with activation_mesh(mesh, layout), cuda_shard_alltoall(), cost:
        new_p, new_s = opt.update(params, grads, state)
        tree_map(placed_like, new_p, params)
        tree_map(placed_like, new_s, state)
    return cost


def _combine(a: dict, b: dict, wa: float, wb: float) -> dict:
    """wa x a + wb x b, field by field, of two ``RankCost.as_dict()``."""
    kinds = sorted(set(a["collectives"]) | set(b["collectives"]))
    zero = {"count": 0.0, "bytes": 0.0}
    return {**{f: wa * a[f] + wb * b[f] for f in (
        "dot_flops_per_device", "dot_bytes_per_device",
        "collective_bytes_per_device")},
        "collectives": {k: {f: wa * a["collectives"].get(k, zero)[f]
                            + wb * b["collectives"].get(k, zero)[f]
                            for f in ("count", "bytes")} for k in kinds}}


def _extrapolate(c1: dict, c2: dict, n: float) -> dict:
    """The counts at ``n`` periods from those at 1 and 2: c1 + (n - 1) x
    (c2 - c1)."""
    return _combine(c1, c2, 2 - n, n - 1)


def op_cost(cfg, shape, mesh, layout: str) -> tuple:
    """Rank 0's counts for the whole stack: the step extrapolated from the
    traces at 1 and 2 periods and, for a train step, its optimizer update
    traced at full depth (DTensor's plan for a stacked leaf's update can
    change with the stack's length); returns (counts, the two traced
    n_layers)."""
    per, prologue = period_layers(cfg)
    n = (cfg.n_layers - prologue) / per
    cfgs = [at_depth(cfg, d) for d in (1, 2)]
    train = shape.mode == "train"
    c1, c2 = (trace_step(c, shape, mesh, layout, update=not train).as_dict()
              for c in cfgs)
    cost = _extrapolate(c1, c2, n)
    if train:
        cost = _combine(cost, trace_update(cfg, mesh, layout).as_dict(), 1, 1)
    return cost, [c.n_layers for c in cfgs]


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              mesh=None, config_overrides: dict | None = None,
              layout: str = "2d") -> dict:
    """Trace one combination; returns the result record. ``mesh`` defaults
    to the production mesh on a fake world of its size (made here when no
    process group is initialised)."""
    shape = SHAPES[shape_name]
    cfg = get_arch_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    with contextlib.ExitStack() as stack:
        if mesh is None:
            if not dist.is_initialized():
                sizes, _ = production_mesh_shape(multi_pod=multi_pod)
                stack.enter_context(fake_world(math.prod(sizes)))
            mesh = make_production_mesh(multi_pod=multi_pod, backend="fake",
                                        device="cpu")
        return _record(arch, shape_name, shape, cfg, mesh, layout)


def _record(arch, shape_name, shape, cfg, mesh, layout) -> dict:
    n_chips = mesh.size
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.sizes),
        "axes": list(mesh.axis_names), "n_chips": int(n_chips),
        "mode": shape.mode, "param_count": cfg.param_count(),
        "param_count_active": cfg.param_count(active_only=True),
        "optimizer": cfg.optimizer, "layout": layout,
    }
    t0 = time.time()
    cost, depths = op_cost(cfg, shape, mesh, layout)
    rec["trace_s"] = round(time.time() - t0, 2)
    rec["trace_depths"] = depths
    rec["op_cost"] = cost

    # ---- roofline (GLOBAL = a rank's counts x ranks; memory term from the
    # analytic traffic model in launch/roofline.py) ----
    model = build_model(cfg)
    params_sds = params_shapes(model)
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    p_bytes = _tree_bytes(params_sds)
    opt_bytes = 0
    if shape.mode == "train":
        opt_sds = as_specs(make_optimizer(cfg.optimizer).init(
            as_meta(params_sds)))
        opt_bytes = _tree_bytes(opt_sds)
    cache_bytes = (_tree_bytes(cache_shapes(model, cfg, shape))
                   if shape.mode == "decode" else 0)
    n_layers_eff = cfg.n_layers + (cfg.n_enc_layers
                                   if cfg.is_encoder_decoder else 0)
    mem_global = analytic_memory_bytes(
        shape.mode, params_bytes=p_bytes, opt_bytes=opt_bytes,
        cache_bytes=cache_bytes, tokens=tokens, d_model=cfg.d_model,
        n_layers=n_layers_eff,
        act_bytes=getattr(torch, cfg.param_dtype).itemsize)
    rec["bytes"] = {"params": p_bytes, "opt_state": opt_bytes,
                    "kv_cache": cache_bytes,
                    "memory_traffic_global": mem_global,
                    "params_per_device": p_bytes / n_chips,
                    "hbm_per_device": (p_bytes + opt_bytes + cache_bytes)
                    / n_chips}
    flops_global = cost["dot_flops_per_device"] * n_chips
    coll_global = cost["collective_bytes_per_device"] * n_chips
    rec["roofline"] = roofline_terms(n_chips, flops_global, mem_global,
                                     coll_global)
    # MODEL_FLOPS = 6*N_active*tokens (train) / 2*N_active*tokens (fwd)
    mult = 6.0 if shape.mode == "train" else 2.0
    model_flops = mult * cfg.param_count(active_only=True) * tokens
    rec["model_flops"] = model_flops
    rec["useful_flops_ratio"] = (model_flops / flops_global
                                 if flops_global else None)
    rec["ok"] = True
    return rec


def choose_layout(arch: str, shape_name: str, n_chips: int) -> str:
    """Auto layout: pure-DP for small models on train_4k (TP activation
    all-reduces dominate otherwise — the reference's §Perf iteration 2: 7x
    collective-term win on h2o-danube), 2-D FSDP x TP everywhere else."""
    cfg = get_arch_config(arch)
    shape = SHAPES[shape_name]
    if shape.mode == "decode":
        # weights stay resident (no per-token FSDP gathers) — §Perf iter. 3
        return "decode"
    if (shape.mode == "train" and cfg.param_count() < 12e9
            and shape.global_batch % n_chips == 0):
        return "dp"
    return "2d"


def result_path(arch: str, shape_name: str, mesh_tag: str) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh_tag}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every supported (arch x shape) on this mesh")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--layout", choices=("auto", "2d", "dp", "decode"),
                    default="auto")
    args = ap.parse_args(argv)

    sizes, _ = production_mesh_shape(multi_pod=args.multi_pod)
    mesh_tag = "x".join(str(s) for s in sizes)
    if args.all:
        combos = [(a, s) for a in ARCH_NAMES for s in SHAPES
                  if supports_shape(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    failures = 0
    with fake_world(math.prod(sizes)):
        mesh = make_production_mesh(multi_pod=args.multi_pod, backend="fake",
                                    device="cpu")
        for arch, shape_name in combos:
            out = result_path(arch, shape_name, mesh_tag)
            if args.skip_existing and os.path.exists(out):
                print(f"[skip] {arch} x {shape_name} ({mesh_tag})")
                continue
            layout = (choose_layout(arch, shape_name, mesh.size)
                      if args.layout == "auto" else args.layout)
            print(f"[dryrun] {arch} x {shape_name} on {mesh_tag} "
                  f"(layout={layout}) ...", flush=True)
            try:
                rec = lower_one(arch, shape_name, mesh=mesh, layout=layout)
                roof, cost = rec["roofline"], rec["op_cost"]
                print(f"  trace {rec['trace_s']}s (n_layers "
                      f"{rec['trace_depths']}) dominant={roof['dominant']} "
                      f"step={roof['roofline_step_s']:.4f}s "
                      f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}")
                print(f"  hbm/device={rec['bytes']['hbm_per_device'] / 1e9:.2f}GB "
                      f"collective/dev="
                      f"{cost['collective_bytes_per_device'] / 1e9:.3f}GB "
                      f"collectives={json.dumps(cost['collectives'])}",
                      flush=True)
            except Exception as e:
                failures += 1
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                       "ok": False, "error": str(e),
                       "traceback": traceback.format_exc()}
                print(f"  FAILED: {e}", flush=True)
            with open(out, "w") as f:
                json.dump(rec, f, indent=2, default=str)
    if failures:
        raise SystemExit(f"{failures} dry-run combination(s) failed")
    return 0


if __name__ == "__main__":
    main()

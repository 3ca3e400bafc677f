"""Carry a reference system's initial state or model weights into the port.

torch cannot repeat ``jax.random`` draws, so a port system that must start
where a reference system starts takes that system's state as arrays:
``{k: np.asarray(v)}`` of its CNN params, and its BS distances and up/down
channel gains; an LM takes the reference's parameter tree, leaf by leaf as
numpy. Both models keep the reference's layout, so nothing is transposed.
The MARL controller's state comes over the same way: the reference's
``MADDPGState`` and ``EnvState`` with their leaves as numpy arrays, and so
do the scenario runners' and the serve loop's: a ``ScenarioBatch``, an
``FLState`` and a ``ServeState``; and an LM optimizer's state, so that both
sides train on from one mid-training state.
"""
from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(params_np, dist, h_up, h_down, device) -> dict:
    """Arrays -> the ``init_state`` dict ``DTWNSystem`` takes, as fp32
    tensors on ``device``: ``{"params", "dist", "h_up", "h_down"}``."""
    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"params": {k: put(v) for k, v in params_np.items()},
            "dist": put(dist), "h_up": put(h_up), "h_down": put(h_down)}


def lm_params_from_numpy(tree, device, dtype=None):
    """A reference LM parameter tree, its leaves converted to numpy (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``), -> the port's parameter
    dict with the same keys and shapes, on ``device``.

    ``np.asarray`` of a bf16 array gives an ``ml_dtypes.bfloat16`` array,
    which ``torch.from_numpy`` refuses; every leaf goes through float32,
    which holds bf16 exactly, and is then cast to ``dtype`` (default: the
    leaf's own dtype when it is float32, else bfloat16). The default keeps a
    bf16 tree's fp32 leaves in fp32: mamba's ``A_log``, ``D`` and
    ``dt_bias``, and the MoE router; a ``dtype`` casts every leaf. Nested
    stacks (jamba's ``blocks.mamba``, (n_blocks, 7, ...)), the
    ``prologue`` and the encoder-decoder's tree (``enc_blocks``,
    ``dec_blocks`` with its ``xattn``) come over leaf for leaf with the
    reference's keys. A loaded checkpoint's ``params`` come over too (bf16
    leaves as ``|V2`` bits).
    """
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _float_leaf(tree, device, dtype)


def _float_leaf(a, device, dtype=None):
    """One float leaf -> a tensor on ``device``: through fp32 (which holds
    bf16 exactly) to ``dtype``, default fp32 for an fp32 leaf and bf16 for
    any other. A ``|V2`` leaf holds bf16 bits, as a checkpoint of the
    reference (or of the port) gives them back (``checkpoint/ckpt.py``)."""
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device=device,
                                             dtype=dtype or torch.bfloat16)
    want = dtype or (torch.float32 if a.dtype == np.float32 else torch.bfloat16)
    return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=want)


def opt_state_from_numpy(tree, device):
    """A reference optimizer state with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``, or a loaded checkpoint's)
    -> the port's state on ``device``, with the same structure (dicts,
    lists and tuples): adamw's and
    adamw_bf16's ``{"m", "v", "step"}``, adafactor's ``{"v": {... {"vr",
    "vc"} | {"v"}}, "step"}``, sgd's ``{"mom", "step"}``. Float leaves go
    through fp32 and keep their width (fp32 moments fp32, bf16 moments
    bf16, as :func:`lm_params_from_numpy`); the step counter is an int32
    tensor, as the port's adamw and adafactor keep it."""
    if isinstance(tree, dict):
        return {k: opt_state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(opt_state_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype.kind in "iu":
        return torch.tensor(a, dtype=torch.int32, device=device)
    return _float_leaf(a, device)


def _tensors(tree, device):
    """A nest of dicts, lists and tuples of arrays -> the same nest of fp32
    (or integer) tensors on ``device``; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def maddpg_state_from_numpy(tree, device):
    """A reference ``MADDPGState`` whose leaves are numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, state)``) -> the port's
    ``MADDPGState`` on ``device``: actor, critic, both targets and both
    momentum trees, for either policy. Parameter dicts keep their keys and
    the MLP layers their order."""
    from repro_torch.core.marl.ddpg import MADDPGState

    return MADDPGState(*(_tensors(getattr(tree, f), device)
                         for f in MADDPGState._fields))


def env_state_from_numpy(tree, device):
    """A reference ``EnvState`` whose leaves are numpy arrays -> the port's
    ``EnvState`` on ``device``: the association as int32, the step counter
    as a host int, and the chain view (a ``ChainState``) when present."""
    from repro_torch.core.consensus import ChainState
    from repro_torch.core.marl.env import EnvState

    chain = None
    if getattr(tree, "chain", None) is not None:
        chain = ChainState(*(_tensors(getattr(tree.chain, f), device)
                             for f in ChainState._fields))
    return EnvState(
        freqs=_tensors(tree.freqs, device),
        data_sizes=_tensors(tree.data_sizes, device),
        h_up=_tensors(tree.h_up, device), h_down=_tensors(tree.h_down, device),
        dist=_tensors(tree.dist, device),
        assoc=_tensors(tree.assoc, device).to(torch.int32),
        t=int(np.asarray(tree.t)), chain=chain)


def scenario_batch_from_numpy(tree):
    """A reference ``ScenarioBatch`` with numpy leaves -> the port's, on the
    CPU: the float axes as fp32 tensors, and the row keys (S, 2) uint32
    folded into the port's int64 row seeds (which only seed the port's own
    default draws)."""
    from repro_torch.core.scenario import ScenarioBatch

    key = np.asarray(tree.key).astype(np.int64)
    seed = torch.from_numpy((key[:, 0] << 26) ^ key[:, 1])
    return ScenarioBatch(seed, *(
        None if getattr(tree, f) is None
        else torch.tensor(np.asarray(getattr(tree, f), np.float32))
        for f in ScenarioBatch._fields[1:]))


def fl_state_from_numpy(tree, device):
    """A reference ``FLState`` with numpy leaves -> the port's ``FLState``
    on ``device`` (labels as int64)."""
    from repro_torch.fl.stream import FLState

    def t(a, dtype=None):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        out = torch.tensor(a, device=device)
        return out if dtype is None else out.to(dtype)

    return FLState(
        params={k: t(v) for k, v in tree.params.items()},
        twin_params={k: t(v) for k, v in tree.twin_params.items()},
        twin_mom={k: t(v) for k, v in tree.twin_mom.items()},
        malicious=t(tree.malicious, torch.bool), x=t(tree.x),
        y=t(tree.y, torch.int64), x_eval=t(tree.x_eval),
        y_eval=t(tree.y_eval, torch.int64))


def serve_state_from_numpy(tree, device):
    """A reference ``ServeState`` with numpy leaves -> the port's
    ``ServeState`` on ``device``: the env (``env_state_from_numpy``), the
    masks as bool, the agent and replay in policy mode (the replay's
    pointer and size as host ints), the FL state, and the round counter as
    a host int."""
    from repro_torch.core.marl.replay import Replay
    from repro_torch.core.serve import ServeState

    buf = None
    if getattr(tree, "buf", None) is not None:
        b = tree.buf
        buf = Replay(*(_tensors(getattr(b, f), device)
                       for f in ("state", "act_enc", "reward", "next_state")),
                     ptr=int(np.asarray(b.ptr)), size=int(np.asarray(b.size)))
    return ServeState(
        env=env_state_from_numpy(tree.env, device),
        active=_tensors(tree.active, device).to(torch.bool),
        bad=_tensors(tree.bad, device).to(torch.bool),
        byz=_tensors(tree.byz, device).to(torch.bool),
        agent=(None if getattr(tree, "agent", None) is None
               else maddpg_state_from_numpy(tree.agent, device)),
        buf=buf,
        fl=(None if getattr(tree, "fl", None) is None
            else fl_state_from_numpy(tree.fl, device)),
        round=int(np.asarray(tree.round)))


def lm_params_to_mesh(tree, mesh, device=None, dtype=None, layout="2d"):
    """A reference LM parameter tree (numpy leaves, as
    :func:`lm_params_from_numpy` takes it) placed on an LM mesh
    (``launch/mesh.py``) by ``sharding.param_pspecs``: DTensors, each rank
    keeping its own block. ``device`` defaults to the mesh's."""
    from repro_torch.sharding import param_pspecs, place_tree

    params = lm_params_from_numpy(tree, device or mesh.device, dtype)
    return place_tree(params, param_pspecs(params, mesh, layout), mesh)

"""Checkpointing (port of ``repro/checkpoint/ckpt.py``): tree -> .npz + JSON
structure index.

Atomic (write-to-tmp + rename), step-indexed, with garbage collection of old
steps; this covers the train/FL loops' needs (params, optimizer state,
data-iterator seeds). The files are the reference's: a checkpoint written
here loads in the reference to the same tree, and the other way round.

A tree is a nest of dicts, lists, tuples and ``None`` whose leaves are
tensors (any device), numpy arrays or numbers. :func:`load_checkpoint`
returns numpy leaves, as the reference's does (``bridge`` carries them to
tensors). The reference writes a bf16 leaf as its raw 2-byte records and
reads it back as ``|V2`` (the dtype is lost; ROADMAP C2): a bf16 tensor is
written as the same bits (``view(torch.int16)`` seen as ``V2``), with no
``ml_dtypes``, and reads back as ``|V2`` too."""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def _to_numpy(x) -> np.ndarray:
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _flatten_with_paths(tree) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}", v)
        elif node is None:
            flat[prefix + "@none"] = np.zeros(0)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree)
    return flat


def _structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"__kind__": kind, "items": [_structure(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf"}


def _rebuild(struct, flat, prefix=""):
    kind = struct["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in struct["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, flat, f"{prefix}/{i}")
               for i, v in enumerate(struct["items"])]
        return seq if kind == "list" else tuple(seq)
    if kind == "none":
        return None
    return flat[prefix]


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    tree = tree_map(_to_numpy, tree)
    flat = _flatten_with_paths(tree)
    path = os.path.join(directory, f"ckpt_{step:09d}.npz")
    meta = os.path.join(directory, f"ckpt_{step:09d}.json")
    tmp = path + ".tmp.npz"  # .npz suffix keeps np.savez from renaming
    np.savez(tmp, **{k: v for k, v in flat.items()})
    os.replace(tmp, path)
    with open(meta + ".tmp", "w") as f:
        json.dump({"step": step, "structure": _structure(tree)}, f)
    os.replace(meta + ".tmp", meta)
    _gc(directory, keep)
    return path


def _gc(directory: str, keep: int):
    steps = sorted(
        int(f[5:14]) for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz"))
    for s in steps[:-keep] if keep > 0 else []:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(directory, f"ckpt_{s:09d}{ext}"))
            except OSError:
                pass


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:14]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None):
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(os.path.join(directory, f"ckpt_{step:09d}.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(directory, f"ckpt_{step:09d}.npz"))
    flat = {k: data[k] for k in data.files}
    return _rebuild(meta["structure"], flat), step

"""Shape-and-dtype stand-ins for every (arch x shape) combination (port of
``repro/launch/specs.py``).

Each function returns a tree of :class:`TensorSpec`: what the train and
decode steps consume, with no allocation. The modality frontends are stubs:
a vision-stub spec carries merged patch/text embeddings and M-RoPE position
triplets, an audio spec encoder frame embeddings (seq_len // 4 frames, at
least 8). Parameter and cache trees are built on the ``meta`` device:
:func:`params_shapes` runs the model's own ``init`` with every factory call
sent to ``meta`` and its generator dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The reference's ``jax.ShapeDtypeStruct``: a shape and a dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _act_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def train_inputs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.modality == "vision_stub":
        return {
            "embeds": TensorSpec((B, S, cfg.d_model), _act_dtype(cfg)),
            "positions": TensorSpec((B, S, 3), torch.int32),
            "labels": TensorSpec((B, S), torch.int32),
        }
    if cfg.is_encoder_decoder:
        return {
            "frames": TensorSpec((B, max(S // 4, 8), cfg.d_model),
                                 _act_dtype(cfg)),
            "tokens": TensorSpec((B, S), torch.int32),
        }
    return {"tokens": TensorSpec((B, S), torch.int32)}


def decode_inputs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    """One-token decode batch; the cache's spec comes from
    :func:`cache_shapes`."""
    B = shape.global_batch
    if cfg.modality == "vision_stub":
        return {
            "embed": TensorSpec((B, 1, cfg.d_model), _act_dtype(cfg)),
            "positions": TensorSpec((B, 1, 3), torch.int32),
        }
    return {"token": TensorSpec((B, 1), torch.int32)}


def as_specs(tree):
    """The tree of :class:`TensorSpec` of a tree of tensors."""
    if isinstance(tree, dict):
        return {k: as_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_specs(v) for v in tree)
    if tree is None:
        return None
    return TensorSpec(tuple(tree.shape), tree.dtype)


def as_meta(tree):
    """A tree of ``meta`` tensors of a tree of :class:`TensorSpec`."""
    if isinstance(tree, dict):
        return {k: as_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_meta(v) for v in tree)
    if tree is None:
        return None
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


class _OnMeta(TorchFunctionMode):
    """Every call with a ``device`` or ``generator`` argument goes to the
    ``meta`` device without its generator."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "generator" in kwargs or "device" in kwargs:
            kwargs.pop("generator", None)
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def cache_shapes(model, cfg: ArchConfig, shape: ShapeConfig):
    """The decode cache's tree of :class:`TensorSpec` (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return as_specs(model.init_cache(B, S, max(S // 4, 8), device="meta"))
    return as_specs(model.init_cache(B, S, device="meta"))


def params_shapes(model):
    """The parameters' tree of :class:`TensorSpec` (no allocation)."""
    with _OnMeta():
        return as_specs(model.init(torch.Generator()))

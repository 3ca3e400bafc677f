"""Uniform Model facade (port of ``repro/models/model.py``) for the
decoder-only assembly.

Every ported architecture exposes:
    init(generator) -> params
    forward(params, batch, **kw) -> (logits, aux[, cache])   (prefill; aux
        is the MoE layers' summed load-balance loss, 0.0 without MoE)
    init_cache(batch, seq, dtype=None, device=None) -> cache
    decode_step(params, cache, batch, pos) -> (logits, cache)   (the
        cache, in the reference's structure, written in place)
    loss(params, batch)  raises: training waits for its slice

Encoder-decoder configs (seamless) raise, naming ROADMAP A11.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    loss: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable


def _loss_not_ported(*_args, **_kwargs):
    raise NotImplementedError("loss_fn and chunked_xent are not ported yet: "
                              "the LM training slice (ROADMAP A11)")


def build_model(cfg: ArchConfig, *, use_pallas: bool = False) -> Model:
    """``use_pallas=True`` (the reference's keyword) sends every full-sequence
    GQA attention through the hand-written flash kernel, and every mamba
    mixer's SSD scan through the hand-written SSD-scan kernel. MLA's
    attention takes the plain path either way, as in the reference."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet (ROADMAP A11)")
    return Model(
        cfg=cfg,
        init=lambda gen: transformer.init_params(cfg, gen),
        loss=_loss_not_ported,
        forward=lambda p, b, **kw: transformer.forward(
            cfg, p, b, use_pallas=use_pallas, **kw),
        init_cache=lambda batch, seq, dtype=None, device=None:
            transformer.init_cache(cfg, batch, seq, dtype, device),
        decode_step=lambda p, c, b, pos: transformer.decode_step(cfg, p, c, b,
                                                                 pos),
    )

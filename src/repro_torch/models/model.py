"""Uniform Model facade (port of ``repro/models/model.py``) dispatching to
the decoder-only (``transformer``) and encoder-decoder (``encdec``)
assemblies.

Every architecture exposes:
    init(generator) -> params
    forward(params, batch, **kw) -> (logits, aux[, cache])   (prefill; aux
        is the MoE layers' summed load-balance loss, 0.0 without MoE;
        encoder-decoder: batch {frames, tokens}, no cache)
    init_cache(batch, seq, dtype=None, device=None) -> cache
        (encoder-decoder: init_cache(batch, seq, enc_frames=None,
        dtype=None, device=None), enc_frames defaulting to
        max(seq // 4, 8))
    decode_step(params, cache, batch, pos) -> (logits, cache)   (the
        cache, in the reference's structure, written in place)
    encode(params, frames) -> encoder output   (encoder-decoder only, None
        otherwise: the reference's serve calls ``encdec.encode``; the field
        keeps the model's attention route)
    loss(params, batch) -> scalar   (the train step's objective: next-token
        cross-entropy through the chunked vocab head, plus the MoE aux
        loss; an encoder-decoder's batch is {frames, tokens})
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    loss: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable
    encode: Optional[Callable] = None


def build_model(cfg: ArchConfig, *, use_pallas: bool = False) -> Model:
    """``use_pallas=True`` (the reference's keyword) sends every full-sequence
    GQA attention through the hand-written flash kernel (an encoder-decoder's
    encoder and decoder self-attention too), and every mamba mixer's SSD
    scan through the hand-written SSD-scan kernel. MLA's attention and
    cross-attention take the plain path either way, as in the reference."""
    if cfg.is_encoder_decoder:
        return Model(
            cfg=cfg,
            init=lambda gen: encdec.init_params(cfg, gen),
            loss=lambda p, b: encdec.loss_fn(cfg, p, b, use_pallas=use_pallas),
            forward=lambda p, b, **kw: encdec.forward(
                cfg, p, b, use_pallas=use_pallas, **kw),
            init_cache=lambda batch, seq, enc_frames=None, dtype=None,
            device=None: encdec.init_cache(
                cfg, batch, seq, enc_frames or max(seq // 4, 8), dtype, device),
            decode_step=lambda p, c, b, pos: encdec.decode_step(cfg, p, c, b,
                                                                pos),
            encode=lambda p, frames: encdec.encode(cfg, p, frames,
                                                   use_pallas=use_pallas),
        )
    return Model(
        cfg=cfg,
        init=lambda gen: transformer.init_params(cfg, gen),
        loss=lambda p, b: transformer.loss_fn(cfg, p, b,
                                              use_pallas=use_pallas),
        forward=lambda p, b, **kw: transformer.forward(
            cfg, p, b, use_pallas=use_pallas, **kw),
        init_cache=lambda batch, seq, dtype=None, device=None:
            transformer.init_cache(cfg, batch, seq, dtype, device),
        decode_step=lambda p, c, b, pos: transformer.decode_step(cfg, p, c, b,
                                                                 pos),
    )

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
    loss(params, batch)  raises: training waits for its slice (A11.8)
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


def _loss_not_ported(*_args, **_kwargs):
    raise NotImplementedError("loss_fn and chunked_xent are not ported yet: "
                              "the LM training slice (ROADMAP A11.8)")


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
            loss=_loss_not_ported,
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
        loss=_loss_not_ported,
        forward=lambda p, b, **kw: transformer.forward(
            cfg, p, b, use_pallas=use_pallas, **kw),
        init_cache=lambda batch, seq, dtype=None, device=None:
            transformer.init_cache(cfg, batch, seq, dtype, device),
        decode_step=lambda p, c, b, pos: transformer.decode_step(cfg, p, c, b,
                                                                 pos),
    )

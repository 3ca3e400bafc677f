"""The ``score`` request: the port's scoring forward ``model.forward(params,
{"tokens": prompts})``, logits at every position.

What decides ``correct``: ``logits``, the relative L2 gap of one position's
logits over the vocabulary, the widest over the sample.
"""
from __future__ import annotations

import torch

from portbench.check import rel
from portbench.reference.common import fp8_rows

# requests compared a run: each holds every position's logits, (B, S,
# vocab_padded) fp32, kept on the card through the window
SAMPLE = 2


def head_positions(seq: int) -> int:
    return seq


class Entry:
    """One request a call. The record: ``logits`` (B, S, vocab_padded) fp32,
    complete on the card when the call returns."""

    def __init__(self, model, params):
        self.model, self.params = model, params

    def __call__(self, prompts) -> dict:
        logits, _ = self.model.forward(self.params, {"tokens": prompts})
        if prompts.device.type == "cuda":
            torch.cuda.synchronize(prompts.device)
        return {"logits": logits}


def numbers(ref, sizes: dict, params: dict, prompts, record: dict) -> dict:
    """One request's numbers: ``record`` (the program's outputs, or the
    control's) against the fp32 reference on ``prompts``."""
    worst = []

    def on_logits(lo, hi, logits):
        got = record["logits"][:, lo:hi, :sizes["vocab_size"]]
        worst.append(rel(got, logits, -1).max().item())

    ref.forward(sizes, params, prompts, on_logits=on_logits)
    return {"logits": max(worst)}


def control_record(ref, sizes: dict, params: dict, prompts) -> dict:
    """The control's outputs of one request: the reference with fp8
    operands."""
    return {"logits": ref.forward(sizes, params, prompts, quant=fp8_rows)}

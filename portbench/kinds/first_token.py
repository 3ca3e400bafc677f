"""The ``first_token`` request: the port's ``serve.generate(model, params,
prompts, 1)``, the prefill, the decode cache filled from it and the first
greedy token. The LM head runs at the last position only.

What decides ``correct``, each number the widest over the sample:
- ``logits``: the relative L2 gap of a row's last-position logits over the
  vocabulary;
- ``kv``: the relative L2 gap of a layer's keys or values as the program
  left them in its decode cache;
- ``token_gap``: the reference's best logit less its logit of the served
  token.
"""
from __future__ import annotations

import torch

from portbench.check import rel
from portbench.reference.common import fp8_rows

# requests compared a run: a request serves one token a row, and each costs
# one fp32 reference pass after the window
SAMPLE = 8


def head_positions(seq: int) -> int:
    return 1


class CacheNotSeen(RuntimeError):
    """``generate`` returned without making a decode cache through the
    model's ``init_cache``: the ``kv`` number has nothing to read."""


class Entry:
    """One request a call. The record: ``tokens`` (B,) on the host,
    ``logits`` (B, vocab_padded) fp32 and the decode ``cache``, as the
    program made them. The cache is the one ``generate`` asked the model's
    ``init_cache`` for, seen through a model whose ``init_cache`` keeps
    it."""

    def __init__(self, model, params):
        from repro_torch.launch import serve

        self.serve, self.params = serve, params
        self._init_cache, self._cache = model.init_cache, None
        self.model = model._replace(init_cache=self._keep)

    def _keep(self, *args, **kw):
        self._cache = self._init_cache(*args, **kw)
        return self._cache

    def __call__(self, prompts) -> dict:
        self._cache = None
        res = self.serve.generate(self.model, self.params, prompts, 1)
        if self._cache is None:
            raise CacheNotSeen("serve.generate made no decode cache through "
                               "model.init_cache")
        rec = {"tokens": res["tokens"][:, 0].cpu(),
               "logits": res["logits"][:, 0], "cache": self._cache}
        self._cache = None
        return rec


def numbers(ref, sizes: dict, params: dict, prompts, record: dict) -> dict:
    """One request's numbers: ``record`` (the program's outputs, or the
    control's) against the fp32 reference on ``prompts``."""
    P, kv = prompts.shape[1], []
    cache = record["cache"]["blocks"]

    def on_kv(i, k, v):
        kv.append(max(rel(cache["k"][i][:, :P], k).item(),
                      rel(cache["v"][i][:, :P], v).item()))

    ref_logits = ref.forward(sizes, params, prompts, on_kv=on_kv)
    got = record["logits"][:, :sizes["vocab_size"]]
    served = record["tokens"].to(ref_logits.device)
    gap = ref_logits.max(-1).values - ref_logits.gather(
        -1, served[:, None].long())[:, 0]
    return {"logits": rel(got, ref_logits, -1).max().item(),
            "kv": max(kv) if len(kv) == sizes["n_layers"] else float("inf"),
            "token_gap": gap.max().item()}


def control_record(ref, sizes: dict, params: dict, prompts) -> dict:
    """The control's outputs of one request, in the record's layout: the
    reference computed with fp8 operands."""
    ks, vs = [], []
    logits = ref.forward(sizes, params, prompts, quant=fp8_rows,
                         on_kv=lambda i, k, v: (ks.append(k), vs.append(v)))
    return {"logits": logits, "tokens": logits.argmax(-1),
            "cache": {"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}}

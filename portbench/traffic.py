"""The general traffic generator: a traffic file's parameters turned into
the prompts of a run.

A traffic file (``traffic/<name>.json``) gives the request ``kind`` (a
module ``kinds/<kind>.py``: ``first_token``, prefill to the first greedy
token; ``score``, logits at every position), ``batch`` prompts of
``prompt_len`` tokens a request, drawn ``uniform`` over the configuration's
vocabulary, a ``closed`` loop with ``in_flight`` requests outstanding, and
in ``source`` the public statistic its lengths stand for. Every seed gives
the same sizes and arrivals; only the tokens differ.
"""
from __future__ import annotations

import math

import torch

from portbench import seeds

# prompts drawn before the window: as many as the card could serve at its
# peak, up to this many (more are reached only off the card, where the
# prompts then repeat in turn)
MAX_DRAWN = 4096


def validate(traffic: dict) -> None:
    if traffic.get("loop") != "closed" or traffic.get("in_flight") != 1:
        raise ValueError("the generator drives a closed loop with one "
                         "request in flight")
    if traffic.get("tokens") != "uniform":
        raise ValueError("the generator draws tokens uniform over the "
                         "vocabulary")
    for key in ("batch", "prompt_len"):
        if not isinstance(traffic.get(key), int) or traffic[key] < 1:
            raise ValueError(f"traffic {key} must be a positive integer")


def n_drawn(seconds: float, least_request_s: float, extra: int) -> int:
    """Prompts to draw: the most requests a window of ``seconds`` can
    finish at the card's peak, plus ``extra`` for the warm-up."""
    most = math.ceil(seconds / max(least_request_s, 1e-9)) + 1
    return min(most, MAX_DRAWN) + extra


def draw(traffic: dict, sizes: dict, seed: int, n: int, device):
    """(n, batch, prompt_len) int64 token ids uniform in [0, vocab_size),
    request ``i``'s prompts at ``[i]``."""
    gen = torch.Generator(device=device).manual_seed(seeds.sub(seed, "prompts"))
    return torch.randint(0, sizes["vocab_size"],
                         (n, traffic["batch"], traffic["prompt_len"]),
                         generator=gen, device=device)

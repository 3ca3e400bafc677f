"""The port's own copy of ``repro/data/tokens.py``, kept verbatim (numpy only)
so it returns the same arrays as the reference without importing it.

Synthetic LM token pipeline (offline container — no corpora).

Generates Zipf-distributed token streams with short-range Markov structure so
that the cross-entropy of a real model decreases during training (pure-uniform
tokens would pin loss at log V). Deterministic per (seed, shard)."""
from __future__ import annotations

import numpy as np


def synthetic_tokens(vocab: int, n_tokens: int, seed: int = 0,
                     order: int = 2) -> np.ndarray:
    """Zipfian unigram + hash-based bigram bias: learnable structure."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    base = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    # bias: with p=0.5, token t+1 = f(token t) for a fixed random map f
    fmap = rng.permutation(vocab).astype(np.int32)
    follow = rng.rand(n_tokens) < 0.5
    out = base.copy()
    out[1:][follow[1:]] = fmap[out[:-1][follow[1:]]]
    return out


def batches(tokens: np.ndarray, batch: int, seq: int, seed: int = 0):
    """Infinite iterator of {tokens: (batch, seq)} windows."""
    rng = np.random.RandomState(seed)
    n = tokens.shape[0] - seq - 1
    while True:
        starts = rng.randint(0, n, size=batch)
        yield {"tokens": np.stack([tokens[s : s + seq] for s in starts])}

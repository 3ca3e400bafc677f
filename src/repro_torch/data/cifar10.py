"""The port's own copy of ``repro/data/cifar10.py``, kept verbatim (numpy only) so it
returns the same arrays as the reference without importing it.

CIFAR-10 loader with a deterministic synthetic fallback.

The paper evaluates on CIFAR-10 (Section V). This container has no network
access; if the real binary batches exist under ``$CIFAR10_DIR`` (or
``./data/cifar-10-batches-py``) they are used, otherwise we generate
**cifar10-sim**: class-conditional Gabor/blob textures with the same shapes
and split sizes (50k train / 10k test, 32x32x3, 10 classes). The synthetic
classes are linearly-nonseparable but CNN-learnable, so FL convergence curves
(paper Fig. 6) are meaningful. Every experiment artifact records which
dataset was used.
"""
from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

NUM_CLASSES = 10
TRAIN_N = 50_000
TEST_N = 10_000


def _try_real(path: str):
    try:
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(path, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        xtr = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        ytr = np.asarray(ys, np.int32)
        with open(os.path.join(path, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xte = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        yte = np.asarray(d[b"labels"], np.int32)
        return ((xtr.astype(np.float32) / 255.0, ytr),
                (xte.astype(np.float32) / 255.0, yte), "cifar10")
    except (OSError, KeyError, pickle.UnpicklingError):
        return None


def _synthetic(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional textures: per-class Gabor orientation/frequency +
    colored blob; additive noise keeps Bayes error non-trivial."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, NUM_CLASSES, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0

    x = np.empty((n, 32, 32, 3), np.float32)
    # fixed per-class texture parameters (deterministic)
    prng = np.random.RandomState(1234)
    angles = prng.uniform(0, np.pi, NUM_CLASSES)
    freqs = prng.uniform(3.0, 9.0, NUM_CLASSES)
    colors = prng.uniform(0.2, 1.0, (NUM_CLASSES, 3))
    centers = prng.uniform(0.25, 0.75, (NUM_CLASSES, 2))
    for c in range(NUM_CLASSES):
        idx = np.nonzero(y == c)[0]
        if idx.size == 0:
            continue
        u = np.cos(angles[c]) * xx + np.sin(angles[c]) * yy
        gabor = 0.5 + 0.5 * np.sin(2 * np.pi * freqs[c] * u)
        blob = np.exp(-(((xx - centers[c, 0]) ** 2
                         + (yy - centers[c, 1]) ** 2) / 0.05))
        base = (0.6 * gabor + 0.4 * blob)[None, :, :, None] * colors[c]
        jitter = rng.normal(0, 0.25, size=(idx.size, 32, 32, 3))
        shift = rng.normal(0, 0.1, size=(idx.size, 1, 1, 3))
        x[idx] = np.clip(base + jitter + shift, 0.0, 1.0).astype(np.float32)
    return x, y


def load(max_train: int = TRAIN_N, max_test: int = TEST_N):
    """Returns ((x_train, y_train), (x_test, y_test), dataset_name)."""
    for path in (os.environ.get("CIFAR10_DIR", ""),
                 "data/cifar-10-batches-py"):
        if path and os.path.isdir(path):
            real = _try_real(path)
            if real is not None:
                (xtr, ytr), (xte, yte), name = real
                return ((xtr[:max_train], ytr[:max_train]),
                        (xte[:max_test], yte[:max_test]), name)
    xtr, ytr = _synthetic(max_train, seed=0)
    xte, yte = _synthetic(max_test, seed=1)
    return (xtr, ytr), (xte, yte), "cifar10-sim"

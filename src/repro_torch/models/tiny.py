"""A deliberately small FL model for population-scale streaming sweeps, port
of ``repro/models/tiny.py``.

The paper's CNN (``repro_torch.models.cnn``) holds ~2.1M parameters: one
``(capacity, ...)`` model and momentum row per twin in the streamed-FL
serve state (``repro_torch.fl.stream``) would take ~170 GB at N=10^4. This
model keeps the CNN's interface (``init_params`` / ``forward`` /
``loss_fn`` / ``accuracy`` over ``{"images", "labels"}`` batches) and its
(32, 32, 3) inputs, but mean-pools to 8x8 patches and classifies through one
hidden layer of 16: 3,258 parameters, ~260 MB of buffers at N=10^4.
Parameters are a dict with the reference's keys and layout.
``forward_stacked`` / ``loss_stacked`` run P models at once (leaves with a
leading P axis, batched products), as ``models.cnn`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_POOL = 4            # 32 -> 8 spatial via 4x4 mean pooling
_FEATS = 8 * 8 * 3   # flattened pooled features
_HIDDEN = 16


def init_params(gen: torch.Generator, num_classes: int = 10,
                dtype=torch.float32, device=None):
    """He-normal weights and zero biases, drawn from ``gen`` on the CPU and
    moved to ``device``."""
    def he(shape, fan_in):
        w = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
        return w.to(dtype=dtype, device=device)

    return {
        "w1": he((_FEATS, _HIDDEN), _FEATS),
        "b1": torch.zeros((_HIDDEN,), dtype=dtype, device=device),
        "w2": he((_HIDDEN, num_classes), _HIDDEN),
        "b2": torch.zeros((num_classes,), dtype=dtype, device=device),
    }


def forward(params, images):
    """images: (B, 32, 32, 3) float -> logits (B, 10)."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // _POOL, _POOL, w // _POOL, _POOL, c)
    x = x.mean(dim=(2, 4)).reshape(b, -1)
    x = F.relu(x @ params["w1"] + params["b1"])
    return x @ params["w2"] + params["b2"]


def loss_fn(params, batch):
    logits = forward(params, batch["images"])
    return F.cross_entropy(logits, batch["labels"].long())


def accuracy(params, batch):
    logits = forward(params, batch["images"])
    return torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())


def forward_stacked(params, images):
    """P models on their own images: leaves (P, ...), images (P, B, 32, 32,
    3) -> logits (P, B, 10)."""
    p, b, h, w, c = images.shape
    x = images.reshape(p, b, h // _POOL, _POOL, w // _POOL, _POOL, c)
    x = x.mean(dim=(3, 5)).reshape(p, b, -1)
    x = F.relu(torch.bmm(x, params["w1"]) + params["b1"][:, None])
    return torch.bmm(x, params["w2"]) + params["b2"][:, None]


def loss_stacked(params, batch):
    """(P,) mean cross-entropies of P models on their own minibatches."""
    logits = forward_stacked(params, batch["images"])
    p, b = logits.shape[:2]
    nll = F.cross_entropy(logits.reshape(p * b, -1),
                          batch["labels"].reshape(-1).long(),
                          reduction="none")
    return nll.reshape(p, b).mean(dim=1)

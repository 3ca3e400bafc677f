"""The paper's federated-learning model (Section V), port of
``repro/models/cnn.py``: two 5x5 convolutions (32, 64 channels), each
followed by 2x2 max-pooling, then a 512-unit fully-connected layer and a
10-way classifier head.

Parameters are a dict with the reference's keys and its NHWC/HWIO layout, so
a reference parameter dict loads as it is. ``forward`` moves to NCHW/OIHW
only inside, for ``F.conv2d``. ``forward_stacked`` / ``loss_stacked`` run P
models at once (leaves with a leading P axis, one minibatch each): the
convolutions become grouped convolutions over the P models, the dense
layers batched products, so one autograd pass over the sum of the P losses
gives every model its own gradient (the streamed FL round's local SGD,
``repro_torch.fl.client.local_sgd_stacked``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_params(gen: torch.Generator, num_classes: int = 10,
                dtype=torch.float32, device=None):
    """He-normal weights and zero biases, drawn from ``gen`` on the CPU and
    moved to ``device``."""
    def he(shape, fan_in):
        w = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
        return w.to(dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "conv1_w": he((5, 5, 3, 32), 5 * 5 * 3),
        "conv1_b": zeros(32),
        "conv2_w": he((5, 5, 32, 64), 5 * 5 * 32),
        "conv2_b": zeros(64),
        # after two 2x2 pools: 32 -> 16 -> 8 spatial, 64 channels
        "fc1_w": he((8 * 8 * 64, 512), 8 * 8 * 64),
        "fc1_b": zeros(512),
        "fc2_w": he((512, num_classes), 512),
        "fc2_b": zeros(num_classes),
    }


def _conv(x, w, b):
    """'SAME' 5x5 convolution: x NCHW, w HWIO -> NCHW."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=2)


def forward(params, images):
    """images: (B, 32, 32, 3) float -> logits (B, 10)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv1_w"], params["conv1_b"])), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2_w"], params["conv2_b"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten order
    x = F.relu(x @ params["fc1_w"] + params["fc1_b"])
    return x @ params["fc2_w"] + params["fc2_b"]


def loss_fn(params, batch):
    logits = forward(params, batch["images"])
    return F.cross_entropy(logits, batch["labels"].long())


def accuracy(params, batch):
    logits = forward(params, batch["images"])
    return torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())


def _conv_stacked(x, w, b):
    """P 'SAME' 5x5 convolutions as one grouped convolution: x (B, P*Cin,
    H, W), w (P, 5, 5, Cin, Cout) HWIO, b (P, Cout) -> (B, P*Cout, H, W)."""
    p, kh, kw, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(p * cout, cin, kh, kw)
    return F.conv2d(x, wt, b.reshape(-1), padding=2, groups=p)


def forward_stacked(params, images):
    """P models on their own images: leaves (P, ...), images (P, B, 32, 32,
    3) -> logits (P, B, 10)."""
    p, bsz = images.shape[:2]
    x = images.permute(1, 0, 4, 2, 3).reshape(bsz, p * 3, 32, 32)
    x = F.max_pool2d(F.relu(_conv_stacked(x, params["conv1_w"],
                                          params["conv1_b"])), 2)
    x = F.max_pool2d(F.relu(_conv_stacked(x, params["conv2_w"],
                                          params["conv2_b"])), 2)
    # (B, P*64, 8, 8) -> each model's NHWC flatten, (P, B, 4096)
    x = x.reshape(bsz, p, 64, 8, 8).permute(1, 0, 3, 4, 2).reshape(p, bsz, -1)
    x = F.relu(torch.bmm(x, params["fc1_w"]) + params["fc1_b"][:, None])
    return torch.bmm(x, params["fc2_w"]) + params["fc2_b"][:, None]


def loss_stacked(params, batch):
    """(P,) mean cross-entropies of P models on their own minibatches
    (``batch`` leaves (P, B, ...))."""
    logits = forward_stacked(params, batch["images"])
    p, b = logits.shape[:2]
    nll = F.cross_entropy(logits.reshape(p * b, -1),
                          batch["labels"].reshape(-1).long(),
                          reduction="none")
    return nll.reshape(p, b).mean(dim=1)

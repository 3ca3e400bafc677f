"""Learning-rate schedules (port of ``repro/optim/schedule.py``).

Each schedule maps a step (a Python int or a 0-d tensor) to a 0-d fp32
tensor, on the step's device, computed in fp32 as the reference computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (min_frac + (1.0 - min_frac) * cos)

    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        s = _f32(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        return torch.where(s < warmup, base_lr * w, cos(s - warmup))

    return lr

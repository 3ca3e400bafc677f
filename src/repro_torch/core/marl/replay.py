"""Replay memory of the MARL trainer, port of ``repro/core/marl/replay.py``.

The buffer's tensors are allocated once and rows are written in place; the
write pointer and the fill count are host ints, since the trainer knows
them without asking the device. Rows are N-independent: the state slots
hold ``spaces.compact_obs`` vectors and the action slot the (M, E)
joint-action encoding, so one row costs ``(2*compact_dim + M*E + M) * 4``
bytes at any twin count.

Two samplers: uniform (``replay_sample``) and prioritized-lite
(``replay_sample_prioritized``: proportional to the stored mean |reward|,
by a cumulative sum and a ``searchsorted`` inversion). Their draws (row
indices, or uniforms in [0, 1)) are an argument, or come from a
``torch.Generator`` on its device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Replay(NamedTuple):
    state: torch.Tensor       # (cap, compact_dim)
    act_enc: torch.Tensor     # (cap, n_agents, enc_dim)
    reward: torch.Tensor      # (cap, n_agents)
    next_state: torch.Tensor  # (cap, compact_dim)
    ptr: int                  # rows written so far
    size: int                 # valid rows, at most cap


def replay_init(capacity: int, state_dim: int, n_agents: int, enc_dim: int,
                device=None) -> Replay:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return Replay(state=zeros(capacity, state_dim),
                  act_enc=zeros(capacity, n_agents, enc_dim),
                  reward=zeros(capacity, n_agents),
                  next_state=zeros(capacity, state_dim), ptr=0, size=0)


def replay_row_bytes(buf: Replay) -> int:
    """Bytes one transition occupies (the N-independence figure of merit)."""
    return sum(a.element_size() * math.prod(a.shape[1:])
               for a in (buf.state, buf.act_enc, buf.reward, buf.next_state))


def replay_add(buf: Replay, s, e, r, s2) -> Replay:
    """Write one transition at row ``ptr % cap``, in place; returns the
    buffer with ``ptr`` and ``size`` advanced."""
    cap = buf.state.shape[0]
    i = buf.ptr % cap
    buf.state[i] = s
    buf.act_enc[i] = e
    buf.reward[i] = r
    buf.next_state[i] = s2
    return buf._replace(ptr=buf.ptr + 1, size=min(buf.size + 1, cap))


def _rows(buf: Replay, idx):
    return (buf.state[idx], buf.act_enc[idx], buf.reward[idx],
            buf.next_state[idx])


def uniform_indices(gen: torch.Generator, buf: Replay,
                    batch: int) -> torch.Tensor:
    """(batch,) row indices uniform over the valid rows (row 0 of an empty
    buffer), drawn from ``gen`` on its device."""
    return torch.randint(0, max(buf.size, 1), (batch,), generator=gen,
                         device=gen.device)


def replay_sample(buf: Replay, idx, batch: int):
    """``batch`` uniform rows ``(s, enc, r, s2)``; ``idx`` is the (batch,)
    row indices, or a ``torch.Generator`` to draw them from."""
    if isinstance(idx, torch.Generator):
        idx = uniform_indices(idx, buf, batch)
    return _rows(buf, idx)


def replay_sample_prioritized(buf: Replay, u, batch: int, eps: float = 1e-3):
    """Prioritized-lite sampling: P(row) proportional to the stored mean
    |reward| (+eps) over valid rows. ``u`` is (batch,) uniforms in [0, 1),
    or a ``torch.Generator`` to draw them from; each is scaled to the total
    priority and inverted through ``searchsorted(side="right")`` on the
    cumulative sum. An empty buffer sends every draw to row cap-1, an
    all-zero row, like the uniform sampler."""
    cap = buf.reward.shape[0]
    dev = buf.reward.device
    if isinstance(u, torch.Generator):
        u = torch.rand((batch,), generator=u, device=u.device)
    valid = (torch.arange(cap, device=dev) < buf.size).to(torch.float32)
    pri = (torch.abs(buf.reward).mean(dim=1) + eps) * valid
    csum = torch.cumsum(pri, dim=0)
    target = u.to(dev) * csum[-1]
    idx = torch.clamp(torch.searchsorted(csum, target, right=True), 0,
                      cap - 1)
    return _rows(buf, idx)

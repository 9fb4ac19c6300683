"""The replay ring's layout: ``buffer_init`` of
``rcmarl_tpu/training/buffer.py`` (pushes belong to the training
slices)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ReplayBuffer(NamedTuple):
    """Ring of transitions, every array ``(capacity, n_agents, ...)``."""

    s: torch.Tensor  # (C, N, n_states) scaled states
    ns: torch.Tensor  # (C, N, n_states)
    a: torch.Tensor  # (C, N, 1) float action indices
    r: torch.Tensor  # (C, N, 1) scaled rewards
    ptr: torch.Tensor  # () int32 next write position
    count: torch.Tensor  # () int32 number of valid rows


def buffer_init(capacity: int, n_agents: int, n_states: int) -> ReplayBuffer:
    f32 = torch.float32
    return ReplayBuffer(
        s=torch.zeros((capacity, n_agents, n_states), dtype=f32),
        ns=torch.zeros((capacity, n_agents, n_states), dtype=f32),
        a=torch.zeros((capacity, n_agents, 1), dtype=f32),
        r=torch.zeros((capacity, n_agents, 1), dtype=f32),
        ptr=torch.zeros((), dtype=torch.int32),
        count=torch.zeros((), dtype=torch.int32),
    )

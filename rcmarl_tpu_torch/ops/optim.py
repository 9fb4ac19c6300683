"""Optimizer state: the shape of ``rcmarl_tpu/ops/optim.py``'s Adam.

The serve slice only loads and writes checkpoints, which carry the
actors' Adam moments; the update rules belong to the training slices.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from rcmarl_tpu_torch.tree import map_tree


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 step counter (t in TF's formula)
    m: object  # first-moment tree, same structure as params
    v: object  # second-moment tree


def adam_init(params, count_shape: Sequence[int] = ()) -> AdamState:
    """Zero moments and a zero step count. ``count_shape=(N,)`` is the
    JAX package's ``vmap(adam_init)`` over a stacked agent axis."""
    return AdamState(
        count=torch.zeros(tuple(count_shape), dtype=torch.int32),
        m=map_tree(torch.zeros_like, params),
        v=map_tree(torch.zeros_like, params),
    )

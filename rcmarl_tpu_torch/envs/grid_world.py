"""The grid world's reset and observation: the serve slice's part of
``rcmarl_tpu/envs/grid_world.py``.

``env_reset`` is also the grid world's task draw (the JAX package's
``envs/api.py:env_task``): the goal layout a run starts from. The
dynamics belong to the training slices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.config import Config


class GridWorld(NamedTuple):
    """Static environment description."""

    nrow: int = 5
    ncol: int = 5
    n_agents: int = 5
    scaling: bool = True

    @property
    def mean_state(self) -> np.ndarray:
        x, y = np.arange(self.nrow), np.arange(self.ncol)
        return np.array([np.mean(x), np.mean(y)], dtype=np.float32)

    @property
    def std_state(self) -> np.ndarray:
        x, y = np.arange(self.nrow), np.arange(self.ncol)
        return np.array([np.std(x), np.std(y)], dtype=np.float32)


def make_env(cfg: Config) -> GridWorld:
    """The grid world of ``cfg``; the other worlds of the JAX package's
    zoo are not ported yet."""
    if cfg.env != "grid_world":
        raise NotImplementedError(
            f"env={cfg.env!r}: the port has only the grid world so far"
        )
    return GridWorld(cfg.nrow, cfg.ncol, cfg.n_agents, cfg.scaling)


def env_reset(env: GridWorld, key: torch.Tensor) -> torch.Tensor:
    """Integer positions ~ U{0..nrow-1} x U{0..ncol-1}: ``(N, 2)`` int32,
    bitwise ``jax.random.randint`` with array bounds. A batched
    ``(..., 2)`` key gives ``(..., N, 2)``, one reset per key."""
    return prng.randint(
        key, (env.n_agents, 2), torch.tensor([0, 0]), torch.tensor([env.nrow, env.ncol])
    )


def scale_state(env: GridWorld, pos: torch.Tensor) -> torch.Tensor:
    """``(pos - mean) / std`` per axis, or a plain float cast."""
    if not env.scaling:
        return pos.float()
    mean = torch.as_tensor(env.mean_state, device=pos.device)
    std = torch.as_tensor(env.std_state, device=pos.device)
    return (pos.float() - mean) / std

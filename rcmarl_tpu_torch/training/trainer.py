"""Run state: ``TrainState`` and ``init_train_state`` of
``rcmarl_tpu/training/trainer.py``.

The port builds the JAX package's exact initial state from the same key
(leaf for leaf, bitwise), so it can write a checkpoint that the JAX
package loads, and serve one without the JAX package installed. The
training blocks belong to later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.agents.updates import AgentParams, init_agent_params
from rcmarl_tpu_torch.config import Config
from rcmarl_tpu_torch.device import DeviceLike, resolve_device
from rcmarl_tpu_torch.envs.grid_world import env_reset, make_env
from rcmarl_tpu_torch.training.buffer import ReplayBuffer, buffer_init
from rcmarl_tpu_torch.tree import map_tree


class TrainState(NamedTuple):
    """Everything that evolves across blocks (one checkpointable tree)."""

    params: AgentParams
    buffer: ReplayBuffer
    desired: torch.Tensor  # (N, 2) int32 goal layout
    initial: torch.Tensor  # (N, 2) int32 reset layout
    key: torch.Tensor  # (2,) uint32 run key
    block: torch.Tensor  # () int32 completed-block counter


def init_train_state(
    cfg: Config,
    key: torch.Tensor,
    desired: Optional[torch.Tensor] = None,
    params: Optional[AgentParams] = None,
    device: DeviceLike = None,
) -> TrainState:
    """Fresh run state, drawn from ``key`` on the key's device (the host,
    as a rule) and then moved to ``device`` (``None`` is the GPU). A key
    on the ``meta`` device gives the state's shapes alone, the JAX
    package's ``eval_shape`` of this function."""
    dev = resolve_device(device)
    k_desired, k_initial, k_params, k_run = prng.split(key, 4)
    env = make_env(cfg)
    if desired is None:
        desired = env_reset(env, k_desired)
    initial = env_reset(env, k_initial)
    if params is None:
        params = init_agent_params(k_params, cfg)
    state = TrainState(
        params=params,
        buffer=buffer_init(cfg.buffer_size, cfg.n_agents, cfg.n_states),
        desired=torch.as_tensor(desired).to(torch.int32),
        initial=initial.to(torch.int32),
        key=k_run,
        block=torch.zeros((), dtype=torch.int32),
    )
    return map_tree(lambda t: t.to(dev), state)

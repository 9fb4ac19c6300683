"""Agent parameter structure: the ``AgentParams`` of
``rcmarl_tpu/agents/updates.py``, and ``init_agent_params`` from
``rcmarl_tpu/training/update.py``.

The update rules (critic/TR fits, consensus, actor steps) belong to the
training slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.config import Config
from rcmarl_tpu_torch.models.mlp import MLPParams, init_stacked_mlp
from rcmarl_tpu_torch.ops.optim import AdamState, adam_init


class AgentParams(NamedTuple):
    """All agents' learnable state, every leaf with leading agent axis N.
    ``critic_local`` is the malicious agent's private critic (an unused
    mirror for the other roles)."""

    actor: MLPParams
    critic: MLPParams
    tr: MLPParams
    critic_local: MLPParams
    actor_opt: AdamState


def init_agent_params(key: torch.Tensor, cfg: Config) -> AgentParams:
    """Each agent's independent Glorot-uniform draw, bitwise the JAX
    package's from the same key."""
    k_a, k_c, k_t, k_l = prng.split(key, 4)
    N = cfg.n_agents
    actor = init_stacked_mlp(k_a, N, cfg.obs_dim, cfg.hidden, cfg.n_actions)
    critic = init_stacked_mlp(k_c, N, cfg.obs_dim, cfg.hidden, 1)
    tr = init_stacked_mlp(k_t, N, cfg.sa_dim, cfg.hidden, 1)
    critic_local = init_stacked_mlp(k_l, N, cfg.obs_dim, cfg.hidden, 1)
    return AgentParams(actor, critic, tr, critic_local, adam_init(actor, (N,)))

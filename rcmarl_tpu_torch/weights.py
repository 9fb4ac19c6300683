"""Carry the JAX package's parameters into the port.

:func:`from_jax` takes a parameter tree of the JAX package with numpy
leaves (``jax.tree.map(np.asarray, tree)``) and returns the same
structure as the port's tensors: a NamedTuple the port also defines
(``AgentParams``, ``AdamState``, ``TrainState``, ``ReplayBuffer``)
becomes the port's type of that name, any other tuple a plain tuple.
It is how the tests feed both packages the same parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from rcmarl_tpu_torch.agents.updates import AgentParams
from rcmarl_tpu_torch.device import DeviceLike, resolve_device
from rcmarl_tpu_torch.ops.optim import AdamState
from rcmarl_tpu_torch.training.buffer import ReplayBuffer
from rcmarl_tpu_torch.training.trainer import TrainState

_TYPES = {cls.__name__: cls for cls in (AgentParams, AdamState, ReplayBuffer, TrainState)}


def from_jax(params_numpy, device: DeviceLike = None):
    """The port's tensors (on ``device``, ``None`` = the GPU) for a JAX
    parameter tree with numpy leaves."""
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, tuple):
            kids = [convert(c) for c in x]
            cls = _TYPES.get(type(x).__name__) if hasattr(x, "_fields") else None
            return cls(*kids) if cls is not None else tuple(kids)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return convert(params_numpy)

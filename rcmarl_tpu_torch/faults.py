"""Fault-plan records and the finite-parameter guard.

The serve slice needs two things from the JAX package's
``rcmarl_tpu/faults.py``: the :class:`FaultPlan` and
:class:`ReplicaFaultPlan` dataclasses, so that the ``__config__`` JSON a
checkpoint carries decodes into a :class:`~rcmarl_tpu_torch.config.Config`,
and :func:`params_finite`, the guard that refuses to serve a poisoned
policy. The fault injection itself belongs to the training slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from rcmarl_tpu_torch.tree import leaves

_PROBS = ("drop_p", "stale_p", "corrupt_p", "flip_p", "nan_p", "inf_p")

#: Valid always-adversarial payload modes of a :class:`ReplicaFaultPlan`.
BYZANTINE_MODES = ("nan", "sign_flip", "inf")


def _check_probs(plan, name: str) -> None:
    for field in _PROBS:
        p = getattr(plan, field)
        if not 0.0 <= float(p) <= 1.0:
            raise ValueError(f"{name}.{field}={p} must be in [0, 1]")
    if not float(plan.corrupt_scale) >= 0.0:
        raise ValueError(f"{name}.corrupt_scale={plan.corrupt_scale} must be >= 0")


@dataclass(frozen=True)
class FaultPlan:
    """Per-link transport-fault probabilities of the consensus exchange."""

    drop_p: float = 0.0
    stale_p: float = 0.0
    corrupt_p: float = 0.0
    corrupt_scale: float = 1.0
    flip_p: float = 0.0
    nan_p: float = 0.0
    inf_p: float = 0.0
    seed: int = 0

    def __post_init__(self):
        _check_probs(self, "FaultPlan")


@dataclass(frozen=True)
class ReplicaFaultPlan:
    """The replica-level gossip-link fault plan."""

    drop_p: float = 0.0
    stale_p: float = 0.0
    corrupt_p: float = 0.0
    corrupt_scale: float = 1.0
    flip_p: float = 0.0
    nan_p: float = 0.0
    inf_p: float = 0.0
    byzantine_replicas: Tuple[int, ...] = ()
    byzantine_mode: str = "nan"
    seed: int = 0

    def __post_init__(self):
        _check_probs(self, "ReplicaFaultPlan")
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(
                f"ReplicaFaultPlan.byzantine_mode={self.byzantine_mode!r}: "
                f"expected one of {BYZANTINE_MODES}"
            )
        byz = tuple(self.byzantine_replicas)
        if any(int(b) < 0 for b in byz):
            raise ValueError(
                f"ReplicaFaultPlan.byzantine_replicas={byz} must be "
                "non-negative replica indices"
            )
        if len(set(byz)) != len(byz):
            raise ValueError(
                f"ReplicaFaultPlan.byzantine_replicas={byz} carries "
                "duplicate indices"
            )


def params_finite(params) -> bool:
    """True when every floating leaf of ``params`` is finite (NaN and
    ±Inf both fail); integer leaves are not inspected."""
    return all(
        bool(torch.isfinite(leaf).all())
        for leaf in leaves(params)
        if torch.is_floating_point(leaf)
    )

"""Fleet serving: the port of ``rcmarl_tpu/serve/fleet.py``.

F policy checkpoints stacked along a leading fleet axis and served by
one launch, with per-request routing as data: request b is served by
member ``route[b]`` with the same ``fold_in(fold_in(key, b), n)`` key it
would get solo, so a routed row equals that member's solo row. The
per-member hot-swap watchers are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rcmarl_tpu_torch.config import Config
from rcmarl_tpu_torch.device import DeviceLike
from rcmarl_tpu_torch.models.mlp import MLPParams, pad_features
from rcmarl_tpu_torch.serve.engine import (
    SERVE_MODES,
    ServeEngine,
    batch_probs,
    sample_actions,
    serve_keys,
)


def fleet_stack(blocks: Sequence[MLPParams]) -> MLPParams:
    """F row-stacked actor blocks stacked along a NEW leading fleet axis:
    leaf shapes ``(N, ...) -> (F, N, ...)``."""
    if not blocks:
        raise ValueError("fleet_stack needs at least one member block")
    return tuple(
        (torch.stack([b[l][0] for b in blocks]), torch.stack([b[l][1] for b in blocks]))
        for l in range(len(blocks[0]))
    )


def fleet_block(
    cfg: Config,
    fleet: MLPParams,
    obs: torch.Tensor,
    key: Optional[torch.Tensor],
    route: torch.Tensor,
    mode: str = "sample",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain fleet arm: every member's probabilities for every
    request, then the ``(B,)`` route gathers row b from member
    ``route[b]``; sampling as solo."""
    if mode not in SERVE_MODES:
        raise ValueError(f"mode={mode!r}: expected one of {SERVE_MODES}")
    B = obs.shape[0]
    x = pad_features(obs, fleet[0][0].shape[-2])
    probs_all = batch_probs(cfg, fleet, x)  # (F, B, N, A)
    probs = probs_all[route.long(), torch.arange(B, device=obs.device)]
    return sample_actions(probs, key, mode), probs


class FleetEngine:
    """F checkpoints served as one stacked fleet. Each member loads
    through its own :class:`ServeEngine` (checksummed load, ``.prev``
    fallback, loud rejection of replica worlds and non-finite params),
    and all members must share one config."""

    def __init__(
        self,
        checkpoints: Sequence,
        cfg: Optional[Config] = None,
        mode: str = "sample",
        eval_seed: int = 0,
        serve_impl: str = "auto",
        device: DeviceLike = None,
    ) -> None:
        if not checkpoints:
            raise ValueError("FleetEngine needs at least one checkpoint")
        self.members: List[ServeEngine] = [
            ServeEngine(p, cfg=cfg, mode=mode, eval_seed=eval_seed,
                        serve_impl=serve_impl, device=device)
            for p in checkpoints
        ]
        cfg0 = self.members[0].cfg
        for m in self.members[1:]:
            if m.cfg != cfg0:
                raise ValueError(
                    f"fleet members must share ONE serving config: "
                    f"{m.checkpoint_path} was trained under a different Config "
                    "than member 0"
                )
        self.cfg = cfg0
        self.mode = mode
        self.eval_seed = eval_seed
        self.device = self.members[0].device
        self.serve_impl = self.members[0].serve_impl
        self.fleet = fleet_stack([m.block for m in self.members])
        self.counters = {"launches": 0, "actions": 0}

    @property
    def n_members(self) -> int:
        return len(self.members)

    def round_robin_route(self, B: int) -> torch.Tensor:
        """The default ``(B,)`` route: request b -> member b % F."""
        return torch.arange(B, dtype=torch.int32, device=self.device) % self.n_members

    def serve(
        self,
        obs: torch.Tensor,
        route: Optional[torch.Tensor] = None,
        key: Optional[torch.Tensor] = None,
        step: Optional[int] = None,
        mode: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve one batch through the fleet; ``route=None`` round-robins."""
        if route is None:
            route = self.round_robin_route(obs.shape[0])
        if key is None:
            key = serve_keys(
                self.eval_seed, self.counters["launches"] if step is None else step
            )
        if self.serve_impl == "plain":
            out = fleet_block(self.cfg, self.fleet, obs, key, route, mode or self.mode)
        else:
            from rcmarl_tpu_torch.ops.cuda_serve import serve_kernel_block

            out = serve_kernel_block(
                self.cfg, self.fleet, obs, key, mode or self.mode, route=route
            )
        self.counters["launches"] += 1
        self.counters["actions"] += int(obs.shape[0]) * int(obs.shape[1])
        return out

    def summary(self) -> dict:
        return {**self.counters, "members": [m.summary() for m in self.members]}

    def summary_line(self) -> str:
        """The JAX fleet's summary line."""
        c = self.counters
        per = ", ".join(
            f"m{f}:{'last-good' if m.degraded else 'fresh'}"
            f"({m.counters['swaps']}s/{m.counters['rejects']}r)"
            for f, m in enumerate(self.members)
        )
        return (
            f"fleet: {self.n_members} members, {c['launches']} launches, "
            f"{c['actions']} actions [{per}]"
        )

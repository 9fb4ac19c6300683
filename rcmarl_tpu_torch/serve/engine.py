"""Policy serving: the port of ``rcmarl_tpu/serve/engine.py``.

- :func:`stack_actor_rows` — all agents' actors as one row-stacked block
  (row i = agent i).
- :func:`serve_block` — the plain PyTorch serving arm: ``(B, N, obs_dim)``
  observations -> ``(actions, probs)``, the port of the JAX package's
  XLA ``serve_block``. It is the CUDA serve kernel's plain version
  (:mod:`rcmarl_tpu_torch.ops.cuda_serve`).
- :func:`serve_request_keys` — the per-(request, agent) key discipline
  ``fold_in(fold_in(key, b), n)``.
- :class:`ServeEngine` — the host shell: checksummed checkpoint load
  (with the ``.prev`` fallback), the stacked block, the deterministic
  replayable serve stream and the traffic counters.

``serve_impl`` picks the arm: ``'cuda'`` is the hand-written kernel,
``'plain'`` the PyTorch arm (for the tests), ``'auto'`` the kernel on
the card and the plain arm on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.config import Config
from rcmarl_tpu_torch.device import DeviceLike, resolve_device
from rcmarl_tpu_torch.models.mlp import (
    MLPParams,
    actor_probs,
    agent_slice,
    netstack_stack_rows,
    pad_features,
)

#: 'sample' draws one categorical action per (request, agent);
#: 'greedy' is the deterministic argmax (no keys consumed).
SERVE_MODES = ("sample", "greedy")

#: The serving arms (see the module docstring).
SERVE_IMPLS = ("auto", "cuda", "plain")


def resolve_serve_impl(impl: str, device: torch.device) -> str:
    """``'auto'`` -> ``'cuda'`` on a CUDA device, ``'plain'`` on the
    host; explicit arms pass through."""
    if impl not in SERVE_IMPLS:
        raise ValueError(f"serve_impl={impl!r}: expected one of {SERVE_IMPLS}")
    if impl != "auto":
        return impl
    return "cuda" if device.type == "cuda" else "plain"


def stack_actor_rows(params, cfg: Config) -> MLPParams:
    """All agents' actor nets as ONE row-stacked block (row i = agent i,
    first-layer rows zero-padded to the widest input)."""
    return netstack_stack_rows([agent_slice(params.actor, i) for i in range(cfg.n_agents)])


def serve_request_keys(key: torch.Tensor, B: int, N: int) -> torch.Tensor:
    """The ``(B, N, 2)`` per-(request, agent) keys
    ``fold_in(fold_in(key, b), n)``, in ``key``'s dtype and device."""
    rows = prng.fold_in(key, torch.arange(B, device=key.device))
    return prng.fold_in(rows[:, None, :], torch.arange(N, device=key.device)[None, :])


def serve_keys(eval_seed: int, step: int) -> torch.Tensor:
    """Launch ``step``'s base key in the ``eval_seed`` namespace (on the
    host): replaying a (seed, step) pair replays its action stream."""
    return prng.fold_in(prng.PRNGKey(eval_seed), step)


def batch_probs(cfg: Config, block: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """``(B, N, width)`` features through the row-stacked block ->
    ``(B, N, n_actions)`` probabilities (row n = agent n). A fleet block
    (leaves ``(F, N, ...)``) gives every member's ``(F, B, N, n_actions)``."""
    probs = actor_probs(block, x.transpose(0, 1), cfg.leaky_alpha, cfg.dot_dtype)
    return probs.transpose(-3, -2)


def sample_actions(
    probs: torch.Tensor, key: Optional[torch.Tensor], mode: str
) -> torch.Tensor:
    """``(B, N, A)`` probabilities -> ``(B, N)`` int32 actions: the
    argmax, or ``categorical(fold_in(fold_in(key, b), n), log(probs))``."""
    if mode not in SERVE_MODES:
        raise ValueError(f"mode={mode!r}: expected one of {SERVE_MODES}")
    if mode == "greedy":
        return torch.argmax(probs, dim=-1).to(torch.int32)
    B, N = probs.shape[0], probs.shape[1]
    words = prng.key_words(key).to(probs.device)
    keys = serve_request_keys(words, B, N)
    return prng.categorical(keys, torch.log(probs)).to(torch.int32)


def serve_block(
    cfg: Config,
    block: MLPParams,
    obs: torch.Tensor,
    key: Optional[torch.Tensor],
    mode: str = "sample",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain serving arm: ``(B, N, obs_dim)`` observations ->
    ``(actions, probs)``, ``(B, N)`` int32 and ``(B, N, A)`` float32."""
    if mode not in SERVE_MODES:
        raise ValueError(f"mode={mode!r}: expected one of {SERVE_MODES}")
    x = pad_features(obs, block[0][0].shape[-2])
    probs = batch_probs(cfg, block, x)
    return sample_actions(probs, key, mode), probs


class ServeEngine:
    """Load once, serve forever.

    Loads a checksummed checkpoint through the ``.prev`` fallback chain
    onto ``device`` (``None`` is the GPU), builds the stacked actor
    block and serves ``(B, N, obs_dim)`` batches through the resolved
    arm. A replica-world checkpoint and non-finite parameters fail
    loudly. ``counters`` is the traffic ledger the summary line reports
    (``swaps``/``rejects`` stay 0 until the hot-swap watcher is
    ported).
    """

    def __init__(
        self,
        checkpoint,
        cfg: Optional[Config] = None,
        mode: str = "sample",
        eval_seed: int = 0,
        serve_impl: str = "auto",
        device: DeviceLike = None,
    ) -> None:
        from rcmarl_tpu_torch.faults import params_finite
        from rcmarl_tpu_torch.utils.checkpoint import load_checkpoint_with_meta

        if mode not in SERVE_MODES:
            raise ValueError(f"mode={mode!r}: expected one of {SERVE_MODES}")
        self.device = resolve_device(device)
        self.checkpoint_path = Path(checkpoint)
        state, stored_cfg, loaded, _ = load_checkpoint_with_meta(
            self.checkpoint_path, cfg, device=self.device
        )
        if not params_finite(state.params):
            raise ValueError(
                f"checkpoint {loaded} holds non-finite parameters; refusing "
                "to serve a poisoned policy"
            )
        self.cfg = stored_cfg if cfg is None else cfg
        self.mode = mode
        self.eval_seed = eval_seed
        self.serve_impl = resolve_serve_impl(serve_impl, self.device)
        self.block = stack_actor_rows(state.params, self.cfg)
        self.degraded = False
        self.counters = {
            "launches": 0,
            "actions": 0,
            "swaps": 0,
            "rejects": 0,
            "fallbacks": 1 if Path(loaded) != self.checkpoint_path else 0,
        }

    def serve(
        self,
        obs: torch.Tensor,
        key: Optional[torch.Tensor] = None,
        step: Optional[int] = None,
        mode: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve one ``(B, N, obs_dim)`` batch -> ``(actions, probs)``.
        ``key=None`` uses the serve stream at the launch counter, or at
        ``step`` to replay a past launch exactly."""
        if key is None:
            key = serve_keys(
                self.eval_seed, self.counters["launches"] if step is None else step
            )
        if self.serve_impl == "plain":
            out = serve_block(self.cfg, self.block, obs, key, mode or self.mode)
        else:
            from rcmarl_tpu_torch.ops.cuda_serve import serve_kernel_block

            out = serve_kernel_block(self.cfg, self.block, obs, key, mode or self.mode)
        self.counters["launches"] += 1
        self.counters["actions"] += int(obs.shape[0]) * int(obs.shape[1])
        return out

    def summary(self) -> dict:
        return dict(self.counters)

    def summary_line(self) -> str:
        """The JAX engine's one-line serve summary, word for word."""
        c = self.counters
        status = "last-good" if self.degraded else "fresh"
        return (
            f"serve: {c['launches']} launches, {c['actions']} actions, "
            f"{c['swaps']} swaps, {c['rejects']} rejects, "
            f"{c['fallbacks']} fallbacks (served: {status})"
        )

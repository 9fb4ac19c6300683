"""Stacked-agent MLPs: the port of ``rcmarl_tpu/models/mlp.py``.

A model family is one tuple of ``(W, b)`` layer pairs whose leaves carry
a leading agent axis: ``W`` is ``(N, in, out)`` and ``b`` is ``(N, out)``.
Every function here takes such stacked parameters with ``x`` of shape
``(N, batch, features)``, or one agent's parameters with ``x`` of shape
``(batch, features)``; the leading agent axis replaces the JAX package's
``vmap`` over agents. Initialisation draws the JAX package's exact
weights from the same key (:mod:`rcmarl_tpu_torch.prng`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rcmarl_tpu_torch import prng

MLPParams = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def dot(a: torch.Tensor, b: torch.Tensor, dtype: Optional[str] = None) -> torch.Tensor:
    """Model contraction at the configured precision.

    ``dtype=None``: a float32 matmul (the parity path; on the card TF32
    must be off, which is PyTorch's default for matmul).
    ``dtype='bfloat16'``: both operands rounded to bf16, the products
    (exact in float32) accumulated in float32, as the JAX package's
    ``preferred_element_type=float32`` recipe does.
    """
    if dtype is None:
        return torch.matmul(a, b)
    if dtype != "bfloat16":
        raise ValueError(f"dot dtype={dtype!r}: expected None or 'bfloat16'")
    return torch.matmul(
        a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    )


def glorot_uniform(key: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """Keras' default kernel init: U(-l, l), l = sqrt(6/(fan_in+fan_out)).
    A batched ``(..., 2)`` key gives ``(..., fan_in, fan_out)``."""
    limit = float(
        torch.sqrt(torch.tensor(6.0 / (fan_in + fan_out), dtype=torch.float32, device="cpu"))
    )
    return prng.uniform(key, (fan_in, fan_out), -limit, limit)


def init_mlp(
    key: torch.Tensor, in_dim: int, hidden: Sequence[int], out_dim: int
) -> MLPParams:
    """One MLP per key: Glorot-uniform kernels, zero biases. A batched
    ``(..., 2)`` key gives leaves with its batch shape leading, which is
    the JAX package's ``vmap(init_mlp)``."""
    dims = [in_dim, *hidden, out_dim]
    keys = prng.split(key, len(dims) - 1)
    batch = tuple(key.shape[:-1])
    return tuple(
        (
            glorot_uniform(keys[..., l, :], d_in, d_out),
            torch.zeros(batch + (d_out,), dtype=torch.float32, device=key.device),
        )
        for l, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))
    )


def init_stacked_mlp(
    key: torch.Tensor, n_agents: int, in_dim: int, hidden: Sequence[int], out_dim: int
) -> MLPParams:
    """N independent MLPs stacked on a leading agent axis, agent i drawn
    from ``split(key, N)[i]``."""
    return init_mlp(prng.split(key, n_agents), in_dim, hidden, out_dim)


def leaky_relu(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def trunk_apply(
    trunk_params: MLPParams, x: torch.Tensor, alpha: float = 0.1, dtype=None
) -> torch.Tensor:
    """Hidden layers only, on already flat features."""
    h = x
    for W, b in trunk_params:
        h = leaky_relu(dot(h, W, dtype) + b.unsqueeze(-2), alpha)
    return h


def head_forward(head_params, phi: torch.Tensor, dtype=None) -> torch.Tensor:
    W, b = head_params
    return dot(phi, W, dtype) + b.unsqueeze(-2)


def mlp_forward(
    params: MLPParams, x: torch.Tensor, alpha: float = 0.1, dtype=None
) -> torch.Tensor:
    """Full forward pass -> ``(..., batch, out_dim)`` linear output."""
    return head_forward(params[-1], trunk_apply(params[:-1], x, alpha, dtype), dtype)


def actor_probs(
    params: MLPParams, x: torch.Tensor, alpha: float = 0.1, dtype=None
) -> torch.Tensor:
    """Softmax policy probabilities (max-subtracted)."""
    return torch.softmax(mlp_forward(params, x, alpha, dtype), dim=-1)


def agent_slice(params: MLPParams, i: int) -> MLPParams:
    """Agent i's parameters from a stacked family."""
    return tuple((W[i], b[i]) for W, b in params)


def pad_features(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the trailing feature axis of ``x`` up to ``width``."""
    d = x.shape[-1]
    if d == width:
        return x
    if d > width:
        raise ValueError(f"cannot pad feature dim {d} down to {width}")
    return torch.nn.functional.pad(x, (0, width - d))


def pad_rows(W: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the input-row axis (``-2``) of a kernel up to ``rows``."""
    d = W.shape[-2]
    if d == rows:
        return W
    return torch.nn.functional.pad(W, (0, 0, 0, rows - d))


def netstack_stack_rows(nets: Sequence[MLPParams]) -> MLPParams:
    """Stack MLP families along a NEW leading row axis, zero-padding each
    first-layer kernel's input rows to the widest (padded rows are
    exactly neutral in the forward pass)."""
    nets = tuple(nets)
    if not nets:
        raise ValueError("netstack_stack_rows needs at least one net")
    depths = {len(n) for n in nets}
    if len(depths) != 1:
        raise ValueError(f"netstack requires equal depth, got {sorted(depths)} layers")
    width = max(n[0][0].shape[-2] for n in nets)
    padded = [((pad_rows(n[0][0], width), n[0][1]),) + tuple(n[1:]) for n in nets]
    return tuple(
        (torch.stack([p[l][0] for p in padded]), torch.stack([p[l][1] for p in padded]))
        for l in range(len(padded[0]))
    )

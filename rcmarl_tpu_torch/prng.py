"""A ``jax.random``-compatible threefry2x32 generator on torch tensors.

The JAX package draws every random number from keyed threefry2x32
streams (``jax.random``). The port reproduces those streams bit for bit,
so a policy served or initialised here samples the same actions and
draws the same weights as the reference from the same key.

Keys are explicit tensors of shape ``(..., 2)`` holding the two key
words, as ``torch.uint32`` (what :func:`PRNGKey` returns and a
checkpoint stores) or as ``int64``; there is no global generator state.
The uint32 arithmetic runs on ``int64`` tensors masked with
``& 0xFFFFFFFF``, because torch implements few operators for
``uint32``. Derived keys keep the dtype of the key they came from, so
int64 keys never leave the arithmetic dtype (on the card, too).

The bits layout is jax's *partitionable* one (``jax_threefry_partitionable``,
the default since jax 0.5): element ``i`` of a ``random_bits`` draw
(row-major flat index) is ``o0 ^ o1`` of ``threefry2x32(key, (i >> 32,
i & 0xFFFFFFFF))``, and ``split(key, n)[i]`` is the word pair
``threefry2x32(key, (0, i))`` itself. ``fold_in(key, d)`` is
``threefry2x32(key, (0, d))``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One threefry2x32 block on int64 tensors holding uint32 words:
    key ``(k0, k1)``, counter ``(x0, x1)`` -> the two output words.
    Elementwise; all four operands broadcast."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK
    return x0, x1


def key_words(key: torch.Tensor) -> torch.Tensor:
    """The ``(..., 2)`` key words as int64 (the arithmetic dtype)."""
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has trailing shape (2,), got {tuple(key.shape)}")
    return key.to(torch.int64) & MASK


def _as_key(words: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return words if like.dtype == torch.int64 else words.to(torch.uint32)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the int32 seed
    in the low word, zero in the high word."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device).to(
        torch.uint32
    )


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``(num, 2)`` keys; a batched
    ``(..., 2)`` key gives ``(..., num, 2)``."""
    w = key_words(key)
    i = torch.arange(num, dtype=torch.int64, device=w.device)
    o0, o1 = threefry2x32(w[..., 0, None], w[..., 1, None], torch.zeros_like(i), i)
    return _as_key(torch.stack([o0, o1], dim=-1), key)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``key`` ``(..., 2)`` and
    ``data`` (an int or an integer tensor) broadcast against each
    other, which batches what jax writes as a ``vmap``."""
    w = key_words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=w.device) & MASK
    o0, o1 = threefry2x32(w[..., 0], w[..., 1], torch.zeros_like(d), d)
    return _as_key(torch.stack(torch.broadcast_tensors(o0, o1), dim=-1), key)


def _bits64(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``random_bits`` as int64 words; a batched ``(..., 2)`` key gives
    ``(..., *shape)`` — one independent draw per key, as under ``vmap``."""
    w = key_words(key)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=w.device)
    batch = w.shape[:-1]
    k0 = w[..., 0].reshape(batch + (1,))
    k1 = w[..., 1].reshape(batch + (1,))
    o0, o1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return (o0 ^ o1).reshape(batch + shape)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32)."""
    return _bits64(key, shape).to(torch.uint32)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 with ONE rounding, as the fused
    multiply-add XLA:CPU emits for jax's uniform affine map. The float64
    product is exact; the float64 sum is rounded to odd (the TwoSum
    error decides the last bit), so the final cast to float32 rounds
    the exact value correctly."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """jax's mantissa fill: 23 random bits under the exponent of 1.0,
    minus 1, then the affine map onto ``[minval, maxval)``, in float32."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = mant - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo.expand_as(floats)))


def uniform(
    key: torch.Tensor,
    shape: Sequence[int] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform`` for float32 with scalar bounds."""
    return _uniform_from_bits(_bits64(key, shape), minval, maxval)


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` for float32 in its default 'low' mode:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis.

    A single ``(2,)`` key draws one gumbel array over all of
    ``logits.shape``, as jax does. A batched ``(..., 2)`` key whose
    batch shape equals ``logits.shape[:-1]`` draws one ``(A,)`` row per
    key, which is what ``vmap(jax.random.categorical)`` computes."""
    if key.dim() == 1:
        g = gumbel(key, logits.shape)
    else:
        if tuple(key.shape[:-1]) != tuple(logits.shape[:-1]):
            raise ValueError(
                f"batched keys {tuple(key.shape)} do not match logits "
                f"{tuple(logits.shape)}"
            )
        g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def _rem(x: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """uint32 remainder with XLA's ``x % 0 == x``."""
    zero = span == 0
    return torch.where(zero, x, x % torch.where(zero, torch.ones_like(span), span))


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: IntLike,
    maxval: IntLike,
) -> torch.Tensor:
    """``jax.random.randint(..., dtype=int32)`` with scalar or array
    bounds (broadcast against ``shape``): two 32-bit draws folded into
    the span exactly as jax folds them. A batched ``(..., 2)`` key gives
    ``(..., *shape)``, one draw per key."""
    i32_min, i32_max = -(2**31), 2**31 - 1
    device = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=device)
    hi_out_of_range = hi > i32_max
    lo = lo.clamp(i32_min, i32_max)
    hi = hi.clamp(i32_min, i32_max)
    ks = split(key, 2)
    k1, k2 = ks[..., 0, :], ks[..., 1, :]
    higher = _bits64(k1, shape)
    lower = _bits64(k2, shape)
    span = (hi - lo) & MASK
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    span = torch.where(hi_out_of_range & (hi > lo), (span + 1) & MASK, span)
    mult = _rem(torch.full_like(span, 2**16), span)
    mult = _rem((mult * mult) & MASK, span)
    off = (((_rem(higher, span) * mult) & MASK) + _rem(lower, span)) & MASK
    off = _rem(off, span)
    out = lo + off
    return (((out - i32_min) & MASK) + i32_min).to(torch.int32)

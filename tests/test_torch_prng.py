"""The port's threefry2x32 generator against ``jax.random``.

The uint32 words (keys, splits, fold-ins, raw bits, the uniform's float
bits, randint) must be bitwise jax's; gumbel floats within rtol 1e-6
(the two ``log`` implementations may differ by an ulp); categorical
draws equal over 1,000 keys. Inputs are made with numpy from a seed and
handed to both packages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmarl_tpu.envs import grid_world as jgw
from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.envs import grid_world as tgw

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _same_words(a, b: torch.Tensor) -> None:
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 42, 300, 2**31 - 1, -5])
def test_prngkey(seed):
    _same_words(jax.random.PRNGKey(seed), prng.PRNGKey(seed))


@pytest.mark.parametrize("num", [1, 2, 4, 7])
def test_split(num):
    key = jax.random.PRNGKey(11)
    _same_words(jax.random.split(key, num), prng.split(prng.PRNGKey(11), num))


@pytest.mark.parametrize("data", [0, 1, 7, 4096, 2**31 - 1])
def test_fold_in(data):
    key = jax.random.PRNGKey(3)
    _same_words(jax.random.fold_in(key, data), prng.fold_in(prng.PRNGKey(3), data))


def test_fold_in_batched_equals_vmap():
    key = jax.random.PRNGKey(9)
    data = np.arange(37)
    want = jax.vmap(lambda d: jax.random.fold_in(key, d))(jnp.asarray(data))
    _same_words(want, prng.fold_in(prng.PRNGKey(9), torch.arange(37)))


@pytest.mark.parametrize("shape", [(), (1,), (4,), (5,), (3, 7), (2, 3, 5)])
def test_random_bits(shape):
    key = jax.random.PRNGKey(42)
    _same_words(jax.random.bits(key, shape), prng.random_bits(prng.PRNGKey(42), shape))


@pytest.mark.parametrize(
    "bounds", [(0.0, 1.0), (-0.3, 0.3), (-0.7745967, 0.7745967), (2.5, 7.25)]
)
def test_uniform_bitwise(bounds):
    lo, hi = bounds
    for seed in range(3):
        want = np.asarray(
            jax.random.uniform(jax.random.PRNGKey(seed), (40, 30), minval=lo, maxval=hi)
        )
        got = prng.uniform(prng.PRNGKey(seed), (40, 30), lo, hi).numpy()
        np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("shape", [(5,), (6,), (4, 3)])
def test_gumbel(shape):
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.gumbel(key, shape))
    got = prng.gumbel(prng.PRNGKey(5), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_randint_array_bounds():
    rng = np.random.default_rng(0)
    lo = rng.integers(-20, 20, size=(3,)).astype(np.int32)
    hi = (lo + rng.integers(1, 1000, size=(3,))).astype(np.int32)
    for seed in range(5):
        want = jax.random.randint(
            jax.random.PRNGKey(seed), (4, 3), jnp.asarray(lo), jnp.asarray(hi), dtype=jnp.int32
        )
        _same_words(want, prng.randint(prng.PRNGKey(seed), (4, 3), _t(lo), _t(hi)))


def test_randint_batched_keys_equal_vmap():
    keys = jax.random.split(jax.random.PRNGKey(2), 16)
    lo, hi = jnp.array([0, 0]), jnp.array([5, 7])
    want = jax.vmap(
        lambda k: jax.random.randint(k, (3, 2), lo, hi, dtype=jnp.int32)
    )(keys)
    got = prng.randint(_t(keys), (3, 2), torch.tensor([0, 0]), torch.tensor([5, 7]))
    _same_words(want, got)


@pytest.mark.parametrize("n_actions", [2, 5, 7])
def test_categorical_1000_keys(n_actions):
    rng = np.random.default_rng(n_actions)
    logits = np.log(rng.dirichlet(np.ones(n_actions), size=1000)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(17), 1000)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits)))
    got = prng.categorical(_t(keys), _t(logits)).numpy()
    np.testing.assert_array_equal(want, got)


def test_categorical_single_key():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(50, 6)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(4), jnp.asarray(logits)))
    got = prng.categorical(prng.PRNGKey(4), _t(logits)).numpy()
    np.testing.assert_array_equal(want, got)


def test_int64_keys_give_the_same_words():
    key = prng.PRNGKey(8)
    wide = prng.key_words(key)
    assert wide.dtype == torch.int64
    np.testing.assert_array_equal(
        prng.fold_in(wide, 5).numpy(), prng.fold_in(key, 5).numpy().astype(np.int64)
    )


@pytest.mark.parametrize("grid", [(5, 5, 5), (3, 4, 6)])
def test_grid_world_reset(grid):
    nrow, ncol, n = grid
    jenv = jgw.GridWorld(nrow=nrow, ncol=ncol, n_agents=n)
    tenv = tgw.GridWorld(nrow=nrow, ncol=ncol, n_agents=n)
    keys = jax.random.split(jax.random.PRNGKey(21), 8)
    want = jax.vmap(lambda k: jgw.env_reset(jenv, k))(keys)
    _same_words(want, tgw.env_reset(tenv, _t(keys)))
    _same_words(jgw.env_reset(jenv, keys[0]), tgw.env_reset(tenv, _t(keys[0])))

"""The port's run state and checkpoints against the JAX package's.

``init_train_state`` must build the JAX package's state leaf for leaf
(shape, dtype and bytes) from the same key; checkpoints written by
either package must load in the other with equal payload checksums; a
corrupt primary falls back to ``.prev``; a replica world is refused.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rcmarl_tpu.config import Config as JConfig
from rcmarl_tpu.faults import FaultPlan as JFaultPlan
from rcmarl_tpu.training.trainer import init_train_state as jinit
from rcmarl_tpu.utils import checkpoint as jck
from rcmarl_tpu_torch import prng, tree
from rcmarl_tpu_torch.config import Config as TConfig
from rcmarl_tpu_torch.faults import FaultPlan as TFaultPlan
from rcmarl_tpu_torch.training.trainer import init_train_state as tinit
from rcmarl_tpu_torch.utils import checkpoint as tck
from rcmarl_tpu_torch.weights import from_jax

torch.set_num_threads(2)

CASTS = {
    "ref5": dict(),
    "adversaries": dict(agent_roles=(0, 0, 1, 2, 3), H=1),
    "narrow": dict(
        n_agents=3, agent_roles=(0, 0, 3), in_nodes=((0, 1, 2), (1, 2, 0), (2, 0, 1)),
        hidden=(8,), n_actions=4, nrow=3, ncol=4, buffer_size=16,
    ),
}


def _assert_same_leaves(jax_tree, port_tree):
    jl, tl = jax.tree.leaves(jax_tree), tree.leaves(port_tree)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        a, b = np.asarray(a), b.detach().cpu().numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), i
        assert a.tobytes() == b.tobytes(), i


def _checksum(path) -> int:
    with np.load(path) as z:
        return int(z["__checksum__"][0])


@pytest.mark.parametrize("cast", sorted(CASTS))
def test_init_train_state_leaf_for_leaf(cast):
    kw = CASTS[cast]
    want = jinit(JConfig(**kw), jax.random.PRNGKey(0))
    got = tinit(TConfig(**kw), prng.PRNGKey(0), device="cpu")
    _assert_same_leaves(want, got)
    if cast == "ref5":
        assert len(tree.leaves(got)) == 47


@pytest.mark.parametrize("cast", sorted(CASTS))
def test_config_header_is_byte_identical(cast):
    kw = dict(CASTS[cast], compute_dtype="bfloat16")
    jc = JConfig(**kw, fault_plan=JFaultPlan(drop_p=0.25, seed=3))
    tc = TConfig(**kw, fault_plan=TFaultPlan(drop_p=0.25, seed=3))
    assert tck._config_to_json(tc) == jck._config_to_json(jc)
    assert tck.config_from_json(jck._config_to_json(jc)) == tc


def test_config_fields_match():
    names = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert names(TConfig) == names(JConfig)


def test_jax_checkpoint_loads_in_port(tmp_path):
    cfg = JConfig(**CASTS["adversaries"])
    state = jinit(cfg, jax.random.PRNGKey(4))
    path = tmp_path / "jax.npz"
    jck.save_checkpoint(path, state, cfg)
    loaded, stored = tck.load_checkpoint(path, device="cpu")
    assert stored == TConfig(**CASTS["adversaries"])
    _assert_same_leaves(state, loaded)
    # writing the loaded state back reproduces the file's checksum
    tck.save_checkpoint(tmp_path / "again.npz", loaded, stored)
    assert _checksum(tmp_path / "again.npz") == _checksum(path)


def test_port_checkpoint_loads_in_jax(tmp_path):
    kw = CASTS["ref5"]
    port_state = tinit(TConfig(**kw), prng.PRNGKey(6), device="cpu")
    tck.save_checkpoint(tmp_path / "port.npz", port_state, TConfig(**kw))
    state, stored = jck.load_checkpoint(tmp_path / "port.npz")
    assert stored == JConfig(**kw)
    _assert_same_leaves(state, port_state)
    jck.save_checkpoint(tmp_path / "jax.npz", jinit(JConfig(**kw), jax.random.PRNGKey(6)), stored)
    assert _checksum(tmp_path / "port.npz") == _checksum(tmp_path / "jax.npz")


def test_corrupt_primary_falls_back_to_prev(tmp_path):
    cfg = TConfig(**CASTS["narrow"])
    path = tmp_path / "ck.npz"
    first = tinit(cfg, prng.PRNGKey(1), device="cpu")
    tck.save_checkpoint(path, first, cfg)
    tck.save_checkpoint(path, tinit(cfg, prng.PRNGKey(2), device="cpu"), cfg)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(tck.CheckpointError):
        tck.load_checkpoint(path, device="cpu")
    state, _, loaded, meta = tck.load_checkpoint_with_meta(path, device="cpu")
    assert loaded.name == "ck.npz.prev" and meta == {}
    for a, b in zip(tree.leaves(state), tree.leaves(first)):
        assert torch.equal(a, b)
    _, _, loaded = tck.load_checkpoint_with_fallback(path, device="cpu")
    assert loaded.name == "ck.npz.prev"


def test_truncated_without_prev_raises(tmp_path):
    path = tmp_path / "ck.npz"
    cfg = TConfig(**CASTS["narrow"])
    tck.save_checkpoint(path, tinit(cfg, prng.PRNGKey(1), device="cpu"), cfg)
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(tck.CheckpointError):
        tck.load_checkpoint_with_meta(path, device="cpu")


def test_replica_world_is_refused(tmp_path):
    cfg = TConfig(**CASTS["narrow"])
    path = tmp_path / "ck.npz"
    tck.save_checkpoint(path, tinit(cfg, prng.PRNGKey(1), device="cpu"), cfg, meta={"replicas": 2})
    with pytest.raises(ValueError, match="replica"):
        tck.load_checkpoint(path, device="cpu")


def test_structure_mismatch_raises(tmp_path):
    cfg = TConfig(**CASTS["narrow"])
    path = tmp_path / "ck.npz"
    tck.save_checkpoint(path, tinit(cfg, prng.PRNGKey(1), device="cpu"), cfg)
    with pytest.raises(ValueError, match="shape"):
        tck.load_checkpoint(path, dataclasses.replace(cfg, hidden=(9,)), device="cpu")


def test_weights_from_jax():
    state = jinit(JConfig(), jax.random.PRNGKey(3))
    params = from_jax(jax.tree.map(np.asarray, state.params), device="cpu")
    assert type(params).__name__ == "AgentParams"
    assert type(params.actor_opt).__name__ == "AdamState"
    _assert_same_leaves(state.params, params)

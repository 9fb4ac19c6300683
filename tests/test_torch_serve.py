"""The port's serve path against the JAX package's XLA serve arms.

The port's plain ``serve_block``/``fleet_block`` (which is also the CUDA
serve kernel's plain version, so this holds the kernel's function
against the JAX package) must give the JAX ``serve_block``/``fleet_block``
probabilities within rtol 1e-5 / atol 1e-6 in float32 and atol 2e-2 in
bf16, and the same actions wherever the top-two margin of
``gumbel + log(probs)`` exceeds the near-tie threshold. The JAX fused
Pallas arm is not the oracle: its sampling layout is stale under jax
0.9. Same parameters (carried over with ``weights.from_jax``) and the
same numpy inputs go to both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcmarl_tpu.config import Config as JConfig
from rcmarl_tpu.serve import engine as jeng
from rcmarl_tpu.serve import fleet as jfleet
from rcmarl_tpu.training.trainer import init_train_state as jinit
from rcmarl_tpu.utils.checkpoint import save_checkpoint as jsave
from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.cli import main as port_main
from rcmarl_tpu_torch.config import Config as TConfig
from rcmarl_tpu_torch.ops import cuda_serve
from rcmarl_tpu_torch.serve import engine as teng
from rcmarl_tpu_torch.serve import fleet as tfleet
from rcmarl_tpu_torch.weights import from_jax

torch.set_num_threads(2)

SHAPES = {
    "ref5": dict(),
    "narrow2": dict(
        n_agents=3, agent_roles=(0, 0, 0), in_nodes=((0, 1), (1, 2), (2, 0)),
        hidden=(8,), n_actions=4, nrow=3, ncol=4,
    ),
}
B = 64


def _configs(shape: str, dtype: str):
    kw = dict(SHAPES[shape], compute_dtype=dtype)
    return JConfig(**kw), TConfig(**kw)


def _blocks(jcfg, n_members: int):
    blocks = [
        jeng.stack_actor_rows(jinit(jcfg, jax.random.PRNGKey(10 + m)).params, jcfg)
        for m in range(max(n_members, 1))
    ]
    return jfleet.fleet_stack(blocks) if n_members else blocks[0]


def _port(tree_):
    return from_jax(jax.tree.map(np.asarray, tree_), device="cpu")


def _scores(jkey, jprobs, mode):
    """The JAX arm's argmax scores: gumbel + log(probs), or the probs."""
    if mode == "greedy":
        return np.asarray(jprobs)
    keys = jeng.serve_request_keys(jkey, jprobs.shape[0], jprobs.shape[1])
    A = jprobs.shape[-1]
    g = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (A,))))(keys)
    return np.asarray(g + jnp.log(jprobs))


def _check(jout, tout, jkey, mode, dtype):
    (ja, jp), (ta, tp) = jout, tout
    jp, tpn = np.asarray(jp), tp.numpy()
    assert ta.dtype == torch.int32 and ta.shape == tuple(ja.shape)
    if dtype == "float32":
        np.testing.assert_allclose(tpn, jp, rtol=1e-5, atol=1e-6)
        tie = 1e-4
    else:
        np.testing.assert_allclose(tpn, jp, rtol=0, atol=2e-2)
        tie = max(1e-4, 2 * float(np.abs(np.log(tpn) - np.log(jp)).max()))
    top2 = np.sort(_scores(jkey, jout[1], mode), axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > tie
    near_ties = int((~decided).sum())
    assert near_ties < decided.size // 10, f"{near_ties} near ties"
    np.testing.assert_array_equal(np.asarray(ja)[decided], ta.numpy()[decided])


@pytest.mark.parametrize("fleet", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sample", "greedy"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_serve_matches_jax_xla_arm(shape, mode, dtype, fleet):
    jcfg, tcfg = _configs(shape, dtype)
    jblock = _blocks(jcfg, fleet)
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(B, jcfg.n_agents, jcfg.obs_dim)).astype(np.float32)
    jkey, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    if fleet:
        route = ((np.arange(B) + 1) % fleet).astype(np.int32)
        jout = jfleet.fleet_block(jcfg, jblock, jnp.asarray(obs), jkey, jnp.asarray(route), mode=mode)
        tout = tfleet.fleet_block(tcfg, _port(jblock), torch.from_numpy(obs), tkey,
                                  torch.from_numpy(route), mode)
    else:
        jout = jeng.serve_block(jcfg, jblock, jnp.asarray(obs), jkey, mode=mode)
        tout = teng.serve_block(tcfg, _port(jblock), torch.from_numpy(obs), tkey, mode)
    _check(jout, tout, jkey, mode, dtype)


def test_kernel_wrapper_on_host_tensors_is_the_plain_version():
    jcfg, tcfg = _configs("narrow2", "float32")
    block = _port(_blocks(jcfg, 0))
    obs = torch.from_numpy(np.random.default_rng(1).normal(size=(B, 3, 6)).astype(np.float32))
    before = cuda_serve.LAUNCHES["serve_kernel"]
    a1, p1 = cuda_serve.serve_kernel_block(tcfg, block, obs, prng.PRNGKey(2), "sample")
    a2, p2 = teng.serve_block(tcfg, block, obs, prng.PRNGKey(2), "sample")
    assert torch.equal(a1, a2) and torch.equal(p1, p2)
    assert cuda_serve.LAUNCHES["serve_kernel"] == before


def test_request_keys_match_jax():
    want = jeng.serve_request_keys(jax.random.PRNGKey(5), 9, 4)
    got = teng.serve_request_keys(prng.PRNGKey(5), 9, 4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(np.asarray(jeng.serve_keys(2, 7)), teng.serve_keys(2, 7).numpy())


def test_stack_actor_rows_is_the_actor_block():
    jcfg, tcfg = _configs("ref5", "float32")
    state = jinit(jcfg, jax.random.PRNGKey(0))
    got = teng.stack_actor_rows(_port(state.params), tcfg)
    for (W, b), (jW, jb) in zip(got, jeng.stack_actor_rows(state.params, jcfg)):
        np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("impl", ["auto", "cuda", "plain"])
def test_resolve_serve_impl(impl):
    host = teng.resolve_serve_impl(impl, torch.device("cpu"))
    assert host == ("plain" if impl == "auto" else impl)
    assert teng.resolve_serve_impl("auto", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError):
        teng.resolve_serve_impl("pallas", torch.device("cpu"))


def test_engine_end_to_end_matches_jax_engine(tmp_path):
    jcfg, _ = _configs("narrow2", "float32")
    path = tmp_path / "checkpoint.npz"
    jsave(path, jinit(jcfg, jax.random.PRNGKey(8)), jcfg)
    jengine = jeng.ServeEngine(path, serve_impl="xla")
    tengine = teng.ServeEngine(path, serve_impl="plain", device="cpu")
    assert tengine.cfg == TConfig(**SHAPES["narrow2"])
    rng = np.random.default_rng(4)
    served = []
    for _ in range(3):
        obs = rng.normal(size=(B, 3, 6)).astype(np.float32)
        jout = jengine.serve(jnp.asarray(obs))
        tout = tengine.serve(torch.from_numpy(obs))
        served.append((obs, tout[0]))
        _check(jout, tout, jeng.serve_keys(0, len(served) - 1), "sample", "float32")
    assert tengine.summary() == jengine.summary()
    assert tengine.summary_line() == jengine.summary_line()
    obs, actions = served[1]
    replay, _ = tengine.serve(torch.from_numpy(obs), step=1)
    assert torch.equal(replay, actions)


def test_engine_reports_prev_fallback(tmp_path):
    jcfg, _ = _configs("narrow2", "float32")
    path = tmp_path / "checkpoint.npz"
    jsave(path, jinit(jcfg, jax.random.PRNGKey(1)), jcfg)
    jsave(path, jinit(jcfg, jax.random.PRNGKey(2)), jcfg)
    path.write_bytes(path.read_bytes()[:200])
    engine = teng.ServeEngine(path, serve_impl="plain", device="cpu")
    assert engine.counters["fallbacks"] == 1


def test_engine_refuses_non_finite_params(tmp_path):
    jcfg, _ = _configs("narrow2", "float32")
    state = jinit(jcfg, jax.random.PRNGKey(1))
    actor = state.params.actor
    bad = ((actor[0][0].at[0, 0, 0].set(jnp.nan), actor[0][1]),) + actor[1:]
    state = state._replace(params=state.params._replace(actor=bad))
    jsave(tmp_path / "bad.npz", state, jcfg)
    with pytest.raises(ValueError, match="non-finite"):
        teng.ServeEngine(tmp_path / "bad.npz", device="cpu")


@pytest.mark.parametrize("fleet", [False, True])
def test_cli_serve_on_host(tmp_path, capsys, fleet):
    jcfg, _ = _configs("narrow2", "float32")
    paths = []
    for m in range(2 if fleet else 1):
        paths.append(str(tmp_path / f"m{m}.npz"))
        jsave(paths[-1], jinit(jcfg, jax.random.PRNGKey(m)), jcfg)
    args = ["--fleet", *paths] if fleet else ["--checkpoint", paths[0]]
    rc = port_main(["serve", *args, "--batch", "16", "--steps", "2", "--reps", "1",
                    "--device", "cpu", "--out", str(tmp_path / "rows.jsonl")])
    out = capsys.readouterr().out
    assert rc == 0
    assert ("fleet: 2 members, 3 launches" if fleet else "serve: 3 launches, 144 actions") in out
    assert "actions/sec" in out and (tmp_path / "rows.jsonl").exists()


def test_fleet_route_row_equals_solo_row():
    jcfg, tcfg = _configs("narrow2", "float32")
    members = [_port(_blocks(jcfg, 0))]
    members.append(tuple((W * 0.5, b) for W, b in members[0]))
    fleet = tfleet.fleet_stack(members)
    obs = torch.from_numpy(np.random.default_rng(2).normal(size=(B, 3, 6)).astype(np.float32))
    route = (torch.arange(B) % 2).to(torch.int32)
    fa, fp = tfleet.fleet_block(tcfg, fleet, obs, prng.PRNGKey(1), route, "sample")
    for m in range(2):
        sa, sp = teng.serve_block(tcfg, members[m], obs, prng.PRNGKey(1), "sample")
        rows = route == m
        assert torch.equal(fa[rows], sa[rows]) and torch.equal(fp[rows], sp[rows])


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the serve kernel has no host mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg, tcfg = _configs("ref5", "float32")
    block = tuple((W.cuda(), b.cuda()) for W, b in _port(_blocks(jcfg, 0)))
    obs = torch.from_numpy(
        np.random.default_rng(3).normal(size=(300, 5, 10)).astype(np.float32)
    ).cuda()
    for mode in ("sample", "greedy"):
        ka, kp = cuda_serve.serve_kernel_block(tcfg, block, obs, prng.PRNGKey(0), mode)
        pa, pp = cuda_serve.plain_serve_block(tcfg, block, obs, prng.PRNGKey(0), mode)
        torch.testing.assert_close(kp, pp, rtol=1e-5, atol=1e-6)
        assert (ka == pa).float().mean().item() > 0.99

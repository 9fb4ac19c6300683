"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. device — a CUDA device is required; prints the card's name and power
   limit as ``nvidia-smi`` reports them. TF32 is turned off.
2. build — compiles the serve kernel (``rcmarl_tpu_torch/ops/csrc``)
   from the checkout's sources.
3. kernel against plain — the kernel and its plain PyTorch version on
   the same inputs on the card: the reference cast (5 agents, 20-20
   nets, 5 actions, B=4096) in {sample, greedy} x {float32, bf16} and as
   a 4-member fleet, the 256x256x256 64-agent configuration in float32
   and bf16, and a ragged B=1000. Probabilities within rtol 1e-5 /
   atol 1e-6 (float32) or atol 2e-2 (bf16); actions equal wherever the
   top-two margin of ``gumbel + log(probs)`` exceeds the near-tie
   threshold.
4. end to end — a reference-cast state from seed 0 is written and read
   back as a checkpoint, then ``python -m rcmarl_tpu_torch serve``
   serves it: 50 launches at B=4096 through ``ServeEngine`` and the
   kernel. The launch counter is zeroed just before and read just
   after, replaying a launch must give identical actions, and the
   engine's output must agree with the plain arm.
5. the kernel line (time, plain time, bound, launches, error) and the
   result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

#: An H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores; TF32 would change the result
BF16_FLOPS = 989e12  # tensor cores
REPLACES = "rcmarl_tpu/ops/pallas_serve.py:463"
SOURCE = "rcmarl_tpu_torch/ops/csrc/serve_kernel.cu"
REF5 = dict(n_agents=5, hidden=(20, 20), obs_dim=10, n_actions=5)
WIDE = dict(n_agents=64, hidden=(256, 256, 256), obs_dim=128, n_actions=5)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def random_block(gen, n_agents, hidden, obs_dim, n_actions, members=0):
    """Glorot-scaled random actor weights (and biases), on the card."""
    lead = (members, n_agents) if members else (n_agents,)
    dims = [obs_dim, *hidden, n_actions]
    block = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        lim = (6.0 / (d_in + d_out)) ** 0.5
        W = (torch.rand(lead + (d_in, d_out), generator=gen) * 2 - 1) * lim
        b = (torch.rand(lead + (d_out,), generator=gen) * 2 - 1) * 0.1
        block.append((W.cuda(), b.cuda()))
    return tuple(block)


def serve_bound_ms(block, obs, B, n_actions, bf16, members):
    """The least time the card could take: unique bytes read once and
    written once over the HBM rate, or the matmul FLOPs (routed member
    only) over the peak for the operand type, whichever is larger."""
    w_bytes = sum(W.numel() * 4 + b.numel() * 4 for W, b in block)
    obs_bytes = B * obs.shape[2] * 4 * (1 if obs.stride(1) == 0 else obs.shape[1])
    N = obs.shape[1]
    out_bytes = B * N * (n_actions + 1) * 4
    route_bytes = B * 4 if members else 0
    flops = 2 * B * N * sum(W.shape[-2] * W.shape[-1] for W, _ in block)
    t_bytes = (w_bytes + obs_bytes + out_bytes + route_bytes) / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS if bf16 else F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def call_ms(fn, warm=5, reps=50) -> float:
    """Time per call over a run of back-to-back calls, from CUDA events
    (host enqueue included where the host is the slower side)."""
    for _ in range(warm):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profiled(fn, reps=20):
    """``(device ms per call, wall ms per call, kernel names)`` from
    ``torch.profiler``: the summed duration of the GPU kernels the calls
    ran (0.0 when the profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    return total_us / 1e3 / reps, 1e3 * wall / reps, [e.key[:60] for e in top]


def timings(fn):
    """Device ms per call (profiler), and the CUDA-event call time."""
    dev, _, _ = profiled(fn)
    return {"device_ms": dev if dev > 0 else None, "call_ms": call_ms(fn)}


def near_tie_threshold(probs_k, probs_p, f32: bool) -> float:
    """An action can flip only where the top-two margin of the scores is
    below the scores' discrepancy: 1e-4 in float32; in bf16 at least
    twice the largest log-probability difference."""
    if f32:
        return 1e-4
    dlog = (torch.log(probs_k) - torch.log(probs_p)).abs().max().item()
    return max(1e-4, 2 * dlog)


def compare(name, cfg, block, obs, key, mode, route=None, timing=False):
    """Kernel against plain on one case; raises on a disagreement."""
    from rcmarl_tpu_torch import prng
    from rcmarl_tpu_torch.ops import cuda_serve
    from rcmarl_tpu_torch.serve.engine import serve_request_keys

    B, N = obs.shape[0], obs.shape[1]
    A = block[-1][0].shape[-1]
    f32 = cfg.dot_dtype is None
    ak, pk = cuda_serve.serve_kernel_block(cfg, block, obs, key, mode, route)
    ap, pp = cuda_serve.plain_serve_block(cfg, block, obs, key, mode, route)
    torch.cuda.synchronize()
    if ak.shape != (B, N) or pk.shape != (B, N, A) or not torch.isfinite(pk).all():
        raise AssertionError(f"{name}: kernel output has the wrong shape or is not finite")
    err = (pk - pp).abs()
    max_err = err.max().item()
    ok = (err <= 1e-6 + 1e-5 * pp.abs()).all().item() if f32 else max_err <= 2e-2
    if not ok:
        raise AssertionError(f"{name}: probs differ from plain by {max_err:.3e}")
    if mode == "sample":
        keys = serve_request_keys(prng.key_words(key).cuda(), B, N)
        scores = prng.gumbel(keys, (A,)) + torch.log(pp)
    else:
        scores = pp
    top2 = scores.topk(2, dim=-1).values
    tie_tol = near_tie_threshold(pk, pp, f32)
    decided = (top2[..., 0] - top2[..., 1]) > tie_tol
    wrong = ((ak != ap) & decided).sum().item()
    near_ties = int((~decided).sum().item())
    if wrong:
        raise AssertionError(f"{name}: {wrong} decided actions differ from plain")
    case = {
        "case": name, "B": B, "N": N, "mode": mode, "dtype": cfg.compute_dtype,
        "fleet": int(block[0][0].shape[0]) if route is not None else 0,
        "max_abs_err": max_err, "near_ties": near_ties, "near_tie_tol": tie_tol,
        "actions_equal": int((ak == ap).sum().item()), "actions": B * N,
    }
    if timing:
        k = timings(lambda: cuda_serve.serve_kernel_block(cfg, block, obs, key, mode, route))
        p = timings(lambda: cuda_serve.plain_serve_block(cfg, block, obs, key, mode, route))
        case["ms"], case["call_ms"] = k["device_ms"] or k["call_ms"], k["call_ms"]
        case["plain_ms"], case["plain_call_ms"] = p["device_ms"] or p["call_ms"], p["call_ms"]
        case["timer"] = "profiler" if k["device_ms"] and p["device_ms"] else "cuda_events"
        case["bound_ms"], case["bound_by"] = serve_bound_ms(
            block, obs, B, A, not f32, route is not None
        )
    print(f"[kernel vs plain] {json.dumps(case)}", flush=True)
    return case


def kernel_cases():
    from rcmarl_tpu_torch import prng
    from rcmarl_tpu_torch.config import Config, circulant_in_nodes

    def cfg_for(shape, dtype):
        n = shape["n_agents"]
        return Config(
            n_agents=n, agent_roles=(0,) * n, in_nodes=circulant_in_nodes(n, min(n, 4)),
            hidden=shape["hidden"], n_actions=shape["n_actions"], compute_dtype=dtype,
        )

    gen = torch.Generator().manual_seed(0)
    key = prng.PRNGKey(7)
    cases = []
    for shape_name, shape in (("ref5", REF5), ("wide", WIDE)):
        block = random_block(gen, **shape)
        for B in ((4096, 1000) if shape_name == "ref5" else (4096,)):
            flat = torch.randn(B, shape["obs_dim"], generator=gen).cuda()
            obs = flat[:, None, :].expand(B, shape["n_agents"], shape["obs_dim"])
            if B == 1000:  # ragged tile, one distinct view per agent
                obs = torch.randn(B, shape["n_agents"], shape["obs_dim"], generator=gen).cuda()
            modes = ("sample", "greedy") if shape_name == "ref5" and B == 4096 else ("sample",)
            dtypes = ("float32",) if B == 1000 else ("float32", "bfloat16")
            for mode in modes:
                for dtype in dtypes:
                    name = f"{shape_name}_B{B}_{mode}_{dtype}"
                    cases.append(compare(name, cfg_for(shape, dtype), block, obs, key, mode,
                                         timing=(B == 4096)))
        if shape_name == "ref5":
            fleet = random_block(gen, members=4, **shape)
            B = 4096
            flat = torch.randn(B, shape["obs_dim"], generator=gen).cuda()
            obs = flat[:, None, :].expand(B, shape["n_agents"], shape["obs_dim"])
            route = ((torch.arange(B) + 1) % 4).to(torch.int32).cuda()
            for dtype in ("float32", "bfloat16"):
                cases.append(compare(f"ref5_fleet4_B{B}_sample_{dtype}", cfg_for(shape, dtype),
                                     fleet, obs, key, "sample", route, timing=True))
    return cases


def end_to_end(workdir: Path):
    """Checkpoint round trip, then the serve command on the kernel."""
    from rcmarl_tpu_torch import cli, prng
    from rcmarl_tpu_torch.config import Config
    from rcmarl_tpu_torch.ops import cuda_serve
    from rcmarl_tpu_torch.serve.engine import ServeEngine
    from rcmarl_tpu_torch.training.trainer import init_train_state
    from rcmarl_tpu_torch.tree import leaves
    from rcmarl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = Config()
    state = init_train_state(cfg, prng.PRNGKey(0), device="cuda")
    path = workdir / "ref5_seed0.npz"
    save_checkpoint(path, state, cfg)
    loaded, stored = load_checkpoint(path, device="cuda")
    if stored != cfg or any(
        not torch.equal(a.cpu(), b.cpu()) for a, b in zip(leaves(state), leaves(loaded))
    ):
        raise AssertionError("checkpoint round trip changed the state")
    print(f"[end to end] checkpoint round trip: {len(leaves(loaded))} leaves equal", flush=True)

    steps = 50
    cuda_serve.LAUNCHES["serve_kernel"] = 0
    row = cli.cmd_serve([
        "--checkpoint", str(path), "--batch", "4096", "--steps", str(steps),
        "--reps", "1", "--serve_impl", "cuda",
    ])
    launches = cuda_serve.LAUNCHES["serve_kernel"]
    if launches != steps + 1 or row["serve_impl"] != "cuda":  # warm-up + timed loop
        raise AssertionError(f"the serve command launched the kernel {launches} times")

    engine = ServeEngine(path, serve_impl="cuda", device="cuda")
    obs = cli.obs_batch(cfg, 4096, 0, engine.device)
    a1, p1 = engine.serve(obs, step=3)
    a2, _ = engine.serve(obs, step=3)
    a3, _ = engine.serve(obs, step=4)
    ap, pp = cuda_serve.plain_serve_block(cfg, engine.block, obs, engine_key(3), "sample")
    torch.cuda.synchronize()
    if not torch.equal(a1, a2):
        raise AssertionError("replaying a launch changed its actions")
    if torch.equal(a1, a3):
        raise AssertionError("two launches of the stream drew the same actions")
    if not (torch.isfinite(p1).all() and ((p1.sum(-1) - 1).abs() < 1e-5).all()):
        raise AssertionError("served probabilities are not a distribution")
    if not ((p1 - pp).abs() <= 1e-6 + 1e-5 * pp.abs()).all():
        raise AssertionError("served probabilities disagree with the plain arm")
    print(f"[end to end] replay identical; {int((a1 == ap).sum())}/{a1.numel()} actions "
          "equal to the plain arm", flush=True)
    dev_ms, wall_ms, top = profiled(lambda: engine.serve(obs))
    busy = {"engine_wall_ms": wall_ms, "engine_device_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms, "top_kernels": top}
    return row, launches, busy


def engine_key(step):
    from rcmarl_tpu_torch.serve.engine import serve_keys

    return serve_keys(0, step)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rcmarl_tpu_torch.ops import cuda_serve

    t0 = time.perf_counter()
    cuda_serve.build_library()
    print(f"[build] serve kernel built in {time.perf_counter() - t0:.1f} s", flush=True)

    cases = kernel_cases()
    with tempfile.TemporaryDirectory() as d:
        row, launches, busy = end_to_end(Path(d))
    main_case = next(c for c in cases if c["case"] == "ref5_B4096_sample_float32")
    print(json.dumps({"serve_path": {
        "sec_per_launch": row["sec_per_launch"], "actions_per_sec": row["actions_per_sec"],
        "kernel_launches": launches, "serve_launches": row["degradation"]["launches"], **busy,
    }}))
    print(json.dumps({"cases": cases}))
    print(card)
    print(json.dumps({"card": card, "kernels": [{
        "name": "serve_kernel", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

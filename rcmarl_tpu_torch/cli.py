"""``python -m rcmarl_tpu_torch serve``: the port of
``rcmarl_tpu/cli.py:cmd_serve``.

Serves a trained policy checkpoint (or, with ``--fleet``, several) on the
GPU: random grid-world states in batches of ``--batch`` requests, timed
over ``--steps`` launches for ``--reps`` repetitions. It prints the
engine's ``serve:`` summary line and one JSON row with the actions per
second. The checkpoint hot-swap, canary and autoscaler flags of the JAX
command are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from datetime import datetime

import torch

from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.device import device_name
from rcmarl_tpu_torch.envs.grid_world import env_reset, make_env, scale_state

#: Distinct observation batches cycled through the timed loop.
OBS_BUFFERS = 4


def obs_batch(cfg, batch: int, seed: int, device: torch.device) -> torch.Tensor:
    """``batch`` random global states (grid-world resets from
    ``split(PRNGKey(seed), batch)``, scaled as the rollout scales them),
    broadcast to every agent's view: the ``(B, N, obs_dim)`` layout."""
    env = make_env(cfg)
    pos = env_reset(env, prng.split(prng.PRNGKey(seed), batch))  # (B, N, 2)
    flat = scale_state(env, pos).reshape(batch, -1).to(device)
    return flat[:, None, :].expand(batch, cfg.n_agents, cfg.obs_dim)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_serve(argv) -> dict:
    p = argparse.ArgumentParser(
        prog="rcmarl_tpu_torch serve",
        description="Serve a trained policy checkpoint on the GPU: one "
        "serve-kernel launch per request batch.",
    )
    p.add_argument("--checkpoint", type=str, default="./simulation_results/checkpoint.npz")
    p.add_argument("--fleet", nargs="+", type=str, default=None,
                   help="serve these checkpoints as one fleet (overrides "
                   "--checkpoint), round-robin routing")
    p.add_argument("--batch", type=int, default=1024, help="requests per launch")
    p.add_argument("--steps", type=int, default=50, help="timed launches per rep")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--mode", type=str, default="sample", choices=["sample", "greedy"])
    p.add_argument("--serve_impl", type=str, default="auto",
                   choices=["auto", "cuda", "plain"],
                   help="cuda = the serve kernel, plain = the PyTorch arm, "
                   "auto = cuda on the GPU")
    p.add_argument("--eval_seed", type=int, default=0,
                   help="serve-stream namespace (replays the same actions)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' to run the plain arm on the host")
    p.add_argument("--out", type=str, default=None,
                   help="append the serve row as a JSON line to this file")
    args = p.parse_args(argv)
    if args.batch < 1 or args.steps < 1 or args.reps < 1:
        raise SystemExit("--batch, --steps and --reps must be >= 1")

    from rcmarl_tpu_torch.serve.engine import ServeEngine
    from rcmarl_tpu_torch.serve.fleet import FleetEngine

    kw = dict(mode=args.mode, eval_seed=args.eval_seed,
              serve_impl=args.serve_impl, device=args.device)
    engine = FleetEngine(args.fleet, **kw) if args.fleet else ServeEngine(args.checkpoint, **kw)
    cfg, dev = engine.cfg, engine.device
    buffers = [obs_batch(cfg, args.batch, args.eval_seed + i, dev) for i in range(OBS_BUFFERS)]

    def launch(s: int):
        return engine.serve(buffers[s % OBS_BUFFERS])

    launch(0)  # warm-up: builds the kernel on first use
    _sync(dev)
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        for s in range(args.steps):
            launch(s)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    actions_per_launch = args.batch * cfg.n_agents
    row = {
        "kind": "serve",
        "checkpoint": args.fleet[0] if args.fleet else args.checkpoint,
        "mode": args.mode,
        "serve_impl": engine.serve_impl,
        "n_agents": cfg.n_agents,
        "hidden": list(cfg.hidden),
        "compute_dtype": cfg.compute_dtype,
        "batch": args.batch,
        "actions_per_sec": args.steps * actions_per_launch / best,
        "launches_per_sec": args.steps / best,
        "sec_per_launch": best / args.steps,
        "degradation": engine.summary(),
        "workload": {"steps": args.steps, "reps": args.reps, "obs_buffers": OBS_BUFFERS},
        "device": device_name(dev),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "timestamp": datetime.now().isoformat(timespec="seconds"),
    }
    if args.fleet:
        row["fleet"] = engine.n_members
    line = json.dumps(row)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(engine.summary_line())
    print(f"actions/sec: {row['actions_per_sec']:.1f} ({row['platform']}, {row['device']})")
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmds = {"serve": cmd_serve}
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m rcmarl_tpu_torch {{{','.join(cmds)}}} [flags]")
        return 0 if argv else 2
    if argv[0] not in cmds:
        print(f"unknown command {argv[0]!r}; expected one of {sorted(cmds)}")
        return 2
    cmds[argv[0]](argv[1:])
    return 0

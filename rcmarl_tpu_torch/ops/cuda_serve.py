"""The CUDA serve kernel: its build, its binding and its plain version.

Replaces the TPU kernel ``rcmarl_tpu/ops/pallas_serve.py:_serve_kernel``
(``fused_serve_block`` / ``fused_fleet_block``): per batch tile the
row-stacked actor forward, the softmax, the per-(request, agent) keys
``fold_in(fold_in(key, b), n)`` and the gumbel-argmax sample, in one
launch that writes only actions and probabilities. The source is
``csrc/serve_kernel.cu`` (its header says what bounds it on an H100 and
how the design answers that).

:func:`serve_kernel_block` is the wrapper: on a CUDA tensor it launches
the kernel (building it on first use) or raises; on a host tensor it
runs :func:`plain_serve_block`, the plain PyTorch version (the engine's
``serve_block`` and the fleet's ``fleet_block``). No failure of the
build or of a launch falls back to the plain version.

``LAUNCHES["serve_kernel"]`` counts the kernel's launches, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.config import Config
from rcmarl_tpu_torch.models.mlp import MLPParams
from rcmarl_tpu_torch.serve.engine import SERVE_MODES, serve_block
from rcmarl_tpu_torch.serve.fleet import fleet_block

SOURCE = Path(__file__).resolve().parent / "csrc" / "serve_kernel.cu"
#: Where the first call on the card builds the kernel (listed in .gitignore).
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: Kernel launches since the process started (or since a caller reset it).
LAUNCHES = {"serve_kernel": 0}

# The kernel's limits (csrc/serve_kernel.cu): layers, threads per CTA and
# rows per thread; the tile is a multiple of RB rows and at most THREADS.
MAX_LAYERS = 8
THREADS = 256
RB = 16
MAX_TILE = 128
#: Shared memory a CTA may take for its two activation buffers.
SMEM_BUDGET = 96 * 1024

_LIB: Optional[ctypes.CDLL] = None


def build_library() -> ctypes.CDLL:
    """Compile ``serve_kernel.cu`` for ``sm_90a`` (once per process) and
    bind its C entry points."""
    global _LIB
    if _LIB is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = load(
            name="rcmarl_serve_kernel",
            sources=[str(SOURCE)],
            build_directory=str(BUILD_DIR),
            extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
            is_python_module=False,
            verbose=False,
        )
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rcmarl_serve_launch.argtypes = [
            p, ctypes.c_longlong, ctypes.c_longlong, i,  # obs, strides, obs_dim
            p, p, p, i,  # W ptrs, b ptrs, dims, n_layers
            i, i, i, p,  # n_agents, batch, n_members, route
            ctypes.c_uint, ctypes.c_uint, i, i, ctypes.c_float,  # key, sample, bf16, alpha
            i, p, p, p,  # tile, actions, probs, stream
        ]
        lib.rcmarl_serve_launch.restype = i
        lib.rcmarl_cuda_error_string.argtypes = [i]
        lib.rcmarl_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def tile_rows(widest: int) -> int:
    """Rows per CTA: the most (a multiple of RB, at most MAX_TILE) whose
    two activation buffers of ``widest + 1`` floats a row fit the
    shared-memory budget."""
    tile = min(MAX_TILE, SMEM_BUDGET // (2 * 4 * (widest + 1)) // RB * RB)
    if tile < RB:
        raise ValueError(f"a {widest}-wide layer is wider than the serve kernel takes")
    return tile


def plain_serve_block(
    cfg: Config,
    block: MLPParams,
    obs: torch.Tensor,
    key: Optional[torch.Tensor],
    mode: str = "sample",
    route: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: the engine's ``serve_block``,
    or with a ``route`` the fleet's ``fleet_block``."""
    if route is None:
        return serve_block(cfg, block, obs, key, mode)
    return fleet_block(cfg, block, obs, key, route, mode)


def _check_block(block: MLPParams, lead: Tuple[int, ...], device) -> list:
    dims = [int(block[0][0].shape[-2])]
    for W, b in block:
        want_w = lead + (dims[-1], int(W.shape[-1]))
        if tuple(W.shape) != want_w or tuple(b.shape) != want_w[:-2] + want_w[-1:]:
            raise ValueError(
                f"layer shapes {tuple(W.shape)}/{tuple(b.shape)} do not chain "
                f"as a {lead}-stacked MLP"
            )
        for t in (W, b):
            if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
                raise ValueError("weights must be contiguous float32 on the obs device")
        dims.append(int(W.shape[-1]))
    return dims


def serve_kernel_block(
    cfg: Config,
    block: MLPParams,
    obs: torch.Tensor,
    key: Optional[torch.Tensor],
    mode: str = "sample",
    route: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serve ``(B, N, obs_dim)`` observations -> ``(actions, probs)``.

    ``block`` is the row-stacked actor block (leaves ``(N, ...)``), or
    with ``route`` (``(B,)`` int32, each in ``[0, F)``) a fleet block
    (leaves ``(F, N, ...)``). On the host this is the plain version; on
    the card it is one kernel launch on the current stream.
    """
    if mode not in SERVE_MODES:
        raise ValueError(f"mode={mode!r}: expected one of {SERVE_MODES}")
    if obs.device.type == "cpu":
        return plain_serve_block(cfg, block, obs, key, mode, route)
    if obs.device.type != "cuda":
        raise ValueError(f"the serve kernel runs on CUDA tensors, got {obs.device}")
    if obs.dim() != 3 or obs.dtype != torch.float32 or obs.stride(2) != 1:
        raise ValueError("obs must be (B, N, obs_dim) float32 with unit feature stride")
    B, N, D = obs.shape
    if len(block) > MAX_LAYERS:
        raise ValueError(f"the serve kernel takes at most {MAX_LAYERS} layers")
    fleet = route is not None
    F = int(block[0][0].shape[0]) if fleet else 1
    dims = _check_block(block, (F, N) if fleet else (N,), obs.device)
    if D > dims[0]:
        raise ValueError(f"obs feature dim {D} exceeds the first layer's {dims[0]} rows")
    if fleet and (
        route.shape != (B,) or route.dtype != torch.int32
        or route.device != obs.device or not route.is_contiguous()
    ):
        raise ValueError("route must be a contiguous (B,) int32 tensor on the obs device")
    k0 = k1 = 0
    if mode == "sample":
        k0, k1 = (int(w) for w in prng.key_words(key).reshape(2).tolist())
    lib = build_library()
    actions = torch.empty((B, N), dtype=torch.int32, device=obs.device)
    probs = torch.empty((B, N, dims[-1]), dtype=torch.float32, device=obs.device)
    L = len(block)
    w_ptrs = (ctypes.c_void_p * L)(*[W.data_ptr() for W, _ in block])
    b_ptrs = (ctypes.c_void_p * L)(*[b.data_ptr() for _, b in block])
    c_dims = (ctypes.c_int * (L + 1))(*dims)
    err = lib.rcmarl_serve_launch(
        obs.data_ptr(), obs.stride(0), obs.stride(1), D,
        ctypes.cast(w_ptrs, ctypes.c_void_p), ctypes.cast(b_ptrs, ctypes.c_void_p),
        ctypes.cast(c_dims, ctypes.c_void_p), L,
        N, B, F, route.data_ptr() if fleet else None,
        k0, k1, int(mode == "sample"), int(cfg.dot_dtype == "bfloat16"),
        float(cfg.leaky_alpha), tile_rows(max(dims)),
        actions.data_ptr(), probs.data_ptr(),
        torch.cuda.current_stream(obs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"serve kernel launch failed: {lib.rcmarl_cuda_error_string(err).decode()}"
        )
    LAUNCHES["serve_kernel"] += 1
    return actions, probs

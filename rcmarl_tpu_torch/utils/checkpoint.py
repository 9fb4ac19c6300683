"""Checkpoints in the JAX package's ``.npz`` format
(``rcmarl_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` with every :class:`TrainState` leaf under
``leaf_NNN`` (``jax.tree.flatten`` order: 47 leaves for the reference
cast, ``leaf_000..leaf_005`` the actor's ``(W, b)`` pairs), a
``__config__`` JSON header, an optional ``__meta__`` header and a CRC32
``__checksum__`` over all of them. Both packages read and write the same
files: a checkpoint the JAX package wrote loads here, and one written
here loads there with the same checksum. Saving rotates the previous
file to ``<path>.prev``; loading falls back to it when the primary is
corrupt. The port serves solo policies only and refuses a replica-world
checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from rcmarl_tpu_torch import prng
from rcmarl_tpu_torch.config import Config
from rcmarl_tpu_torch.device import DeviceLike, resolve_device
from rcmarl_tpu_torch.faults import FaultPlan, ReplicaFaultPlan
from rcmarl_tpu_torch.training.trainer import TrainState, init_train_state
from rcmarl_tpu_torch.tree import leaves, unflatten


class CheckpointError(ValueError):
    """The FILE is bad (unreadable, truncated, checksum mismatch), as
    opposed to a structure mismatch against the caller's config (plain
    ``ValueError``). :func:`load_checkpoint_with_fallback` falls back to
    ``.prev`` on exactly this."""


def _config_to_json(cfg: Config) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


def config_from_json(s: str) -> Config:
    d = json.loads(s)
    d["agent_roles"] = tuple(d["agent_roles"])
    d["in_nodes"] = tuple(tuple(n) for n in d["in_nodes"])
    d["hidden"] = tuple(d["hidden"])
    if "task_levels" in d:
        d["task_levels"] = tuple(d["task_levels"])
    if d.get("fault_plan") is not None:
        d["fault_plan"] = FaultPlan(**d["fault_plan"])
    if d.get("replica_fault_plan") is not None:
        rp = dict(d["replica_fault_plan"])
        rp["byzantine_replicas"] = tuple(rp.get("byzantine_replicas", ()))
        d["replica_fault_plan"] = ReplicaFaultPlan(**rp)
    return Config(**d)


def _payload_checksum(arrays: dict) -> np.uint32:
    """CRC32 over every array's key, dtype, shape and bytes in key order
    (``__checksum__`` itself excluded)."""
    crc = 0
    for k in sorted(arrays):
        if k == "__checksum__":
            continue
        a = np.ascontiguousarray(arrays[k])
        crc = zlib.crc32(f"{k}:{a.dtype.str}:{a.shape}:".encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return np.uint32(crc & 0xFFFFFFFF)


def save_checkpoint(
    path, state: TrainState, cfg: Config, meta: Optional[dict] = None
) -> None:
    """Write ``state`` to ``path`` (.npz) with the config header and the
    payload checksum, rotating an existing file to ``<path>.prev``
    without ever unlinking the primary."""
    arrays = {
        f"leaf_{i:03d}": l.detach().cpu().numpy() for i, l in enumerate(leaves(state))
    }
    arrays["__config__"] = np.frombuffer(_config_to_json(cfg).encode(), dtype=np.uint8)
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
        )
    arrays["__checksum__"] = np.asarray([_payload_checksum(arrays)])
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    if path.exists():
        prev = Path(str(path) + ".prev")
        try:
            os.unlink(prev)
        except FileNotFoundError:
            pass
        try:
            os.link(path, prev)
        except OSError:  # a filesystem without hard links
            shutil.copy2(path, prev)
    os.replace(tmp, path)


def _read_arrays(path) -> dict:
    try:
        z = np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:  # zipfile/OSError: truncated or not an npz
        raise CheckpointError(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e})"
        ) from None
    with z:
        try:
            return {k: z[k] for k in z.files}
        except Exception as e:  # a member fails to decompress
            raise CheckpointError(
                f"checkpoint {path} is corrupted ({type(e).__name__}: {e})"
            ) from None


def _decode_header(arrays: dict, name: str, path):
    try:
        return bytes(arrays[name]).decode()
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path} has a corrupted {name} header ({type(e).__name__}: {e})"
        ) from None


def train_state_template(cfg: Config) -> TrainState:
    """The state's structure with shape-only (``meta``) leaves."""
    with torch.device("meta"):
        return init_train_state(cfg, prng.PRNGKey(0, device="meta"), device="meta")


def _load(path, cfg: Optional[Config], device: DeviceLike) -> Tuple[TrainState, Config, dict]:
    """Read, verify and unflatten one file: ``(state, stored_cfg, meta)``.
    :class:`CheckpointError` for a bad file; ``ValueError`` for a
    structure mismatch against ``cfg`` or a replica-world checkpoint."""
    dev = resolve_device(device)
    arrays = _read_arrays(path)
    if "__checksum__" in arrays:
        want = np.uint32(arrays["__checksum__"][0])
        got = _payload_checksum(arrays)
        if want != got:
            raise CheckpointError(
                f"checkpoint {path} failed its payload checksum (stored "
                f"{int(want):#010x}, recomputed {int(got):#010x})"
            )
    if "__config__" not in arrays:
        raise CheckpointError(f"checkpoint {path} has no __config__ header")
    try:
        stored_cfg = config_from_json(_decode_header(arrays, "__config__", path))
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path} has an undecodable __config__ header "
            f"({type(e).__name__}: {e})"
        ) from None
    meta = {}
    if "__meta__" in arrays:
        try:
            meta = json.loads(_decode_header(arrays, "__meta__", path))
        except json.JSONDecodeError as e:
            raise CheckpointError(
                f"checkpoint {path} has a corrupted __meta__ header ({e})"
            ) from None
    n_rep = int(meta.get("replicas", 0))
    if n_rep:
        raise ValueError(
            f"checkpoint {path} holds a {n_rep}-replica gossip world; the "
            "port loads SOLO checkpoints only (replica worlds must be "
            "exported explicitly, never served implicitly)"
        )
    template = train_state_template(stored_cfg if cfg is None else cfg)
    t_leaves = leaves(template)
    keys = [f"leaf_{i:03d}" for i in range(len(t_leaves))]
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise ValueError(
            f"checkpoint {path} does not match config structure: missing "
            f"{missing[:3]}... ({len(missing)} leaves)"
        )
    out = []
    for k, tmpl in zip(keys, t_leaves):
        a = arrays[k]
        if tuple(a.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"checkpoint leaf {k} has shape {a.shape}, config expects "
                f"{tuple(tmpl.shape)}"
            )
        out.append(torch.from_numpy(np.array(a, copy=True)).to(dev))
    return unflatten(template, out), stored_cfg, meta


def load_checkpoint(
    path, cfg: Optional[Config] = None, device: DeviceLike = None
) -> Tuple[TrainState, Config]:
    """Restore ``(state, stored_config)`` from ``path`` onto ``device``
    (``None`` is the GPU). ``cfg``, when given, must match the stored
    structure; the returned config is always the STORED one."""
    state, stored, _ = _load(path, cfg, device)
    return state, stored


def load_checkpoint_with_fallback(
    path, cfg: Optional[Config] = None, device: DeviceLike = None
) -> Tuple[TrainState, Config, Path]:
    """:func:`load_checkpoint`, falling back to the rotated
    ``<path>.prev`` when the primary FILE is bad; returns
    ``(state, stored_cfg, loaded_path)``."""
    state, stored, loaded, _ = load_checkpoint_with_meta(path, cfg, device)
    return state, stored, loaded


def load_checkpoint_with_meta(
    path, cfg: Optional[Config] = None, device: DeviceLike = None
) -> Tuple[TrainState, Config, Path, dict]:
    """The discovery chain the serve engine uses: the primary, then the
    rotated ``<path>.prev`` when the primary FILE is bad. Returns
    ``(state, stored_cfg, loaded_path, meta)``; the meta always belongs
    to ``loaded_path``. Re-raises the primary error when there is no
    good fallback."""
    path = Path(path)
    try:
        state, stored, meta = _load(path, cfg, device)
        return state, stored, path, meta
    except CheckpointError as primary_err:
        prev = Path(str(path) + ".prev")
        if not prev.exists():
            raise
        try:
            state, stored, meta = _load(prev, cfg, device)
        except CheckpointError:
            raise primary_err from None
        return state, stored, prev, meta

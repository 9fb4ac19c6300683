"""Structural contracts of the port, checked in fresh interpreters.

- Importing ``rcmarl_tpu_torch`` and every submodule loads neither
  ``jax`` nor any ``rcmarl_tpu`` module (checked in a subprocess, so this
  test process's modules are never touched).
- No source line of the port or of ``chip_smoke.py`` imports them.
- With no GPU visible, the default device is an error, never a quiet
  run on the host, and ``chip_smoke.py`` exits non-zero without a
  result line.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env={**os.environ, **env}, capture_output=True, text=True, timeout=300,
    )


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rcmarl_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'rcmarl_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'rcmarl_tpu.'))"
        " or m == 'rcmarl_tpu']\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print('imported', len(names))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from) (jax|rcmarl_tpu)\b")
    files = sorted((REPO / "rcmarl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [
        f"{f.relative_to(REPO)}:{i}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert not hits, hits


def test_default_device_without_gpu_raises():
    code = (
        "from rcmarl_tpu_torch.device import resolve_device\n"
        "from rcmarl_tpu_torch.config import Config\n"
        "from rcmarl_tpu_torch.training.trainer import init_train_state\n"
        "from rcmarl_tpu_torch import prng\n"
        "assert str(resolve_device('cpu')) == 'cpu'\n"
        "for fn in (lambda: resolve_device(), lambda: init_train_state(Config(), prng.PRNGKey(0))):\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('no error without a GPU')\n"
        "print('raised')\n"
    )
    proc = _run(code, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert "raised" in proc.stdout


def test_chip_smoke_without_gpu_fails_without_a_result():
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

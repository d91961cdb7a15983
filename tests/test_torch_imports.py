"""The torch port stands alone: it imports neither ``jax`` nor ``repro``.

A fresh interpreter blocks both (``None`` in ``sys.modules`` makes any
import of them fail), then imports every module of ``repro_torch`` and
``chip_smoke.py``.
"""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
bad = [m for m in bad if sys.modules[m] is not None]
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_repro():
    code = _SCRIPT.format(src=str(ROOT / "src"), smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a visible card the script exits non-zero and prints no
    result line (decided at run time, so the test holds on either kind of
    machine only where no card is visible)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo: the
    script cannot find the port and exits non-zero."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


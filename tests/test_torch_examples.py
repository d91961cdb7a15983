"""The examples on the PyTorch port (``examples/torch_*.py``), each the
counterpart of a JAX example, run on the CPU at small sizes.

Each runs in a fresh interpreter that blocks ``jax`` and ``repro`` (as
``tests/test_torch_imports.py`` does), with ``--device cpu``, and must exit
0 after its own checks: the quickstart's parallel, interpreter and
plan-cache agreements and its fused single-pass op; every TPC-H query
against its numpy reference; k-means against the numpy baseline's
centroids; every request served; the training loss falling.  Without
``--device`` each wants the card and fails where none is visible.
"""

import subprocess
import sys

import pytest

pytest.importorskip("torch")

from test_torch_imports import ROOT  # noqa: E402

_RUN = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
sys.argv = [{path!r}] + {argv!r}
runpy.run_path({path!r}, run_name="__main__")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
bad = [m for m in bad if sys.modules[m] is not None]
assert not bad, bad
"""

EXAMPLES = ("quickstart", "tpch_cvm", "kmeans", "serve_lm", "train_lm")


def _run(name, argv, timeout=600):
    path = str(ROOT / "examples" / f"torch_{name}.py")
    code = _RUN.format(src=str(ROOT / "src"), path=path, argv=list(argv))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)


def _ok(out):
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_quickstart_on_the_cpu():
    out = _ok(_run("quickstart", ["--device", "cpu"]))
    for check in ("parallel == sequential ✓", "interp (abstract machine) == sequential ✓",
                  "repeated compile hit the plan cache ✓", "fused select+aggregate pipeline ✓"):
        assert check in out, check
    assert out.count("  region ") == 8


@pytest.mark.parametrize("parallel", [None, 4])
def test_tpch_cvm_matches_the_numpy_references(parallel):
    argv = ["--device", "cpu", "--sf", "0.002"] + (["--parallel", str(parallel)] if parallel
                                                    else [])
    out = _ok(_run("tpch_cvm", argv))
    lines = [ln for ln in out.splitlines() if "physical ops" in ln]
    assert len(lines) == 6 and all(ln.endswith("ref ✓") for ln in lines), lines
    assert "all 6 queries match their numpy references ✓" in out


def test_kmeans_matches_the_numpy_baseline():
    out = _ok(_run("kmeans", ["--device", "cpu", "--n", "4096"]))
    assert "la.KMeansStep" in out and "cf.CombineChunks" in out
    err = float(out.split("max|Δ| = ")[1].split()[0])
    assert err < 1e-2


def test_serve_lm_serves_every_request():
    out = _ok(_run("serve_lm", ["--device", "cpu"]))
    assert "[serve] 12/12 requests" in out and "[serve] 4/4 requests" in out
    assert "whisper served 4 requests ✓" in out


def test_train_lm_reduces_the_loss(tmp_path):
    out = _ok(_run("train_lm", ["--device", "cpu", "--steps", "6",
                                "--ckpt-dir", str(tmp_path / "ck")]))
    assert "end-to-end training ✓" in out
    first, _, last = out.split("loss trajectory: ")[1].split("\n")[0].split(" → ")
    assert float(last) < float(first)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_want_the_card_by_default(name, tmp_path):
    """With no ``--device`` an example runs on the card: where none is
    visible it fails before it reports anything (no run on the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    argv = ["--ckpt-dir", str(tmp_path / "ck"), "--steps", "2"] if name == "train_lm" else []
    out = _run(name, argv)
    assert out.returncode != 0
    assert "✓" not in out.stdout

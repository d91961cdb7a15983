"""The port's input shapes (``repro_torch/configs/shapes.py``) against the
JAX package's, on every (arch × shape) cell.

JAX returns ``jax.ShapeDtypeStruct`` stand-ins; the port returns tensors on
the ``meta`` device.  Each cell's tree of names, shapes and dtypes must be
JAX's, and ``cell_applicable`` must give JAX's answer; nothing is
allocated on either side.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.configs import ARCH_IDS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.shapes import cell_applicable as jax_applicable  # noqa: E402
from repro.configs.shapes import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_config, input_specs  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def test_the_registries_are_jaxs():
    assert ARCH_IDS == list(JAX_ARCHS)
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in JAX_SHAPES.items()}
    assert all(isinstance(v, Shape) for v in SHAPES.values())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    kind, specs = input_specs(get_config(arch), shape)
    jkind, jspecs = jax_input_specs(jax_config(arch), shape)
    assert kind == jkind
    assert _flat(specs) == _flat(jspecs)
    for leaf in _flat_tensors(specs):
        assert leaf.device.type == "meta"  # never allocated


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_applicable_matches_jax(arch, shape):
    assert cell_applicable(get_config(arch), shape) == jax_applicable(jax_config(arch), shape)


def test_decode_len_is_an_int32_scalar_and_swa_caps_the_cache():
    _, specs = input_specs(get_config("qwen2-1.5b"), "decode_32k")
    assert specs["state"]["len"].shape == () and specs["state"]["len"].dtype == torch.int32
    assert tuple(specs["state"]["k"].shape) == (28, 128, 2, 32768, 128)
    _, specs = input_specs(get_config("mixtral-8x7b"), "long_500k")
    assert specs["state"]["k"].shape[3] == get_config("mixtral-8x7b").window
    _, specs = input_specs(get_config("whisper-base"), "decode_32k")
    assert specs["state"]["cross_k"].shape[3] == 1500


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat_tensors(v)]
    return [tree]

"""The port's sharding table (``repro_torch/models/sharding.py``) against the
JAX package's ``models/sharding.py``, leaf for leaf.

JAX's rules read only ``mesh.shape[name]`` and ``mesh.axis_names``, so they
are called with a stand-in that has those two attributes (no 256 JAX
devices); the port's read its ``launch/mesh.py:Mesh``.  Parameter shapes
come from ``jax.eval_shape`` and from the port's ``init`` under
``FakeTensorMode``: nothing is allocated.  Every spec must equal
``tuple(jax_spec)``: params, optimizer state (ZeRO-1 on and off), the
gradient accumulator, each cell's batch and decode state, for the full and
reduced configs of all ten archs on 16 × 16, 2 × 16 × 16 and 2 × 2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.configs.shapes import input_specs as jax_input_specs  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_reduced, input_specs  # noqa: E402
from repro_torch.launch.dryrun import fake_world, param_shapes  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


class _JaxMesh:
    """What JAX's rules read of a mesh: ``shape`` by name and ``axis_names``."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _meshes(name):
    shape, axes = MESHES[name]
    return (_JaxMesh(shape, axes),
            Mesh(None, tuple(range(int(np.prod(shape)))), axes, shape, torch.device("cpu")))


def _norm(tree):
    """Spec trees as nested dicts/lists of plain tuples (JAX's
    ``PartitionSpec`` and the port's ``P`` alike)."""
    if isinstance(tree, (shd.P, jax.sharding.PartitionSpec)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_norm(v) for v in tree]
    raise TypeError(type(tree))


def _shapes(arch, reduced):
    jcfg = (jax_reduced if reduced else jax_config)(arch)
    tcfg = (get_reduced if reduced else get_config)(arch)
    jp = jax.eval_shape(jax_build(jcfg).init, jax.ShapeDtypeStruct((2,), np.uint32))
    tp = param_shapes(build_model(tcfg))
    return jp, tp


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_opt_and_grad_specs_match_jax(arch, reduced, mesh):
    jm, tm = _meshes(mesh)
    jp, tp = _shapes(arch, reduced)
    jps, tps = jshd.tree_param_specs(jp, jm), shd.tree_param_specs(tp, tm)
    assert _norm(tps) == _norm(jps)
    jo = jax.eval_shape(JaxAdamW().init, jp)
    with torch._subclasses.fake_tensor.FakeTensorMode():
        to = AdamW().init(tp)
    for zero1 in (True, False):
        assert _norm(shd.tree_opt_specs(to, tps, tm, zero1=zero1)) == _norm(
            jshd.tree_opt_specs(jo, jps, jm, zero1=zero1))
    assert _norm(shd.tree_grad_specs(tp, tps, tm)) == _norm(jshd.tree_grad_specs(jp, jps, jm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_jax(arch, shape, mesh):
    jm, tm = _meshes(mesh)
    kind, specs = input_specs(get_config(arch), shape)
    _, jspecs = jax_input_specs(jax_config(arch), shape)
    if kind == "decode":
        cfg = get_config(arch)
        assert _norm(shd.cache_specs(specs["state"], tm, cfg)) == _norm(
            jshd.cache_specs(jspecs["state"], jm, jax_config(arch)))
        specs, jspecs = {"tokens": specs["tokens"]}, {"tokens": jspecs["tokens"]}
    got = shd.batch_specs({k: (v.shape, v.dtype) for k, v in specs.items()}, tm)
    want = jshd.batch_specs({k: (v.shape, v.dtype) for k, v in jspecs.items()}, jm)
    assert _norm(got) == _norm(want)


def test_param_spec_rules_on_small_cases():
    _, m = _meshes("16x16")
    leaf = torch.empty((32, 4096, 1024), device="meta")
    assert shd.param_spec("layers/moe/w_gate", leaf, m) == ("model", None, None)
    assert shd.param_spec("layers/mlp/w_down", torch.empty((4, 64, 8), device="meta"), m) == (
        None, "model", None)
    assert shd.param_spec("layers/attn/wk", torch.empty((4, 8, 8), device="meta"), m) == (
        None, None, None)  # 8 columns do not divide over 16: replicated
    assert shd.param_spec("emb", torch.empty((160, 8), device="meta"), m,
                          zero1_axis="data") == ("model", None)  # 8 < 16
    assert repr(shd.P("model", None)) == "P('model', None)"


def test_placements_follow_the_specs_on_the_production_meshes():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(512):
        dm = shd.device_mesh(make_production_mesh(multi_pod=True, device="cpu"))
        assert dm.mesh_dim_names == ("pod", "data", "model")
        assert shd.placements(dm, shd.P(("pod", "data"), None, "model")) == (
            Shard(0), Shard(0), Shard(2))
        assert shd.placements(dm, shd.P()) == (Replicate(),) * 3
        assert shd.placements(dm, shd.P(None, "data")) == (Replicate(), Shard(1), Replicate())
    with fake_world(256):
        mesh = make_production_mesh(device="cpu")
        assert (mesh.axis_names, mesh.shape, mesh.size) == (("data", "model"), (16, 16), 256)


def test_shard_tree_keeps_each_ranks_slice():
    """On a fake world of 4, rank 0's slice of each leaf is the full
    tensor's first block along every sharded dim (major-to-minor)."""
    from torch.distributed.tensor import DTensor

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        dm = shd.device_mesh(mesh)
        full = {"a": torch.arange(32.0).reshape(4, 8), "b": torch.arange(8.0)}
        specs = {"a": shd.P("data", "model"), "b": shd.P(("data", "model"))}
        got = shd.shard_tree(full, specs, dm)
        assert isinstance(got["a"], DTensor)
        assert torch.equal(got["a"].to_local(), full["a"][:2, :4])
        assert torch.equal(got["b"].to_local(), full["b"][:2])

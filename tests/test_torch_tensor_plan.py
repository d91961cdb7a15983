"""The tensor frontend on the port: the LM train step planned through the
port's driver (the ``pjit`` target), as
tests/test_system.py::TestCvmPlansTheTrainer plans it in JAX.

The plan's summary (workers, split, broadcast, combines, the pipeline
inside) is held equal to the JAX package's; the mesh rewrite turns the
gradient pre-aggregation into ``mesh.AllReduce`` with the port's
``LowerToMesh``/``PushCombineIntoMesh``; the lowered plan trains on one
device (the CPU here); a mesh of ranks needs its process group (the
sharded step itself is tests/test_torch_pjit_mesh.py's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.frontends import tensor as jtensor  # noqa: E402
from repro.models.api import build_model as jax_build  # noqa: E402
from repro_torch.compiler import compile as cvm_compile  # noqa: E402
from repro_torch.compiler.targets import TARGETS_LATER, available_targets  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import verify  # noqa: E402
from repro_torch.core.passes import LowerToMesh, PushCombineIntoMesh  # noqa: E402
from repro_torch.frontends.tensor import (  # noqa: E402
    PjitBackend, PjitCompiled, lower_to_pjit, plan_summary, plan_train_program)
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train.optimizer import AdamW, tree_leaves  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return build_model(get_reduced("qwen2-1.5b"))


class TestCvmPlansTheTrainer:
    def test_plan_has_alg2_structure(self, model):
        plan = plan_train_program(model, n_data=16)
        verify(plan)
        s = plan_summary(plan)
        assert s["n_workers"] == 16
        assert len(s["split"]) == 1          # the batch is split (DP)
        assert len(s["broadcast"]) >= 1      # params broadcast into workers
        assert "cf.CombineChunks" in s["combines"]  # gradient pre-aggregation
        assert "tz.Pipeline" in s["inner_ops"]      # data path inside CE

    def test_mesh_rewrite_turns_combine_into_allreduce(self, model):
        plan = plan_train_program(model, n_data=8)
        plan = LowerToMesh(axis="data").apply(plan)
        plan = PushCombineIntoMesh().apply(plan)
        verify(plan)
        s = plan_summary(plan)
        assert "mesh.AllReduce" in s["combines"]  # pre-agg became a collective

    def test_lowered_plan_trains(self, model):
        cfg = model.cfg
        plan = plan_train_program(model, n_data=1)
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        rng = np.random.default_rng(0)
        b, s = 4, 32
        batch = {
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)),
            "mask": torch.ones((b, s), dtype=torch.float32),
        }
        step, summary = lower_to_pjit(plan, model, mesh, AdamW(lr=3e-3))
        params = model.init(torch.Generator("cpu").manual_seed(0))
        opt_state = AdamW(lr=3e-3).init(params)
        p, o, m0 = step(params, opt_state, batch)
        for _ in range(3):
            p, o, m = step(p, o, batch)
        assert float(m["loss"]) < float(m0["loss"])
        assert summary["n_workers"] == 1


@pytest.mark.parametrize("n_data,mesh_rules", [(16, False), (1, False), (8, True)])
def test_plan_summary_is_the_jax_packages(model, n_data, mesh_rules):
    jplan = jtensor.plan_train_program(jax_build(jax_reduced("qwen2-1.5b")), n_data=n_data)
    plan = plan_train_program(model, n_data=n_data)
    if mesh_rules:
        from repro.backends.spmd import LowerToMesh as JaxLowerToMesh
        from repro.backends.spmd import PushCombineIntoMesh as JaxPush

        jplan = JaxPush().apply(JaxLowerToMesh(axis="data").apply(jplan))
        plan = PushCombineIntoMesh().apply(LowerToMesh(axis="data").apply(plan))
    assert plan_summary(plan) == jtensor.plan_summary(jplan)
    assert [i.opcode for i in plan.body] == [i.opcode for i in jplan.body]


def test_pjit_is_a_registered_target(model):
    assert "pjit" in available_targets() and not TARGETS_LATER
    records = []
    plan = plan_train_program(model, n_data=4, records=records)
    assert [r.name for r in records]  # the driver's per-pass timings
    res = cvm_compile(plan, target="pjit", cache=False, store=False)
    assert isinstance(res.executable, PjitCompiled) and res.executable.fn is None
    assert res.executable.summary == plan_summary(plan)
    with pytest.raises(RuntimeError, match="plan-only"):
        res.executable({}, {}, {})


def test_a_mesh_of_more_than_one_device_needs_its_process_group(model):
    """A mesh of ranks binds the step on DTensors (tests/test_torch_pjit_mesh.py
    runs it on four gloo ranks); without an initialised process group the
    backend refuses before any rendezvous."""
    plan = plan_train_program(model, n_data=4)
    mesh = Mesh(None, (0, 1, 2, 3), ("data",), (4,), torch.device("cpu"))
    with pytest.raises(ValueError, match="process group"):
        lower_to_pjit(plan, model, mesh, AdamW())
    with pytest.raises(ValueError, match="process group"):
        PjitBackend(model=model, mesh=mesh)


def test_a_one_rank_mesh_binds_the_plain_step(model):
    """No group and one rank: ``make_train_step``'s own step on plain
    tensors, the same bits as calling it directly."""
    from repro_torch.models.api import make_train_step

    plan = plan_train_program(model, n_data=1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    step, _ = lower_to_pjit(plan, model, mesh, AdamW(lr=3e-3), microbatch=2)
    direct, _ = make_train_step(model, AdamW(lr=3e-3), microbatch=2)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (4, 16)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, 512, (4, 16)).astype(np.int32)),
             "mask": torch.ones((4, 16), dtype=torch.float32)}
    params = model.init(torch.Generator("cpu").manual_seed(0))
    a = step(params, AdamW(lr=3e-3).init(params), batch)
    b = direct(params, AdamW(lr=3e-3).init(params), batch)
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])))

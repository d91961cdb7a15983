"""Tensor frontend: the LM training step planned *through* CVM (the port's
copy of ``repro/frontends/tensor.py``).

The trainer does not hand-write its distribution: it builds the step as a
CVM program (paper Alg. 1 shape), lets the generic parallelization rewrite
introduce ``Split → ConcurrentExecute → pre-aggregation`` (Alg. 2), lets the
mesh rewrite turn the combine into a ``mesh.AllReduce``, and only then
binds the plan to a train step:

    batch    ← tz.Source(batch)
    shards   ← cf.Split(n_data)(batch)                  # DP
    g, l     ← cf.ConcurrentExecute(grad_pipeline)(shards, ⊕params, ⊕opt)
    gsum     ← cf.CombineChunks(sum)(g)                 # pre-agg → AllReduce
    loss     ← cf.CombineChunks(sum)(l)
    params'  ← tz.OptUpdate(opt)(params, opt_state, gsum)

The plan goes through the port's own driver (the registered ``pjit``
target).  ``lower_to_pjit`` binds it to ``models.api.make_train_step``:
with no mesh (or one rank and no process group) on the device of the
parameters it is called with; over a mesh of ranks on DTensors placed by
the weight-sharding table (``models/sharding.py``), where JAX binds the
same plan to GSPMD shardings.  Split on the batch → the batch sharded over
the data axes; Broadcast on params → replicated over data, model-axis
splits from the table; the pre-aggregation → the gradients' partial sums
reduced (a reduce-scatter to the ZeRO-1 moments' placement).  The port is
multi-controller: every rank of the mesh calls the step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..core import Builder, Program, verify
from ..core.ops.tensor import register_pipeline
from ..core.types import F32, CollectionKind, CollectionType, Single, TupleType
from ..models import sharding as shd
from ..models.api import Model, make_train_step
from ..train.optimizer import AdamW, Optimizer

# custom collection kind: an opaque (but named) parameter/batch pytree —
# frontends may define their own collection types (paper §3.3)
PYTREE = CollectionKind("PyTree", abstract=False, ordered=True)


def pytree_type(tag: str) -> CollectionType:
    return CollectionType(PYTREE, TupleType(()), (("tag", tag),))


def plan_train_program(model: Model, n_data: int,
                       records: Optional[list] = None) -> Program:
    """Build the sequential step program and plan it via the ``pjit`` target.

    The Alg. 1 → Alg. 2 rewrite (split the batch, push the pipeline inside,
    pre-aggregate gradients) is the registered ``pjit`` target's lowering
    path, run through the compile driver like every other frontend
    (``records`` collects the driver's per-pass timings).
    """
    cfg = model.cfg
    grad_name = f"grad_{cfg.arch}"
    register_pipeline(grad_name, None, overwrite=True)  # bound at lowering

    b = Builder(f"train_{cfg.arch}")
    params = b.input("params", pytree_type("params"))
    opt_state = b.input("opt", pytree_type("opt_state"))
    batch = b.input("batch", pytree_type("batch"))

    grads, loss = b.emit(
        "tz.Pipeline", [batch, params],
        {"fn": grad_name,
         "out_types": (pytree_type("grads"), Single(TupleType.of(loss=F32)))},
    )
    new_params, new_opt = b.emit(
        "tz.OptUpdate", [params, opt_state, grads], {"opt": "adamw"})
    program = b.finish(new_params, new_opt, loss)
    verify(program)

    from ..compiler import compile as cvm_compile

    res = cvm_compile(program, target="pjit", parallel=n_data,
                      parallelize_targets=[batch.name], cache=False,
                      store=False)
    if records is not None:
        records.extend(res.records)
    return res.program


class _PlanError(Exception):
    pass


def plan_summary(program: Program) -> Dict[str, Any]:
    """Extract the distribution decisions the rewrites made."""
    ops = [i.opcode for i in program.body]
    ce = next((i for i in program.body if i.opcode in
               ("cf.ConcurrentExecute", "mesh.MeshExecute")), None)
    if ce is None:
        raise _PlanError(f"no ConcurrentExecute in plan: {ops}")
    inner = ce.param("P")
    return {
        "n_workers": ce.inputs[0].type.attr("n"),
        "split": [i.inputs[0].name for i in program.body if i.opcode == "cf.Split"],
        "broadcast": [i.inputs[0].name for i in program.body if i.opcode == "cf.Broadcast"],
        "combines": [i.opcode for i in program.body
                     if i.opcode in ("cf.CombineChunks", "rel.CombinePartials")]
                    + [i.opcode for i in inner.body if i.opcode == "mesh.AllReduce"],
        "inner_ops": [i.opcode for i in inner.body],
    }


@dataclass
class PjitCompiled:
    """A compiled pjit plan: the program, its summary, and (when a model is
    bound) the train step."""

    program: Program
    summary: Optional[Dict[str, Any]]
    fn: Optional[Callable[..., Any]] = None

    def __call__(self, *args: Any) -> Any:
        # unlike the relational backends there is no sources dict: every
        # positional argument is a train-step argument (params, opt, batch)
        if self.fn is None:
            raise RuntimeError(
                "plan-only pjit compile: pass backend=PjitBackend(model=..., "
                "mesh=..., optimizer=..., batch_shapes=...) to bind a "
                "runnable train step")
        return self.fn(*args)


@dataclass
class ShardedStep:
    """The train step bound over a mesh of ranks: called alike on every
    rank with params, optimizer state and batch as DTensors placed by
    ``specs`` (``place`` makes them from the full tensors), inside
    ``dtensor_scope``; the loss comes back as a plain tensor on every rank."""

    fn: Callable[..., Any]
    device_mesh: Any
    #: spec trees: "params", "opt" (ZeRO-1), "batch", "grads" (ZeRO-2)
    specs: Dict[str, Any]

    def __call__(self, params: Any, opt_state: Any, batch: Any) -> Any:
        from torch.distributed.tensor import DTensor

        with shd.dtensor_scope(params):
            params, opt_state, met = self.fn(params, opt_state, batch)
        loss = met["loss"]
        return params, opt_state, {"loss": loss.full_tensor() if isinstance(loss, DTensor)
                                   else loss}

    def place(self, params: Any, opt_state: Any, batch: Any):
        """(params, opt_state, batch) as DTensors, each rank keeping its slice
        of the full tensors it holds."""
        return tuple(shd.shard_tree(tree, self.specs[k], self.device_mesh)
                     for tree, k in ((params, "params"), (opt_state, "opt"), (batch, "batch")))


@dataclass
class PjitBackend:
    """Backend for the registered ``pjit`` target.

    Without a model binding it compiles *plans* (the distribution decisions
    only).  Bound to a model and optimizer with no mesh (or a one-rank mesh
    without a process group) it returns ``make_train_step``'s step, which
    runs on the device of the parameters it is called with.  Over a larger
    mesh it returns a :class:`ShardedStep`: the parameters placed by
    ``tree_param_specs``, the optimizer state by ``tree_opt_specs`` (ZeRO-1),
    the batch by ``batch_specs`` of ``batch_shapes`` (leaves with a shape
    and a dtype), and with microbatches the f32 accumulator by
    ``tree_grad_specs``, as JAX's dry-run binds it; the optimizer's update
    goes through ``zero1_optimizer``.
    """

    name = "pjit"

    model: Optional[Model] = None
    mesh: Any = None
    optimizer: Optional[Optimizer] = None
    batch_shapes: Optional[Dict[str, Any]] = None
    microbatch: int = 1

    def __post_init__(self) -> None:
        import torch.distributed as dist

        if self.mesh is not None and self.mesh.size > 1 and not dist.is_initialized():
            raise ValueError(f"a mesh of {self.mesh.size} ranks needs its process group: "
                             "call torch.distributed.init_process_group on every rank first")

    def compile(self, program: Program) -> PjitCompiled:
        try:
            summary = plan_summary(program)
        except _PlanError:
            summary = None
        if self.model is None:
            return PjitCompiled(program, summary)
        if summary is None or not summary["split"]:
            raise _PlanError("plan has no data split")
        if self.mesh is None or (self.mesh.size == 1 and self.mesh.group is None):
            step, _ = make_train_step(self.model, self.optimizer, microbatch=self.microbatch)
            return PjitCompiled(program, summary, step)
        return PjitCompiled(program, summary, self._sharded())

    def _sharded(self) -> ShardedStep:
        from torch._subclasses.fake_tensor import FakeTensorMode

        if self.batch_shapes is None:
            raise ValueError("a sharded pjit step needs batch_shapes (leaves with a shape "
                             "and a dtype) to place the batch")
        dmesh = shd.device_mesh(self.mesh)
        opt = self.optimizer or AdamW()
        with FakeTensorMode():  # shapes only: nothing is allocated
            params_shapes = self.model.init(torch.Generator())
            opt_shapes = opt.init(params_shapes)
        pspecs = shd.tree_param_specs(params_shapes, self.mesh)
        specs = {
            "params": pspecs,
            "opt": shd.tree_opt_specs(opt_shapes, pspecs, self.mesh, zero1=True),
            "batch": shd.batch_specs({k: (v.shape, v.dtype)
                                      for k, v in self.batch_shapes.items()}, self.mesh),
            "grads": shd.tree_grad_specs(params_shapes, pspecs, self.mesh),
        }
        step, _ = make_train_step(
            self.model, shd.zero1_optimizer(opt, specs["params"], specs["opt"], dmesh),
            microbatch=self.microbatch,
            grad_constraint=lambda tree: shd.redistribute_tree(tree, specs["grads"], dmesh))
        return ShardedStep(step, dmesh, specs)


def lower_to_pjit(program: Program, model: Model, mesh: Any = None,
                  optimizer: Optional[Optimizer] = None,
                  batch_shapes: Optional[Dict[str, Any]] = None, microbatch: int = 1):
    """Bind the CVM plan to a train step: ``(step, summary)``.

    Routes through ``compile(program, target="pjit", backend=...)`` — the
    registered target's lowering path — so the LM trainer compiles via the
    driver like every other frontend.  Over a mesh of ranks ``step`` is a
    :class:`ShardedStep`, called on every rank."""
    from ..compiler import compile as cvm_compile

    be = PjitBackend(model=model, mesh=mesh, optimizer=optimizer,
                     batch_shapes=batch_shapes, microbatch=microbatch)
    res = cvm_compile(program, target="pjit", backend=be, cache=False, store=False)
    compiled: PjitCompiled = res.executable
    return compiled.fn, compiled.summary

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
target).  ``lower_to_pjit`` binds it to ``models.api.make_train_step`` on
one device, the device of the parameters it is called with; a mesh of more
than one device raises ``NotImplementedError`` until the weight-sharding
table is ported (``models/sharding.py`` on ``torch.distributed``, ROADMAP
Queue 1 item 8.7).  JAX binds the same plan to GSPMD shardings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..core import Builder, Program, verify
from ..core.ops.tensor import register_pipeline
from ..core.types import F32, CollectionKind, CollectionType, Single, TupleType
from ..models.api import Model, make_train_step
from ..train.optimizer import Optimizer

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
                "optimizer=...) to bind a runnable train step")
        return self.fn(*args)


@dataclass
class PjitBackend:
    """Backend for the registered ``pjit`` target.

    Without a model binding it compiles *plans* (the distribution decisions
    only); bound to a model and optimizer it returns the train step of
    ``make_train_step``, which runs on the device of the parameters it is
    called with.  ``mesh`` may be ``None`` or a one-device
    ``launch.mesh.Mesh``; a larger one raises ``NotImplementedError``.
    """

    name = "pjit"

    model: Optional[Model] = None
    mesh: Any = None
    optimizer: Optional[Optimizer] = None
    microbatch: int = 1

    def __post_init__(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            raise NotImplementedError(
                f"the pjit target runs on one device; a mesh of {self.mesh.size} devices "
                "needs the weight-sharding table (ROADMAP Queue 1 item 8.7: "
                "models/sharding.py on torch.distributed)")

    def compile(self, program: Program) -> PjitCompiled:
        try:
            summary = plan_summary(program)
        except _PlanError:
            summary = None
        if self.model is None:
            return PjitCompiled(program, summary)
        if summary is None or not summary["split"]:
            raise _PlanError("plan has no data split")
        step, _ = make_train_step(self.model, self.optimizer, microbatch=self.microbatch)
        return PjitCompiled(program, summary, step)


def lower_to_pjit(program: Program, model: Model, mesh: Any = None,
                  optimizer: Optional[Optimizer] = None, microbatch: int = 1):
    """Bind the CVM plan to a train step: ``(step, summary)``.

    Routes through ``compile(program, target="pjit", backend=...)`` — the
    registered target's lowering path — so the LM trainer compiles via the
    driver like every other frontend.  ``mesh``: ``None`` or one device.
    """
    from ..compiler import compile as cvm_compile

    be = PjitBackend(model=model, mesh=mesh, optimizer=optimizer, microbatch=microbatch)
    res = cvm_compile(program, target="pjit", backend=be, cache=False, store=False)
    compiled: PjitCompiled = res.executable
    return compiled.fn, compiled.summary

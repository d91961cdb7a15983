"""Tensor/step-pipeline flavor — how the LM stack rides on CVM (the
port's copy of ``repro/core/ops/tensor.py``).

The paper's lowering extracts tree-shaped data paths into *pipelines* that
are JIT-compiled, with orchestration around them.  For the LM workloads the
data path is the model's forward/backward — represented as an opaque-but-
typed ``tz.Pipeline`` instruction whose ``fn`` parameter names a pure
function in the pipeline table (registered by ``frontends.tensor``).  The
parallelization/backend rewrites manipulate the *orchestration* around
pipelines (Split / MeshExecute / AllReduce / OptUpdate) exactly as they do
for relational programs; the ``pjit`` target binds the plan to
``models.api.make_train_step``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

from ..registry import op
from ..types import ItemType

# pipeline table: name -> (callable, signature_fn(params, in_types) -> out_types)
_PIPELINES: Dict[str, Tuple[Callable[..., Any], Any]] = {}


def register_pipeline(name: str, fn: Callable[..., Any],
                      out_types_fn: Callable[[Mapping[str, Any], Sequence[ItemType]], Sequence[ItemType]] | None = None,
                      overwrite: bool = False) -> None:
    if name in _PIPELINES and not overwrite:
        raise ValueError(f"pipeline {name!r} already registered")
    _PIPELINES[name] = (fn, out_types_fn)


def get_pipeline(name: str) -> Callable[..., Any]:
    if name not in _PIPELINES:
        raise KeyError(f"pipeline {name!r} not registered")
    return _PIPELINES[name][0]


@op("tz.Pipeline", aggregation={"kind": "segmented"})
def _pipeline(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Pipeline(fn, out_types)(X1..Xk) — JIT-compiled tree-shaped data path.

    ``out_types`` may be given explicitly (frontends know their shapes) or
    derived from the registered signature function.  Declared sum-
    decomposable over its first (data) input: a gradient pipeline returns
    per-chunk sums, so the parallelization rewrite may run it per shard and
    combine with ``cf.CombineChunks(sum)`` (→ all-reduce on the mesh
    backend).  Non-decomposable pipelines belong in a different opcode.
    """
    if "out_types" in params and params["out_types"] is not None:
        return list(params["out_types"])
    name = params["fn"]
    if name in _PIPELINES and _PIPELINES[name][1] is not None:
        return list(_PIPELINES[name][1](params, ins))
    raise TypeError(f"tz.Pipeline {name!r}: no out_types and no signature registered")


@op("tz.Source", source=True)
def _source(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """Source(name, type) — a model input / parameter tree / data batch."""
    return [params["type"]]


@op("tz.OptUpdate")
def _optupdate(params: Mapping[str, Any], ins: Sequence[ItemType]) -> Sequence[ItemType]:
    """OptUpdate(opt)(params, opt_state, grads) → (params', opt_state').

    Typed pass-through: output types equal the first two input types.
    """
    if len(ins) < 3:
        raise TypeError("OptUpdate(params, opt_state, grads)")
    return [ins[0], ins[1]]

"""Instruction registry: the open vocabulary of the CVM IR language.

The IR language fixes the *shape* of instructions (SSA, typed registers,
constant/program parameters); this registry holds the *vocabulary* — each
frontend/backend flavor registers its opcodes here together with

  * a signature function (typing rule): ``(params, in_types) -> out_types``
  * semantic flags used by generic rewritings:
      - ``pure``: no side effects (all but data sources/sinks)
      - ``elementwise``: commutes with ``cf.Split`` — the parallelization
        rewrite may push it inside ``ConcurrentExecute`` unchanged
      - ``aggregation``: decomposition for the pre-aggregation rewrite
        (paper Alg. 2): a dict of {pre, combine, finalize} opcode/param info
      - ``source`` / ``sink``: pins instruction to the orchestration layer
      - ``barrier``: may not be reordered across (e.g. collectives)

Unknown opcodes are allowed inside programs (the paper: a rewrite rule that
encounters an unknown instruction "leaves it as is"), but the verifier warns
and the lowering requires an emitter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from .types import ItemType

SignatureFn = Callable[[Mapping[str, Any], Sequence[ItemType]], Sequence[ItemType]]


@dataclass
class OpSpec:
    opcode: str
    signature: SignatureFn
    pure: bool = True
    elementwise: bool = False
    source: bool = False
    sink: bool = False
    barrier: bool = False
    aggregation: Optional[Dict[str, Any]] = None
    doc: str = ""


_REGISTRY: Dict[str, OpSpec] = {}


def register_op(
    opcode: str,
    signature: SignatureFn,
    *,
    pure: bool = True,
    elementwise: bool = False,
    source: bool = False,
    sink: bool = False,
    barrier: bool = False,
    aggregation: Optional[Dict[str, Any]] = None,
    doc: str = "",
    overwrite: bool = False,
) -> OpSpec:
    if opcode in _REGISTRY and not overwrite:
        raise ValueError(f"opcode {opcode!r} already registered")
    spec = OpSpec(
        opcode=opcode,
        signature=signature,
        pure=pure,
        elementwise=elementwise,
        source=source,
        sink=sink,
        barrier=barrier,
        aggregation=aggregation,
        doc=doc,
    )
    _REGISTRY[opcode] = spec
    return spec


def op(opcode: str, **flags: Any) -> Callable[[SignatureFn], SignatureFn]:
    """Decorator form: the decorated function is the typing rule."""

    def deco(fn: SignatureFn) -> SignatureFn:
        register_op(opcode, fn, doc=fn.__doc__ or "", **flags)
        return fn

    return deco


def lookup(opcode: str) -> Optional[OpSpec]:
    return _REGISTRY.get(opcode)


def require(opcode: str) -> OpSpec:
    spec = _REGISTRY.get(opcode)
    if spec is None:
        raise KeyError(f"opcode {opcode!r} is not registered in any IR flavor")
    return spec


def registered_opcodes(flavor: Optional[str] = None) -> List[str]:
    if flavor is None:
        return sorted(_REGISTRY)
    return sorted(o for o in _REGISTRY if o.startswith(flavor + "."))


def infer_output_types(
    opcode: str, params: Mapping[str, Any], in_types: Sequence[ItemType]
) -> Sequence[ItemType]:
    spec = require(opcode)
    out = spec.signature(params, in_types)
    return list(out)


def ensure_flavors_loaded() -> None:
    """Import the standard flavor modules (idempotent)."""
    from .ops import controlflow, dataflow, linalg, mesh, relational, tensor, vec  # noqa: F401

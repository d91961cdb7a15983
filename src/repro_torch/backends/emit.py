"""Torch emitters: the executable meaning of each vec opcode.

The final stage of compilation (paper §3.5): every instruction of the
lowered program runs as a building block on torch tensors, eagerly.
Under ``use_kernels`` the three fused operators launch their CUDA kernels
(``kernels.ops``) — at any bucket count: the JAX package's 4096-bucket
gate existed only for the TPU kernels' one-hot.

Value model: Vec⟨tuple⟩ → VecTable, Single⟨tuple⟩ → dict[str, 0-dim tensor].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from ..core.program import Program
from ..relational import runtime as rt

_EMIT: Dict[str, Callable[..., List[Any]]] = {}


def emitter(opcode: str):
    def deco(fn):
        _EMIT[opcode] = fn
        return fn
    return deco


@dataclass
class EvalCtx:
    """Carries sources and backend knobs through evaluation."""

    sources: Dict[str, Any] = field(default_factory=dict)
    use_kernels: bool = False


def evaluate_program(ctx: EvalCtx, program: Program, *args: Any) -> List[Any]:
    """Run a lowered CVM program on torch tensors."""
    if len(args) != len(program.inputs):
        raise ValueError(f"{program.name}: expected {len(program.inputs)} args")
    env: Dict[str, Any] = {r.name: v for r, v in zip(program.inputs, args)}
    for ins in program.body:
        fn = _EMIT.get(ins.opcode)
        if fn is None:
            raise NotImplementedError(
                f"no torch emitter for {ins.opcode}: not ported yet "
                "(ROADMAP.md, 'What remains')")
        outs = fn(ctx, ins, [env[r.name] for r in ins.inputs])
        for r, v in zip(ins.outputs, outs):
            env[r.name] = v
    return [env[r.name] for r in program.results]


@emitter("vec.ScanVec")
def _scanvec(ctx, ins, args):
    return [ctx.sources[ins.param("table")]]


@emitter("vec.MaskSelect")
def _maskselect(ctx, ins, args):
    return [rt.mask_select(args[0], ins.param("pred"))]


@emitter("vec.ExProjVec")
def _exprojvec(ctx, ins, args):
    return [rt.exproj(args[0], ins.param("exprs"))]


@emitter("vec.AggrVec")
def _aggrvec(ctx, ins, args):
    return [rt.aggr(args[0], ins.param("aggs"))]


@emitter("vec.FusedSelectAgg")
def _fused_select_agg(ctx, ins, args):
    (t,) = args
    pred, aggs = ins.param("pred"), ins.param("aggs")
    if ctx.use_kernels:
        from ..kernels import ops as kops
        return [kops.fused_select_agg(t, pred, aggs)]
    return [rt.aggr(rt.mask_select(t, pred), aggs)]


@emitter("vec.FinalizeSingle")
def _finalize_single(ctx, ins, args):
    (single,) = args
    return [{n: rt.eval_expr(e, single) for n, e in ins.param("exprs")}]


@emitter("vec.SortByKey")
def _sortbykey(ctx, ins, args):
    keys = ins.param("keys")
    asc = ins.param("ascending") or [True] * len(keys)
    return [rt.sort_by_key(args[0], keys, asc)]


@emitter("vec.GroupAggDirect")
def _groupagg_direct(ctx, ins, args):
    (t,) = args
    keys = tuple(ins.param("keys"))
    aggs = tuple(ins.param("aggs"))
    mg = int(ins.param("max_groups"))
    domains = tuple(ins.param("key_domains"))
    nb = int(ins.param("num_buckets"))
    pred = ins.param("pred")
    if ctx.use_kernels:
        from ..kernels import ops as kops
        return [kops.grouped_select_agg(t, pred, keys, aggs, mg, domains, nb)]
    return [rt.group_agg_direct(t, keys, aggs, mg, domains, nb, pred=pred)]


@emitter("vec.HashJoinDirect")
def _hashjoin_direct(ctx, ins, args):
    nb = ins.param("num_buckets")
    return [rt.hash_join_direct(args[0], args[1], ins.param("left_on"),
                                ins.param("right_on"),
                                int(ins.param("max_count")),
                                key_domains=ins.param("key_domains"),
                                num_buckets=int(nb) if nb is not None else None)]


@emitter("vec.FusedJoinGroupAgg")
def _fused_join_group_agg(ctx, ins, args):
    left, right = args
    kw = dict(
        left_on=tuple(ins.param("left_on")),
        right_on=tuple(ins.param("right_on")),
        join_key_domains=tuple(ins.param("join_key_domains")),
        join_num_buckets=int(ins.param("join_num_buckets")),
        keys=tuple(ins.param("keys")),
        aggs=tuple(ins.param("aggs")),
        max_groups=int(ins.param("max_groups")),
        key_domains=tuple(ins.param("key_domains")),
        num_buckets=int(ins.param("num_buckets")),
        pred=ins.param("pred"),
    )
    if ctx.use_kernels:
        from ..kernels import ops as kops
        return [kops.grouped_join_agg(left, right, **kw)]
    return [rt.fused_join_group_agg(left, right, **kw)]

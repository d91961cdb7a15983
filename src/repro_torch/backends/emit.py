"""Torch emitters: the executable meaning of each opcode.

The final stage of compilation (paper §3.5): every instruction of the
lowered program runs as a building block on torch tensors, eagerly.
Under ``use_kernels`` the fused operators launch their CUDA kernels
(``kernels.ops``) — the relational ones at any bucket count: the JAX
package's 4096-bucket gate existed only for the TPU kernels' one-hot.

Value model: Vec⟨tuple⟩ → VecTable, Single⟨tuple⟩ → dict[str, 0-dim
tensor], Tensor → torch.Tensor, split Seq[n]⟨X⟩ → list of n values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

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
    #: where ``la.Literal`` values are made
    device: Optional[torch.device] = None


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


@emitter("vec.SplitVec")
def _splitvec(ctx, ins, args):
    return [rt.split(args[0], int(ins.param("n")))]


@emitter("vec.ConcatVec")
def _concatvec(ctx, ins, args):
    return [rt.concat(args[0])]


@emitter("rel.CombinePartials")
def _combinepartials(ctx, ins, args):
    return [rt.combine_partials(args[0], ins.param("aggs"))]


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------


def _split_value(v: Any, n: int) -> List[Any]:
    """``n`` equal row ranges of a VecTable or a tensor (contiguous views)."""
    if isinstance(v, rt.VecTable):
        return rt.split(v, n)
    if v.shape[0] % n != 0:
        raise ValueError(f"{v.shape[0]} rows not divisible by {n}")
    return list(torch.split(v, v.shape[0] // n))


def _merge_value(chunks: List[Any]) -> Any:
    if isinstance(chunks[0], rt.VecTable):
        return rt.concat(chunks)
    return torch.cat(chunks)


@emitter("cf.Split")
def _cf_split(ctx, ins, args):
    return [_split_value(args[0], int(ins.param("n")))]


@emitter("cf.Broadcast")
def _cf_broadcast(ctx, ins, args):
    return [[args[0]] * int(ins.param("n"))]


@emitter("cf.Merge")
def _cf_merge(ctx, ins, args):
    return [_merge_value(args[0])]


@emitter("cf.ConcurrentExecute")
def _cf_ce(ctx, ins, args):
    """Local lowering of ConcurrentExecute: the nested program once per
    chunk, in turn.  Each run's kernels queue on the same stream, so the
    card overlaps nothing across chunks; the chunks bound each launch."""
    p: Program = ins.param("P")
    n = len(args[0])
    results: List[List[Any]] = [[] for _ in p.results]
    for w in range(n):
        for i, o in enumerate(evaluate_program(ctx, p, *[a[w] for a in args])):
            results[i].append(o)
    return results


_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _combine(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    """``fn`` over a pair of tensors or of dicts of tensors."""
    if isinstance(a, dict):
        return {k: fn(a[k], b[k]) for k in a}
    return fn(a, b)


@emitter("cf.CombineChunks")
def _cf_combine(ctx, ins, args):
    (chunks,) = args
    fn = _COMBINE[ins.param("op")]
    acc = chunks[0]
    for c in chunks[1:]:
        acc = _combine(fn, acc, c)
    return [acc]


@emitter("cf.TakeChunk")
def _cf_take(ctx, ins, args):
    return [args[0][int(ins.param("i", 0))]]


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------
#
# Products are full-f32 ``torch.matmul``, as XLA computes them outside any
# Pallas kernel: ``torch.backends.cuda.matmul.allow_tf32`` stays False
# (PyTorch's default), so labels agree with an f32 reference.


@emitter("la.Literal")
def _la_literal(ctx, ins, args):
    name = ins.param("name")
    if name is not None and name in ctx.sources:
        return [ctx.sources[name]]
    return [rt.x32(torch.as_tensor(ins.param("value"), device=ctx.device))]


@emitter("la.MMMult")
def _la_mmmult(ctx, ins, args):
    return [torch.matmul(args[0], args[1])]


@emitter("la.Transpose")
def _la_transpose(ctx, ins, args):
    return [args[0].T]


_UNARY = {"neg": torch.neg, "abs": torch.abs, "add": lambda a: a, "sqrt": torch.sqrt,
          "square": lambda a: a * a}
_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div}


@emitter("la.Ewise")
def _la_ewise(ctx, ins, args):
    op = ins.param("op")
    if len(args) == 1:
        return [_UNARY[op](args[0])]
    return [_BINARY[op](*args)]


@emitter("la.ReduceSum")
def _la_reducesum(ctx, ins, args):
    return [rt.x32(args[0].sum(int(ins.param("axis"))))]


@emitter("la.CDist2")
def _la_cdist2(ctx, ins, args):
    from ..kernels import ref
    return [ref.cdist2(*args)]


@emitter("la.ArgMinRow")
def _la_argminrow(ctx, ins, args):
    return [torch.argmin(args[0], dim=1).to(torch.int32)]


@emitter("la.SegSum")
def _la_segsum(ctx, ins, args):
    x, lab = args
    return [rt.segment_sum(x, lab, int(ins.param("k")))]


@emitter("la.SegCount")
def _la_segcount(ctx, ins, args):
    return [rt.segment_count(args[0], int(ins.param("k")))]


@emitter("la.KMeansStep")
def _la_kmeans_step(ctx, ins, args):
    from ..kernels import ops as kops, ref
    step = kops.kmeans_step if ctx.use_kernels else ref.kmeans_step
    return list(step(*args))

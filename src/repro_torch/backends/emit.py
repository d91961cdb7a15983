"""Torch emitters: the executable meaning of each opcode.

The final stage of compilation (paper §3.5): every instruction of the
lowered program runs as a building block on torch tensors, eagerly.
Under ``use_kernels`` the fused operators launch their CUDA kernels
(``kernels.ops``) — the relational ones at any bucket count: the JAX
package's 4096-bucket gate existed only for the TPU kernels' one-hot.
Any failure inside a kernel's wrapper re-raises as ``KernelLaunchError``,
which the driver's fallback ladder does not walk.

Value model: Vec⟨tuple⟩ → VecTable, Single⟨tuple⟩ → dict[str, 0-dim
tensor], Tensor → torch.Tensor, split Seq[n]⟨X⟩ → list of n values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..core.program import Instruction, Program
from ..errors import KernelLaunchError, card_fault
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
    #: the plan's numpy constants (dictionary tables) on ``device``, kept
    #: by the compiled plan across its calls: ``(id, device) → (array, tensor)``
    consts: Dict[Any, Any] = field(default_factory=dict)
    #: traced executions install a dict here; tapped ops accumulate
    #: ``key → [occurrences, rows_in, rows_out]``, the rows as 0-dim device
    #: tensors where they depend on the data (read back once, at the end)
    taps: Optional[Dict[str, List[Any]]] = None
    #: the spmd backend's mesh (``launch.mesh.Mesh``) and the axis name of
    #: the MeshExecute being run; ``None`` outside a mesh
    mesh: Any = None
    axis: Optional[str] = None


def _on_device(ctx: EvalCtx, arr: Any) -> torch.Tensor:
    """A numpy constant of the plan as a tensor on the run's device (x64
    off), moved there once per plan and device."""
    key = (id(arr), str(ctx.device))
    got = ctx.consts.get(key)
    if got is None:
        got = ctx.consts[key] = (arr, rt.x32(torch.as_tensor(arr, device=ctx.device)))
    return got[1]


def tap_rows(v: Any) -> Any:
    """Cardinality of one runtime value: valid rows for a VecTable (a 0-dim
    tensor on its device, no sync), leading dim for tensors and column
    dicts, summed chunks for split sequences, 1 for singles."""
    if isinstance(v, rt.VecTable):
        return v.count()
    if isinstance(v, dict):
        if not v:
            return 0
        first = next(iter(v.values()))
        return first.shape[0] if getattr(first, "ndim", 0) >= 1 else 1
    if isinstance(v, (list, tuple)):
        return sum(tap_rows(c) for c in v)
    shape = getattr(v, "shape", None)
    if shape:
        return shape[0]
    return 1


def record_tap(ctx: EvalCtx, program: Program, index: int, ins: Instruction,
               args: Sequence[Any], outs: Sequence[Any]) -> None:
    """Accumulate one instruction's measured cardinality into ``ctx.taps``.

    Repeated hits of the same instruction (ConcurrentExecute chunks, loop
    iterations) sum their row counts — the summed-chunk global cardinality
    the profile joins against the per-chunk estimate × occurrences."""
    from ..obs.feedback import TAPPED_OPS, tap_key

    if ins.opcode not in TAPPED_OPS or not ins.outputs:
        return
    key = tap_key(program.name, index, ins.opcode, ins.outputs[0].name)
    rows_in = tap_rows(args[0]) if args else None
    rows_out = tap_rows(outs[0])
    entry = ctx.taps.get(key)
    if entry is None:
        ctx.taps[key] = [1, rows_in, rows_out]
    else:
        entry[0] += 1
        entry[1] = (None if entry[1] is None or rows_in is None
                    else entry[1] + rows_in)
        entry[2] = entry[2] + rows_out


def read_taps(taps: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
    """``taps`` with every device count read back, in one copy to the host."""
    on_device = [v for e in taps.values() for v in e[1:] if isinstance(v, torch.Tensor)]
    host = iter(torch.stack([v.reshape(()).to(torch.int64) for v in on_device]).tolist()
                if on_device else ())
    return {k: [e[0]] + [next(host) if isinstance(v, torch.Tensor) else v for v in e[1:]]
            for k, e in taps.items()}


def evaluate_program(ctx: EvalCtx, program: Program, *args: Any) -> List[Any]:
    """Run a lowered CVM program on torch tensors."""
    if len(args) != len(program.inputs):
        raise ValueError(f"{program.name}: expected {len(program.inputs)} args")
    env: Dict[str, Any] = {r.name: v for r, v in zip(program.inputs, args)}
    for i, ins in enumerate(program.body):
        fn = _EMIT.get(ins.opcode)
        if fn is None:
            raise NotImplementedError(
                f"no torch emitter for {ins.opcode}: not ported yet "
                "(ROADMAP.md, Queue 1: the emitters still missing)")
        ins_args = [env[r.name] for r in ins.inputs]
        outs = fn(ctx, ins, ins_args)
        if ctx.taps is not None:
            record_tap(ctx, program, i, ins, ins_args, outs)
        for r, v in zip(ins.outputs, outs):
            env[r.name] = v
    return [env[r.name] for r in program.results]


@emitter("vec.ScanVec")
def _scanvec(ctx, ins, args):
    return [ctx.sources[ins.param("table")]]


@emitter("vec.MaskSelect")
def _maskselect(ctx, ins, args):
    return [rt.mask_select(args[0], ins.param("pred"))]


@emitter("vec.ProjVec")
def _projvec(ctx, ins, args):
    return [rt.proj(args[0], ins.param("names"))]


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
        with card_fault(KernelLaunchError, "fused_select_agg"):
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


@emitter("vec.GroupAggSorted")
def _groupagg(ctx, ins, args):
    return [rt.group_agg_sorted(args[0], ins.param("keys"), ins.param("aggs"),
                                int(ins.param("max_groups")))]


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
        with card_fault(KernelLaunchError, "grouped_select_agg"):
            return [kops.grouped_select_agg(t, pred, keys, aggs, mg, domains, nb)]
    return [rt.group_agg_direct(t, keys, aggs, mg, domains, nb, pred=pred)]


@emitter("vec.DictEncode")
def _dictencode(ctx, ins, args):
    tables = [_on_device(ctx, tab) for tab in ins.param("tables")]
    return [rt.dict_encode(args[0], ins.param("cols"), ins.param("modes"), tables,
                           ins.param("lows"), ins.param("cards"))]


@emitter("vec.DictDecode")
def _dictdecode(ctx, ins, args):
    tables = [_on_device(ctx, tab) for tab in ins.param("tables")]
    return [rt.dict_decode(args[0], ins.param("cols"), tables)]


@emitter("vec.MergeJoinSorted")
def _mergejoin(ctx, ins, args):
    return [rt.merge_join_sorted(args[0], args[1], ins.param("left_on"),
                                 ins.param("right_on"), int(ins.param("max_count")),
                                 key_domains=ins.param("key_domains"))]


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
        with card_fault(KernelLaunchError, "grouped_join_agg"):
            return [kops.grouped_join_agg(left, right, **kw)]
    return [rt.fused_join_group_agg(left, right, **kw)]


@emitter("vec.MergeGroupedState")
def _merge_grouped_state(ctx, ins, args):
    kd = ins.param("key_domains")
    nb = ins.param("num_buckets")
    return [rt.merge_grouped_partials(
        args[0], args[1], tuple(ins.param("keys")), tuple(ins.param("aggs")),
        int(ins.param("max_groups")),
        key_domains=tuple(kd) if kd is not None else None,
        num_buckets=int(nb) if nb is not None else None)]


@emitter("vec.MergeScalarState")
def _merge_scalar_state(ctx, ins, args):
    return [rt.merge_scalar_partials(args[0], args[1],
                                     tuple(ins.param("aggs")))]


@emitter("vec.Compact")
def _compact(ctx, ins, args):
    return [rt.compact(args[0], ins.param("max_count"))]


@emitter("vec.TopKVec")
def _topkvec(ctx, ins, args):
    keys = ins.param("keys")
    asc = ins.param("ascending") or [True] * len(keys)
    return [rt.topk(args[0], keys, asc, int(ins.param("k")))]


@emitter("vec.LimitVec")
def _limitvec(ctx, ins, args):
    return [rt.limit(args[0], int(ins.param("k")))]


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


# The nested-program instructions run as host loops and branches: each
# iteration's operators queue on the card, and ``While``/``Cond`` read their
# one ``Single⟨bool⟩`` back per test (where the JAX package traces
# ``lax.scan``/``while_loop``/``cond`` into one compiled body).


def _truth(pred: Any) -> bool:
    """A ``Single⟨bool⟩`` as a host bool: one read from its device."""
    return bool(pred.item() if isinstance(pred, torch.Tensor) else pred)


@emitter("cf.Loop")
def _cf_loop(ctx, ins, args):
    p: Program = ins.param("P")
    state = list(args)
    for _ in range(int(ins.param("n"))):
        state = evaluate_program(ctx, p, *state)
    return state


@emitter("cf.While")
def _cf_while(ctx, ins, args):
    p: Program = ins.param("P")
    state = list(args)
    while True:
        outs = evaluate_program(ctx, p, *state)
        if not _truth(outs[0]):
            return state
        state = outs[1:]


@emitter("cf.Cond")
def _cf_cond(ctx, ins, args):
    pred, rest = args[0], args[1:]
    p: Program = ins.param("Pthen") if _truth(pred) else ins.param("Pelse")
    return evaluate_program(ctx, p, *rest)


@emitter("cf.Call")
def _cf_call(ctx, ins, args):
    return evaluate_program(ctx, ins.param("P"), *args)


# ---------------------------------------------------------------------------
# dataflow
# ---------------------------------------------------------------------------


@emitter("df.Source")
def _df_source(ctx, ins, args):
    return [ctx.sources[ins.param("name")]]


@emitter("df.Collect")
def _df_collect(ctx, ins, args):
    return [args[0]]


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
    if not ctx.use_kernels:
        return list(ref.kmeans_step(*args))
    with card_fault(KernelLaunchError, "kmeans_step"):
        return list(kops.kmeans_step(*args))

"""Numpy reference interpreter for CVM programs.

Value representation per type:

* relation (Bag/Set/Seq of tuples)  → ``dict[str, np.ndarray]`` (equal length)
* ``Single⟨tuple⟩``                 → ``dict[str, scalar]``
* ``Tensor`` / KDSeq                → ``np.ndarray``
* split ``Seq[n]⟨X⟩``               → ``list`` of n values
* ``Single⟨X⟩`` (non-tuple)         → the value itself

ConcurrentExecute runs workers sequentially — the interpreter defines
*semantics*, not performance.

The port's copy of ``repro/backends/interp.py`` (numpy only, on the host):
the ``interp`` target and the last rung of the driver's fallback ladder.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..core import registry
from ..core.expr import AggSpec, evaluate
from ..core.program import Instruction, Program

_EVAL: Dict[str, Callable[..., List[Any]]] = {}


def impl(opcode: str):
    def deco(fn):
        _EVAL[opcode] = fn
        return fn
    return deco


def _rows_of(v: Any) -> int:
    """Cardinality of one interpreter value (see the value model above)."""
    if isinstance(v, dict):
        if not v:
            return 0
        first = next(iter(v.values()))
        return int(np.asarray(first).shape[0]) if np.ndim(first) >= 1 else 1
    if isinstance(v, (list, tuple)):
        return sum(_rows_of(c) for c in v)
    if np.ndim(v) >= 1:
        return int(np.asarray(v).shape[0])
    return 1


class Interpreter:
    def __init__(self, sources: Optional[Mapping[str, Any]] = None,
                 max_while_iters: int = 10_000, trace: bool = False) -> None:
        self.sources = dict(sources or {})
        self.max_while_iters = max_while_iters
        #: tracing state (``trace=True``): tap key → [occ, rows_in, rows_out]
        #: and tap key → accumulated wall seconds.  The interpreter is eager
        #: and on the host, so it can time individual operators.
        self.taps: Optional[Dict[str, List[Any]]] = {} if trace else None
        self.walls: Dict[str, float] = {}

    def run(self, program: Program, *args: Any) -> List[Any]:
        if len(args) != len(program.inputs):
            raise ValueError(
                f"program {program.name} takes {len(program.inputs)} inputs, got {len(args)}"
            )
        env: Dict[str, Any] = {r.name: v for r, v in zip(program.inputs, args)}
        if self.taps is not None:
            return self._run_traced(program, env)
        for ins in program.body:
            fn = _EVAL.get(ins.opcode)
            if fn is None:
                raise NotImplementedError(f"interpreter: no impl for {ins.opcode}")
            outs = fn(self, ins, [env[r.name] for r in ins.inputs])
            if len(outs) != len(ins.outputs):
                raise RuntimeError(f"{ins.opcode}: impl returned {len(outs)} values")
            for r, v in zip(ins.outputs, outs):
                env[r.name] = v
        return [env[r.name] for r in program.results]

    def _run_traced(self, program: Program, env: Dict[str, Any]) -> List[Any]:
        """The measured twin of the main loop: a span per operator (nested
        program runs — ConcurrentExecute bodies — nest naturally), wall time
        and output cardinality per tapped op."""
        from ..obs.feedback import TAPPED_OPS, tap_key
        from ..obs.trace import get_tracer

        tracer = get_tracer()
        for i, ins in enumerate(program.body):
            fn = _EVAL.get(ins.opcode)
            if fn is None:
                raise NotImplementedError(f"interpreter: no impl for {ins.opcode}")
            ins_args = [env[r.name] for r in ins.inputs]
            reg = ins.outputs[0].name if ins.outputs else ""
            t0 = time.perf_counter()
            with tracer.span(ins.opcode, cat="execute.op",
                             program=program.name, register=reg) as sp:
                outs = fn(self, ins, ins_args)
            dur = time.perf_counter() - t0
            if len(outs) != len(ins.outputs):
                raise RuntimeError(f"{ins.opcode}: impl returned {len(outs)} values")
            if ins.opcode in TAPPED_OPS and ins.outputs:
                key = tap_key(program.name, i, ins.opcode, reg)
                rows_in = _rows_of(ins_args[0]) if ins_args else None
                rows_out = _rows_of(outs[0])
                entry = self.taps.get(key)
                if entry is None:
                    self.taps[key] = [1, rows_in, rows_out]
                else:
                    entry[0] += 1
                    entry[1] = (None if entry[1] is None or rows_in is None
                                else entry[1] + rows_in)
                    entry[2] += rows_out
                self.walls[key] = self.walls.get(key, 0.0) + dur
                sp.set(rows_in=rows_in, rows_out=rows_out)
            for r, v in zip(ins.outputs, outs):
                env[r.name] = v
        return [env[r.name] for r in program.results]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _ncols(table: Dict[str, np.ndarray]) -> int:
    return len(next(iter(table.values()))) if table else 0


def _mask_table(table: Dict[str, np.ndarray], mask: np.ndarray) -> Dict[str, np.ndarray]:
    return {k: v[mask] for k, v in table.items()}


_AGG_INIT = {"sum": 0.0, "count": 0, "min": np.inf, "max": -np.inf}


def _agg_np(fn: str, arr: np.ndarray) -> Any:
    if fn == "count":
        return np.int64(arr.shape[0])
    if arr.shape[0] == 0:
        return np.float64(_AGG_INIT[fn])
    return {"sum": np.sum, "min": np.min, "max": np.max}[fn](arr.astype(np.float64))


def _apply_aggs(table: Dict[str, np.ndarray], aggs: Sequence[AggSpec]) -> Dict[str, Any]:
    out = {}
    for a in aggs:
        col_vals = evaluate(a.expr, table, np)
        if np.isscalar(col_vals) or getattr(col_vals, "ndim", 1) == 0:
            col_vals = np.full(_ncols(table), col_vals)
        out[a.name] = _agg_np(a.fn, np.asarray(col_vals))
    return out


# ---------------------------------------------------------------------------
# relational flavor
# ---------------------------------------------------------------------------


@impl("rel.Scan")
def _scan(interp: Interpreter, ins: Instruction, args: List[Any]) -> List[Any]:
    return [interp.sources[ins.param("table")]]


@impl("rel.Select")
def _select(interp, ins, args):
    (t,) = args
    mask = np.asarray(evaluate(ins.param("pred"), t, np), dtype=bool)
    return [_mask_table(t, mask)]


@impl("rel.Proj")
def _proj(interp, ins, args):
    (t,) = args
    return [{n: t[n] for n in ins.param("names")}]


@impl("rel.ExProj")
def _exproj(interp, ins, args):
    (t,) = args
    if t and all(np.ndim(v) == 0 for v in t.values()):  # Single⟨tuple⟩
        return [{name: evaluate(e, t, np) for name, e in ins.param("exprs")}]
    out = {}
    n = _ncols(t)
    for name, e in ins.param("exprs"):
        v = evaluate(e, t, np)
        if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
            v = np.full(n, v)
        out[name] = np.asarray(v)
    return [out]


@impl("rel.Aggr")
def _aggr(interp, ins, args):
    (t,) = args
    return [_apply_aggs(t, ins.param("aggs"))]


@impl("rel.GroupByAggr")
def _groupby(interp, ins, args):
    (t,) = args
    keys = list(ins.param("keys"))
    aggs = list(ins.param("aggs"))
    n = _ncols(t)
    if n == 0:
        out = {k: np.asarray([]) for k in keys}
        out.update({a.name: np.asarray([]) for a in aggs})
        return [out]
    key_arrays = [np.asarray(t[k]) for k in keys]
    # group ids via lexsort-stable unique over structured rows
    stacked = np.rec.fromarrays(key_arrays, names=[f"k{i}" for i in range(len(keys))])
    uniq, inverse = np.unique(stacked, return_inverse=True)
    out: Dict[str, np.ndarray] = {}
    for i, k in enumerate(keys):
        out[k] = np.asarray(uniq[f"k{i}"])
    for a in aggs:
        vals = evaluate(a.expr, t, np)
        if np.isscalar(vals) or getattr(vals, "ndim", 1) == 0:
            vals = np.full(n, vals)
        vals = np.asarray(vals)
        out[a.name] = np.asarray(
            [_agg_np(a.fn, vals[inverse == g]) for g in range(len(uniq))]
        )
    return [out]


@impl("vec.GroupAggDirect")
def _vec_groupagg_direct(interp, ins, args):
    """Reference semantics of the dense-bucket grouped aggregation: the
    (optional) fused predicate, then exactly rel.GroupByAggr — the bucket
    layout is a physical detail the oracle need not reproduce."""
    (t,) = args
    pred = ins.param("pred")
    if pred is not None:
        mask = np.asarray(evaluate(pred, t, np), dtype=bool)
        t = _mask_table(t, mask)
    return _groupby(interp, ins, [t])


@impl("vec.DictEncode")
def _vec_dictencode(interp, ins, args):
    """Reference semantics of the rank encoding: value→rank against the
    sorted dictionary, out-of-dictionary → sentinel rank ``card``."""
    (t,) = args
    out = dict(t)
    for c, mode, table, lo, card in zip(
            ins.param("cols"), ins.param("modes"), ins.param("tables"),
            ins.param("lows"), ins.param("cards")):
        a = np.asarray(t[c])
        tab = np.asarray(table)
        if mode == "remap":
            idx = a.astype(np.int64) - int(lo)
            ok = (idx >= 0) & (idx < tab.shape[0])
            ranks = tab[np.clip(idx, 0, tab.shape[0] - 1)]
            out[c] = np.where(ok, ranks, card).astype(np.int32)
        else:
            i = np.searchsorted(tab, a)
            ic = np.clip(i, 0, card - 1)
            out[c] = np.where(tab[ic] == a, ic, card).astype(np.int32)
    return [out]


@impl("vec.DictDecode")
def _vec_dictdecode(interp, ins, args):
    (t,) = args
    out = dict(t)
    for c, table in zip(ins.param("cols"), ins.param("tables")):
        tab = np.asarray(table)
        ranks = np.clip(np.asarray(t[c]).astype(np.int64), 0, tab.shape[0] - 1)
        out[c] = tab[ranks]
    return [out]


@impl("rel.Join")
def _join(interp, ins, args):
    l, r = args
    left_on = list(ins.param("left_on"))
    right_on = list(ins.param("right_on"))
    # hash-join in python (oracle-grade)
    index: Dict[Any, List[int]] = {}
    rkeys = list(zip(*[np.asarray(r[k]).tolist() for k in right_on])) if _ncols(r) else []
    for i, k in enumerate(rkeys):
        index.setdefault(k, []).append(i)
    lkeys = list(zip(*[np.asarray(l[k]).tolist() for k in left_on])) if _ncols(l) else []
    li, ri = [], []
    for i, k in enumerate(lkeys):
        for j in index.get(k, ()):
            li.append(i)
            ri.append(j)
    li = np.asarray(li, dtype=np.int64)
    ri = np.asarray(ri, dtype=np.int64)
    out = {k: np.asarray(v)[li] for k, v in l.items()}
    lnames = set(l.keys())
    for k, v in r.items():
        if k in right_on:
            continue
        name = k if k not in lnames else k + "_r"
        out[name] = np.asarray(v)[ri]
    return [out]


@impl("rel.OrderBy")
def _orderby(interp, ins, args):
    (t,) = args
    keys = list(ins.param("keys"))
    asc = list(ins.param("ascending", [True] * len(keys)))
    arrays = []
    for k, a in zip(reversed(keys), reversed(asc)):
        arr = np.asarray(t[k])
        arrays.append(arr if a else -arr if np.issubdtype(arr.dtype, np.number) else arr[::-1])
    order = np.lexsort(arrays)
    return [{k: np.asarray(v)[order] for k, v in t.items()}]


@impl("rel.Limit")
def _limit(interp, ins, args):
    (t,) = args
    k = int(ins.param("k"))
    return [{kk: np.asarray(v)[:k] for kk, v in t.items()}]


@impl("rel.Distinct")
def _distinct(interp, ins, args):
    (t,) = args
    names = list(t.keys())
    stacked = np.rec.fromarrays([np.asarray(t[n]) for n in names],
                                names=[f"c{i}" for i in range(len(names))])
    uniq = np.unique(stacked)
    return [{n: np.asarray(uniq[f"c{i}"]) for i, n in enumerate(names)}]


@impl("rel.CombinePartials")
def _combine_partials(interp, ins, args):
    (partials,) = args  # list of dicts
    aggs: Sequence[AggSpec] = ins.param("aggs")
    out = {}
    for a in aggs:
        vals = np.asarray([p[a.name] for p in partials])
        out[a.name] = _agg_np(a.fn, vals) if a.fn != "count" else np.int64(np.sum(vals))
    return [out]


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------


def _split_value(v: Any, n: int) -> List[Any]:
    if isinstance(v, dict):  # table: split each column
        cols = {k: np.array_split(np.asarray(a), n) for k, a in v.items()}
        return [{k: cols[k][i] for k in cols} for i in range(n)]
    return [np.ascontiguousarray(c) for c in np.array_split(np.asarray(v), n)]


def _merge_value(chunks: List[Any]) -> Any:
    if isinstance(chunks[0], dict):
        return {k: np.concatenate([np.asarray(c[k]) for c in chunks]) for k in chunks[0]}
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


@impl("cf.Split")
def _cf_split(interp, ins, args):
    return [_split_value(args[0], int(ins.param("n")))]


@impl("cf.Broadcast")
def _cf_broadcast(interp, ins, args):
    return [[args[0]] * int(ins.param("n"))]


@impl("cf.Merge")
def _cf_merge(interp, ins, args):
    return [_merge_value(args[0])]


@impl("cf.ConcurrentExecute")
def _cf_ce(interp, ins, args):
    p: Program = ins.param("P")
    n = len(args[0])
    results: List[List[Any]] = [[] for _ in p.results]
    for w in range(n):
        outs = interp.run(p, *[a[w] for a in args])
        for i, o in enumerate(outs):
            results[i].append(o)
    return results


@impl("mesh.MeshExecute")
def _mesh_exec(interp, ins, args):
    return _cf_ce(interp, ins, args)


@impl("cf.CombineChunks")
def _cf_combine(interp, ins, args):
    (chunks,) = args
    op = ins.param("op")
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    acc = np.asarray(chunks[0], dtype=np.float64)
    for c in chunks[1:]:
        acc = fn(acc, np.asarray(c, dtype=np.float64))
    return [acc]


@impl("cf.TakeChunk")
def _cf_take(interp, ins, args):
    return [args[0][int(ins.param("i", 0))]]


@impl("cf.Loop")
def _cf_loop(interp, ins, args):
    p: Program = ins.param("P")
    state = list(args)
    for _ in range(int(ins.param("n"))):
        state = interp.run(p, *state)
    return state


@impl("cf.While")
def _cf_while(interp, ins, args):
    p: Program = ins.param("P")
    state = list(args)
    for _ in range(interp.max_while_iters):
        outs = interp.run(p, *state)
        cond, state = outs[0], outs[1:]
        if not bool(cond):
            return state
    raise RuntimeError("While exceeded max iterations")


@impl("cf.Cond")
def _cf_cond(interp, ins, args):
    pred, rest = args[0], args[1:]
    p: Program = ins.param("Pthen") if bool(pred) else ins.param("Pelse")
    return interp.run(p, *rest)


@impl("cf.Call")
def _cf_call(interp, ins, args):
    return interp.run(ins.param("P"), *args)


# ---------------------------------------------------------------------------
# dataflow flavor
# ---------------------------------------------------------------------------


@impl("df.Source")
def _df_source(interp, ins, args):
    return [interp.sources[ins.param("name")]]


@impl("df.Literal")
def _df_literal(interp, ins, args):
    return [ins.param("value")]


@impl("df.Collect")
def _df_collect(interp, ins, args):
    return [args[0]]


@impl("df.Map")
def _df_map(interp, ins, args):
    p: Program = ins.param("P")
    (c,) = args
    if isinstance(c, dict):
        n = _ncols(c)
        items = [{k: v[i] for k, v in c.items()} for i in range(n)]
    else:
        items = list(c)
    outs = [interp.run(p, item)[0] for item in items]
    if outs and isinstance(outs[0], dict):
        return [{k: np.asarray([o[k] for o in outs]) for k in outs[0]}]
    return [np.asarray(outs)]


@impl("df.Reduce")
def _df_reduce(interp, ins, args):
    p: Program = ins.param("P")
    (c,) = args
    items = list(c) if not isinstance(c, dict) else [
        {k: v[i] for k, v in c.items()} for i in range(_ncols(c))
    ]
    acc = items[0]
    for it in items[1:]:
        acc = interp.run(p, acc, it)[0]
    return [acc]


# ---------------------------------------------------------------------------
# linear algebra flavor
# ---------------------------------------------------------------------------


@impl("la.Literal")
def _la_literal(interp, ins, args):
    name = ins.param("name")
    if name is not None and name in interp.sources:
        return [np.asarray(interp.sources[name])]
    return [np.asarray(ins.param("value"))]


@impl("la.MMMult")
def _la_mmmult(interp, ins, args):
    return [np.asarray(args[0]) @ np.asarray(args[1])]


@impl("la.Transpose")
def _la_transpose(interp, ins, args):
    return [np.asarray(args[0]).T]


@impl("la.Ewise")
def _la_ewise(interp, ins, args):
    op = ins.param("op")
    if len(args) == 1:
        a = np.asarray(args[0])
        return [{"neg": lambda: -a, "abs": lambda: np.abs(a), "add": lambda: a,
                 "sqrt": lambda: np.sqrt(a), "square": lambda: a * a}[op]()]
    a, b = np.asarray(args[0]), np.asarray(args[1])
    return [{"add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
             "div": lambda: a / b}[op]()]


@impl("la.ReduceSum")
def _la_reducesum(interp, ins, args):
    return [np.sum(np.asarray(args[0]), axis=int(ins.param("axis")))]


@impl("la.CDist2")
def _la_cdist2(interp, ins, args):
    x, c = np.asarray(args[0], dtype=np.float64), np.asarray(args[1], dtype=np.float64)
    x2 = np.sum(x * x, axis=1, keepdims=True)
    c2 = np.sum(c * c, axis=1, keepdims=True).T
    return [x2 - 2.0 * (x @ c.T) + c2]


@impl("la.ArgMinRow")
def _la_argminrow(interp, ins, args):
    return [np.argmin(np.asarray(args[0]), axis=1).astype(np.int32)]


@impl("la.SegSum")
def _la_segsum(interp, ins, args):
    x, lab = np.asarray(args[0], dtype=np.float64), np.asarray(args[1])
    k = int(ins.param("k"))
    out = np.zeros((k, x.shape[1]), dtype=np.float64)
    np.add.at(out, lab, x)
    return [out]


@impl("la.SegCount")
def _la_segcount(interp, ins, args):
    lab = np.asarray(args[0])
    k = int(ins.param("k"))
    return [np.bincount(lab, minlength=k).astype(np.float64)]


@impl("la.KMeansStep")
def _la_kmeans_step(interp, ins, args):
    x, c = np.asarray(args[0], dtype=np.float64), np.asarray(args[1], dtype=np.float64)
    d = _la_cdist2(interp, ins, [x, c])[0]
    lab = np.argmin(d, axis=1)
    k = c.shape[0]
    sums = np.zeros((k, x.shape[1]), dtype=np.float64)
    np.add.at(sums, lab, x)
    counts = np.bincount(lab, minlength=k).astype(np.float64)
    return [sums, counts]


# ---------------------------------------------------------------------------
# backend facade (so "interp" is a registered compile target like the rest)
# ---------------------------------------------------------------------------


class InterpCompiled:
    """Executable wrapper matching the backends' ``compiled(sources, *args)``
    convention; each call runs a fresh Interpreter over the program."""

    #: the eager interpreter emits real per-operator spans during a traced
    #: run, so the driver must not add synthetic annotations on top
    emits_op_spans = True

    def __init__(self, program: Program, max_while_iters: int = 10_000) -> None:
        self.program = program
        self.max_while_iters = max_while_iters

    def __call__(self, sources: Optional[Mapping[str, Any]] = None,
                 *args: Any) -> List[Any]:
        interp = Interpreter(sources=dict(sources or {}),
                             max_while_iters=self.max_while_iters)
        return interp.run(self.program, *args)

    def run_traced(self, sources: Optional[Mapping[str, Any]] = None,
                   *args: Any):
        """Execute and measure: ``(results, cards, per-op wall seconds)``."""
        from ..obs.feedback import TapRecord

        interp = Interpreter(sources=dict(sources or {}),
                             max_while_iters=self.max_while_iters, trace=True)
        outs = interp.run(self.program, *args)
        cards = {k: TapRecord(occ, ri, int(ro))
                 for k, (occ, ri, ro) in interp.taps.items()}
        return outs, cards, dict(interp.walls)


class InterpBackend:
    """The abstract machine as a backend: exact, slow, the oracle."""

    name = "interp"

    def __init__(self, max_while_iters: int = 10_000) -> None:
        self.max_while_iters = max_while_iters

    def compile(self, program: Program) -> InterpCompiled:
        return InterpCompiled(program, max_while_iters=self.max_while_iters)

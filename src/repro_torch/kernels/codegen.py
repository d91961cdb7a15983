"""Generate straight-line CUDA C++ for one query's expressions.

The Pallas kernels of the JAX package close over the query's ``Expr`` and
compile one kernel per query.  The three relational kernels do the same
here: the typed postfix program that ``exprcode.compile_program`` builds is
run symbolically on a stack of C variable names, each instruction
becoming one typed local (``int``, ``float`` or a 0/1 ``uint32_t``), and
the result is a predicate function, one function per aggregated value and,
for the grouped kernels, the bucket id.  Constants become literals (f32
ones by their bit pattern), columns typed ``const T* __restrict__``
pointers at fixed slots, so a query whose constants or column types differ
is a different kernel, as under ``jax.jit``.  There is no stack limit: the
stack exists only while the text is generated.

The row functions are ``__host__ __device__`` code over the macros of
``csrc/rowfn.cuh``, which mean the device intrinsics under nvcc and plain
IEEE operations under a host compiler, so a CPU test can build and run
them (``row_source``).  ``kernel_source`` appends the kernel template of
``csrc/<family>.cu``; ``build.build_generated`` compiles that text once
per distinct query and caches the library by its hash.

What the generated text defines (the templates rely on these names):

* ``GEN_NV`` aggregated values, ``GenCols`` (the column pointers) and
  ``gen_cols(const void* const*)``, ``GenRow`` (one row's loaded columns),
  ``gen_load_pred`` (the columns the predicate reads) and
  ``gen_load_rest`` (the others), ``gen_pred``, ``gen_value<k>`` and
  ``gen_values``; ``gen_ident(k)``, ``gen_comb(k, a, b)`` and ``gen_fn(k)``
  (0 sum, 1 min, 2 max), each value's aggregate (±3e38 for an empty
  min/max);
* for the grouped kernels, ``GEN_NB`` buckets and ``gen_bucket``: the
  lexicographic rank of the key columns in their static domains, each key
  clipped to its domain (f32 keys by their bits, bools as 0/1);
* for ``grouped_join_agg`` (a ``Join`` layout: probe columns, then build
  columns, then the build side's key columns), ``GEN_NJB`` join buckets,
  ``gen_jbucket(r, &ok)`` and ``gen_build_jbucket(c, j, &ok)``, the checked
  join bucket of a probe row and of build row ``j`` (ranked as
  ``gen_bucket`` ranks, but a key outside its domain clears ``ok``: the
  row is dropped, where grouping clips), and ``gen_load_build(r, c, j)``,
  which loads the build columns the values and keys read at build row
  ``j``.  ``gen_load_rest`` then loads only probe columns.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

from . import exprcode

FAMILIES = ("fused_select_agg", "grouped_select_agg", "grouped_join_agg")

_PTR = {"i": "int", "f": "float", "b": "uint8_t"}
_VAL = {"i": "int", "f": "float", "b": "uint32_t"}
_LOAD = {"LOAD_I32": "i", "LOAD_F32": "f", "LOAD_U8": "b"}
_IBIN = {"ADD_I": "RF_IADD", "SUB_I": "RF_ISUB", "MUL_I": "RF_IMUL",
         "MIN_I": "RF_IMIN", "MAX_I": "RF_IMAX"}
_FBIN = {"ADD_F": "RF_FADD", "SUB_F": "RF_FSUB", "MUL_F": "RF_FMUL",
         "DIV_F": "RF_FDIV", "MIN_F": "RF_FMIN", "MAX_F": "RF_FMAX"}
_UN = {"NEG_I": ("i", "RF_INEG"), "ABS_I": ("i", "RF_IABS"),
       "NEG_F": ("f", "RF_FNEG"), "ABS_F": ("f", "RF_FABS"),
       "NOT": ("b", "1u - "), "I2F": ("i", "RF_I2F")}
_CMP = {"LT": "<", "LE": "<=", "GT": ">", "GE": ">=", "EQ": "==", "NE": "!="}
#: each aggregate's identity and combination (``fns`` of the templates)
_IDENT = {"sum": "0.0f", "min": "RF_POS", "max": "RF_NEG"}
_COMB = {"sum": "RF_FADD(a, b)", "min": "RF_FMIN(a, b)", "max": "RF_FMAX(a, b)"}
_FN = {"sum": 0, "min": 1, "max": 2}

Key = Tuple[int, int, int]  # (slot, lo, size) of one key column


class Join(NamedTuple):
    """The slots of ``grouped_join_agg``'s columns: ``[0, n_probe)`` probe
    columns, loaded at the probe row; ``[n_probe, n_probe + n_build)``
    build columns, loaded at the build row the join bucket names; the rest
    the build side's key columns, which only ``gen_build_jbucket`` reads.
    ``probe_keys`` and ``build_keys``: the (slot, lo, size) of each join
    key column on either side, in the same domains."""

    n_probe: int
    n_build: int
    probe_keys: Sequence[Key]
    build_keys: Sequence[Key]


def _int_literal(v: int) -> str:
    v = (v + (1 << 31)) % (1 << 32) - (1 << 31)  # the word as int32
    return "(-2147483647 - 1)" if v == -(1 << 31) else f"({v})"


def _operand(entry: Tuple[str, str], want: str) -> str:
    """``entry`` (C expression, type; type ``c`` for a constant word) as a
    value of type ``want`` (i, f or b), as ``exprcode.interpret`` reads the
    same word."""
    text, kind = entry
    if kind == "c":
        bits = int(text) & 0xFFFFFFFF
        if want == "f":
            return f"RF_F32(0x{bits:08x}u)"
        if want == "i":
            return _int_literal(bits)
        return f"{bits}u"
    if kind == want:
        return text
    if kind == "b" and want == "i":
        return f"static_cast<int>({text})"
    raise TypeError(f"a {kind} value where the program reads {want}")


def _segment(code: Sequence[Tuple[str, int]], slots_type: Sequence[str]
             ) -> Tuple[List[str], str, int]:
    """C statements for one program segment ending in EMIT: (lines, the
    expression of the emitted value, the EMIT's slot)."""
    lines: List[str] = []
    stack: List[Tuple[str, str]] = []
    n = 0

    def local(ctype: str, expr: str, kind: str) -> None:
        nonlocal n
        lines.append(f"  const {ctype} t{n} = {expr};")
        stack.append((f"t{n}", kind))
        n += 1

    for op, arg in code:
        if op in _LOAD:
            kind = _LOAD[op]
            if slots_type[arg] != kind:
                raise TypeError(f"{op} of slot {arg}, a {slots_type[arg]} column")
            local(_VAL[kind], f"r.c{arg}", kind)
        elif op == "CONST":
            stack.append((str(arg), "c"))
        elif op == "EMIT":
            want = "b" if arg == 0 else "f"
            return lines, _operand(stack.pop(), want), arg
        elif op in _UN:
            want, fn = _UN[op]
            a = _operand(stack.pop(), want)
            kind = "f" if op == "I2F" else want
            local(_VAL[kind], f"{fn}({a})" if fn.startswith("RF") else f"{fn}{a}", kind)
        elif op in ("AND", "OR"):
            b, a = _operand(stack.pop(), "b"), _operand(stack.pop(), "b")
            local("uint32_t", f"{a} {'&' if op == 'AND' else '|'} {b}", "b")
        elif op in _IBIN or op in _FBIN:
            want = "i" if op in _IBIN else "f"
            b, a = _operand(stack.pop(), want), _operand(stack.pop(), want)
            fn = _IBIN.get(op) or _FBIN[op]
            local(_VAL[want], f"{fn}({a}, {b})", want)
        elif op[:-2] in _CMP:
            want = "i" if op.endswith("_I") else "f"
            b, a = _operand(stack.pop(), want), _operand(stack.pop(), want)
            local("uint32_t", f"RF_CMP({a}, {_CMP[op[:-2]]}, {b})", "b")
        else:
            raise ValueError(f"unknown instruction {op}")
    raise ValueError("a program segment without EMIT")


def _loads(code: Sequence[Tuple[str, int]]) -> List[int]:
    return sorted({arg for op, arg in code if op in _LOAD})


def _rank(keys: Sequence[Key], types: Sequence[str], word, checked: bool) -> List[str]:
    """Statements that rank the key columns into ``b``: ``word(slot)`` is
    the C expression of a key's value; each key is clipped to its domain,
    and with ``checked`` one outside it also clears ``*ok``."""
    out = ["  long long b = 0, v;"]
    for slot, lo, size in keys:
        w = f"RF_FBITS({word(slot)})" if types[slot] == "f" else word(slot)
        out.append(f"  v = static_cast<long long>({w}) - ({int(lo)}LL);")
        if checked:
            out.append(f"  if (v < 0 || v >= {int(size)}LL) *ok = 0u;")
        out += [f"  v = v < 0 ? 0 : (v >= {int(size)}LL ? {int(size) - 1}LL : v);",
                f"  b = b * {int(size)}LL + v;"]
    return out + ["  return b;"]


def _buckets(keys: Sequence[Key]) -> int:
    nb = 1
    for _, _, size in keys:
        nb *= int(size)
    return nb


def row_source(prog: exprcode.ExprProgram, col_types: Sequence[str],
               fns: Sequence[str] = (), keys: Optional[Sequence[Key]] = None,
               join: Optional[Join] = None) -> str:
    """The row functions of one query, as C++ over ``rowfn.cuh``:
    ``prog`` over columns of the types ``col_types`` (i, f or b; slot
    order), ``fns`` each value's aggregate (sum, min or max), ``keys`` the
    (slot, lo, size) of each key column for the grouped kernels, ``join``
    the slots of ``grouped_join_agg``'s two sides."""
    names = {v: k for k, v in exprcode.OPCODES.items()}
    code = [(names[int(op)], int(arg)) for op, arg in prog.code.tolist()]
    if len(fns) != prog.n_values:
        raise ValueError(f"{len(fns)} aggregate functions for {prog.n_values} values")
    pred_code, value_code = code[:prog.n_pred], code[prog.n_pred:]
    pred_cols = _loads(pred_code)
    rest = set(_loads(value_code)) | {s for s, _, _ in keys or ()}
    build_cols: List[int] = []
    if join is not None:
        n_side = join.n_probe + join.n_build
        if any(s >= join.n_probe for s in pred_cols):
            raise ValueError("the join's predicate may read probe columns only")
        if any(s >= join.n_probe for s, _, _ in join.probe_keys) or any(
                s < n_side for s, _, _ in join.build_keys):
            raise ValueError("join keys outside their side's slots")
        if any(s >= n_side for s in rest):
            raise ValueError("values and group keys read the build side's key columns")
        build_cols = sorted(s for s in rest if s >= join.n_probe)
        rest = {s for s in rest if s < join.n_probe} | {s for s, _, _ in join.probe_keys}
    rest_cols = sorted(rest - set(pred_cols))
    types = list(col_types)
    nv = prog.n_values
    out = ["// generated by repro_torch/kernels/codegen.py: one query's row functions",
           '#include "rowfn.cuh"', "", f"#define GEN_NV {nv}",
           f"#define GEN_NV1 {max(nv, 1)}", ""]
    out.append("struct GenCols {")
    out += [f"  const {_PTR[t]}* __restrict__ c{j};" for j, t in enumerate(types)]
    out += ["};", "", "struct GenRow {"]
    out += [f"  {_VAL[t]} c{j};" for j, t in enumerate(types)]
    out += ["};", "", "RF_FN GenCols gen_cols(const void* const* p) {", "  GenCols c;"]
    out += [f"  c.c{j} = static_cast<const {_PTR[t]}*>(p[{j}]);" for j, t in enumerate(types)]
    out += ["  return c;", "}", ""]
    loads = [("gen_load_pred", pred_cols), ("gen_load_rest", rest_cols)]
    if join is not None:
        loads.append(("gen_load_build", build_cols))
    for fn, cols in loads:
        out.append(f"RF_FN void {fn}(GenRow& r, const GenCols& c, long long i) {{")
        out += [f"  r.c{j} = RF_LDG(c.c{j} + i);" for j in cols]
        out += ["}", ""]
    lines, result, slot = _segment(pred_code, types)
    if slot != 0:
        raise ValueError("the predicate must come first")
    out += ["RF_FN uint32_t gen_pred(const GenRow& r) {", *lines, f"  return {result};", "}", ""]
    seg: List[Tuple[str, int]] = []
    for op, arg in value_code:
        seg.append((op, arg))
        if op != "EMIT":
            continue
        lines, result, slot = _segment(seg, types)
        out += [f"RF_FN float gen_value{slot - 1}(const GenRow& r) {{", *lines,
                f"  return {result};", "}", ""]
        seg = []
    out.append("RF_FN void gen_values(const GenRow& r, float* v) {")
    out += [f"  v[{k}] = gen_value{k}(r);" for k in range(nv)]
    out += ["}", "", "RF_FN float gen_ident(int k) {", "  switch (k) {"]
    out += [f"    case {k}: return {_IDENT[f]};" for k, f in enumerate(fns)]
    out += ["    default: return 0.0f;", "  }", "}", "",
            "RF_FN float gen_comb(int k, float a, float b) {", "  switch (k) {"]
    out += [f"    case {k}: return {_COMB[f]};" for k, f in enumerate(fns)]
    out += ["    default: return a;", "  }", "}", "",
            "RF_FN int gen_fn(int k) {", "  switch (k) {"]
    out += [f"    case {k}: return {_FN[f]};" for k, f in enumerate(fns)]
    out += ["    default: return 0;", "  }", "}", ""]
    if keys is not None:
        out += [f"#define GEN_NB {_buckets(keys)}LL", "",
                "RF_FN long long gen_bucket(const GenRow& r) {",
                *_rank(keys, types, lambda j: f"r.c{j}", False), "}", ""]
    if join is not None:
        if [k[1:] for k in join.probe_keys] != [k[1:] for k in join.build_keys]:
            raise ValueError("the join's two sides rank their keys in other domains")
        out += [f"#define GEN_NJB {_buckets(join.probe_keys)}LL", "",
                "RF_FN long long gen_jbucket(const GenRow& r, uint32_t* ok) {",
                *_rank(join.probe_keys, types, lambda j: f"r.c{j}", True), "}", "",
                "RF_FN long long gen_build_jbucket(const GenCols& c, long long i, uint32_t* ok) {",
                *_rank(join.build_keys, types, lambda j: f"RF_LDG(c.c{j} + i)", True), "}", ""]
    return "\n".join(out)


def kernel_source(family: str, prog: exprcode.ExprProgram, col_types: Sequence[str],
                  fns: Sequence[str], keys: Optional[Sequence[Key]] = None,
                  join: Optional[Join] = None) -> str:
    """The whole source of one generated kernel library: the row functions
    followed by the family's template, ``csrc/<family>.cu``."""
    if family not in FAMILIES:
        raise ValueError(f"no generated kernel family {family!r}")
    if (family != "fused_select_agg") != (keys is not None):
        raise ValueError(f"{family} takes keys only when grouped")
    if (family == "grouped_join_agg") != (join is not None):
        raise ValueError(f"{family} takes a join layout only when it joins")
    return row_source(prog, col_types, fns, keys, join) + f'#include "{family}.cu"\n'

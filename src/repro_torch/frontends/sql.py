"""A small SQL frontend — third frontend over the same CVM IR.

Grammar (enough for analytics demos; the paper's point is that adding a
frontend is a thin translation, not a new engine)::

    SELECT item [, item]*
    FROM table [JOIN table ON col = col]
    [WHERE pred]
    [GROUP BY col [, col]*]
    [ORDER BY col [ASC|DESC] [, ...]]
    [LIMIT n]

    item := expr [AS name] | agg(expr) [AS name]    agg ∈ sum,count,min,max,avg
    expr := literal | col | expr (+,-,*,/) expr | expr cmp expr
            | expr AND/OR expr | NOT expr | (expr) | col BETWEEN a AND b

Produces a ``dataflow.Frame`` — i.e. compiles through exactly the same
rewritings and backends as the Python frontend.  This package's copy of
``repro.frontends.sql``; only ``query`` differs (the ``local`` and
``interp`` targets, on a device).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from ..core.expr import BinOp, Const, Expr, UnOp, col, const
from .dataflow import AggExpr, Context, Frame

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d+|\d+)
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|<>|!=|[=<>(),*+\-/])
    )""", re.X)

_KEYWORDS = {"select", "from", "where", "group", "order", "by", "limit", "as",
             "and", "or", "not", "between", "asc", "desc", "join", "on",
             "sum", "count", "min", "max", "avg"}


def tokenize(sql: str) -> List[str]:
    out, i = [], 0
    while i < len(sql):
        m = _TOKEN.match(sql, i)
        if m is None:
            if sql[i:].strip() == "":
                break
            raise SyntaxError(f"bad SQL at: {sql[i:i+20]!r}")
        i = m.end()
        tok = m.group("num") or m.group("id") or m.group("op")
        if m.group("id") and tok.lower() in _KEYWORDS:
            tok = tok.lower()
        out.append(tok)
    return out


class Parser:
    def __init__(self, toks: List[str]) -> None:
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise SyntaxError("unexpected end of query")
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise SyntaxError(f"expected {tok!r}, got {t!r}")

    def accept(self, tok: str) -> bool:
        if self.peek() == tok:
            self.i += 1
            return True
        return False

    # -- expressions (precedence climbing) ---------------------------------
    def expr(self) -> Expr:
        return self._or()

    def _or(self) -> Expr:
        e = self._and()
        while self.accept("or"):
            e = e | self._and()
        return e

    def _and(self) -> Expr:
        e = self._not()
        while self.accept("and"):
            e = e & self._not()
        return e

    def _not(self) -> Expr:
        if self.accept("not"):
            return ~self._not()
        return self._cmp()

    def _cmp(self) -> Expr:
        e = self._add()
        t = self.peek()
        if t == "between":
            self.next()
            lo = self._add()
            self.expect("and")
            hi = self._add()
            return (e >= lo) & (e <= hi)
        if t in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            rhs = self._add()
            return {"=": e.eq, "<>": e.ne, "!=": e.ne, "<": e.__lt__,
                    "<=": e.__le__, ">": e.__gt__, ">=": e.__ge__}[t](rhs)
        return e

    def _add(self) -> Expr:
        e = self._mul()
        while self.peek() in ("+", "-"):
            op = self.next()
            rhs = self._mul()
            e = e + rhs if op == "+" else e - rhs
        return e

    def _mul(self) -> Expr:
        e = self._atom()
        while self.peek() in ("*", "/"):
            op = self.next()
            rhs = self._atom()
            e = e * rhs if op == "*" else e / rhs
        return e

    def _atom(self) -> Expr:
        t = self.next()
        if t == "(":
            e = self.expr()
            self.expect(")")
            return e
        if t == "-":
            return const(0) - self._atom()
        if re.fullmatch(r"\d+\.\d+", t):
            return const(float(t))
        if re.fullmatch(r"\d+", t):
            return const(int(t))
        return col(t)

    # -- select list ---------------------------------------------------------
    def select_item(self):
        t = self.peek()
        if t in ("sum", "count", "min", "max", "avg"):
            fn = self.next()
            self.expect("(")
            if fn == "count" and self.accept("*"):
                inner: Optional[Expr] = None
            else:
                inner = self.expr()
            self.expect(")")
            name = None
            if self.accept("as"):
                name = self.next()
            if fn == "count":
                agg = AggExpr("count", const(1), name)
            else:
                agg = AggExpr(fn, inner, name)
            return ("agg", agg)
        e = self.expr()
        name = None
        if self.accept("as"):
            name = self.next()
        return ("expr", e, name)


def parse(sql: str, ctx: Context) -> Frame:
    p = Parser(tokenize(sql))
    p.expect("select")
    items = [p.select_item()]
    while p.accept(","):
        items.append(p.select_item())

    p.expect("from")
    frame = ctx.table(p.next())
    if p.accept("join"):
        right = ctx.table(p.next())
        p.expect("on")
        lk = p.next()
        p.expect("=")
        rk = p.next()
        if frame.schema.has_field(lk):
            frame = frame.join(right, left_on=lk, right_on=rk)
        else:
            frame = frame.join(right, left_on=rk, right_on=lk)

    if p.accept("where"):
        frame = frame.filter(p.expr())

    group_cols: List[str] = []
    if p.accept("group"):
        p.expect("by")
        group_cols.append(p.next())
        while p.accept(","):
            group_cols.append(p.next())

    aggs = [it[1] for it in items if it[0] == "agg"]
    plain = [(it[1], it[2]) for it in items if it[0] == "expr"]

    if aggs and group_cols:
        named = tuple(a if a.name else a.as_(f"{a.fn}_{i}") for i, a in enumerate(aggs))
        frame = frame.group_by(*group_cols, max_groups=4096).agg(*named)
    elif aggs:
        named = tuple(a if a.name else a.as_(f"{a.fn}_{i}") for i, a in enumerate(aggs))
        frame = frame.agg(*named)
    elif plain:
        exprs = {}
        for i, (e, name) in enumerate(plain):
            from ..core.expr import Col
            exprs[name or (e.name if isinstance(e, Col) else f"col_{i}")] = e
        frame = frame.project(**exprs)

    if p.accept("order"):
        p.expect("by")
        keys, asc = [], []
        while True:
            keys.append(p.next())
            if p.accept("desc"):
                asc.append(False)
            elif p.accept("asc"):
                asc.append(True)
            else:
                asc.append(True)
            if not p.accept(","):
                break
        frame = frame.order_by(*keys, ascending=asc)

    if p.accept("limit"):
        frame = frame.limit(int(p.next()))

    if p.peek() is not None:
        raise SyntaxError(f"trailing tokens: {p.toks[p.i:]}")
    return frame


def query(ctx: Context, sql: str, target: str = "local",
          parallel: Optional[int] = None, optimize: Optional[str] = None,
          device: Any = None):
    """Parse + execute through the port's compile driver: ``target``
    ``"local"`` on ``device`` (``cuda`` unless given), ``"spmd"`` or
    ``"multipod"`` (on every rank of a mesh of ``parallel`` ranks) or
    ``"interp"`` (the numpy interpreter on the host); ``optimize="cost"``
    lets the driver choose between the target's physical lowerings by the
    context's table statistics."""
    return parse(sql, ctx).collect(target=target, parallel=parallel,
                                   optimize=optimize, device=device)

"""TPC-H workload: generator, queries (paper Figs. 2–4), numpy references.

Strings are dictionary-encoded i32 codes (TPU adaptation, DESIGN.md §2);
dates are epoch days.  The generator is a statistical look-alike of dbgen
(uniform value distributions per the spec's ranges) — adequate for
performance work and for validating plans against the numpy references,
which share the same tables.

Queries implemented: Q1, Q4, Q6, Q12, Q14, Q19 — the set reported across
the paper's three experiments.
"""

from __future__ import annotations

from datetime import date
from typing import Callable, Dict

import numpy as np

from ..core.expr import col, const
from ..frontends.dataflow import Context, Frame, avg_, count_, max_, min_, sum_

# ---------------------------------------------------------------------------
# dictionaries
# ---------------------------------------------------------------------------

RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["O", "F"]
SHIPMODES = ["AIR", "AIR REG", "MAIL", "SHIP", "TRUCK", "RAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
CONTAINERS = [f"{a} {b}" for a in ["SM", "MED", "LG", "JUMBO", "WRAP"]
              for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]]
N_PTYPES = 150
PROMO_PTYPES = 30  # codes < 30 mean "PROMO%"


def _day(y: int, m: int, d: int) -> int:
    return date(y, m, d).toordinal() - date(1970, 1, 1).toordinal()


def code(vocab, name) -> int:
    return vocab.index(name)


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


def generate(sf: float = 0.01, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n_orders = max(64, int(150_000 * sf))
    n_part = max(32, int(200_000 * sf))

    # orders ---------------------------------------------------------------
    o_orderkey = np.arange(1, n_orders + 1, dtype=np.int32)
    o_orderdate = rng.integers(_day(1992, 1, 1), _day(1998, 8, 2), n_orders).astype(np.int32)
    o_orderpriority = rng.integers(0, len(PRIORITIES), n_orders).astype(np.int32)
    orders = {
        "o_orderkey": o_orderkey,
        "o_orderdate": o_orderdate,
        "o_orderpriority": o_orderpriority,
    }

    # part -----------------------------------------------------------------
    part = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int32),
        "p_brand": rng.integers(0, len(BRANDS), n_part).astype(np.int32),
        "p_container": rng.integers(0, len(CONTAINERS), n_part).astype(np.int32),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_type": rng.integers(0, N_PTYPES, n_part).astype(np.int32),
    }

    # lineitem (1..7 lines per order) ---------------------------------------
    lines_per = rng.integers(1, 8, n_orders)
    n_li = int(lines_per.sum())
    l_orderkey = np.repeat(o_orderkey, lines_per)
    odate = np.repeat(o_orderdate, lines_per)
    l_shipdate = (odate + rng.integers(1, 122, n_li)).astype(np.int32)
    l_commitdate = (odate + rng.integers(30, 91, n_li)).astype(np.int32)
    l_receiptdate = (l_shipdate + rng.integers(1, 31, n_li)).astype(np.int32)
    qty = rng.integers(1, 51, n_li).astype(np.float32)
    price = (qty * rng.uniform(900, 1100, n_li)).astype(np.float32)
    lineitem = {
        "l_orderkey": l_orderkey.astype(np.int32),
        "l_partkey": rng.integers(1, n_part + 1, n_li).astype(np.int32),
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": np.round(rng.uniform(0.0, 0.10, n_li), 2).astype(np.float32),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2).astype(np.float32),
        "l_returnflag": rng.integers(0, len(RETURNFLAGS), n_li).astype(np.int32),
        "l_linestatus": rng.integers(0, len(LINESTATUS), n_li).astype(np.int32),
        "l_shipdate": l_shipdate,
        "l_commitdate": l_commitdate,
        "l_receiptdate": l_receiptdate,
        "l_shipmode": rng.integers(0, len(SHIPMODES), n_li).astype(np.int32),
        "l_shipinstruct": rng.integers(0, len(SHIPINSTRUCT), n_li).astype(np.int32),
    }
    return {"lineitem": lineitem, "orders": orders, "part": part}


def make_context(tables: Dict[str, Dict[str, np.ndarray]], pad_to: int = 256) -> Context:
    ctx = Context(pad_to=pad_to)
    for name, data in tables.items():
        ctx.register(name, data)
    return ctx


# ---------------------------------------------------------------------------
# queries (frontend builders)
# ---------------------------------------------------------------------------

Q1_CUTOFF = _day(1998, 12, 1) - 90


def q1(ctx: Context) -> Frame:
    li = ctx.table("lineitem")
    return (
        li.filter(col("l_shipdate") <= Q1_CUTOFF)
        .with_columns(
            disc_price=col("l_extendedprice") * (1.0 - col("l_discount")),
            charge=col("l_extendedprice") * (1.0 - col("l_discount")) * (1.0 + col("l_tax")),
        )
        .group_by("l_returnflag", "l_linestatus", max_groups=8)
        .agg(
            sum_("l_quantity").as_("sum_qty"),
            sum_("l_extendedprice").as_("sum_base_price"),
            sum_("disc_price").as_("sum_disc_price"),
            sum_("charge").as_("sum_charge"),
            avg_("l_quantity").as_("avg_qty"),
            avg_("l_extendedprice").as_("avg_price"),
            avg_("l_discount").as_("avg_disc"),
            count_().as_("count_order"),
        )
        .order_by("l_returnflag", "l_linestatus")
    )


def q4(ctx: Context) -> Frame:
    li = ctx.table("lineitem")
    orders = ctx.table("orders")
    cnt = (
        li.filter(col("l_commitdate") < col("l_receiptdate"))
        .group_by("l_orderkey", max_groups=ctx.capacity("orders"))
        .agg(count_().as_("n_late"))
    )
    return (
        orders.filter(
            (col("o_orderdate") >= _day(1993, 7, 1)) & (col("o_orderdate") < _day(1993, 10, 1))
        )
        .join(cnt, left_on="o_orderkey", right_on="l_orderkey")
        .group_by("o_orderpriority", max_groups=8)
        .agg(count_().as_("order_count"))
        .order_by("o_orderpriority")
    )


def q6(ctx: Context) -> Frame:
    li = ctx.table("lineitem")
    return li.filter(
        (col("l_shipdate") >= _day(1994, 1, 1))
        & (col("l_shipdate") < _day(1995, 1, 1))
        & col("l_discount").between(0.05, 0.07)
        & (col("l_quantity") < 24.0)
    ).agg(sum_(col("l_extendedprice") * col("l_discount")).as_("revenue"))


def q12(ctx: Context) -> Frame:
    li = ctx.table("lineitem")
    orders = ctx.table("orders")
    mail, ship = code(SHIPMODES, "MAIL"), code(SHIPMODES, "SHIP")
    filtered = li.filter(
        (col("l_shipmode").isin((mail, ship)))
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= _day(1994, 1, 1))
        & (col("l_receiptdate") < _day(1995, 1, 1))
    )
    joined = filtered.join(orders, left_on="l_orderkey", right_on="o_orderkey")
    high = col("o_orderpriority") <= 1  # 1-URGENT or 2-HIGH
    return (
        joined.group_by("l_shipmode", max_groups=8)
        .agg(
            sum_(high).as_("high_line_count"),
            sum_(~high).as_("low_line_count"),
        )
        .order_by("l_shipmode")
    )


def q14(ctx: Context) -> Frame:
    li = ctx.table("lineitem")
    part = ctx.table("part")
    joined = (
        li.filter(
            (col("l_shipdate") >= _day(1995, 9, 1)) & (col("l_shipdate") < _day(1995, 10, 1))
        )
        .join(part, left_on="l_partkey", right_on="p_partkey")
        .with_columns(
            rev=col("l_extendedprice") * (1.0 - col("l_discount")),
            promo=(col("p_type") < PROMO_PTYPES) * (col("l_extendedprice") * (1.0 - col("l_discount"))),
        )
    )
    return joined.agg(
        sum_("promo").as_("promo_rev"), sum_("rev").as_("total_rev")
    ).project(promo_revenue=const(100.0) * col("promo_rev") / col("total_rev"))


def q19(ctx: Context) -> Frame:
    li = ctx.table("lineitem")
    part = ctx.table("part")
    sm = [code(CONTAINERS, c) for c in ("SM CASE", "SM BOX", "SM PACK", "SM PKG")]
    med = [code(CONTAINERS, c) for c in ("MED BAG", "MED BOX", "MED PKG", "MED PACK")]
    lg = [code(CONTAINERS, c) for c in ("LG CASE", "LG BOX", "LG PACK", "LG PKG")]
    air = (code(SHIPMODES, "AIR"), code(SHIPMODES, "AIR REG"))
    dip = code(SHIPINSTRUCT, "DELIVER IN PERSON")

    joined = li.join(part, left_on="l_partkey", right_on="p_partkey")
    common = col("l_shipmode").isin(air) & col("l_shipinstruct").eq(dip)
    c1 = (
        col("p_brand").eq(code(BRANDS, "Brand#12")) & col("p_container").isin(tuple(sm))
        & col("l_quantity").between(1.0, 11.0) & col("p_size").between(1, 5)
    )
    c2 = (
        col("p_brand").eq(code(BRANDS, "Brand#23")) & col("p_container").isin(tuple(med))
        & col("l_quantity").between(10.0, 20.0) & col("p_size").between(1, 10)
    )
    c3 = (
        col("p_brand").eq(code(BRANDS, "Brand#34")) & col("p_container").isin(tuple(lg))
        & col("l_quantity").between(20.0, 30.0) & col("p_size").between(1, 15)
    )
    return joined.filter(common & (c1 | c2 | c3)).agg(
        sum_(col("l_extendedprice") * (1.0 - col("l_discount"))).as_("revenue")
    )


QUERIES: Dict[str, Callable[[Context], Frame]] = {
    "q1": q1, "q4": q4, "q6": q6, "q12": q12, "q14": q14, "q19": q19,
}


# ---------------------------------------------------------------------------
# numpy references (oracles)
# ---------------------------------------------------------------------------


def ref_q1(t):
    li = t["lineitem"]
    m = li["l_shipdate"] <= Q1_CUTOFF
    rf, ls = li["l_returnflag"][m], li["l_linestatus"][m]
    qty = li["l_quantity"][m].astype(np.float64)
    ep = li["l_extendedprice"][m].astype(np.float64)
    disc = li["l_discount"][m].astype(np.float64)
    tax = li["l_tax"][m].astype(np.float64)
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
                           "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
                           "avg_disc", "count_order")}
    for f in np.unique(rf):
        for s in np.unique(ls):
            g = (rf == f) & (ls == s)
            if not g.any():
                continue
            out["l_returnflag"].append(f)
            out["l_linestatus"].append(s)
            out["sum_qty"].append(qty[g].sum())
            out["sum_base_price"].append(ep[g].sum())
            out["sum_disc_price"].append((ep[g] * (1 - disc[g])).sum())
            out["sum_charge"].append((ep[g] * (1 - disc[g]) * (1 + tax[g])).sum())
            out["avg_qty"].append(qty[g].mean())
            out["avg_price"].append(ep[g].mean())
            out["avg_disc"].append(disc[g].mean())
            out["count_order"].append(int(g.sum()))
    return {k: np.asarray(v) for k, v in out.items()}


def ref_q4(t):
    li, o = t["lineitem"], t["orders"]
    late = np.unique(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]])
    m = (o["o_orderdate"] >= _day(1993, 7, 1)) & (o["o_orderdate"] < _day(1993, 10, 1))
    sel = m & np.isin(o["o_orderkey"], late)
    prio = o["o_orderpriority"][sel]
    ks = np.unique(prio)
    return {"o_orderpriority": ks,
            "order_count": np.asarray([(prio == k).sum() for k in ks])}


def ref_q6(t):
    li = t["lineitem"]
    m = (
        (li["l_shipdate"] >= _day(1994, 1, 1)) & (li["l_shipdate"] < _day(1995, 1, 1))
        & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
        & (li["l_quantity"] < 24.0)
    )
    return {"revenue": np.asarray(
        (li["l_extendedprice"][m].astype(np.float64) * li["l_discount"][m]).sum())}


def ref_q12(t):
    li, o = t["lineitem"], t["orders"]
    mail, ship = code(SHIPMODES, "MAIL"), code(SHIPMODES, "SHIP")
    m = (
        np.isin(li["l_shipmode"], [mail, ship])
        & (li["l_commitdate"] < li["l_receiptdate"])
        & (li["l_shipdate"] < li["l_commitdate"])
        & (li["l_receiptdate"] >= _day(1994, 1, 1))
        & (li["l_receiptdate"] < _day(1995, 1, 1))
    )
    ok = li["l_orderkey"][m]
    sm = li["l_shipmode"][m]
    pr = o["o_orderpriority"][np.searchsorted(o["o_orderkey"], ok)]
    out_modes = np.unique(sm)
    high = pr <= 1
    return {
        "l_shipmode": out_modes,
        "high_line_count": np.asarray([int(high[sm == x].sum()) for x in out_modes]),
        "low_line_count": np.asarray([int((~high)[sm == x].sum()) for x in out_modes]),
    }


def ref_q14(t):
    li, p = t["lineitem"], t["part"]
    m = (li["l_shipdate"] >= _day(1995, 9, 1)) & (li["l_shipdate"] < _day(1995, 10, 1))
    pk = li["l_partkey"][m]
    ptype = p["p_type"][np.searchsorted(p["p_partkey"], pk)]
    rev = (li["l_extendedprice"][m] * (1 - li["l_discount"][m])).astype(np.float64)
    promo = rev * (ptype < PROMO_PTYPES)
    return {"promo_revenue": np.asarray(100.0 * promo.sum() / rev.sum())}


def ref_q19(t):
    li, p = t["lineitem"], t["part"]
    idx = np.searchsorted(p["p_partkey"], li["l_partkey"])
    brand = p["p_brand"][idx]
    cont = p["p_container"][idx]
    size = p["p_size"][idx]
    sm = [code(CONTAINERS, c) for c in ("SM CASE", "SM BOX", "SM PACK", "SM PKG")]
    med = [code(CONTAINERS, c) for c in ("MED BAG", "MED BOX", "MED PKG", "MED PACK")]
    lg = [code(CONTAINERS, c) for c in ("LG CASE", "LG BOX", "LG PACK", "LG PKG")]
    air = [code(SHIPMODES, "AIR"), code(SHIPMODES, "AIR REG")]
    dip = code(SHIPINSTRUCT, "DELIVER IN PERSON")
    common = np.isin(li["l_shipmode"], air) & (li["l_shipinstruct"] == dip)
    q = li["l_quantity"]
    c1 = (brand == code(BRANDS, "Brand#12")) & np.isin(cont, sm) & (q >= 1) & (q <= 11) & (size >= 1) & (size <= 5)
    c2 = (brand == code(BRANDS, "Brand#23")) & np.isin(cont, med) & (q >= 10) & (q <= 20) & (size >= 1) & (size <= 10)
    c3 = (brand == code(BRANDS, "Brand#34")) & np.isin(cont, lg) & (q >= 20) & (q <= 30) & (size >= 1) & (size <= 15)
    m = common & (c1 | c2 | c3)
    return {"revenue": np.asarray(
        (li["l_extendedprice"][m].astype(np.float64) * (1 - li["l_discount"][m])).sum())}


REFERENCES: Dict[str, Callable] = {
    "q1": ref_q1, "q4": ref_q4, "q6": ref_q6, "q12": ref_q12, "q14": ref_q14, "q19": ref_q19,
}

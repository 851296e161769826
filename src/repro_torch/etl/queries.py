"""SSB query dataflows (paper §5).

Each builder returns (Dataflow, CollectSink, oracle) where ``oracle(data)``
computes the expected result with an INDEPENDENT implementation (direct
dense-key array indexing — no DimTable/searchsorted code shared with the
engine path), so engine-vs-oracle equality is a real correctness check.

Q4.1 is the paper's Figure-11 flow: lineorder source -> 4 lookups -> filter
-> project -> expression -> groupby-sum (block) -> sort (block) -> sink,
which Algorithm 1 partitions into execution trees T1={1..8}, T2={9},
T3={10,11}.

Predicates and derived columns are built with the column-expression DSL
(``core/expr.py``) by default — their read sets are derived from the AST, so
the optimizer and fused kernels get exact provenance.  ``use_dsl=False``
(or ``REPRO_FLOW_STYLE=lambda``) rebuilds the pre-DSL flows from legacy
lambdas with hand-declared ``reads=`` — kept as the A/B reference the
DSL-vs-lambda equivalence tests and benchmarks compare against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..core import config
from ..core.component import StageBoundary
from ..core.expr import col
from ..core.graph import Dataflow
from .components import (Aggregate, ArraySource, CollectSink, DimTable,
                         Expression, Filter, Lookup, Project, Sort)
from .ssb import SSBData, mfgr_id, region_id


@dataclass
class QueryFlow:
    name: str
    flow: Dataflow
    sink: CollectSink
    oracle: Callable[[SSBData], Dict[str, np.ndarray]]
    #: how the flow's predicates/expressions were built ("dsl" | "lambda") —
    #: recorded in benchmark JSON so the perf trajectory tells the two apart
    style: str = "dsl"


def _style(use_dsl: Optional[bool]) -> bool:
    """Resolve a builder's ``use_dsl`` argument: explicit flag wins, else
    the process default (``REPRO_FLOW_STYLE``, "dsl" unless overridden)."""
    return config.flow_style() == "dsl" if use_dsl is None else bool(use_dsl)


# ---------------------------------------------------------------------------
#  helpers
# ---------------------------------------------------------------------------
def _dense(payload: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Oracle-side direct index: payload value per key (keys are 1..N)."""
    return payload[keys - 1]


def _dims(data: SSBData):
    cust = DimTable(data.customer["c_custkey"],
                    {"c_nation": data.customer["c_nation"],
                     "c_region": data.customer["c_region"],
                     "c_city": data.customer["c_city"]})
    supp = DimTable(data.supplier["s_suppkey"],
                    {"s_nation": data.supplier["s_nation"],
                     "s_region": data.supplier["s_region"],
                     "s_city": data.supplier["s_city"]})
    part = DimTable(data.part["p_partkey"],
                    {"p_brand1": data.part["p_brand1"],
                     "p_category": data.part["p_category"],
                     "p_mfgr": data.part["p_mfgr"]})
    date = DimTable(data.date["d_datekey"],
                    {"d_year": data.date["d_year"],
                     "d_yearmonthnum": data.date["d_yearmonthnum"],
                     "d_weeknuminyear": data.date["d_weeknuminyear"]})
    return cust, supp, part, date


# ---------------------------------------------------------------------------
#  Q1.1 — revenue from discount/quantity band in 1993
# ---------------------------------------------------------------------------
def build_q1(data: SSBData, use_dsl: Optional[bool] = None) -> QueryFlow:
    dsl = _style(use_dsl)
    _, _, _, date = _dims(data)
    flow = Dataflow("ssb-q1.1")
    src = ArraySource("lineorder", data.lineorder)
    lk_date = Lookup("lookup_date", date, "lo_orderdate",
                     {"d_year": "d_year"}, matched_flag="d_ok")
    if dsl:
        filt = Filter("filter", col("d_ok")
                      & (col("d_year") == 1993)
                      & col("lo_discount").between(1, 3)
                      & (col("lo_quantity") < 25))
        expr = Expression("revenue_expr", "rev",
                          col("lo_extendedprice") * col("lo_discount"))
    else:
        filt = Filter("filter", lambda c, r: (
            c.col("d_ok")[r]
            & (c.col("d_year")[r] == 1993)
            & (c.col("lo_discount")[r] >= 1) & (c.col("lo_discount")[r] <= 3)
            & (c.col("lo_quantity")[r] < 25)),
            reads=["d_ok", "d_year", "lo_discount", "lo_quantity"])
        expr = Expression("revenue_expr", "rev",
                          lambda c, r: c.col("lo_extendedprice")[r]
                          * c.col("lo_discount")[r],
                          reads=["lo_extendedprice", "lo_discount"])
    agg = Aggregate("sum_revenue", [], {"revenue": ("rev", "sum")})
    sink = CollectSink("sink")
    flow.chain(src, lk_date, filt, expr, agg, sink)

    def oracle(d: SSBData) -> Dict[str, np.ndarray]:
        lo = d.lineorder
        dmap = {k: i for i, k in enumerate(d.date["d_datekey"])}
        year = d.date["d_year"][np.array([dmap[k] for k in lo["lo_orderdate"]])]
        m = ((year == 1993) & (lo["lo_discount"] >= 1)
             & (lo["lo_discount"] <= 3) & (lo["lo_quantity"] < 25))
        rev = (lo["lo_extendedprice"][m] * lo["lo_discount"][m]).astype(np.float64)
        return {"revenue": np.array([rev.sum()])}

    return QueryFlow("Q1.1", flow, sink, oracle,
                     style="dsl" if dsl else "lambda")


# ---------------------------------------------------------------------------
#  Q2.1 — revenue by year/brand for category MFGR#12-equivalent, AMERICA
# ---------------------------------------------------------------------------
def build_q2(data: SSBData, use_dsl: Optional[bool] = None) -> QueryFlow:
    dsl = _style(use_dsl)
    _, supp, part, date = _dims(data)
    CATEGORY = 12
    AMERICA = region_id("AMERICA")
    part_f = DimTable(data.part["p_partkey"],
                      {"p_brand1": data.part["p_brand1"]},
                      row_filter=data.part["p_category"] == CATEGORY)
    supp_f = DimTable(data.supplier["s_suppkey"],
                      {"s_nation": data.supplier["s_nation"]},
                      row_filter=data.supplier["s_region"] == AMERICA)
    flow = Dataflow("ssb-q2.1")
    src = ArraySource("lineorder", data.lineorder)
    lk_part = Lookup("lookup_part", part_f, "lo_partkey",
                     {"p_brand1": "p_brand1"})
    lk_supp = Lookup("lookup_supplier", supp_f, "lo_suppkey",
                     {"s_nation": "s_nation"})
    lk_date = Lookup("lookup_date", date, "lo_orderdate",
                     {"d_year": "d_year"})
    if dsl:
        filt = Filter("filter", (col("p_brand1") >= 0)
                      & (col("s_nation") >= 0) & (col("d_year") >= 0))
    else:
        filt = Filter("filter", lambda c, r: (
            (c.col("p_brand1")[r] >= 0) & (c.col("s_nation")[r] >= 0)
            & (c.col("d_year")[r] >= 0)),
            reads=["p_brand1", "s_nation", "d_year"])
    agg = Aggregate("sum_revenue", ["d_year", "p_brand1"],
                    {"revenue": ("lo_revenue", "sum")})
    srt = Sort("sort", ["d_year", "p_brand1"])
    sink = CollectSink("sink")
    flow.chain(src, lk_part, lk_supp, lk_date, filt, agg, srt, sink)

    def oracle(d: SSBData) -> Dict[str, np.ndarray]:
        lo = d.lineorder
        brand = _dense(d.part["p_brand1"], lo["lo_partkey"])
        cat = _dense(d.part["p_category"], lo["lo_partkey"])
        sregion = _dense(d.supplier["s_region"], lo["lo_suppkey"])
        dmap = {k: i for i, k in enumerate(d.date["d_datekey"])}
        year = d.date["d_year"][np.array([dmap[k] for k in lo["lo_orderdate"]])]
        m = (cat == CATEGORY) & (sregion == AMERICA)
        return _group_sum_oracle({"d_year": year[m], "p_brand1": brand[m]},
                                 lo["lo_revenue"][m], "revenue")

    return QueryFlow("Q2.1", flow, sink, oracle,
                     style="dsl" if dsl else "lambda")


# ---------------------------------------------------------------------------
#  Q3.1 — revenue by c_nation, s_nation, year in ASIA, 1992<=y<=1997
# ---------------------------------------------------------------------------
def build_q3(data: SSBData, use_dsl: Optional[bool] = None) -> QueryFlow:
    dsl = _style(use_dsl)
    ASIA = region_id("ASIA")
    cust_f = DimTable(data.customer["c_custkey"],
                      {"c_nation": data.customer["c_nation"]},
                      row_filter=data.customer["c_region"] == ASIA)
    supp_f = DimTable(data.supplier["s_suppkey"],
                      {"s_nation": data.supplier["s_nation"]},
                      row_filter=data.supplier["s_region"] == ASIA)
    date = DimTable(data.date["d_datekey"], {"d_year": data.date["d_year"]})
    flow = Dataflow("ssb-q3.1")
    src = ArraySource("lineorder", data.lineorder)
    lk_cust = Lookup("lookup_customer", cust_f, "lo_custkey",
                     {"c_nation": "c_nation"})
    lk_supp = Lookup("lookup_supplier", supp_f, "lo_suppkey",
                     {"s_nation": "s_nation"})
    lk_date = Lookup("lookup_date", date, "lo_orderdate",
                     {"d_year": "d_year"})
    if dsl:
        filt = Filter("filter", (col("c_nation") >= 0)
                      & (col("s_nation") >= 0)
                      & col("d_year").between(1992, 1997))
    else:
        filt = Filter("filter", lambda c, r: (
            (c.col("c_nation")[r] >= 0) & (c.col("s_nation")[r] >= 0)
            & (c.col("d_year")[r] >= 1992) & (c.col("d_year")[r] <= 1997)),
            reads=["c_nation", "s_nation", "d_year"])
    agg = Aggregate("sum_revenue", ["c_nation", "s_nation", "d_year"],
                    {"revenue": ("lo_revenue", "sum")})
    srt = Sort("sort", ["d_year", "c_nation", "s_nation"])
    sink = CollectSink("sink")
    flow.chain(src, lk_cust, lk_supp, lk_date, filt, agg, srt, sink)

    def oracle(d: SSBData) -> Dict[str, np.ndarray]:
        lo = d.lineorder
        cn = _dense(d.customer["c_nation"], lo["lo_custkey"])
        cr = _dense(d.customer["c_region"], lo["lo_custkey"])
        sn = _dense(d.supplier["s_nation"], lo["lo_suppkey"])
        sr = _dense(d.supplier["s_region"], lo["lo_suppkey"])
        dmap = {k: i for i, k in enumerate(d.date["d_datekey"])}
        year = d.date["d_year"][np.array([dmap[k] for k in lo["lo_orderdate"]])]
        m = (cr == ASIA) & (sr == ASIA) & (year >= 1992) & (year <= 1997)
        return _group_sum_oracle(
            {"c_nation": cn[m], "s_nation": sn[m], "d_year": year[m]},
            lo["lo_revenue"][m], "revenue",
            sort_by=["d_year", "c_nation", "s_nation"])

    return QueryFlow("Q3.1", flow, sink, oracle,
                     style="dsl" if dsl else "lambda")


# ---------------------------------------------------------------------------
#  Q4.1 — the paper's Figure-11 dataflow (profit by year, customer nation)
# ---------------------------------------------------------------------------
def build_q4(data: SSBData, staged: bool = False,
             use_dsl: Optional[bool] = None) -> QueryFlow:
    """``staged=True`` inserts an explicit StageBoundary between the lookup
    stage and the filter/project/expression stage — the multi-tree variant
    whose trees are connected by a ROW-SYNCHRONIZED boundary, which the
    streaming executor overlaps (Q4.1s in BUILDERS)."""
    dsl = _style(use_dsl)
    AMERICA = region_id("AMERICA")
    M1, M2 = mfgr_id("MFGR#1"), mfgr_id("MFGR#2")
    cust_f = DimTable(data.customer["c_custkey"],
                      {"c_nation": data.customer["c_nation"]},
                      row_filter=data.customer["c_region"] == AMERICA)
    supp_f = DimTable(data.supplier["s_suppkey"],
                      {"s_nation": data.supplier["s_nation"]},
                      row_filter=data.supplier["s_region"] == AMERICA)
    part_f = DimTable(data.part["p_partkey"], {"p_mfgr": data.part["p_mfgr"]},
                      row_filter=((data.part["p_mfgr"] == M1)
                                  | (data.part["p_mfgr"] == M2)))
    date = DimTable(data.date["d_datekey"], {"d_year": data.date["d_year"]})

    flow = Dataflow("ssb-q4.1")
    src = ArraySource("lineorder", data.lineorder)                    # 1
    lk_cust = Lookup("lookup_customer", cust_f, "lo_custkey",
                     {"c_nation": "c_nation"})                        # 2
    lk_supp = Lookup("lookup_supplier", supp_f, "lo_suppkey",
                     {"s_nation": "s_nation"})                        # 3
    lk_part = Lookup("lookup_part", part_f, "lo_partkey",
                     {"p_mfgr": "p_mfgr"})                            # 4
    lk_date = Lookup("lookup_date", date, "lo_orderdate",
                     {"d_year": "d_year"})                            # 5
    if dsl:
        filt = Filter("filter_unmatched",                              # 6
                      (col("c_nation") >= 0) & (col("s_nation") >= 0)
                      & (col("p_mfgr") >= 0) & (col("d_year") >= 0))
        expr = Expression("profit_expr", "profit",                     # 8
                          col("lo_revenue") - col("lo_supplycost"))
    else:
        filt = Filter("filter_unmatched", lambda c, r: (               # 6
            (c.col("c_nation")[r] >= 0) & (c.col("s_nation")[r] >= 0)
            & (c.col("p_mfgr")[r] >= 0) & (c.col("d_year")[r] >= 0)),
            reads=["c_nation", "s_nation", "p_mfgr", "d_year"])
        expr = Expression("profit_expr", "profit",
                          lambda c, r: c.col("lo_revenue")[r]
                          - c.col("lo_supplycost")[r],
                          reads=["lo_revenue", "lo_supplycost"])      # 8
    proj = Project("project", ["d_year", "c_nation",
                               "lo_revenue", "lo_supplycost"])        # 7
    agg = Aggregate("groupby_sum", ["d_year", "c_nation"],
                    {"profit": ("profit", "sum")})                    # 9
    srt = Sort("sort", ["d_year", "c_nation"])                        # 10
    sink = CollectSink("sink")                                        # 11
    if staged:
        cut = StageBoundary("stage_cut")
        flow.chain(src, lk_cust, lk_supp, lk_part, lk_date, cut, filt,
                   proj, expr, agg, srt, sink)
    else:
        flow.chain(src, lk_cust, lk_supp, lk_part, lk_date, filt, proj,
                   expr, agg, srt, sink)

    def oracle(d: SSBData) -> Dict[str, np.ndarray]:
        lo = d.lineorder
        cn = _dense(d.customer["c_nation"], lo["lo_custkey"])
        cr = _dense(d.customer["c_region"], lo["lo_custkey"])
        sr = _dense(d.supplier["s_region"], lo["lo_suppkey"])
        pm = _dense(d.part["p_mfgr"], lo["lo_partkey"])
        dmap = {k: i for i, k in enumerate(d.date["d_datekey"])}
        year = d.date["d_year"][np.array([dmap[k] for k in lo["lo_orderdate"]])]
        m = ((cr == AMERICA) & (sr == AMERICA) & ((pm == M1) | (pm == M2)))
        profit = lo["lo_revenue"] - lo["lo_supplycost"]
        return _group_sum_oracle({"d_year": year[m], "c_nation": cn[m]},
                                 profit[m], "profit")

    return QueryFlow("Q4.1s" if staged else "Q4.1", flow, sink, oracle,
                     style="dsl" if dsl else "lambda")


def build_q4_staged(data: SSBData, use_dsl: Optional[bool] = None) -> QueryFlow:
    return build_q4(data, staged=True, use_dsl=use_dsl)


# ---------------------------------------------------------------------------
def _group_sum_oracle(groups: Dict[str, np.ndarray], vals: np.ndarray,
                      out_name: str, sort_by=None) -> Dict[str, np.ndarray]:
    """Independent group-by-sum using python dicts over packed keys."""
    names = list(groups.keys())
    arrs = [groups[k] for k in names]
    acc: Dict[tuple, float] = {}
    for i in range(len(vals)):
        key = tuple(int(a[i]) for a in arrs)
        acc[key] = acc.get(key, 0.0) + float(vals[i])
    if sort_by is None:
        sort_by = names
    pos = [names.index(s) for s in sort_by]
    keys_sorted = sorted(acc.keys(), key=lambda k: tuple(k[p] for p in pos))
    out = {n: np.array([k[i] for k in keys_sorted], dtype=np.int64)
           for i, n in enumerate(names)}
    out[out_name] = np.array([acc[k] for k in keys_sorted], dtype=np.float64)
    return out


BUILDERS = {"Q1.1": build_q1, "Q2.1": build_q2, "Q3.1": build_q3,
            "Q4.1": build_q4, "Q4.1s": build_q4_staged}

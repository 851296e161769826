"""Star Schema Benchmark (SSB) data generator — the paper's evaluation
workload (§5): fact table `lineorder` + dimensions `customer`, `supplier`,
`part`, `date`.

Categorical attributes are dictionary-encoded int columns (columnar form);
the string dictionaries are exported so queries can reference values like
'AMERICA' or 'MFGR#1' symbolically.  All keys are dense (1..N), which lets
the *independent* query oracles in queries.py use direct array indexing
rather than the DimTable searchsorted path used by the dataflow engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
N_NATIONS = 25                       # nation i belongs to region i % 5
MFGRS = [f"MFGR#{i}" for i in range(1, 6)]
N_CATEGORIES = 25                    # category i belongs to mfgr i // 5
N_BRANDS = 1000                      # brand i belongs to category i // 40
YEARS = list(range(1992, 1999))


def region_of_nation(nation: np.ndarray) -> np.ndarray:
    return nation % 5


def mfgr_of_category(category: np.ndarray) -> np.ndarray:
    return category // 5


def category_of_brand(brand: np.ndarray) -> np.ndarray:
    return brand // 40


@dataclass
class SSBData:
    customer: Dict[str, np.ndarray]
    supplier: Dict[str, np.ndarray]
    part: Dict[str, np.ndarray]
    date: Dict[str, np.ndarray]
    lineorder: Dict[str, np.ndarray]

    def nbytes(self) -> int:
        return sum(sum(v.nbytes for v in t.values())
                   for t in (self.customer, self.supplier, self.part,
                             self.date, self.lineorder))


def generate(lineorder_rows: int = 1_000_000,
             customers: int = 30_000,
             suppliers: int = 2_000,
             parts: int = 20_000,
             seed: int = 42) -> SSBData:
    """Generate SSB tables.  Default sizes give a ~60MB fact table; scale
    ``lineorder_rows`` up for the paper's GB-scale runs."""
    rng = np.random.default_rng(seed)

    c_nation = rng.integers(0, N_NATIONS, customers)
    customer = {
        "c_custkey": np.arange(1, customers + 1, dtype=np.int64),
        "c_nation": c_nation.astype(np.int64),
        "c_region": region_of_nation(c_nation).astype(np.int64),
        "c_city": (c_nation * 10 + rng.integers(0, 10, customers)).astype(np.int64),
    }

    s_nation = rng.integers(0, N_NATIONS, suppliers)
    supplier = {
        "s_suppkey": np.arange(1, suppliers + 1, dtype=np.int64),
        "s_nation": s_nation.astype(np.int64),
        "s_region": region_of_nation(s_nation).astype(np.int64),
        "s_city": (s_nation * 10 + rng.integers(0, 10, suppliers)).astype(np.int64),
    }

    p_brand = rng.integers(0, N_BRANDS, parts)
    p_category = category_of_brand(p_brand)
    part = {
        "p_partkey": np.arange(1, parts + 1, dtype=np.int64),
        "p_brand1": p_brand.astype(np.int64),
        "p_category": p_category.astype(np.int64),
        "p_mfgr": mfgr_of_category(p_category).astype(np.int64),
    }

    # 7 years x 365 days
    n_days = len(YEARS) * 365
    day_of_year = np.tile(np.arange(1, 366), len(YEARS))
    year = np.repeat(np.array(YEARS, dtype=np.int64), 365)
    month = np.minimum((day_of_year - 1) // 31 + 1, 12)
    date = {
        "d_datekey": (year * 10000 + month * 100
                      + ((day_of_year - 1) % 31 + 1)).astype(np.int64),
        "d_year": year,
        "d_yearmonthnum": (year * 100 + month).astype(np.int64),
        "d_weeknuminyear": ((day_of_year - 1) // 7 + 1).astype(np.int64),
    }

    n = lineorder_rows
    quantity = rng.integers(1, 51, n).astype(np.int64)
    extendedprice = rng.integers(90_000, 1_100_000, n).astype(np.int64)
    discount = rng.integers(0, 11, n).astype(np.int64)
    revenue = (extendedprice * (100 - discount) // 100).astype(np.int64)
    lineorder = {
        "lo_orderkey": np.arange(1, n + 1, dtype=np.int64),
        "lo_custkey": rng.integers(1, customers + 1, n).astype(np.int64),
        "lo_suppkey": rng.integers(1, suppliers + 1, n).astype(np.int64),
        "lo_partkey": rng.integers(1, parts + 1, n).astype(np.int64),
        "lo_orderdate": date["d_datekey"][rng.integers(0, n_days, n)],
        "lo_quantity": quantity,
        "lo_discount": discount,
        "lo_extendedprice": extendedprice,
        "lo_revenue": revenue,
        "lo_supplycost": rng.integers(40_000, 60_000, n).astype(np.int64),
    }
    return SSBData(customer=customer, supplier=supplier, part=part,
                   date=date, lineorder=lineorder)


def region_id(name: str) -> int:
    return REGIONS.index(name)


def mfgr_id(name: str) -> int:
    return MFGRS.index(name)

"""The join + group-by query over generated lineitem and orders tables.

Counterpart of ``bench.py:142-235`` (``setup_join_groupby``), which the
port carries itself, as ``tpch.py`` carries q6: it imports nothing of
the JAX package or its bench. The plan is a shuffled hash join of
lineitem against orders on the order key, with the build side's keys
unique (``build_unique_hint``), then revenue summed per order month:

    GpuShuffledHashJoinExec(l_orderkey = o_orderkey, inner, hint)
    -> GpuHashAggregateExec([o_month],
                            [Sum(l_extendedprice * (1 - l_discount))])

over ``DeviceBatchSourceExec``s. The reference's size is
``n_li = 1 << 23`` lineitem rows in batches of ``1 << 21`` and
``n_ord = 1 << 17`` orders. Data comes from numpy's generator with seed
1, drawn in the reference's order. ``host_oracle`` is an independent
answer: a numpy gather on the dense key, a float32 product, and a
float64 ``bincount``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from . import datatypes as dt

__all__ = ["N_LI", "N_ORD", "BATCH_ROWS", "LINEITEM_SCHEMA",
           "ORDERS_SCHEMA", "gen_tables", "device_source", "plan_over",
           "build_plan", "host_oracle"]

N_LI = 1 << 23
N_ORD = 1 << 17
BATCH_ROWS = 1 << 21

LINEITEM_SCHEMA = dt.Schema([
    dt.StructField("l_orderkey", dt.INT32, False),
    dt.StructField("l_extendedprice", dt.FLOAT32, False),
    dt.StructField("l_discount", dt.FLOAT32, False)])
ORDERS_SCHEMA = dt.Schema([
    dt.StructField("o_orderkey", dt.INT32, False),
    dt.StructField("o_month", dt.INT32, False)])

Tables = Dict[str, np.ndarray]


def gen_tables(n_li: int = N_LI, n_ord: int = N_ORD, seed: int = 1) \
        -> Tuple[Tables, Tables]:
    """``(lineitem, orders)`` columns: every order key in ``[0, n_ord)``
    appears once in orders, lineitem draws its keys uniformly, months are
    1..12."""
    rng = np.random.default_rng(seed)
    li = {
        "l_orderkey": rng.integers(0, n_ord, n_li).astype(np.int32),
        "l_extendedprice": rng.uniform(900, 105000, n_li)
        .astype(np.float32),
        "l_discount": (rng.integers(0, 11, n_li) / 100.0)
        .astype(np.float32),
    }
    orders = {
        "o_orderkey": np.arange(n_ord, dtype=np.int32),
        "o_month": rng.integers(1, 13, n_ord).astype(np.int32),
    }
    return li, orders


def device_source(cols: Tables, schema: dt.Schema,
                  batch_rows: int = BATCH_ROWS, device=None,
                  validity: Optional[Tables] = None):
    """Upload the columns as batches of ``batch_rows`` (capacity the next
    power of two) behind a ``DeviceBatchSourceExec``. ``validity`` marks
    nulls (``False`` = null) per column."""
    from .columnar.arrow_bridge import column_from_host
    from .columnar.batch import GpuBatch, bucket_rows
    from .exec.base import DeviceBatchSourceExec, resolve_device
    device = resolve_device(device)
    validity = validity or {}
    n = len(cols[schema[0].name])
    batches = []
    for off in range(0, n, batch_rows):
        m = min(batch_rows, n - off)
        cap = bucket_rows(m)
        cs = []
        for f in schema:
            valid = validity.get(f.name)
            cs.append(column_from_host(
                f.dtype, cols[f.name][off:off + m],
                None if valid is None else valid[off:off + m], cap,
                device))
        batches.append(GpuBatch(cs, schema, m))
    return DeviceBatchSourceExec(batches, schema)


def plan_over(li_src, ord_src, build_unique_hint: bool = True):
    """The join + group-by plan over two sources."""
    from .exec.aggregate import GpuHashAggregateExec
    from .exec.joins import GpuShuffledHashJoinExec
    from .expr import (Alias, Literal, Multiply, Subtract,
                       UnresolvedColumn as col)
    from .expr.aggregates import Sum
    join = GpuShuffledHashJoinExec(
        [col("l_orderkey")], [col("o_orderkey")], "inner", li_src, ord_src,
        build_unique_hint=build_unique_hint)
    rev = Multiply(col("l_extendedprice"),
                   Subtract(Literal(np.float32(1.0), dt.FLOAT32),
                            col("l_discount")))
    return GpuHashAggregateExec([col("o_month")],
                                [Alias(Sum(rev), "revenue")], join)


def build_plan(n_li: int = N_LI, n_ord: int = N_ORD,
               batch_rows: int = BATCH_ROWS, device=None, seed: int = 1):
    """``(plan, lineitem, orders)``: the tables generated from ``seed``
    and uploaded to ``device`` (the GPU unless the caller names the
    CPU), and the plan over them."""
    li, orders = gen_tables(n_li, n_ord, seed)
    plan = plan_over(
        device_source(li, LINEITEM_SCHEMA, batch_rows, device),
        device_source(orders, ORDERS_SCHEMA, batch_rows, device))
    return plan, li, orders


def host_oracle(li: Tables, orders: Tables) -> np.ndarray:
    """Revenue per month by numpy, indexed by month (0 unused): the
    float32 products summed in float64, as the engine's ``Sum`` does."""
    om = orders["o_month"][li["l_orderkey"]]
    rev = li["l_extendedprice"] * (np.float32(1.0) - li["l_discount"])
    return np.bincount(om, weights=rev.astype(np.float64), minlength=13)

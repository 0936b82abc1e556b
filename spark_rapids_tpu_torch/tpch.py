"""TPC-H q6 over generated lineitem Parquet files, and q6's revenue by
line number.

Counterpart of ``bench.py:47-140`` (``gen_lineitem``, ``ensure_parquet``,
``build_q6``), which the port carries itself: it imports nothing of the
JAX package or its bench. Data is generated from a seed, so nothing is
downloaded. ``host_q6`` is an independent oracle: pyarrow reads the
files, numpy applies q6's mask, and the float32 products are summed in
float64, as the engine's ``Sum`` does.

``build_q6_by_linenumber`` is ``SELECT l_linenumber,
sum(l_extendedprice * l_discount) FROM lineitem WHERE <q6's filter> GROUP
BY l_linenumber``: the shape of the reference's fused-scan test
(``tests/test_fusion.py:46``) with a real TPC-H key. ``gen_lineitem(...,
linenumber=True)`` adds ``l_linenumber`` by dbgen's rule (each order has
1..7 lines, uniformly, numbered from 1) from a generator of its own, so
the four q6 columns stay the same bytes; ``host_q6_by_linenumber`` is its
oracle.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import datatypes as dt

__all__ = ["SF1_ROWS", "LINEITEM_SCHEMA", "LINEITEM_GROUPED_SCHEMA",
           "gen_lineitem", "write_lineitem", "build_q6", "host_q6",
           "build_q6_by_linenumber", "host_q6_by_linenumber"]

SF1_ROWS = 6_001_215  # lineitem rows at scale factor 1

LINEITEM_SCHEMA = dt.Schema([
    dt.StructField("l_quantity", dt.FLOAT32, False),
    dt.StructField("l_extendedprice", dt.FLOAT32, False),
    dt.StructField("l_discount", dt.FLOAT32, False),
    dt.StructField("l_shipdate", dt.DATE, False),
])

LINEITEM_GROUPED_SCHEMA = dt.Schema(
    list(LINEITEM_SCHEMA.fields)
    + [dt.StructField("l_linenumber", dt.INT32, False)])

_DICT_COLUMNS = ["l_quantity", "l_discount", "l_shipdate", "l_linenumber"]
_MANIFEST = "manifest.json"


def _linenumbers(n: int, seed: int) -> np.ndarray:
    """dbgen's l_linenumber: orders of a uniform 1..7 lines, each
    numbered 1..k, cut at ``n`` rows."""
    rng = np.random.default_rng([seed, 1])
    sizes = np.zeros(0, np.int64)
    while sizes.sum() < n:
        sizes = np.concatenate([sizes, rng.integers(1, 8, n // 4 + 8)])
    starts = np.cumsum(sizes) - sizes
    line = np.arange(int(sizes.sum())) - np.repeat(starts, sizes) + 1
    return line[:n].astype(np.int32)


def gen_lineitem(n: int, seed: int = 0,
                 linenumber: bool = False) -> Dict[str, np.ndarray]:
    """TPC-H-shaped lineitem columns (``bench.py:47``): l_quantity an
    integer 1..50, l_extendedprice = quantity x a part's retail price
    (200k parts), l_discount one of 11 values, l_shipdate a day number
    inside the spec's date range; with ``linenumber``, l_linenumber from
    a generator of its own, so the other columns do not change."""
    rng = np.random.default_rng(seed)
    n_parts = 200_000
    retail = (90000 + (np.arange(n_parts) % 20001) * 5).astype(np.float32)
    part = rng.integers(0, n_parts, n)
    qty = rng.integers(1, 51, n).astype(np.float32)
    cols = {
        "l_quantity": qty,
        "l_extendedprice": (qty * retail[part] / 100.0).astype(np.float32),
        "l_discount": (rng.integers(0, 11, n) / 100.0).astype(np.float32),
        "l_shipdate": rng.integers(8000, 10600, n).astype(np.int32),
    }
    if linenumber:
        cols["l_linenumber"] = _linenumbers(n, seed)
    return cols


def _manifest(cols, n_files, row_group_size, validity, seed) -> Dict:
    """What the files hold: rows, seed, columns with their types and a
    CRC of their bytes, the dictionary columns, the nulls and the file
    shape."""
    def crc(a):
        return zlib.crc32(np.ascontiguousarray(a).view(np.uint8))

    return {"rows": len(next(iter(cols.values()))), "seed": seed,
            "columns": {k: [str(v.dtype), crc(v)] for k, v in cols.items()},
            "dictionary": [k for k in _DICT_COLUMNS if k in cols],
            "validity": {k: crc(v) for k, v in (validity or {}).items()},
            "files": n_files, "row_group_size": row_group_size,
            "compression": "snappy"}


def write_lineitem(cols: Dict[str, np.ndarray], directory: str,
                   n_files: int = 8, row_group_size: int = 1 << 20,
                   validity: Dict[str, np.ndarray] = None,
                   seed: Optional[int] = None) -> List[str]:
    """Write the columns as ``n_files`` snappy Parquet part files with
    dictionary encoding for quantity, discount, shipdate and line number
    (``bench.py:70``). ``validity`` marks nulls (``False`` = null) per
    column. Files are reused only when the manifest beside them
    (``manifest.json``: rows, seed, columns with a CRC of their bytes,
    encodings, file shape) matches; otherwise they are written anew."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    paths = [os.path.join(directory, f"part-{i:02d}.parquet")
             for i in range(n_files)]
    manifest = _manifest(cols, n_files, row_group_size, validity, seed)
    manifest_path = os.path.join(directory, _MANIFEST)
    if all(os.path.exists(p) for p in paths) \
            and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            if json.load(f) == manifest:
                return paths
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(manifest_path):
        os.remove(manifest_path)
    n = len(next(iter(cols.values())))
    per = (n + n_files - 1) // n_files
    validity = validity or {}
    for i, p in enumerate(paths):
        lo, hi = i * per, min(n, (i + 1) * per)
        arrays = {k: pa.array(v[lo:hi], mask=None if k not in validity
                              else ~validity[k][lo:hi])
                  for k, v in cols.items()}
        tmp = p + ".tmp"
        pq.write_table(pa.Table.from_pydict(arrays), tmp,
                       row_group_size=row_group_size, compression="snappy",
                       use_dictionary=manifest["dictionary"])
        os.replace(tmp, p)
    with open(manifest_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(manifest_path + ".tmp", manifest_path)
    return paths


def _q6_filter_project(src, keys=()):
    """q6's filter over ``src``, then ``rev = price * discount`` and the
    named key columns."""
    from .exec.basic import GpuFilterExec, GpuProjectExec
    from .expr import (Alias, And, GreaterThanOrEqual, LessThan,
                       LessThanOrEqual, Literal, Multiply,
                       UnresolvedColumn as col)

    def d(v):
        return Literal(np.float32(v), dt.FLOAT32)

    cond = And(
        And(GreaterThanOrEqual(col("l_shipdate"), Literal(8766, dt.DATE)),
            LessThan(col("l_shipdate"), Literal(9131, dt.DATE))),
        And(And(GreaterThanOrEqual(col("l_discount"), d(0.05)),
                LessThanOrEqual(col("l_discount"), d(0.07))),
            LessThan(col("l_quantity"), d(24.0))))
    filt = GpuFilterExec(cond, src)
    return GpuProjectExec(
        [Alias(Multiply(col("l_extendedprice"), col("l_discount")), "rev")]
        + [Alias(col(k), k) for k in keys], filt)


def build_q6(src):
    """q6's plan over ``src`` (``bench.py:119``):
    filter -> project(price * discount) -> sum."""
    from .exec.aggregate import GpuHashAggregateExec
    from .expr import Alias, UnresolvedColumn as col
    from .expr.aggregates import Sum
    return GpuHashAggregateExec([], [Alias(Sum(col("rev")), "revenue")],
                                _q6_filter_project(src))


def build_q6_by_linenumber(src):
    """q6's revenue by line number over ``src``: filter ->
    project(price * discount, l_linenumber) -> sum grouped by
    l_linenumber."""
    from .exec.aggregate import GpuHashAggregateExec
    from .expr import Alias, UnresolvedColumn as col
    from .expr.aggregates import Sum
    return GpuHashAggregateExec(
        [col("l_linenumber")], [Alias(Sum(col("rev")), "revenue")],
        _q6_filter_project(src, ["l_linenumber"]))


def _q6_rows(paths: Sequence[str]):
    """q6's mask (nulls dropped) and the table, read by pyarrow."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    t = pq.read_table(list(paths))
    c, ok = {}, np.ones(t.num_rows, np.bool_)
    for name in ("l_quantity", "l_extendedprice", "l_discount",
                 "l_shipdate"):
        col = t.column(name)
        ok &= pc.is_valid(col).to_numpy(zero_copy_only=False)
        c[name] = pc.fill_null(col.cast("float32" if name != "l_shipdate"
                                        else "int32"), 0).to_numpy()
    # a NaN fails q6's mask in Spark's order as in IEEE's: NaN <= 0.07
    # and NaN < 24 are false in both
    disc = c["l_discount"]
    mask = (ok & (c["l_shipdate"] >= 8766) & (c["l_shipdate"] < 9131)
            & (disc >= np.float32(0.05)) & (disc <= np.float32(0.07))
            & (c["l_quantity"] < np.float32(24.0)))
    rev = (c["l_extendedprice"] * disc).astype(np.float64)
    return mask, rev, t


def host_q6(paths: Sequence[str]) -> Tuple[float, int]:
    """(revenue, rows in it) by pyarrow + numpy: q6's mask with nulls
    dropped, float32 products summed in float64."""
    mask, rev, _ = _q6_rows(paths)
    return float(rev[mask].sum()), int(mask.sum())


def host_q6_by_linenumber(paths: Sequence[str]) \
        -> Dict[Optional[int], float]:
    """``{l_linenumber: revenue}`` by pyarrow + numpy over the files, a
    null line number under ``None``: float32 products summed in float64
    per line number."""
    mask, rev, t = _q6_rows(paths)
    col = t.column("l_linenumber")
    keys = col.fill_null(0).to_numpy()[mask].astype(np.int64)
    valid = col.is_valid().to_numpy(zero_copy_only=False)[mask]
    rev = rev[mask]
    out = {int(k): float(rev[valid & (keys == k)].sum())
           for k in np.unique(keys[valid])}
    if not valid.all():
        out[None] = float(rev[~valid].sum())
    return out

"""The DataFrame API's rest over the NDS tables: ROLLUP through Expand,
``sample``, ``pivot``, ``hash``/``xxhash64``, ``regexp_replace``/
``regexp_extract``, and write/read round trips through Parquet (Hive
partitions), ORC, CSV and Hive text, each with an oracle computed
independently in numpy, pyarrow or Python's ``re``.

A text is a builder ``build(session, E)``: ``E`` is a package's
namespace (its expression classes, ``E.dt``, ``E.Expand`` its Expand
exec and ``E.DataFrame``), so one text runs through the port and
through the reference in the tests. ``ROUNDTRIPS`` write with
``DataFrame.write`` under a directory (``roundtrip_builder``) and read
the files back.

    from spark_rapids_tpu_torch.tools import nds_dataframe as ndf
    df = ndf.BUILDERS["df_rollup"](session, ndf.port_namespace())
    ndf.check("df_rollup", df.collect(), ndf.oracle("df_rollup", tables))
"""
from __future__ import annotations

import os
import re
import types
import uuid
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..exec.misc import GpuSampleExec
from ..ops.hash import (XXSEED, _xx_bytes_np, murmur3_bytes_np,
                        murmur3_long_np, xxhash64_long_np)

__all__ = ["TEXTS", "ROUNDTRIPS", "BUILDERS", "namespace",
           "port_namespace", "roundtrip_source", "roundtrip_read",
           "roundtrip_builder", "oracle",
           "roundtrip_oracle", "check", "SAMPLE_FRACTION", "SAMPLE_SEED",
           "REGEX", "PROJECTION_DAYS"]

FLOAT_RTOL = 1e-9
SAMPLE_FRACTION = 0.1
SAMPLE_SEED = 7
#: the round trips' projection: the sales of the first days
PROJECTION_DAYS = 183
#: (function, pattern, replacement or group) of df_regex's three columns
REGEX = (("replace", "[aeiou]+", "*"), ("replace", "o", ""),
         ("extract", "([A-Z][a-z]+)", 1))
HASH_COLUMNS = ("ss_item_sk", "i_category", "ss_sales_price",
                "ss_sold_date_sk")
TEXTS = ("df_rollup", "df_sample", "df_pivot", "df_hash", "df_regex")
ROUNDTRIPS = ("parquet_hive", "orc", "csv", "hivetext")


def namespace(expr_module, aggregates_module, dt_module, expand_cls,
              dataframe_cls):
    """``E``: a package's expression classes, its aggregates, its
    ``datatypes`` module (``E.dt``), its Expand exec (``E.Expand``) and
    its DataFrame (``E.DataFrame``)."""
    names = {k: getattr(expr_module, k) for k in dir(expr_module)
             if not k.startswith("_")}
    names.update({k: getattr(aggregates_module, k)
                  for k in ("Sum", "Count")})
    names.update(dt=dt_module, Expand=expand_cls, DataFrame=dataframe_cls)
    return types.SimpleNamespace(**names)


def port_namespace():
    from .. import datatypes, expr
    from ..exec.misc import GpuExpandExec
    from ..expr import aggregates
    from ..session import DataFrame
    return namespace(expr, aggregates, datatypes, GpuExpandExec, DataFrame)


def _joined(s, E):
    return s.table("store_sales").join(s.table("item"),
                                       on=[("ss_item_sk", "i_item_sk")])


# --- the texts ------------------------------------------------------------------

def _df_rollup(s, E):
    """GROUP BY ROLLUP(ss_store_sk, ss_quantity): three grouping sets
    through Expand, a gid literal naming each."""
    c, lit = E.UnresolvedColumn, E.Literal
    sales = s.table("store_sales")
    store, qty, price = c("ss_store_sk"), c("ss_quantity"), \
        c("ss_ext_sales_price")
    null_store = lit(None, E.dt.INT64)
    null_qty = lit(None, E.dt.INT32)
    projections = [[store, qty, price, lit(0, E.dt.INT32)],
                   [store, null_qty, price, lit(1, E.dt.INT32)],
                   [null_store, null_qty, price, lit(3, E.dt.INT32)]]
    expand = E.DataFrame(E.Expand(
        projections, ["ss_store_sk", "ss_quantity", "ss_ext_sales_price",
                      "gid"], sales._node), s)
    return expand.group_by(c("ss_store_sk"), c("ss_quantity"),
                           c("gid")).agg(
        E.Alias(E.Sum(c("ss_ext_sales_price")), "revenue"),
        E.Alias(E.Count(), "n"))


def _df_sample(s, E):
    c = E.UnresolvedColumn
    return s.table("store_sales").sample(SAMPLE_FRACTION, SAMPLE_SEED) \
        .group_by(c("ss_store_sk")).agg(
            E.Alias(E.Sum(c("ss_ext_sales_price")), "revenue"),
            E.Alias(E.Count(), "n"))


def _df_pivot(s, E):
    c = E.UnresolvedColumn
    return _joined(s, E).group_by(c("ss_store_sk")).pivot(
        c("i_category")).agg(
            E.Alias(E.Sum(c("ss_ext_sales_price")), "revenue"),
            E.Alias(E.Count(), "n"))


def _df_hash(s, E):
    c = E.UnresolvedColumn
    cols = [c(n) for n in HASH_COLUMNS]
    return _joined(s, E).select(
        c("ss_item_sk"), c("ss_sold_date_sk"),
        E.Alias(E.Murmur3Hash(*cols), "murmur3"),
        E.Alias(E.XxHash64(*cols), "xxhash64"))


def _df_regex(s, E):
    c = E.UnresolvedColumn
    cols = []
    for i, (fn, pattern, arg) in enumerate(REGEX):
        e = E.RegExpReplace(c("i_category"), pattern, arg) \
            if fn == "replace" else \
            E.RegExpExtract(c("i_category"), pattern, arg)
        cols.append(E.Alias(e, f"r{i}"))
    return _joined(s, E).select(*cols, c("ss_ext_sales_price")).group_by(
        *(c(f"r{i}") for i in range(len(REGEX)))).agg(
            E.Alias(E.Sum(c("ss_ext_sales_price")), "revenue"),
            E.Alias(E.Count(), "n"))


BUILDERS = {"df_rollup": _df_rollup, "df_sample": _df_sample,
            "df_pivot": _df_pivot, "df_hash": _df_hash,
            "df_regex": _df_regex}


def _projection(s, E):
    """The round trips' source: the first ``PROJECTION_DAYS`` days'
    sales with their item's category."""
    c = E.UnresolvedColumn
    return _joined(s, E).filter(E.LessThan(
        c("ss_sold_date_sk"), E.Literal(PROJECTION_DAYS, E.dt.INT64))
    ).select(c("ss_item_sk"), c("ss_quantity"), c("ss_sales_price"),
             c("i_category"))


def roundtrip_source(kind: str, s, E):
    """``(DataFrame, format, partition_by)`` a round trip writes:
    ``parquet_hive`` all of store_sales partitioned by ``ss_store_sk``,
    the others ``_projection`` as ORC, CSV or Hive text."""
    if kind == "parquet_hive":
        return s.table("store_sales"), "parquet", ["ss_store_sk"]
    return _projection(s, E), kind, None


def roundtrip_read(kind: str, s, files, schema):
    """The written ``files`` read back (Hive text under the written
    ``schema``: the format has no header)."""
    if kind == "hivetext":
        return s._read(files, "hivetext", schema)
    return {"parquet_hive": s.read_parquet, "orc": s.read_orc,
            "csv": s.read_csv}[kind](files)


def roundtrip_builder(kind: str, out_dir: str):
    """A builder that writes its source (``roundtrip_source``) under a
    fresh directory below ``out_dir`` with ``DataFrame.write`` and
    returns the files read back."""
    def build(s, E):
        df, fmt, partition_by = roundtrip_source(kind, s, E)
        where = os.path.join(out_dir, kind, uuid.uuid4().hex[:12])
        files = df.write(where, fmt, partition_by=partition_by)
        return roundtrip_read(kind, s, files, df.schema)
    return build


# --- the oracles ----------------------------------------------------------------

def _np(col) -> np.ndarray:
    return col.to_numpy(zero_copy_only=False)


def _joined_np(tables):
    ss, item = tables["store_sales"], tables["item"]
    items = _np(ss["ss_item_sk"])
    # i_item_sk is the item's row number
    assert (_np(item["i_item_sk"]) == np.arange(item.num_rows)).all()
    return ss, item, items


def _group(keys, arrays):
    """Per distinct key row: the sum of each of ``arrays`` and the count;
    ``keys`` a list of int64 arrays (-1 for null never occurs here)."""
    levels, codes = zip(*(np.unique(k, return_inverse=True) for k in keys))
    flat = np.ravel_multi_index([c.reshape(-1) for c in codes],
                                [len(v) for v in levels])
    cells, inv = np.unique(flat, return_inverse=True)
    inv = inv.reshape(-1)
    uniq = np.stack([v[i] for v, i in zip(
        levels, np.unravel_index(cells, [len(v) for v in levels]))], axis=1)
    sums = [np.bincount(inv, weights=a, minlength=len(uniq))
            for a in arrays]
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    return uniq, sums, counts


def _rollup_oracle(tables):
    ss = tables["store_sales"]
    store = _np(ss["ss_store_sk"]).astype(np.int64)
    qty = _np(ss["ss_quantity"]).astype(np.int64)
    price = _np(ss["ss_ext_sales_price"])
    parts = []
    for gid, keys in ((0, (store, qty)), (1, (store,)), (3, ())):
        if keys:
            uniq, (sums,), counts = _group(list(keys), [price])
        else:
            uniq = np.zeros((1, 0), np.int64)
            sums, counts = np.array([price.sum()]), \
                np.array([len(price)], np.int64)
        m = len(counts)
        parts.append(pa.table({
            "ss_store_sk": pa.array(uniq[:, 0] if keys else
                                    [None] * m, pa.int64()),
            "ss_quantity": pa.array(uniq[:, 1].astype(np.int32)
                                    if len(keys) > 1 else [None] * m,
                                    pa.int32()),
            "gid": pa.array(np.full(m, gid, np.int32)),
            "revenue": pa.array(sums, pa.float64()),
            "n": pa.array(counts, pa.int64())}))
    return pa.concat_tables(parts)


def _sample_oracle(tables):
    ss = tables["store_sales"]
    keep = GpuSampleExec(SAMPLE_FRACTION, SAMPLE_SEED,
                         None)._keep_mask_np(0, ss.num_rows)
    uniq, (sums,), counts = _group(
        [_np(ss["ss_store_sk"])[keep].astype(np.int64)],
        [_np(ss["ss_ext_sales_price"])[keep]])
    return pa.table({"ss_store_sk": pa.array(uniq[:, 0], pa.int64()),
                     "revenue": pa.array(sums, pa.float64()),
                     "n": pa.array(counts, pa.int64())})


def _pivot_oracle(tables):
    ss, item, items = _joined_np(tables)
    cats = np.array(item["i_category"].to_pylist(), dtype=object)
    values = sorted(set(cats.tolist()))
    cat_code = np.array([values.index(v) for v in cats])[items]
    store = _np(ss["ss_store_sk"]).astype(np.int64)
    price = _np(ss["ss_ext_sales_price"])
    stores = np.unique(store)
    sidx = np.searchsorted(stores, store)
    cols = {"ss_store_sk": pa.array(stores, pa.int64())}
    for k, v in enumerate(values):
        m = cat_code == k
        sums = np.bincount(sidx[m], weights=price[m], minlength=len(stores))
        counts = np.bincount(sidx[m], minlength=len(stores))
        cols[f"{v}_revenue"] = pa.array(
            [s if n else None for s, n in zip(sums, counts)], pa.float64())
        cols[f"{v}_n"] = pa.array(counts.astype(np.int64), pa.int64())
    return pa.table(cols)


def _hash_oracle(tables):
    ss, item, items = _joined_np(tables)
    cats = [v.encode() for v in item["i_category"].to_pylist()]
    date = _np(ss["ss_sold_date_sk"]).astype(np.int64)
    price = _np(ss["ss_sales_price"]).astype(np.float64)
    price = np.where(price == 0, 0.0, price)  # -0.0 as 0.0; no NaN here
    # murmur3: item, then the category's bytes (each distinct (seed,
    # item) pair once: the item fixes the category), price, date
    uniq, first, inv = np.unique(items, return_index=True,
                                 return_inverse=True)
    inv = inv.reshape(-1)
    h = murmur3_long_np(items, 42)
    h = np.array([murmur3_bytes_np(cats[it], int(sd))
                  for it, sd in zip(uniq, h[first])], np.uint32)[inv]
    h = murmur3_long_np(price.view(np.int64), h)
    h = murmur3_long_np(date, h)
    x = xxhash64_long_np(items, XXSEED)
    x = np.array([_xx_bytes_np(cats[it], int(sd))
                  for it, sd in zip(uniq, x[first])], np.uint64)[inv]
    x = xxhash64_long_np(price.view(np.int64), x)
    x = xxhash64_long_np(date, x)
    return pa.table({"ss_item_sk": pa.array(items, pa.int64()),
                     "ss_sold_date_sk": pa.array(date, pa.int64()),
                     "murmur3": pa.array(h.view(np.int32)),
                     "xxhash64": pa.array(x.view(np.int64))})


def _regex_host(fn, pattern, arg, v):
    rx = re.compile(pattern, re.ASCII)
    if fn == "replace":
        return rx.sub(arg, v)
    m = rx.search(v)
    return "" if m is None else (m.group(arg) or "")


def _regex_oracle(tables):
    ss, item, items = _joined_np(tables)
    cats = item["i_category"].to_pylist()
    values = sorted(set(cats))
    code = np.array([values.index(v) for v in cats])[items]
    price = _np(ss["ss_ext_sales_price"])
    sums = np.bincount(code, weights=price, minlength=len(values))
    counts = np.bincount(code, minlength=len(values)).astype(np.int64)
    cols = {f"r{i}": pa.array([_regex_host(fn, p, a, v) for v in values],
                              pa.string())
            for i, (fn, p, a) in enumerate(REGEX)}
    cols.update(revenue=pa.array(sums, pa.float64()),
                n=pa.array(counts, pa.int64()))
    t = pa.table(cols)
    return t.filter(pc.greater(t["n"], 0))


_ORACLES = {"df_rollup": _rollup_oracle, "df_sample": _sample_oracle,
            "df_pivot": _pivot_oracle, "df_hash": _hash_oracle,
            "df_regex": _regex_oracle}
#: each text's key columns (its rows sorted by them before the compare)
KEYS = {"df_rollup": ("gid", "ss_store_sk", "ss_quantity"),
        "df_sample": ("ss_store_sk",), "df_pivot": ("ss_store_sk",),
        "df_hash": ("ss_item_sk", "ss_sold_date_sk", "murmur3",
                    "xxhash64"),
        "df_regex": ("r0", "r1", "r2")}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    return _ORACLES[name](tables)


def roundtrip_oracle(kind: str, tables: Dict[str, pa.Table],
                     tmp_dir: str) -> pa.Table:
    """What the read-back holds, from pyarrow over the source:
    store_sales with ``ss_store_sk`` last (int64, inferred from the
    directories), or the projection as pyarrow writes and reads it
    (CSV's types are pyarrow's inference)."""
    ss = tables["store_sales"]
    if kind == "parquet_hive":
        names = [n for n in ss.column_names if n != "ss_store_sk"]
        return ss.select(names + ["ss_store_sk"])
    ss, item, items = _joined_np(tables)
    keep = _np(ss["ss_sold_date_sk"]) < PROJECTION_DAYS
    cats = np.array(item["i_category"].to_pylist(), dtype=object)
    src = pa.table({
        "ss_item_sk": ss["ss_item_sk"].filter(pa.array(keep)),
        "ss_quantity": ss["ss_quantity"].filter(pa.array(keep)),
        "ss_sales_price": ss["ss_sales_price"].filter(pa.array(keep)),
        "i_category": pa.array(cats[items[keep]].tolist(), pa.string())})
    if kind == "csv":
        from pyarrow import csv
        path = os.path.join(tmp_dir, f"oracle-{uuid.uuid4().hex[:8]}.csv")
        csv.write_csv(src, path)
        return csv.read_csv(path)
    return src


def _sorted(t: pa.Table, keys) -> pa.Table:
    return t.sort_by([(k, "ascending") for k in keys])


def check(name: str, got: pa.Table, want: pa.Table, keys=None,
          rtol: float = FLOAT_RTOL) -> float:
    """``got`` against ``want``: names and types equal, the rows sorted
    by ``keys`` (``KEYS[name]``, else every column), every non-float
    column exact, floats within ``rtol``. Returns the largest relative
    float error."""
    assert got.column_names == want.column_names, \
        (name, got.column_names, want.column_names)
    assert got.schema.types == want.schema.types, \
        (name, got.schema.types, want.schema.types)
    assert got.num_rows == want.num_rows, (name, got.num_rows,
                                           want.num_rows)
    keys = list(keys or KEYS.get(name) or got.column_names)
    g, w = _sorted(got, keys), _sorted(want, keys)
    worst = 0.0
    for col in got.column_names:
        a, b = g[col].combine_chunks(), w[col].combine_chunks()
        if pa.types.is_floating(a.type):
            assert a.null_count == b.null_count \
                and pc.all(pc.equal(pc.is_null(a), pc.is_null(b))).as_py(), \
                (name, col)
            x, y = _np(a.fill_null(0.0)), _np(b.fill_null(0.0))
            rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
            rel = np.where(x == y, 0.0, rel)
            worst = max(worst, float(rel.max()) if len(rel) else 0.0)
            assert worst <= rtol, (name, col, worst)
        else:
            assert a.equals(b), (name, col)
    return worst

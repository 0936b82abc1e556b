"""NDS star-schema data, SQL texts and an oracle: the SQL slice's data.

The port's copy of ``spark_rapids_tpu/tools/nds.py``'s ``gen_tables``
(``:27``), ``register_frames`` (``:91``), ``build_query_sql`` and
``SQL_QUERIES`` (``:867``, every text, as data), plus ``write_tables``,
the writer ``bench_nds_from_files`` uses (``bench.py:266-278``: snappy,
row groups of 2^19), and an oracle in numpy and pyarrow for the 22
queries, all of which the port runs from SQL (``PORTED_QUERIES``; the
reference's oracle, ``tools/nds.py``'s ``*_pd`` functions, uses pandas,
which the card's machine does not have).

    from spark_rapids_tpu_torch import nds
    paths = nds.write_tables(nds.gen_tables(1 << 14), "nds_files")
    s = nds.session_over_files(paths, {"spark.sql.shuffle.partitions": 1},
                               device="cpu")
    s.sql(nds.SQL_QUERIES["q3"]).collect()
"""
from __future__ import annotations

import json
import math
import os
import re
import zlib
from typing import Dict, List

import numpy as np
import pyarrow as pa

__all__ = ["gen_tables", "write_tables", "register_frames",
           "session_over_files", "build_query_sql", "SQL_QUERIES",
           "PORTED_QUERIES", "UNPORTED_QUERIES", "oracle",
           "FLOAT_COLUMNS"]

ROW_GROUP_SIZE = 1 << 19
_MANIFEST = "manifest.json"


def gen_tables(n_sales: int = 1 << 15, seed: int = 42):
    """Star schema as pyarrow tables (deterministic)."""
    rng = np.random.default_rng(seed)
    n_dates = 730  # two years
    n_items = max(200, n_sales // 128)
    n_cust = max(500, n_sales // 64)
    n_stores = 25

    date_dim = pa.table({
        "d_date_sk": pa.array(np.arange(n_dates, dtype=np.int64)),
        "d_year": pa.array((2000 + np.arange(n_dates) // 365)
                           .astype(np.int32)),
        "d_moy": pa.array(((np.arange(n_dates) % 365) // 31 + 1)
                          .clip(1, 12).astype(np.int32)),
        "d_qoy": pa.array((((np.arange(n_dates) % 365) // 92) + 1)
                          .clip(1, 4).astype(np.int32)),
    })
    item = pa.table({
        "i_item_sk": pa.array(np.arange(n_items, dtype=np.int64)),
        "i_brand_id": pa.array(rng.integers(1, 60, n_items)
                               .astype(np.int32)),
        "i_category_id": pa.array(rng.integers(1, 11, n_items)
                                  .astype(np.int32)),
        "i_manufact_id": pa.array(rng.integers(1, 100, n_items)
                                  .astype(np.int32)),
        "i_category": pa.array(rng.choice(
            ["Electronics", "Home", "Sports", "Books", "Music",
             "Jewelry"], n_items).tolist()),
        "i_current_price": pa.array(rng.uniform(0.5, 300, n_items)
                                    .astype(np.float64)),
    })
    store = pa.table({
        "s_store_sk": pa.array(np.arange(n_stores, dtype=np.int64)),
        "s_state": pa.array(rng.choice(["CA", "TX", "NY", "WA", "TN"],
                                       n_stores).tolist()),
    })
    customer = pa.table({
        "c_customer_sk": pa.array(np.arange(n_cust, dtype=np.int64)),
        "c_birth_year": pa.array(rng.integers(1930, 2005, n_cust)
                                 .astype(np.int32)),
    })
    qty = rng.integers(1, 100, n_sales).astype(np.int32)
    price = rng.uniform(1, 200, n_sales).astype(np.float64)
    store_sales = pa.table({
        "ss_sold_date_sk": pa.array(rng.integers(0, n_dates, n_sales)
                                    .astype(np.int64)),
        "ss_item_sk": pa.array(rng.integers(0, n_items, n_sales)
                               .astype(np.int64)),
        "ss_customer_sk": pa.array(rng.integers(0, n_cust, n_sales)
                                   .astype(np.int64)),
        "ss_store_sk": pa.array(rng.integers(0, n_stores, n_sales)
                                .astype(np.int64)),
        "ss_quantity": pa.array(qty),
        "ss_sales_price": pa.array(price),
        "ss_ext_sales_price": pa.array((qty * price).astype(np.float64)),
        "ss_net_profit": pa.array(rng.normal(5, 40, n_sales)
                                  .astype(np.float64)),
    })
    return {"store_sales": store_sales, "date_dim": date_dim,
            "item": item, "store": store, "customer": customer}


def _crc(table: pa.Table) -> int:
    crc = 0
    for col in table.columns:
        for chunk in col.chunks:
            for buf in chunk.buffers():
                if buf is not None:
                    crc = zlib.crc32(buf, crc)
    return crc


def write_tables(tables: Dict[str, pa.Table], directory: str,
                 row_group_size: int = ROW_GROUP_SIZE) -> Dict[str, str]:
    """One snappy Parquet file a table (``<name>.parquet``, row groups of
    ``row_group_size``), as ``bench_nds_from_files`` writes them; a
    decimal column of at most 18 digits is stored as INT32 or INT64, as
    Spark writes one. Files are reused only when the manifest beside
    them (rows and a CRC of every table's buffers, the row-group size)
    matches."""
    import pyarrow.parquet as pq
    manifest = {"row_group_size": row_group_size,
                "tables": {k: [t.num_rows, _crc(t)]
                           for k, t in sorted(tables.items())}}
    paths = {k: os.path.join(directory, f"{k}.parquet") for k in tables}
    manifest_path = os.path.join(directory, _MANIFEST)
    if all(os.path.exists(p) for p in paths.values()) \
            and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            if json.load(f) == manifest:
                return paths
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(manifest_path):
        os.remove(manifest_path)
    for k, p in paths.items():
        pq.write_table(tables[k], p + ".tmp", row_group_size=row_group_size,
                       compression="snappy",
                       store_decimal_as_integer=True)
        os.replace(p + ".tmp", p)
    with open(manifest_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(manifest_path + ".tmp", manifest_path)
    return paths


def register_frames(session, frames) -> None:
    """Expose the tables as SQL temp views (the session's catalog)."""
    for k, df in frames.items():
        session.register_table(k, df)


def session_over_files(paths: Dict[str, str], settings=None, device=None):
    """A ``GpuSession`` with every table's Parquet file registered as a
    view, as ``bench_nds_from_files`` sets it up (``bench.py:279-283``)."""
    from .session import GpuSession
    s = GpuSession(dict(settings or {}), device=device)
    register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    return s


def build_query_sql(name: str, session, tables=None):
    """``SQL_QUERIES[name]`` compiled through ``session.sql``; with
    ``tables``, the tables are registered first as in-memory frames."""
    if tables is not None:
        register_frames(session, {k: session.create_dataframe(t)
                                  for k, t in tables.items()})
    return session.sql(SQL_QUERIES[name])


# --- SQL corpus --------------------------------------------------------------
# the reference's texts, unchanged

SQL_QUERIES = {
    "q3": """
SELECT /*+ UNIQUE(dt, item) */ dt.d_year, item.i_brand_id,
       SUM(ss_ext_sales_price) AS sum_agg
FROM date_dim dt, store_sales, item
WHERE dt.d_date_sk = ss_sold_date_sk
  AND ss_item_sk = item.i_item_sk
  AND dt.d_moy = 11
GROUP BY dt.d_year, item.i_brand_id
ORDER BY dt.d_year, sum_agg DESC, i_brand_id
LIMIT 10
""",
    "q42": """
SELECT /*+ UNIQUE(dt, item) */ i_category_id,
       SUM(ss_ext_sales_price) AS s
FROM date_dim dt, store_sales, item
WHERE dt.d_date_sk = ss_sold_date_sk
  AND ss_item_sk = i_item_sk
  AND dt.d_moy = 12 AND dt.d_year = 2000
GROUP BY i_category_id
ORDER BY s DESC, i_category_id
""",
    "q55": """
SELECT /*+ UNIQUE(item) */ i_brand_id,
       SUM(ss_ext_sales_price) AS rev
FROM store_sales, item
WHERE ss_item_sk = i_item_sk
  AND i_manufact_id >= 20 AND i_manufact_id < 40
GROUP BY i_brand_id
ORDER BY rev DESC, i_brand_id
LIMIT 20
""",
    "q7": """
SELECT /*+ UNIQUE(dt, item) */ i_category_id,
       AVG(ss_quantity) AS avg_q, AVG(ss_sales_price) AS avg_p
FROM store_sales, date_dim dt, item
WHERE ss_sold_date_sk = dt.d_date_sk
  AND ss_item_sk = i_item_sk
  AND dt.d_year = 2001
GROUP BY i_category_id
ORDER BY i_category_id
""",
    "q96": """
SELECT /*+ UNIQUE(store, date_dim) */ COUNT(*) AS cnt
FROM store_sales, store, date_dim
WHERE ss_quantity BETWEEN 40 AND 60
  AND ss_store_sk = s_store_sk
  AND ss_sold_date_sk = d_date_sk
  AND d_qoy = 2
""",
    "q97": """
SELECT COUNT(*) AS n_pairs
FROM (SELECT /*+ UNIQUE(date_dim) */ ss_customer_sk
      FROM store_sales, date_dim
      WHERE ss_sold_date_sk = d_date_sk AND d_moy <= 6) h1
LEFT SEMI JOIN
     (SELECT /*+ UNIQUE(date_dim) */ ss_customer_sk AS c2
      FROM store_sales, date_dim
      WHERE ss_sold_date_sk = d_date_sk AND d_moy > 6) h2
ON h1.ss_customer_sk = h2.c2
""",
    "q_like": """
SELECT /*+ UNIQUE(item, store) */ s_state,
       SUM(ss_net_profit) AS profit
FROM store_sales, item, store
WHERE ss_item_sk = i_item_sk
  AND ss_store_sk = s_store_sk
  AND i_category LIKE '%o%s%'
GROUP BY s_state
ORDER BY s_state
""",
    "q_percentile": """
SELECT /*+ UNIQUE(store) */ s_state,
       APPROX_PERCENTILE(ss_sales_price, 0.5) AS p50
FROM store_sales, store
WHERE ss_store_sk = s_store_sk
GROUP BY s_state
ORDER BY s_state
""",
    "q_pivot": """
SELECT /*+ UNIQUE(date_dim) */ d_year,
       SUM(CASE WHEN d_qoy = 1 THEN ss_ext_sales_price END) AS "1",
       SUM(CASE WHEN d_qoy = 2 THEN ss_ext_sales_price END) AS "2",
       SUM(CASE WHEN d_qoy = 3 THEN ss_ext_sales_price END) AS "3",
       SUM(CASE WHEN d_qoy = 4 THEN ss_ext_sales_price END) AS "4"
FROM store_sales, date_dim
WHERE ss_sold_date_sk = d_date_sk
GROUP BY d_year
ORDER BY d_year
""",
    "q_customer_age": """
SELECT /*+ UNIQUE(cust) */ decade, SUM(ss_net_profit) AS profit,
       COUNT(*) AS n
FROM store_sales,
     (SELECT c_customer_sk,
             CAST(c_birth_year AS BIGINT) DIV 10 * 10 AS decade
      FROM customer) cust
WHERE ss_customer_sk = c_customer_sk
GROUP BY decade
ORDER BY decade
""",
    "q_topn": """
SELECT /*+ UNIQUE(date_dim) */ ss_item_sk,
       SUM(ss_net_profit) AS profit
FROM store_sales, date_dim
WHERE ss_sold_date_sk = d_date_sk AND d_qoy = 4
GROUP BY ss_item_sk
ORDER BY profit DESC, ss_item_sk
LIMIT 25
""",
    "q_price_band": """
SELECT /*+ UNIQUE(item) */
       CASE WHEN i_current_price < 10.0 THEN 'low'
            WHEN i_current_price < 100.0 THEN 'mid'
            ELSE 'high' END AS band,
       SUM(ss_ext_sales_price) AS rev
FROM store_sales, item
WHERE ss_item_sk = i_item_sk
GROUP BY band
ORDER BY band
""",
    "q_rank": """
SELECT i_category, i_brand_id, rev, rk
FROM (SELECT i_category, i_brand_id, rev,
             RANK() OVER (PARTITION BY i_category
                          ORDER BY rev DESC, i_brand_id) AS rk
      FROM (SELECT /*+ UNIQUE(item) */ i_category, i_brand_id,
                   SUM(ss_ext_sales_price) AS rev
            FROM store_sales, item
            WHERE ss_item_sk = i_item_sk
            GROUP BY i_category, i_brand_id) brand_rev) ranked
WHERE rk <= 3
ORDER BY i_category, rk, i_brand_id
""",
    "q_rolling": """
SELECT ss_store_sk, ss_sold_date_sk, rev,
       AVG(rev) OVER (PARTITION BY ss_store_sk ORDER BY d32
                      RANGE BETWEEN 6 PRECEDING AND CURRENT ROW)
       AS avg7
FROM (SELECT ss_store_sk, ss_sold_date_sk,
             SUM(ss_ext_sales_price) AS rev,
             CAST(ss_sold_date_sk AS INT) AS d32
      FROM store_sales
      GROUP BY ss_store_sk, ss_sold_date_sk) daily
ORDER BY ss_store_sk, ss_sold_date_sk
""",
    "q52": """
SELECT /*+ UNIQUE(dt, item) */ dt.d_year, item.i_brand_id,
       SUM(ss_ext_sales_price) AS ext_price
FROM date_dim dt, store_sales, item
WHERE dt.d_date_sk = ss_sold_date_sk
  AND ss_item_sk = item.i_item_sk
  AND dt.d_moy = 12 AND dt.d_year = 2001
GROUP BY dt.d_year, item.i_brand_id
ORDER BY dt.d_year, ext_price DESC, i_brand_id
LIMIT 10
""",
    "q_cte": """
WITH year_rev AS (
  SELECT /*+ UNIQUE(date_dim) */ d_year,
         SUM(ss_ext_sales_price) AS rev
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk
  GROUP BY d_year)
SELECT a.d_year, a.rev, b.rev AS prev_rev
FROM year_rev a JOIN year_rev b ON a.d_year = b.d_year + 1
ORDER BY a.d_year
""",
    "q_union": """
SELECT /*+ UNIQUE(date_dim, store) */ 1 AS qtr, s_state,
       SUM(ss_net_profit) AS profit
FROM store_sales, date_dim, store
WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
  AND d_qoy = 1
GROUP BY s_state
UNION ALL
SELECT /*+ UNIQUE(date_dim, store) */ 2 AS qtr, s_state,
       SUM(ss_net_profit) AS profit
FROM store_sales, date_dim, store
WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
  AND d_qoy = 2
GROUP BY s_state
ORDER BY qtr, s_state
""",
    "q_having": """
SELECT /*+ UNIQUE(item) */ i_brand_id, COUNT(*) AS n,
       SUM(ss_ext_sales_price) AS rev
FROM store_sales, item
WHERE ss_item_sk = i_item_sk
GROUP BY i_brand_id
HAVING COUNT(*) > 250
ORDER BY i_brand_id
""",
    "q_in_between": """
SELECT /*+ UNIQUE(date_dim, item) */ i_category,
       SUM(ss_ext_sales_price) AS rev
FROM store_sales, date_dim, item
WHERE ss_sold_date_sk = d_date_sk
  AND ss_item_sk = i_item_sk
  AND ss_quantity BETWEEN 20 AND 40
  AND i_category IN ('Books', 'Music', 'Sports')
  AND d_year = 2000
GROUP BY i_category
ORDER BY i_category
""",
    "q_agg_expr": """
SELECT /*+ UNIQUE(store) */ s_state,
       SUM(CASE WHEN ss_quantity >= 50 THEN ss_ext_sales_price
                ELSE 0.0 END) / SUM(ss_ext_sales_price)
       AS bulk_share
FROM store_sales, store
WHERE ss_store_sk = s_store_sk
GROUP BY s_state
ORDER BY s_state
""",
    "q_rownum": """
SELECT i_category, i_item_sk, rev
FROM (SELECT i_category, i_item_sk, rev,
             ROW_NUMBER() OVER (PARTITION BY i_category
                                ORDER BY rev DESC, i_item_sk) AS rn
      FROM (SELECT /*+ UNIQUE(item) */ i_category, i_item_sk,
                   SUM(ss_ext_sales_price) AS rev
            FROM store_sales, item
            WHERE ss_item_sk = i_item_sk
            GROUP BY i_category, i_item_sk) t) ranked
WHERE rn = 1
ORDER BY i_category
""",
    "q_not_or": """
SELECT /*+ UNIQUE(date_dim) */ d_year, COUNT(*) AS n
FROM store_sales, date_dim
WHERE ss_sold_date_sk = d_date_sk
  AND NOT (d_moy = 1 OR d_moy = 12) AND ss_net_profit > 0.0
GROUP BY d_year
ORDER BY d_year
""",
}


# --- oracle ------------------------------------------------------------------

# the queries the port runs from SQL (all of them), and the ROADMAP item
# each of the others waits for (none)
PORTED_QUERIES = ("q3", "q42", "q52", "q55", "q96", "q_topn", "q7",
                  "q_pivot", "q_customer_age", "q_price_band", "q_cte",
                  "q_having", "q_in_between", "q_agg_expr", "q_not_or",
                  "q_rank", "q_rownum", "q_rolling", "q_union",
                  "q_percentile", "q97", "q_like")
UNPORTED_QUERIES: Dict[str, int] = {}

# the output columns holding float sums and averages (compared at a
# relative tolerance; every other column exactly: q_percentile's p50 is
# one of the data's own values)
FLOAT_COLUMNS = {"q3": ("sum_agg",), "q42": ("s",), "q52": ("ext_price",),
                 "q55": ("rev",), "q96": (), "q_topn": ("profit",),
                 "q7": ("avg_q", "avg_p"), "q_pivot": ("1", "2", "3", "4"),
                 "q_customer_age": ("profit",), "q_price_band": ("rev",),
                 "q_cte": ("rev", "prev_rev"), "q_having": ("rev",),
                 "q_in_between": ("rev",), "q_agg_expr": ("bulk_share",),
                 "q_not_or": (), "q_rank": ("rev",), "q_rownum": ("rev",),
                 "q_rolling": ("rev", "avg7"), "q_union": ("profit",),
                 "q_percentile": (), "q97": (), "q_like": ("profit",)}


def _np(table: pa.Table, name: str) -> np.ndarray:
    return table.column(name).to_numpy()


def _lookup(keys: np.ndarray, build_keys: np.ndarray,
            keep: np.ndarray) -> np.ndarray:
    """Row of the (unique-keyed) build side each key joins, -1 where
    none does or the build row is filtered out."""
    order = np.argsort(build_keys, kind="stable")
    sk = build_keys[order]
    pos = np.clip(np.searchsorted(sk, keys), 0, max(len(sk) - 1, 0))
    if not len(sk):
        return np.full(len(keys), -1, np.int64)
    idx = order[pos]
    hit = (sk[pos] == keys) & keep[idx]
    return np.where(hit, idx, -1)


def _grouped_sum(keys: List[np.ndarray], vals: np.ndarray):
    """``(group key columns, float64 sums)`` of ``vals`` by the keys."""
    stacked = np.stack([k.astype(np.int64) for k in keys], axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=vals, minlength=len(uniq))
    return [uniq[:, i] for i in range(len(keys))], sums


def _star(tables, dd_keep, it_keep):
    """store_sales joined to the kept date_dim rows (when ``dd_keep`` is
    not None) and the kept item rows: ``(sales mask, date row, item
    row)``."""
    ss, it = tables["store_sales"], tables["item"]
    ok = np.ones(ss.num_rows, bool)
    drow = None
    if dd_keep is not None:
        dd = tables["date_dim"]
        drow = _lookup(_np(ss, "ss_sold_date_sk"), _np(dd, "d_date_sk"),
                       dd_keep(dd))
        ok &= drow >= 0
    irow = _lookup(_np(ss, "ss_item_sk"), _np(it, "i_item_sk"),
                   it_keep(it))
    ok &= irow >= 0
    return ok, drow, irow


def _year_brand(tables, dd_keep, out_name, limit):
    ok, drow, irow = _star(tables, dd_keep,
                           lambda it: np.ones(it.num_rows, bool))
    dd, it = tables["date_dim"], tables["item"]
    year = _np(dd, "d_year")[drow[ok]]
    brand = _np(it, "i_brand_id")[irow[ok]]
    vals = _np(tables["store_sales"], "ss_ext_sales_price")[ok]
    (y, b), s = _grouped_sum([year, brand], vals)
    order = np.lexsort((b, -s, y))[:limit]
    return pa.table({"d_year": pa.array(y[order].astype(np.int32)),
                     "i_brand_id": pa.array(b[order].astype(np.int32)),
                     out_name: pa.array(s[order])})


def _q3(tables):
    return _year_brand(tables, lambda dd: _np(dd, "d_moy") == 11,
                       "sum_agg", 10)


def _q52(tables):
    return _year_brand(tables,
                       lambda dd: (_np(dd, "d_moy") == 12)
                       & (_np(dd, "d_year") == 2001), "ext_price", 10)


def _q42(tables):
    ok, _, irow = _star(tables, lambda dd: (_np(dd, "d_moy") == 12)
                        & (_np(dd, "d_year") == 2000),
                        lambda it: np.ones(it.num_rows, bool))
    cat = _np(tables["item"], "i_category_id")[irow[ok]]
    vals = _np(tables["store_sales"], "ss_ext_sales_price")[ok]
    (c,), s = _grouped_sum([cat], vals)
    order = np.lexsort((c, -s))
    return pa.table({"i_category_id": pa.array(c[order].astype(np.int32)),
                     "s": pa.array(s[order])})


def _q55(tables):
    def keep(it):
        m = _np(it, "i_manufact_id")
        return (m >= 20) & (m < 40)
    ok, _, irow = _star(tables, None, keep)
    brand = _np(tables["item"], "i_brand_id")[irow[ok]]
    vals = _np(tables["store_sales"], "ss_ext_sales_price")[ok]
    (b,), s = _grouped_sum([brand], vals)
    order = np.lexsort((b, -s))[:20]
    return pa.table({"i_brand_id": pa.array(b[order].astype(np.int32)),
                     "rev": pa.array(s[order])})


def _groups(keys: List[np.ndarray]):
    """``(the distinct key tuples as columns, ascending, and each row's
    group)``: integer keys, or one string key (byte order)."""
    if len(keys) == 1 and keys[0].dtype == object:
        uniq, inv = np.unique(keys[0], return_inverse=True)
        return [uniq], inv.reshape(-1)
    stacked = np.stack([k.astype(np.int64) for k in keys], axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    return [uniq[:, i] for i in range(len(keys))], inv.reshape(-1)


def _sums(inv: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(inv, weights=vals, minlength=n)


def _counts(inv: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(inv, minlength=n).astype(np.int64)


def _dim(tables, table: str, key: str, keys: np.ndarray,
         keep=None) -> np.ndarray:
    """The row of ``table`` each key joins (-1: none, or filtered)."""
    t = tables[table]
    mask = np.ones(t.num_rows, bool) if keep is None else keep(t)
    return _lookup(keys, _np(t, key), mask)


def _ss(tables, name: str) -> np.ndarray:
    return _np(tables["store_sales"], name)


def _q7(tables):
    ok, _, irow = _star(tables, lambda dd: _np(dd, "d_year") == 2001,
                        lambda it: np.ones(it.num_rows, bool))
    cat = _np(tables["item"], "i_category_id")[irow[ok]]
    (c,), inv = _groups([cat])
    cnt = _counts(inv, len(c))
    q = _sums(inv, _ss(tables, "ss_quantity")[ok].astype(np.float64),
              len(c))
    p = _sums(inv, _ss(tables, "ss_sales_price")[ok], len(c))
    return pa.table({"i_category_id": pa.array(c.astype(np.int32)),
                     "avg_q": pa.array(q / cnt), "avg_p": pa.array(p / cnt)})


def _q96(tables):
    qty = _ss(tables, "ss_quantity")
    ok = (qty >= 40) & (qty <= 60)
    ok &= _dim(tables, "store", "s_store_sk", _ss(tables, "ss_store_sk")) \
        >= 0
    ok &= _dim(tables, "date_dim", "d_date_sk",
               _ss(tables, "ss_sold_date_sk"),
               lambda dd: _np(dd, "d_qoy") == 2) >= 0
    return pa.table({"cnt": pa.array([int(ok.sum())], pa.int64())})


def _q_topn(tables):
    drow = _dim(tables, "date_dim", "d_date_sk",
                _ss(tables, "ss_sold_date_sk"),
                lambda dd: _np(dd, "d_qoy") == 4)
    ok = drow >= 0
    (item,), inv = _groups([_ss(tables, "ss_item_sk")[ok]])
    profit = _sums(inv, _ss(tables, "ss_net_profit")[ok], len(item))
    order = np.lexsort((item, -profit))[:25]
    return pa.table({"ss_item_sk": pa.array(item[order].astype(np.int64)),
                     "profit": pa.array(profit[order])})


def _q_pivot(tables):
    drow = _dim(tables, "date_dim", "d_date_sk",
                _ss(tables, "ss_sold_date_sk"))
    ok = drow >= 0
    dd = tables["date_dim"]
    (year,), inv = _groups([_np(dd, "d_year")[drow[ok]]])
    qoy = _np(dd, "d_qoy")[drow[ok]]
    vals = _ss(tables, "ss_ext_sales_price")[ok]
    out = {"d_year": pa.array(year.astype(np.int32))}
    for q in range(1, 5):
        hit = qoy == q
        s = _sums(inv[hit], vals[hit], len(year))
        n = _counts(inv[hit], len(year))
        out[str(q)] = pa.array(s, mask=n == 0)
    return pa.table(out)


def _q_customer_age(tables):
    crow = _dim(tables, "customer", "c_customer_sk",
                _ss(tables, "ss_customer_sk"))
    ok = crow >= 0
    birth = _np(tables["customer"], "c_birth_year").astype(np.int64)
    (decade,), inv = _groups([(birth // 10 * 10)[crow[ok]]])
    return pa.table({
        "decade": pa.array(decade.astype(np.int64)),
        "profit": pa.array(_sums(inv, _ss(tables, "ss_net_profit")[ok],
                                 len(decade))),
        "n": pa.array(_counts(inv, len(decade)))})


def _q_price_band(tables):
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    ok = irow >= 0
    price = _np(tables["item"], "i_current_price")
    band = np.where(price < 10.0, "low",
                    np.where(price < 100.0, "mid", "high")).astype(object)
    (b,), inv = _groups([band[irow[ok]]])
    return pa.table({
        "band": pa.array(b.tolist(), pa.string()),
        "rev": pa.array(_sums(inv, _ss(tables, "ss_ext_sales_price")[ok],
                              len(b)))})


def _q_cte(tables):
    drow = _dim(tables, "date_dim", "d_date_sk",
                _ss(tables, "ss_sold_date_sk"))
    ok = drow >= 0
    (year,), inv = _groups([_np(tables["date_dim"], "d_year")[drow[ok]]])
    rev = _sums(inv, _ss(tables, "ss_ext_sales_price")[ok], len(year))
    prev = {int(y) + 1: r for y, r in zip(year, rev)}
    keep = [i for i, y in enumerate(year) if int(y) in prev]
    return pa.table({
        "d_year": pa.array(year[keep].astype(np.int32)),
        "rev": pa.array(rev[keep]),
        "prev_rev": pa.array([prev[int(year[i])] for i in keep],
                             pa.float64())})


def _q_having(tables):
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    ok = irow >= 0
    (brand,), inv = _groups([_np(tables["item"], "i_brand_id")[irow[ok]]])
    n = _counts(inv, len(brand))
    rev = _sums(inv, _ss(tables, "ss_ext_sales_price")[ok], len(brand))
    keep = n > 250
    return pa.table({"i_brand_id": pa.array(brand[keep].astype(np.int32)),
                     "n": pa.array(n[keep]), "rev": pa.array(rev[keep])})


def _q_in_between(tables):
    qty = _ss(tables, "ss_quantity")
    ok = (qty >= 20) & (qty <= 40)
    ok &= _dim(tables, "date_dim", "d_date_sk",
               _ss(tables, "ss_sold_date_sk"),
               lambda dd: _np(dd, "d_year") == 2000) >= 0
    cats = np.asarray(tables["item"].column("i_category").to_pylist(),
                      dtype=object)
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"),
                lambda it: np.isin(cats, ["Books", "Music", "Sports"]))
    ok &= irow >= 0
    (c,), inv = _groups([cats[irow[ok]]])
    return pa.table({
        "i_category": pa.array(c.tolist(), pa.string()),
        "rev": pa.array(_sums(inv, _ss(tables, "ss_ext_sales_price")[ok],
                              len(c)))})


def _q_agg_expr(tables):
    srow = _dim(tables, "store", "s_store_sk", _ss(tables, "ss_store_sk"))
    ok = srow >= 0
    states = np.asarray(tables["store"].column("s_state").to_pylist(),
                        dtype=object)
    (st,), inv = _groups([states[srow[ok]]])
    ext = _ss(tables, "ss_ext_sales_price")[ok]
    bulk = np.where(_ss(tables, "ss_quantity")[ok] >= 50, ext, 0.0)
    share = _sums(inv, bulk, len(st)) / _sums(inv, ext, len(st))
    return pa.table({"s_state": pa.array(st.tolist(), pa.string()),
                     "bulk_share": pa.array(share)})


def _q_not_or(tables):
    def keep(dd):
        moy = _np(dd, "d_moy")
        return ~((moy == 1) | (moy == 12))
    drow = _dim(tables, "date_dim", "d_date_sk",
                _ss(tables, "ss_sold_date_sk"), keep)
    ok = (drow >= 0) & (_ss(tables, "ss_net_profit") > 0.0)
    (year,), inv = _groups([_np(tables["date_dim"], "d_year")[drow[ok]]])
    return pa.table({"d_year": pa.array(year.astype(np.int32)),
                     "n": pa.array(_counts(inv, len(year)))})


def _item_revenue(tables, key: str):
    """Every item's category and ``key`` column with the sum of
    ``ss_ext_sales_price`` a (category, key) group: ``(categories
    (object), keys, revenues)``, unordered."""
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    ok = irow >= 0
    it = tables["item"]
    cats = np.asarray(it.column("i_category").to_pylist(), dtype=object)
    (c_codes, keys), inv = _groups(
        [np.unique(cats, return_inverse=True)[1].reshape(-1)[irow[ok]],
         _np(it, key)[irow[ok]]])
    rev = _sums(inv, _ss(tables, "ss_ext_sales_price")[ok], len(keys))
    return np.unique(cats)[c_codes], keys, rev


def _partition_order(part: np.ndarray, rev: np.ndarray,
                     key: np.ndarray) -> np.ndarray:
    """Rows ordered by partition, then ``rev`` descending, then ``key``
    ascending: the windows' sort, by one ``np.lexsort``."""
    _, pcode = np.unique(part, return_inverse=True)
    return np.lexsort((key, -rev, pcode.reshape(-1)))


def _q_rank(tables):
    cat, brand, rev = _item_revenue(tables, "i_brand_id")
    order = _partition_order(cat, rev, brand)
    cat, brand, rev = cat[order], brand[order], rev[order]
    # RANK(): one plus the rows of the partition before the row's first
    # peer (equal rev and brand)
    rk = np.empty(len(cat), np.int64)
    start = 0
    for i in range(len(cat)):
        if i == 0 or cat[i] != cat[i - 1]:
            start = i
        peer = i > start and rev[i] == rev[i - 1] \
            and brand[i] == brand[i - 1]
        rk[i] = rk[i - 1] if peer else i - start + 1
    keep = np.flatnonzero(rk <= 3)
    keep = keep[np.lexsort((brand[keep], rk[keep],
                            np.unique(cat[keep],
                                      return_inverse=True)[1].reshape(-1)))]
    return pa.table({
        "i_category": pa.array(cat[keep].tolist(), pa.string()),
        "i_brand_id": pa.array(brand[keep].astype(np.int32)),
        "rev": pa.array(rev[keep]),
        "rk": pa.array(rk[keep].astype(np.int32))})


def _q_rownum(tables):
    cat, item, rev = _item_revenue(tables, "i_item_sk")
    order = _partition_order(cat, rev, item)
    cat, item, rev = cat[order], item[order], rev[order]
    # ROW_NUMBER() = 1: each partition's first row in that order
    first = np.flatnonzero(np.r_[True, cat[1:] != cat[:-1]])
    return pa.table({
        "i_category": pa.array(cat[first].tolist(), pa.string()),
        "i_item_sk": pa.array(item[first].astype(np.int64)),
        "rev": pa.array(rev[first])})


def _q_rolling(tables):
    (store, date), inv = _groups([_ss(tables, "ss_store_sk"),
                                  _ss(tables, "ss_sold_date_sk")])
    rev = _sums(inv, _ss(tables, "ss_ext_sales_price"), len(store))
    # an explicit 7-day window a (store, day): the days d - 6 .. d that
    # have a row, summed in a dense (store, day) grid
    stores, s_code = np.unique(store, return_inverse=True)
    d32 = date.astype(np.int32).astype(np.int64)
    lo_day = int(d32.min())
    span = int(d32.max()) - lo_day + 1
    grid = np.zeros((len(stores), span + 6))
    have = np.zeros((len(stores), span + 6), bool)
    grid[s_code, d32 - lo_day + 6] = rev
    have[s_code, d32 - lo_day + 6] = True
    total = np.zeros(len(store))
    count = np.zeros(len(store), np.int64)
    for back in range(7):
        col = d32 - lo_day + 6 - back
        total += grid[s_code, col]
        count += have[s_code, col]
    return pa.table({"ss_store_sk": pa.array(store.astype(np.int64)),
                     "ss_sold_date_sk": pa.array(date.astype(np.int64)),
                     "rev": pa.array(rev),
                     "avg7": pa.array(total / count)})


def _q_union(tables):
    states = np.asarray(tables["store"].column("s_state").to_pylist(),
                        dtype=object)
    qtr, st, profit = [], [], []
    for q in (1, 2):
        ok = _dim(tables, "date_dim", "d_date_sk",
                  _ss(tables, "ss_sold_date_sk"),
                  lambda dd: _np(dd, "d_qoy") == q) >= 0
        srow = _dim(tables, "store", "s_store_sk",
                    _ss(tables, "ss_store_sk"))
        ok &= srow >= 0
        (g,), inv = _groups([states[srow[ok]]])
        qtr += [q] * len(g)
        st += g.tolist()
        profit += _sums(inv, _ss(tables, "ss_net_profit")[ok],
                        len(g)).tolist()
    return pa.table({"qtr": pa.array(qtr, pa.int32()),
                     "s_state": pa.array(st, pa.string()),
                     "profit": pa.array(profit, pa.float64())})


def _q97(tables):
    """store_sales rows of the first half-year whose customer also bought
    in the second (the LEFT SEMI JOIN over duplicated keys)."""
    moy = _np(tables["date_dim"], "d_moy")
    drow = _dim(tables, "date_dim", "d_date_sk",
                _ss(tables, "ss_sold_date_sk"))
    cust = _ss(tables, "ss_customer_sk")
    hit = drow >= 0
    first = hit & (moy[np.where(hit, drow, 0)] <= 6)
    second = hit & (moy[np.where(hit, drow, 0)] > 6)
    n = int(np.isin(cust[first], np.unique(cust[second])).sum())
    return pa.table({"n_pairs": pa.array([n], pa.int64())})


def _q_like(tables):
    """Profit by state over items whose category matches LIKE
    '%o%s%' (Python's ``re``, wildcards across newlines)."""
    like = re.compile("(?s).*o.*s.*")
    it = tables["item"]
    keep = np.array([v is not None and like.fullmatch(v) is not None
                     for v in it.column("i_category").to_pylist()])
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"),
                lambda t: keep)
    srow = _dim(tables, "store", "s_store_sk", _ss(tables, "ss_store_sk"))
    ok = (irow >= 0) & (srow >= 0)
    states = np.asarray(tables["store"].column("s_state").to_pylist(),
                        dtype=object)
    (st,), inv = _groups([states[srow[ok]]])
    profit = _sums(inv, _ss(tables, "ss_net_profit")[ok], len(st))
    return pa.table({"s_state": pa.array(st.tolist(), pa.string()),
                     "profit": pa.array(profit)})


def _q_percentile(tables):
    """Each state's median sale price at Spark's rank ``ceil(0.5 n)``
    (1-based) of its sorted prices."""
    srow = _dim(tables, "store", "s_store_sk", _ss(tables, "ss_store_sk"))
    ok = srow >= 0
    states = np.asarray(tables["store"].column("s_state").to_pylist(),
                        dtype=object)
    (st,), inv = _groups([states[srow[ok]]])
    price = _ss(tables, "ss_sales_price")[ok]
    p50 = []
    for g in range(len(st)):
        v = np.sort(price[inv == g])
        p50.append(v[min(max(math.ceil(0.5 * len(v)) - 1, 0),
                         len(v) - 1)])
    return pa.table({"s_state": pa.array(st.tolist(), pa.string()),
                     "p50": pa.array(p50, pa.float64())})


_ORACLES = {"q3": _q3, "q42": _q42, "q52": _q52, "q55": _q55, "q96": _q96,
            "q_topn": _q_topn, "q7": _q7, "q_pivot": _q_pivot,
            "q_customer_age": _q_customer_age,
            "q_price_band": _q_price_band, "q_cte": _q_cte,
            "q_having": _q_having, "q_in_between": _q_in_between,
            "q_agg_expr": _q_agg_expr, "q_not_or": _q_not_or,
            "q_rank": _q_rank, "q_rownum": _q_rownum,
            "q_rolling": _q_rolling, "q_union": _q_union,
            "q97": _q97, "q_like": _q_like, "q_percentile": _q_percentile}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    """The query's rows from numpy and pyarrow over the same tables (in
    memory, or read back from the Parquet files), in its output order."""
    return _ORACLES[name](tables)

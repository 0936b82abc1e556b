"""Nine SQL texts over the NDS tables that need the joins the 22-query
corpus avoids, and an oracle in numpy and pyarrow for each.

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_joins
    s = nds.session_over_files(paths, device="cpu")
    got = s.sql(nds_joins.SQL_QUERIES["q_full_halves"]).collect()
    want = nds_joins.oracle("q_full_halves", nds.gen_tables(1 << 14))

- ``q_full_halves``: TPC-DS q97's own shape, a FULL OUTER JOIN of two
  aggregated half-years on (customer, item), then the counts of pairs
  sold only in the first, only in the second, and in both;
- ``q_right_items``: a RIGHT OUTER JOIN that keeps every item, most of
  them unmatched, counted by category;
- ``q28_buckets``: TPC-DS q28's shape, six one-row subqueries joined by
  CROSS JOIN;
- ``q90_ratio``: TPC-DS q90's shape, the ratio of two one-row counts from
  a comma FROM with no equality between them (a cross join);
- ``q_band_year``, ``q_band_left``, ``q_band_anti``, ``q_band_semi``,
  ``q_band_full``: date-range band predicates, which Spark plans as a
  ``BroadcastNestedLoopJoin``, as inner, left outer, left anti, left
  semi and full outer joins of store_sales to each year's (or
  December's) first and last date key.

The texts run unchanged through the JAX package's ``TpuSession`` and the
port's ``GpuSession``. ``FLOAT_COLUMNS`` names the output columns that
hold float sums, averages and ratios (compared at a relative tolerance);
every other column is compared exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import pyarrow as pa

from ..nds import _dim, _np, _ss

__all__ = ["SQL_QUERIES", "QUERIES", "FLOAT_COLUMNS", "oracle"]

_BANDS = """(SELECT d_year, MIN(d_date_sk){shift} AS lo,
         MAX(d_date_sk){shift} AS hi
  FROM date_dim{where} GROUP BY d_year)"""


def _bands(shift: str = "", where: str = "") -> str:
    return _BANDS.format(shift=shift, where=where)


def _half(op: str, n: int) -> str:
    return f"""h{n} AS (
  SELECT /*+ UNIQUE(date_dim) */ ss_customer_sk AS c{n},
         ss_item_sk AS i{n}
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_moy {op} 6
  GROUP BY ss_customer_sk, ss_item_sk)"""


def _bucket(i: int) -> str:
    return f"""(SELECT AVG(ss_sales_price) AS b{i}_avg,
          COUNT(ss_sales_price) AS b{i}_cnt,
          MAX(ss_net_profit) AS b{i}_max
   FROM store_sales
   WHERE ss_quantity BETWEEN {5 * i} AND {5 * i + 4}) b{i}"""


def _ca_count(name: str, cond: str) -> str:
    return f"""(SELECT /*+ UNIQUE(store) */ COUNT(*) AS {name}
      FROM store_sales, store
      WHERE ss_store_sk = s_store_sk AND s_state = 'CA'
        AND {cond})"""


_ON_BAND = "ON ss_sold_date_sk >= {a}.lo AND ss_sold_date_sk <= {a}.hi"

SQL_QUERIES = {
    "q_full_halves": f"""
WITH {_half("<=", 1)},
{_half(">", 2)}
SELECT SUM(CASE WHEN c1 IS NOT NULL AND c2 IS NULL THEN 1 ELSE 0 END)
         AS only_h1,
       SUM(CASE WHEN c1 IS NULL AND c2 IS NOT NULL THEN 1 ELSE 0 END)
         AS only_h2,
       SUM(CASE WHEN c1 IS NOT NULL AND c2 IS NOT NULL THEN 1 ELSE 0 END)
         AS in_both
FROM h1 FULL OUTER JOIN h2 ON h1.c1 = h2.c2 AND h1.i1 = h2.i2
""",
    "q_right_items": """
SELECT i_category, COUNT(*) AS n_rows, COUNT(s.ss_item_sk) AS n_sold
FROM (SELECT ss_item_sk FROM store_sales
      WHERE ss_store_sk = 3 AND ss_quantity > 90) s
RIGHT OUTER JOIN item ON s.ss_item_sk = i_item_sk
GROUP BY i_category
ORDER BY i_category
""",
    "q28_buckets": "\nSELECT *\nFROM " + "\nCROSS JOIN ".join(
        _bucket(i) for i in range(6)) + "\n",
    "q90_ratio": f"""
SELECT CAST(amc AS DOUBLE) / CAST(pmc AS DOUBLE) AS am_pm_ratio
FROM {_ca_count("amc", "ss_quantity < 20")} am,
     {_ca_count("pmc", "ss_quantity > 80")} pm
""",
    "q_band_year": f"""
SELECT y.d_year, COUNT(*) AS n_sales, SUM(ss_net_profit) AS profit
FROM store_sales JOIN {_bands()} y
  {_ON_BAND.format(a="y")}
GROUP BY y.d_year
ORDER BY y.d_year
""",
    "q_band_left": f"""
SELECT COUNT(*) AS n_rows, COUNT(b.lo) AS n_in_2001
FROM store_sales LEFT OUTER JOIN {_bands(where=" WHERE d_year = 2001")} b
  {_ON_BAND.format(a="b")}
""",
    "q_band_anti": f"""
SELECT COUNT(*) AS n_sales, SUM(ss_net_profit) AS profit
FROM store_sales LEFT ANTI JOIN {_bands(where=" WHERE d_moy = 12")} dec
  {_ON_BAND.format(a="dec")}
""",
    "q_band_semi": f"""
SELECT COUNT(*) AS n_sales
FROM store_sales LEFT SEMI JOIN {_bands(where=" WHERE d_moy = 12")} dec
  {_ON_BAND.format(a="dec")}
""",
    "q_band_full": f"""
SELECT y.d_year, COUNT(*) AS n_rows, COUNT(ss_sold_date_sk) AS n_sales
FROM store_sales FULL OUTER JOIN {_bands(shift=" + 365")} y
  {_ON_BAND.format(a="y")}
GROUP BY y.d_year
ORDER BY y.d_year
""",
}

QUERIES = tuple(SQL_QUERIES)

FLOAT_COLUMNS = {
    "q_full_halves": (), "q_right_items": (),
    "q28_buckets": tuple(f"b{i}_avg" for i in range(6)),
    "q90_ratio": ("am_pm_ratio",), "q_band_year": ("profit",),
    "q_band_left": (), "q_band_anti": ("profit",), "q_band_semi": (),
    "q_band_full": ()}


def _date_rows(tables) -> np.ndarray:
    return _dim(tables, "date_dim", "d_date_sk",
                _ss(tables, "ss_sold_date_sk"))


def _band_table(tables, keep=None, shift: int = 0):
    """``(years, lo, hi)`` of each kept year's first and last date key,
    years ascending."""
    dd = tables["date_dim"]
    year, sk = _np(dd, "d_year"), _np(dd, "d_date_sk")
    mask = np.ones(len(sk), bool) if keep is None else keep(dd)
    years = np.unique(year[mask])
    lo = np.array([sk[mask & (year == y)].min() for y in years]) + shift
    hi = np.array([sk[mask & (year == y)].max() for y in years]) + shift
    return years, lo, hi


def _in_bands(tables, lo, hi) -> np.ndarray:
    """``(sales, bands)`` bool: the sale's date key lies in the band."""
    sk = _ss(tables, "ss_sold_date_sk")[:, None]
    return (sk >= lo[None, :]) & (sk <= hi[None, :])


def _december(dd) -> np.ndarray:
    return _np(dd, "d_moy") == 12


def _q_full_halves(tables):
    moy = _np(tables["date_dim"], "d_moy")
    drow = _date_rows(tables)
    hit = drow >= 0
    m = moy[np.where(hit, drow, 0)]
    pair = (_ss(tables, "ss_customer_sk") << 32) | _ss(tables, "ss_item_sk")
    a, b = np.unique(pair[hit & (m <= 6)]), np.unique(pair[hit & (m > 6)])
    both = len(np.intersect1d(a, b))
    return pa.table({"only_h1": pa.array([len(a) - both], pa.int64()),
                     "only_h2": pa.array([len(b) - both], pa.int64()),
                     "in_both": pa.array([both], pa.int64())})


def _q_right_items(tables):
    it = tables["item"]
    keep = (_ss(tables, "ss_store_sk") == 3) \
        & (_ss(tables, "ss_quantity") > 90)
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk")[keep])
    sold = np.bincount(irow[irow >= 0], minlength=it.num_rows)
    cats = np.asarray(it.column("i_category").to_pylist(), dtype=object)
    names = sorted(set(cats))
    rows = [int(np.maximum(sold, 1)[cats == c].sum()) for c in names]
    n_sold = [int(sold[cats == c].sum()) for c in names]
    return pa.table({"i_category": pa.array(names, pa.string()),
                     "n_rows": pa.array(rows, pa.int64()),
                     "n_sold": pa.array(n_sold, pa.int64())})


def _q28_buckets(tables):
    qty = _ss(tables, "ss_quantity")
    price = _ss(tables, "ss_sales_price")
    profit = _ss(tables, "ss_net_profit")
    cols = {}
    for i in range(6):
        sel = (qty >= 5 * i) & (qty <= 5 * i + 4)
        n = int(sel.sum())
        cols[f"b{i}_avg"] = pa.array([price[sel].sum() / n if n else None],
                                     pa.float64())
        cols[f"b{i}_cnt"] = pa.array([n], pa.int64())
        cols[f"b{i}_max"] = pa.array([profit[sel].max() if n else None],
                                     pa.float64())
    return pa.table(cols)


def _q90_ratio(tables):
    states = np.asarray(tables["store"].column("s_state").to_pylist(),
                        dtype=object)
    srow = _dim(tables, "store", "s_store_sk", _ss(tables, "ss_store_sk"))
    ca = (srow >= 0) & (states[np.where(srow >= 0, srow, 0)] == "CA")
    qty = _ss(tables, "ss_quantity")
    amc, pmc = int((ca & (qty < 20)).sum()), int((ca & (qty > 80)).sum())
    return pa.table({"am_pm_ratio": pa.array(
        [amc / pmc if pmc else None], pa.float64())})


def _q_band_year(tables):
    years, lo, hi = _band_table(tables)
    inside = _in_bands(tables, lo, hi)
    profit = _ss(tables, "ss_net_profit")
    keep = inside.any(0)
    return pa.table({
        "d_year": pa.array(years[keep], pa.int32()),
        "n_sales": pa.array(inside.sum(0)[keep], pa.int64()),
        "profit": pa.array([profit[inside[:, b]].sum()
                            for b in np.flatnonzero(keep)], pa.float64())})


def _q_band_left(tables):
    _, lo, hi = _band_table(tables, lambda dd: _np(dd, "d_year") == 2001)
    m = _in_bands(tables, lo, hi).sum(1)
    return pa.table({"n_rows": pa.array([int(np.maximum(m, 1).sum())],
                                        pa.int64()),
                     "n_in_2001": pa.array([int(m.sum())], pa.int64())})


def _q_band_anti(tables):
    _, lo, hi = _band_table(tables, _december)
    out = ~_in_bands(tables, lo, hi).any(1)
    return pa.table({
        "n_sales": pa.array([int(out.sum())], pa.int64()),
        "profit": pa.array([_ss(tables, "ss_net_profit")[out].sum()],
                           pa.float64())})


def _q_band_semi(tables):
    _, lo, hi = _band_table(tables, _december)
    return pa.table({"n_sales": pa.array(
        [int(_in_bands(tables, lo, hi).any(1).sum())], pa.int64())})


def _q_band_full(tables):
    years, lo, hi = _band_table(tables, shift=365)
    inside = _in_bands(tables, lo, hi)
    matched = inside.sum(0)
    lost = int((~inside.any(1)).sum())
    year = [None] + years.tolist() if lost else years.tolist()
    rows = ([lost] if lost else []) + np.maximum(matched, 1).tolist()
    sales = ([lost] if lost else []) + matched.tolist()
    return pa.table({"d_year": pa.array(year, pa.int32()),
                     "n_rows": pa.array(rows, pa.int64()),
                     "n_sales": pa.array(sales, pa.int64())})


_ORACLES = {"q_full_halves": _q_full_halves,
            "q_right_items": _q_right_items, "q28_buckets": _q28_buckets,
            "q90_ratio": _q90_ratio, "q_band_year": _q_band_year,
            "q_band_left": _q_band_left, "q_band_anti": _q_band_anti,
            "q_band_semi": _q_band_semi, "q_band_full": _q_band_full}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    """The query's rows from numpy and pyarrow over the same tables, in
    its output order."""
    return _ORACLES[name](tables)

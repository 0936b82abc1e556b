"""Eight SQL texts over the NDS tables that need the per-operator CPU
fallback, each with its conf, the nodes the planner places on the CPU,
and an oracle in numpy and pyarrow.

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_fallback as fb
    s = nds.session_over_files(paths, fb.CONF["q3_cpu"], device="cpu")
    got = s.sql(fb.SQL_QUERIES["q3_cpu"]).collect()
    want = fb.oracle("q3_cpu", nds.gen_tables(1 << 14))

- ``q_outer_price``, ``q_semi_price``, ``q_anti_price``: a price audit
  against list price, ``store_sales`` joined to ``item`` on the item key
  and ``ss_sales_price > i_current_price`` as a left outer, left semi
  and left anti join (a non-equi condition on an equi-join runs on the
  CPU), counted by category or by store;
- ``q_rolling_range``: each store's daily revenue with its 7-day rolling
  sum, ``RANGE BETWEEN 6 PRECEDING AND CURRENT ROW`` over the 64-bit date
  key (the device's RANGE offsets need an order lane of at most 32 bits);
- ``q_lag_default``: each store's categories by revenue with the one
  ranked above, ``LAG(i_category, 1, 'none')`` (a string default);
- ``q_like_intl``: sales by category of the items whose category does not
  match ``'%é_%'`` (a non-ASCII pattern, outside the device dialect);
- ``q3_float_exact``: NDS q3 under ``spark.rapids.sql.variableFloatAgg
  .enabled=false`` (the float sum's aggregate on the CPU);
- ``q3_cpu``: NDS q3 under ``spark.rapids.sql.enabled=false`` (every
  node on the CPU).

``FALLBACK`` gives ``PhysicalPlan.fallback_nodes()`` for each text, the
same at every partition count. ``FLOAT_COLUMNS`` names the output
columns that hold float sums (compared at a relative tolerance); every
other column is compared exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import pyarrow as pa

from .. import nds
from ..nds import _dim, _np, _ss

__all__ = ["SQL_QUERIES", "QUERIES", "CONF", "FALLBACK", "FLOAT_COLUMNS",
           "oracle"]

_PRICE_ON = "ON ss_item_sk = i_item_sk AND ss_sales_price > i_current_price"

_PRICE_BY_STORE = """
SELECT ss_store_sk, COUNT(*) AS n_sales
FROM store_sales LEFT {kind} JOIN item
  {on}
GROUP BY ss_store_sk
ORDER BY ss_store_sk
"""

SQL_QUERIES = {
    "q_outer_price": f"""
SELECT i_category, COUNT(*) AS n_sales, SUM(ss_sales_price) AS revenue
FROM store_sales LEFT OUTER JOIN item
  {_PRICE_ON}
GROUP BY i_category
ORDER BY i_category
""",
    "q_semi_price": _PRICE_BY_STORE.format(kind="SEMI", on=_PRICE_ON),
    "q_anti_price": _PRICE_BY_STORE.format(kind="ANTI", on=_PRICE_ON),
    "q_rolling_range": """
SELECT ss_store_sk, ss_sold_date_sk, rev,
       SUM(rev) OVER (PARTITION BY ss_store_sk ORDER BY ss_sold_date_sk
                      RANGE BETWEEN 6 PRECEDING AND CURRENT ROW) AS rev7
FROM (SELECT ss_store_sk, ss_sold_date_sk,
             SUM(ss_ext_sales_price) AS rev
      FROM store_sales
      GROUP BY ss_store_sk, ss_sold_date_sk) daily
ORDER BY ss_store_sk, ss_sold_date_sk
""",
    "q_lag_default": """
SELECT ss_store_sk, i_category, rev,
       LAG(i_category, 1, 'none') OVER (PARTITION BY ss_store_sk
                                        ORDER BY rev DESC) AS prev_category
FROM (SELECT /*+ UNIQUE(item) */ ss_store_sk, i_category,
             SUM(ss_ext_sales_price) AS rev
      FROM store_sales, item
      WHERE ss_item_sk = i_item_sk
      GROUP BY ss_store_sk, i_category) r
ORDER BY ss_store_sk, rev DESC
""",
    "q_like_intl": """
SELECT /*+ UNIQUE(item) */ i_category, COUNT(*) AS n_sales
FROM store_sales, item
WHERE ss_item_sk = i_item_sk AND NOT i_category LIKE '%é_%'
GROUP BY i_category
ORDER BY i_category
""",
    "q3_float_exact": nds.SQL_QUERIES["q3"],
    "q3_cpu": nds.SQL_QUERIES["q3"],
}

QUERIES = tuple(SQL_QUERIES)

CONF = {q: {} for q in QUERIES}
CONF["q3_float_exact"] = {"spark.rapids.sql.variableFloatAgg.enabled":
                          "false"}
CONF["q3_cpu"] = {"spark.rapids.sql.enabled": "false"}

FALLBACK = {
    "q_outer_price": ["ShuffledHashJoinExec"],
    "q_semi_price": ["ShuffledHashJoinExec"],
    "q_anti_price": ["ShuffledHashJoinExec"],
    "q_rolling_range": ["WindowExec"],
    "q_lag_default": ["WindowExec"],
    "q_like_intl": ["FilterExec"],
    "q3_float_exact": ["HashAggregateExec"],
    "q3_cpu": ["GlobalLimitExec", "SortExec", "ProjectExec",
               "HashAggregateExec", "ShuffleExchangeExec",
               "ShuffledHashJoinExec", "ShuffledHashJoinExec",
               "FileScanExec", "FilterExec", "FileScanExec",
               "FileScanExec"],
}

FLOAT_COLUMNS = {"q_outer_price": ("revenue",), "q_semi_price": (),
                 "q_anti_price": (), "q_rolling_range": ("rev", "rev7"),
                 "q_lag_default": ("rev",), "q_like_intl": (),
                 "q3_float_exact": ("sum_agg",), "q3_cpu": ("sum_agg",)}


def _price_match(tables) -> np.ndarray:
    """A sale's item row where the join's ON holds, else -1."""
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    price = _np(tables["item"], "i_current_price")
    hit = (irow >= 0) & (_ss(tables, "ss_sales_price")
                         > price[np.where(irow >= 0, irow, 0)])
    return np.where(hit, irow, -1)


def _categories(tables) -> np.ndarray:
    return np.asarray(tables["item"].column("i_category").to_pylist(),
                      dtype=object)


def _by_store(keep: np.ndarray, tables) -> pa.Table:
    stores, n = np.unique(_ss(tables, "ss_store_sk")[keep],
                          return_counts=True)
    return pa.table({"ss_store_sk": pa.array(stores, pa.int64()),
                     "n_sales": pa.array(n, pa.int64())})


def _q_outer_price(tables):
    irow = _price_match(tables)
    cats = _categories(tables)
    price = _ss(tables, "ss_sales_price")
    names = [None] + sorted(set(cats[irow[irow >= 0]]))
    cat = np.where(irow >= 0, cats[np.where(irow >= 0, irow, 0)], None)
    rows = [cat == c if c is not None else irow < 0 for c in names]
    keep = [i for i, r in enumerate(rows) if r.any()]
    return pa.table({
        "i_category": pa.array([names[i] for i in keep], pa.string()),
        "n_sales": pa.array([int(rows[i].sum()) for i in keep], pa.int64()),
        "revenue": pa.array([float(price[rows[i]].sum()) for i in keep],
                            pa.float64())})


def _q_semi_price(tables):
    return _by_store(_price_match(tables) >= 0, tables)


def _q_anti_price(tables):
    return _by_store(_price_match(tables) < 0, tables)


def _daily(tables):
    """Each (store, day)'s revenue, sorted by store then day."""
    store, day = _ss(tables, "ss_store_sk"), _ss(tables, "ss_sold_date_sk")
    key = store * 1_000_000 + day
    keys, inv = np.unique(key, return_inverse=True)
    rev = np.zeros(len(keys))
    np.add.at(rev, inv, _ss(tables, "ss_ext_sales_price"))
    return keys // 1_000_000, keys % 1_000_000, rev


def _q_rolling_range(tables):
    store, day, rev = _daily(tables)
    rev7 = np.empty(len(rev))
    for s in np.unique(store):
        at = np.flatnonzero(store == s)
        lo = np.searchsorted(day[at], day[at] - 6, side="left")
        rev7[at] = [rev[at[a:b + 1]].sum()
                    for a, b in zip(lo, range(len(at)))]
    return pa.table({"ss_store_sk": pa.array(store, pa.int64()),
                     "ss_sold_date_sk": pa.array(day, pa.int64()),
                     "rev": pa.array(rev, pa.float64()),
                     "rev7": pa.array(rev7, pa.float64())})


def _q_lag_default(tables):
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    cats = _categories(tables)[irow]
    store = _ss(tables, "ss_store_sk")
    ext = _ss(tables, "ss_ext_sales_price")
    rows = []
    for s in np.unique(store):
        sel = store == s
        revs = sorted(((float(ext[sel & (cats == c)].sum()), c)
                       for c in set(cats[sel])), key=lambda r: -r[0])
        prev = "none"
        for rev, c in revs:
            rows.append((int(s), c, rev, prev))
            prev = c
    cols = list(zip(*rows))
    return pa.table({"ss_store_sk": pa.array(cols[0], pa.int64()),
                     "i_category": pa.array(cols[1], pa.string()),
                     "rev": pa.array(cols[2], pa.float64()),
                     "prev_category": pa.array(cols[3], pa.string())})


def _q_like_intl(tables):
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    cats = _categories(tables)[irow[irow >= 0]]
    # '%é_%': an é followed by at least one more character
    keep = np.array(["é" not in c[:-1] for c in cats], dtype=bool)
    names, n = np.unique(cats[keep].astype(str), return_counts=True)
    return pa.table({"i_category": pa.array(names.tolist(), pa.string()),
                     "n_sales": pa.array(n, pa.int64())})


_ORACLES = {"q_outer_price": _q_outer_price,
            "q_semi_price": _q_semi_price, "q_anti_price": _q_anti_price,
            "q_rolling_range": _q_rolling_range,
            "q_lag_default": _q_lag_default, "q_like_intl": _q_like_intl,
            "q3_float_exact": lambda t: nds.oracle("q3", t),
            "q3_cpu": lambda t: nds.oracle("q3", t)}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    """The query's rows from numpy and pyarrow over the same tables, in
    its output order."""
    return _ORACLES[name](tables)

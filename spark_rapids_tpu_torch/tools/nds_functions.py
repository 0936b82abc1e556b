"""Ten SQL texts over the NDS tables that run every family of the SQL
function registry, each with the nodes the planner places on the CPU
and an oracle that does not use the engine's expression code (numpy,
pyarrow and Python's ``math``/``datetime`` over the distinct values).

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_functions as fn
    tables = nds.gen_tables(1 << 12)
    s = nds.session_over_files(nds.write_tables(tables, dir), None,
                               device="cpu")
    fn.check("q_fn_math", s.sql(fn.SQL_QUERIES["q_fn_math"]).collect(),
             tables)

The shapes come from TPC-DS:

- ``q_fn_cv``: q39's coefficient of variation, ``AVG`` and
  ``STDDEV_SAMP`` of ``ss_quantity`` by store and month and their
  ratio, filtered on the ratio;
- ``q_fn_moments``: q17's moments, the four variances and deviations of
  ``ss_net_profit`` and ``ss_quantity`` by ``i_category``;
- ``q_fn_minmax_str``: ``MIN``/``MAX`` of ``i_category`` by ``s_state``,
  with ``FIRST``/``LAST`` of ``ss_quantity``;
- ``q_fn_window_moments``: ``STDDEV_SAMP``, ``FIRST`` and ``LAST`` over
  a 3-row frame by store, ordered by date, item, customer and profit (no
  ties), summed by store;
- ``q_fn_strings``: q8/q62's ``SUBSTR`` (a negative start too),
  ``UPPER``, ``LOWER``, ``LENGTH``, ``TRIM`` and ``CONCAT`` (and ``||``)
  as group keys;
- ``q_fn_match``: ``STARTSWITH``, ``ENDSWITH`` and ``CONTAINS`` of
  literals, a non-ASCII ``ENDSWITH`` and a non-ASCII ``LIKE`` suffix;
- ``q_fn_dates``: the TPC-DS date window: a date built with ``DATE_ADD``
  of a ``CAST`` string, its parts, ``LAST_DAY``, ``DATEDIFF``,
  ``ADD_MONTHS``, ``MONTHS_BETWEEN`` and ``TRUNC``, filtered ``BETWEEN``
  two dates;
- ``q_fn_casts``: integers, strings and dates (before 1970 too) cast to
  string and back, grouped by a string made of casts;
- ``q_fn_math``: ``ROUND``/``BROUND`` of a double (the item projection,
  on the CPU as the reference places a double's round), ``ROUND`` of an
  integer to tens, ``FLOOR``, ``CEIL``, ``SQRT``, ``LN``, ``LOG10``,
  ``POW``, ``ABS`` and ``SIGN`` over ``ss_net_profit``, which has
  negative values;
- ``q_fn_host``: ``REPLACE``, ``LOCATE``, ``LPAD``, ``RPAD``, ``REPEAT``
  and ``REVERSE`` of the item categories, a CPU island as the reference
  places them.

``FALLBACK`` gives ``PhysicalPlan.fallback_nodes()`` for each text at
the default conf, at every partition count. ``check`` holds a result to
the oracle: integers, strings and dates exactly, the ``FLOAT_COLUMNS``
within a relative ``FLOAT_RTOL`` (a float sum's order differs), and the
``MEMBER_COLUMNS`` (``FIRST``/``LAST`` after a join, whose row order is
not fixed) only to be a value of their group.
"""
from __future__ import annotations

import datetime
import decimal
import math
from typing import Dict

import numpy as np
import pyarrow as pa

from ..nds import _dim, _np, _ss

__all__ = ["SQL_QUERIES", "QUERIES", "FALLBACK", "FLOAT_COLUMNS",
           "MEMBER_COLUMNS", "FLOAT_RTOL", "oracle", "check"]

FLOAT_RTOL = 1e-9

_ROWS3 = ("PARTITION BY ss_store_sk ORDER BY ss_sold_date_sk, ss_item_sk, "
          "ss_customer_sk, ss_net_profit ROWS BETWEEN 2 PRECEDING AND "
          "CURRENT ROW")
_DAY0 = "CAST('2000-01-01' AS DATE)"
_PRE1970 = "CAST('1969-12-25' AS DATE)"

SQL_QUERIES = {
    "q_fn_cv": """
SELECT ss_store_sk, mon, mean_q, sd_q, sd_q / mean_q AS cov
FROM (SELECT ss_store_sk, d_moy AS mon, AVG(ss_quantity) AS mean_q,
             STDDEV_SAMP(ss_quantity) AS sd_q
      FROM store_sales JOIN date_dim ON ss_sold_date_sk = d_date_sk
      WHERE d_year = 2000
      GROUP BY ss_store_sk, d_moy) t
WHERE mean_q > 0 AND sd_q / mean_q > 0.57
ORDER BY ss_store_sk, mon
""",
    "q_fn_moments": """
SELECT i_category, COUNT(*) AS n,
       STDDEV_SAMP(ss_net_profit) AS sd_s, STDDEV_POP(ss_net_profit) AS sd_p,
       VAR_SAMP(ss_net_profit) AS v_s, VAR_POP(ss_net_profit) AS v_p,
       STDDEV(ss_quantity) AS sd_q, VARIANCE(ss_quantity) AS v_q
FROM store_sales JOIN item ON ss_item_sk = i_item_sk
GROUP BY i_category
ORDER BY i_category
""",
    "q_fn_minmax_str": """
SELECT s_state, MIN(i_category) AS lo_cat, MAX(i_category) AS hi_cat,
       FIRST(ss_quantity) AS f_q, LAST(ss_quantity) AS l_q,
       COUNT(*) AS n
FROM store_sales JOIN item ON ss_item_sk = i_item_sk
     JOIN store ON ss_store_sk = s_store_sk
GROUP BY s_state
ORDER BY s_state
""",
    "q_fn_window_moments": f"""
SELECT ss_store_sk, COUNT(*) AS n, COUNT(sd3) AS n_sd, SUM(sd3) AS s_sd3,
       SUM(f3) AS s_f3, SUM(l3) AS s_l3
FROM (SELECT ss_store_sk,
             STDDEV_SAMP(ss_net_profit) OVER ({_ROWS3}) AS sd3,
             FIRST(ss_quantity) OVER ({_ROWS3}) AS f3,
             LAST(ss_quantity) OVER ({_ROWS3}) AS l3
      FROM store_sales) t
GROUP BY ss_store_sk
ORDER BY ss_store_sk
""",
    "q_fn_strings": """
SELECT st_cat, pre, post, up, lo, len, tr, COUNT(*) AS n
FROM (SELECT CONCAT(s_state, '-', i_category) AS st_cat,
             SUBSTR(i_category, 1, 3) AS pre,
             SUBSTR(i_category, -3, 2) AS post,
             UPPER(i_category) AS up, LOWER(s_state) AS lo,
             LENGTH(i_category) AS len,
             TRIM('  ' || s_state || ' ') AS tr
      FROM store_sales JOIN item ON ss_item_sk = i_item_sk
           JOIN store ON ss_store_sk = s_store_sk) t
GROUP BY st_cat, pre, post, up, lo, len, tr
ORDER BY st_cat
""",
    "q_fn_match": """
SELECT i_category, COUNT(*) AS n,
       SUM(CASE WHEN STARTSWITH(i_category, 'Bo') THEN 1 ELSE 0 END) AS sw,
       SUM(CASE WHEN ENDSWITH(i_category, 'ics') THEN 1 ELSE 0 END) AS ew,
       SUM(CASE WHEN CONTAINS(i_category, 'o') THEN 1 ELSE 0 END) AS ct,
       SUM(CASE WHEN ENDSWITH(CONCAT(i_category, 'é'), 'é') THEN 1 ELSE 0
           END) AS ew_intl,
       SUM(CASE WHEN CONCAT(i_category, 'é') LIKE '%sé' THEN 1 ELSE 0
           END) AS like_intl
FROM store_sales JOIN item ON ss_item_sk = i_item_sk
GROUP BY i_category
ORDER BY i_category
""",
    "q_fn_dates": f"""
SELECT d, yr, mo, qtr, dow, ld, mstart, next_m, dd, mb, COUNT(*) AS n
FROM (SELECT d, YEAR(d) AS yr, MONTH(d) AS mo, QUARTER(d) AS qtr,
             DAYOFWEEK(d) AS dow, LAST_DAY(d) AS ld,
             TRUNC(d, 'MM') AS mstart, ADD_MONTHS(d, 1) AS next_m,
             DATEDIFF(d, {_DAY0}) AS dd,
             MONTHS_BETWEEN(d, CAST('2000-01-31' AS DATE)) AS mb
      FROM (SELECT DATE_ADD({_DAY0}, ss_sold_date_sk) AS d
            FROM store_sales) s
      WHERE d BETWEEN CAST('2000-02-01' AS DATE)
                  AND DATE_ADD(CAST('2000-02-01' AS DATE), 30)) t
GROUP BY d, yr, mo, qtr, dow, ld, mstart, next_m, dd, mb
ORDER BY d
""",
    "q_fn_casts": f"""
SELECT key, COUNT(*) AS n, MIN(qs) AS min_qs, MAX(qs) AS max_qs,
       SUM(rt) AS s_rt, SUM(back) AS s_back, MIN(ds) AS min_ds
FROM (SELECT CONCAT(CAST(ss_store_sk AS STRING), '/',
                    CAST(ss_quantity % 10 AS STRING)) AS key,
             CAST(ss_quantity AS STRING) AS qs,
             CAST(CAST(ss_item_sk AS STRING) AS BIGINT) AS rt,
             CAST(DATE_ADD({_PRE1970}, ss_sold_date_sk) AS STRING) AS ds,
             DATEDIFF(CAST(CAST(DATE_ADD({_PRE1970}, ss_sold_date_sk)
                                AS STRING) AS DATE), {_PRE1970}) AS back
      FROM store_sales) t
GROUP BY key
ORDER BY key
""",
    "q_fn_math": """
SELECT ss_store_sk, COUNT(*) AS n, SUM(p2) AS s_round, SUM(b1) AS s_bround,
       SUM(ROUND(ss_quantity, -1)) AS s_round_int,
       SUM(FLOOR(ss_net_profit)) AS s_floor,
       SUM(CEIL(ss_net_profit)) AS s_ceil,
       SUM(SQRT(ss_sales_price)) AS s_sqrt, SUM(LN(ss_net_profit)) AS s_ln,
       COUNT(LN(ss_net_profit)) AS n_ln,
       SUM(LOG10(ss_sales_price)) AS s_log10,
       SUM(POW(ss_net_profit, 2)) AS s_pow,
       SUM(ABS(ss_net_profit)) AS s_abs, SUM(SIGN(ss_net_profit)) AS s_sign
FROM store_sales JOIN (SELECT i_item_sk, ROUND(i_current_price, 2) AS p2,
                              BROUND(i_current_price, 1) AS b1
                       FROM item) it ON ss_item_sk = i_item_sk
GROUP BY ss_store_sk
ORDER BY ss_store_sk
""",
    "q_fn_host": """
SELECT r, COUNT(*) AS n
FROM store_sales JOIN (
  SELECT i_item_sk,
         CONCAT(REPLACE(i_category, 'o', '0'), '|',
                CAST(LOCATE('o', i_category) AS STRING), '|',
                LPAD(i_category, 8, '*'), '|', RPAD(i_category, 3, '#'),
                '|', REPEAT(i_category, 2), '|', REVERSE(i_category)) AS r
  FROM item) it ON ss_item_sk = i_item_sk
GROUP BY r
ORDER BY r
""",
}

QUERIES = tuple(SQL_QUERIES)

FALLBACK = {q: [] for q in QUERIES}
FALLBACK["q_fn_math"] = ["ProjectExec"]
FALLBACK["q_fn_host"] = ["ProjectExec"]

FLOAT_COLUMNS = {
    "q_fn_cv": ("mean_q", "sd_q", "cov"),
    "q_fn_moments": ("sd_s", "sd_p", "v_s", "v_p", "sd_q", "v_q"),
    "q_fn_minmax_str": (),
    "q_fn_window_moments": ("s_sd3",),
    "q_fn_strings": (), "q_fn_match": (),
    "q_fn_dates": ("mb",),
    "q_fn_casts": (),
    "q_fn_math": ("s_round", "s_bround", "s_sqrt", "s_ln", "s_log10",
                  "s_pow", "s_abs", "s_sign"),
    "q_fn_host": (),
}

MEMBER_COLUMNS = {"q_fn_minmax_str": ("f_q", "l_q")}


# --- oracles -------------------------------------------------------------------

def _groups(*keys):
    """Distinct key tuples in sorted order and each row's group."""
    cols = [np.asarray(k) for k in keys]
    order = np.lexsort(cols[::-1])
    sk = [c[order] for c in cols]
    change = np.zeros(len(order), bool)
    if len(order):
        change[0] = True
        for c in sk:
            change[1:] |= c[1:] != c[:-1]
    gid_sorted = np.cumsum(change) - 1
    gid = np.empty(len(order), np.int64)
    gid[order] = gid_sorted
    firsts = order[change]
    return [c[firsts] for c in cols], gid


def _moments(x: np.ndarray, gid: np.ndarray, n_groups: int, ddof: int):
    """Two-pass variances by group (NaN where undefined)."""
    n = np.bincount(gid, minlength=n_groups).astype(np.float64)
    s = np.bincount(gid, weights=x, minlength=n_groups)
    mean = s / np.where(n > 0, n, 1)
    d = x - mean[gid]
    m2 = np.bincount(gid, weights=d * d, minlength=n_groups)
    return np.where(n > ddof, m2 / np.where(n > ddof, n - ddof, 1), np.nan)


def _null_nan(v: np.ndarray) -> pa.Array:
    return pa.array(np.where(np.isnan(v), None, v).tolist(), pa.float64())


def _strs(values) -> np.ndarray:
    return np.asarray(list(values), dtype=object)


def _q_fn_cv(tables):
    dd = tables["date_dim"]
    drow = _dim(tables, "date_dim", "d_date_sk", _ss(tables, "ss_sold_date_sk"))
    keep = drow >= 0
    keep[keep] &= _np(dd, "d_year")[drow[keep]] == 2000
    store = _ss(tables, "ss_store_sk")[keep]
    mon = _np(dd, "d_moy")[drow[keep]]
    q = _ss(tables, "ss_quantity")[keep].astype(np.float64)
    (ks, km), gid = _groups(store, mon)
    g = len(ks)
    mean = np.bincount(gid, weights=q, minlength=g) \
        / np.bincount(gid, minlength=g)
    sd = np.sqrt(_moments(q, gid, g, 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        cov = sd / mean
    ok = (mean > 0) & ~np.isnan(cov) & (cov > 0.57)
    return pa.table({"ss_store_sk": pa.array(ks[ok], pa.int64()),
                     "mon": pa.array(km[ok], pa.int32()),
                     "mean_q": pa.array(mean[ok], pa.float64()),
                     "sd_q": pa.array(sd[ok], pa.float64()),
                     "cov": pa.array(cov[ok], pa.float64())})


def _codes(table: pa.Table, name: str):
    """A string column's distinct values in byte order and each row's
    code into them."""
    vals = table.column(name).to_pylist()
    names = sorted(set(vals), key=lambda v: v.encode())
    at = {v: i for i, v in enumerate(names)}
    return _strs(names), np.array([at[v] for v in vals], np.int64)


_ITEM_CATS: Dict[int, tuple] = {}


def _item_cats(tables):
    """Each sale's item row (-1: none), the categories in byte order and
    each item's category code; computed once for a set of tables."""
    key = id(tables["store_sales"])
    if key not in _ITEM_CATS:
        _ITEM_CATS.clear()
        irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
        _ITEM_CATS[key] = (irow,) + _codes(tables["item"], "i_category")
    return _ITEM_CATS[key]


def _q_fn_moments(tables):
    irow, names, code = _item_cats(tables)
    keep = irow >= 0
    (kcode,), gid = _groups(code[irow[keep]])
    kc = names[kcode]
    g = len(kc)
    p = _ss(tables, "ss_net_profit")[keep]
    q = _ss(tables, "ss_quantity")[keep].astype(np.float64)
    vs, vp = _moments(p, gid, g, 1), _moments(p, gid, g, 0)
    vq = _moments(q, gid, g, 1)
    return pa.table({
        "i_category": pa.array(kc.tolist(), pa.string()),
        "n": pa.array(np.bincount(gid, minlength=g), pa.int64()),
        "sd_s": _null_nan(np.sqrt(vs)), "sd_p": _null_nan(np.sqrt(vp)),
        "v_s": _null_nan(vs), "v_p": _null_nan(vp),
        "sd_q": _null_nan(np.sqrt(vq)), "v_q": _null_nan(vq)})


def _q_fn_minmax_str(tables):
    irow, names, code = _item_cats(tables)
    srow = _dim(tables, "store", "s_store_sk", _ss(tables, "ss_store_sk"))
    keep = (irow >= 0) & (srow >= 0)
    snames, scode = _codes(tables["store"], "s_state")
    (kscode,), gid = _groups(scode[srow[keep]])
    ks = snames[kscode]
    cat = code[irow[keep]]  # codes in byte order: min and max are theirs
    qty = _ss(tables, "ss_quantity")[keep]
    lo, hi, allowed = [], [], []
    for g in range(len(ks)):
        sel = gid == g
        lo.append(names[cat[sel].min()])
        hi.append(names[cat[sel].max()])
        allowed.append(np.unique(qty[sel]).tolist())
    members_t = pa.list_(pa.int32())
    return pa.table({
        "s_state": pa.array(ks.tolist(), pa.string()),
        "lo_cat": pa.array(lo, pa.string()),
        "hi_cat": pa.array(hi, pa.string()),
        "f_q": pa.array(allowed, members_t),
        "l_q": pa.array(allowed, members_t),
        "n": pa.array(np.bincount(gid, minlength=len(ks)), pa.int64())})


def _q_fn_window_moments(tables):
    store = _ss(tables, "ss_store_sk")
    # the window's order: (store, date, item, customer) packed into one
    # int64 (5 + 10 + 15 + 16 bits at NDS's sizes), the profit breaking
    # its ties: two stable sorts, the tie-breaker's first
    assert _ss(tables, "ss_item_sk").max() < 1 << 15 \
        and _ss(tables, "ss_customer_sk").max() < 1 << 16 \
        and _ss(tables, "ss_sold_date_sk").max() < 1024 \
        and store.max() < 1 << 5, "keys past the packed widths"
    key = ((store * 1024 + _ss(tables, "ss_sold_date_sk")) * (1 << 31)
           + _ss(tables, "ss_item_sk") * (1 << 16)
           + _ss(tables, "ss_customer_sk"))
    by_profit = np.argsort(_ss(tables, "ss_net_profit"), kind="stable")
    order = by_profit[np.argsort(key[by_profit], kind="stable")]
    st = store[order]
    x = _ss(tables, "ss_net_profit")[order]
    q = _ss(tables, "ss_quantity")[order].astype(np.int64)
    n = len(st)
    seg_start = np.zeros(n, np.int64)
    if n:
        starts = np.flatnonzero(np.r_[True, st[1:] != st[:-1]])
        seg_start = starts[np.searchsorted(starts, np.arange(n),
                                           side="right") - 1]
    pos = np.arange(n)
    lo = np.maximum(pos - 2, seg_start)
    width = pos - lo + 1
    win = [np.where(pos - k >= lo, x[np.maximum(pos - k, 0)], np.nan)
           for k in range(3)]
    stack = np.stack(win)
    mean = np.nansum(stack, 0) / width
    m2 = np.nansum((stack - mean) ** 2, 0)
    sd = np.where(width > 1, np.sqrt(m2 / np.maximum(width - 1, 1)), np.nan)
    f3 = q[lo]
    (ks,), gid = _groups(st)
    g = len(ks)
    has = ~np.isnan(sd)
    return pa.table({
        "ss_store_sk": pa.array(ks, pa.int64()),
        "n": pa.array(np.bincount(gid, minlength=g), pa.int64()),
        "n_sd": pa.array(np.bincount(gid[has], minlength=g), pa.int64()),
        "s_sd3": pa.array(np.bincount(gid[has], weights=sd[has],
                                      minlength=g), pa.float64()),
        "s_f3": pa.array(np.bincount(gid, weights=f3, minlength=g)
                         .astype(np.int64), pa.int64()),
        "s_l3": pa.array(np.bincount(gid, weights=q, minlength=g)
                         .astype(np.int64), pa.int64())})


def _spark_substr(s: str, pos: int, length: int) -> str:
    n = len(s)
    start = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
    end = min(start + max(length, 0), n)
    start = max(start, 0)
    return s[start:end] if end > start else ""


def _q_fn_strings(tables):
    irow, names, code = _item_cats(tables)
    srow = _dim(tables, "store", "s_store_sk", _ss(tables, "ss_store_sk"))
    keep = (irow >= 0) & (srow >= 0)
    snames, scode = _codes(tables["store"], "s_state")
    k = len(snames)
    pair, n = np.unique(code[irow[keep]] * k + scode[srow[keep]],
                        return_counts=True)
    pairs = {(names[p // k], snames[p % k]): int(c)
             for p, c in zip(pair.tolist(), n.tolist())}
    rows = []
    for (c, s), n in pairs.items():
        rows.append((f"{s}-{c}", _spark_substr(c, 1, 3),
                     _spark_substr(c, -3, 2), c.upper(), s.lower(), len(c),
                     f"  {s} ".strip(" "), n))
    rows.sort(key=lambda r: r[0].encode())
    names = ["st_cat", "pre", "post", "up", "lo", "len", "tr", "n"]
    types = [pa.string()] * 5 + [pa.int32(), pa.string(), pa.int64()]
    return pa.table({nm: pa.array([r[i] for r in rows], t)
                     for i, (nm, t) in enumerate(zip(names, types))})


def _q_fn_match(tables):
    irow, names, code = _item_cats(tables)
    kcode, n = np.unique(code[irow[irow >= 0]], return_counts=True)
    kc = names[kcode]

    def per_cat(pred):
        return pa.array([int(n[i]) if pred(c) else 0
                         for i, c in enumerate(kc)], pa.int64())
    return pa.table({
        "i_category": pa.array(kc.tolist(), pa.string()),
        "n": pa.array(n, pa.int64()),
        "sw": per_cat(lambda c: c.startswith("Bo")),
        "ew": per_cat(lambda c: c.endswith("ics")),
        "ct": per_cat(lambda c: "o" in c),
        "ew_intl": per_cat(lambda c: (c + "é").endswith("é")),
        "like_intl": per_cat(lambda c: (c + "é").endswith("sé"))})


def _last_day(d: datetime.date) -> datetime.date:
    nxt = datetime.date(d.year + (d.month == 12), d.month % 12 + 1, 1)
    return nxt - datetime.timedelta(days=1)


def _add_months(d: datetime.date, n: int) -> datetime.date:
    tot = d.year * 12 + d.month - 1 + n
    y, m = divmod(tot, 12)
    first = datetime.date(y, m + 1, 1)
    return first.replace(day=min(d.day, _last_day(first).day))


def _months_between(a: datetime.date, b: datetime.date) -> float:
    months = (a.year - b.year) * 12 + (a.month - b.month)
    if a == _last_day(a) and b == _last_day(b) or a.day == b.day:
        return float(months)
    v = months + (a.day - b.day) / 31.0
    return float(decimal.Decimal(v * 1e8).quantize(
        decimal.Decimal(1), rounding=decimal.ROUND_HALF_EVEN)) / 1e8


def _q_fn_dates(tables):
    day0 = datetime.date(2000, 1, 1)
    lo = datetime.date(2000, 2, 1)
    hi = lo + datetime.timedelta(days=30)
    keys, n = np.unique(_ss(tables, "ss_sold_date_sk"), return_counts=True)
    rows = []
    for k, c in zip(keys.tolist(), n.tolist()):
        d = day0 + datetime.timedelta(days=k)
        if not lo <= d <= hi:
            continue
        rows.append((d, d.year, d.month, (d.month - 1) // 3 + 1,
                     d.isoweekday() % 7 + 1, _last_day(d), d.replace(day=1),
                     _add_months(d, 1), (d - day0).days,
                     _months_between(d, datetime.date(2000, 1, 31)), c))
    names = ["d", "yr", "mo", "qtr", "dow", "ld", "mstart", "next_m", "dd",
             "mb", "n"]
    types = [pa.date32()] + [pa.int32()] * 4 + [pa.date32()] * 3 \
        + [pa.int32(), pa.float64(), pa.int64()]
    return pa.table({nm: pa.array([r[i] for r in rows], t)
                     for i, (nm, t) in enumerate(zip(names, types))})


def _q_fn_casts(tables):
    store = _ss(tables, "ss_store_sk")
    qty = _ss(tables, "ss_quantity").astype(np.int64)
    item = _ss(tables, "ss_item_sk")
    days = _ss(tables, "ss_sold_date_sk")
    base = datetime.date(1969, 12, 25)
    (ks, kq), gid = _groups(store, qty % 10)
    g = len(ks)
    n = np.bincount(gid, minlength=g)
    s_item = np.zeros(g, np.int64)
    np.add.at(s_item, gid, item)
    s_days = np.zeros(g, np.int64)
    np.add.at(s_days, gid, days)
    min_day = np.full(g, np.iinfo(np.int64).max)
    np.minimum.at(min_day, gid, days)
    # each group's distinct quantities, then their strings in byte order
    pq = np.unique(gid * 128 + qty)
    qsets: Dict[int, list] = {}
    for v in pq.tolist():
        qsets.setdefault(v // 128, []).append(str(v % 128))
    out = {}
    for i in range(g):
        qs = sorted(qsets[i], key=lambda v: v.encode())
        ds = (base + datetime.timedelta(days=int(min_day[i]))).isoformat()
        out[f"{ks[i]}/{kq[i]}"] = (int(n[i]), qs[0], qs[-1],
                                   int(s_item[i]), int(s_days[i]), ds)
    keys = sorted(out, key=lambda k: k.encode())
    cols = ["n", "min_qs", "max_qs", "s_rt", "s_back", "min_ds"]
    types = [pa.int64(), pa.string(), pa.string(), pa.int64(), pa.int64(),
             pa.string()]
    t = {"key": pa.array(keys, pa.string())}
    for j, (c, ty) in enumerate(zip(cols, types)):
        t[c] = pa.array([out[k][j] for k in keys], ty)
    return pa.table(t)


def _round_exact(x: float, digits: int, half_even: bool) -> float:
    mode = decimal.ROUND_HALF_EVEN if half_even else decimal.ROUND_HALF_UP
    return float(decimal.Decimal(x).quantize(
        decimal.Decimal(1).scaleb(-digits), rounding=mode))


def _q_fn_math(tables):
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    keep = irow >= 0
    price = _np(tables["item"], "i_current_price")
    p2 = np.array([_round_exact(v, 2, False) for v in price.tolist()])
    b1 = np.array([_round_exact(v, 1, True) for v in price.tolist()])
    store = _ss(tables, "ss_store_sk")[keep]
    (ks,), gid = _groups(store)
    g = len(ks)
    profit = _ss(tables, "ss_net_profit")[keep]
    sp = _ss(tables, "ss_sales_price")[keep]
    qty = _ss(tables, "ss_quantity")[keep].astype(np.int64)
    r10 = (qty + 5) // 10 * 10  # HALF_UP of non-negative quantities
    pos = profit > 0

    def fsum(v, sel=None):
        if sel is None:
            return np.bincount(gid, weights=v, minlength=g)
        return np.bincount(gid[sel], weights=v[sel], minlength=g)

    def isum(v):
        out = np.zeros(g, np.int64)
        np.add.at(out, gid, v)
        return out
    with np.errstate(invalid="ignore", divide="ignore"):
        ln = np.log(np.where(pos, profit, 1.0))
    return pa.table({
        "ss_store_sk": pa.array(ks, pa.int64()),
        "n": pa.array(np.bincount(gid, minlength=g), pa.int64()),
        "s_round": pa.array(fsum(p2[irow[keep]]), pa.float64()),
        "s_bround": pa.array(fsum(b1[irow[keep]]), pa.float64()),
        "s_round_int": pa.array(isum(r10), pa.int64()),
        "s_floor": pa.array(isum(np.floor(profit).astype(np.int64)),
                            pa.int64()),
        "s_ceil": pa.array(isum(np.ceil(profit).astype(np.int64)),
                           pa.int64()),
        "s_sqrt": pa.array(fsum(np.sqrt(sp)), pa.float64()),
        "s_ln": pa.array(fsum(ln, pos), pa.float64()),
        "n_ln": pa.array(np.bincount(gid[pos], minlength=g), pa.int64()),
        "s_log10": pa.array(fsum(np.log10(sp)), pa.float64()),
        "s_pow": pa.array(fsum(profit * profit), pa.float64()),
        "s_abs": pa.array(fsum(np.abs(profit)), pa.float64()),
        "s_sign": pa.array(fsum(np.sign(profit)), pa.float64())})


def _host_string(c: str) -> str:
    def pad(v, n, fill, left):
        if len(v) >= n:
            return v[:n]
        f = (fill * n)[:n - len(v)]
        return f + v if left else v + f
    return "|".join([c.replace("o", "0"), str(c.find("o") + 1),
                     pad(c, 8, "*", True), pad(c, 3, "#", False), c * 2,
                     c[::-1]])


def _q_fn_host(tables):
    irow, names, code = _item_cats(tables)
    kcode, n = np.unique(code[irow[irow >= 0]], return_counts=True)
    kc = names[kcode]
    rows: Dict[str, int] = {}
    for c, k in zip(kc.tolist(), n.tolist()):
        r = _host_string(c)
        rows[r] = rows.get(r, 0) + k
    keys = sorted(rows, key=lambda v: v.encode())
    return pa.table({"r": pa.array(keys, pa.string()),
                     "n": pa.array([rows[k] for k in keys], pa.int64())})


_ORACLES = {"q_fn_cv": _q_fn_cv, "q_fn_moments": _q_fn_moments,
            "q_fn_minmax_str": _q_fn_minmax_str,
            "q_fn_window_moments": _q_fn_window_moments,
            "q_fn_strings": _q_fn_strings, "q_fn_match": _q_fn_match,
            "q_fn_dates": _q_fn_dates, "q_fn_casts": _q_fn_casts,
            "q_fn_math": _q_fn_math, "q_fn_host": _q_fn_host}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    """The query's rows from numpy, pyarrow and Python over the same
    tables, in its output order (a ``MEMBER_COLUMNS`` cell holds the
    group's allowed values)."""
    return _ORACLES[name](tables)


def check(name: str, got: pa.Table, tables: Dict[str, pa.Table],
          want: pa.Table = None) -> None:
    """Hold ``got`` to the oracle (module docstring; ``want``, the
    oracle's rows when already computed); raises ``AssertionError``
    naming the first cell that differs."""
    if want is None:
        want = oracle(name, tables)
    assert got.column_names == want.column_names, \
        (name, got.column_names, want.column_names)
    assert got.num_rows == want.num_rows, (name, got.num_rows,
                                           want.num_rows)
    floats = set(FLOAT_COLUMNS[name])
    members = set(MEMBER_COLUMNS.get(name, ()))
    for c in got.column_names:
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        for i, (a, b) in enumerate(zip(g, w)):
            if c in members:
                ok = a in b
            elif c in floats:
                ok = (a is None and b is None) or (
                    a is not None and b is not None
                    and (a == b or (math.isnan(a) and math.isnan(b))
                         or math.isclose(a, b, rel_tol=FLOAT_RTOL)))
            else:
                ok = a == b and type(a) is type(b)
            assert ok, (name, c, i, a, b)

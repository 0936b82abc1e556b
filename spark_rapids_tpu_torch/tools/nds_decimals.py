"""SQL texts over the NDS tables with TPC-DS's money columns as
``DECIMAL(7,2)``, each with the nodes the planner places on the CPU and
an oracle that does not use the engine's expression code: exact integer
arithmetic on the cents, read from pyarrow's decimal buffers, and
Python's ``decimal`` for the few values that need more than 64 bits.

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_decimals as nd
    tables = nd.decimal_tables(nds.gen_tables(1 << 12))
    paths = nds.write_tables(tables, dir)
    s = nds.session_over_files(paths, None, device="cpu")
    nd.check("q_dec_keys", s.sql(nd.SQL_QUERIES["q_dec_keys"]).collect(),
             tables)

TPC-DS defines every money column as ``DECIMAL(7,2)`` (specification
v3, sections 2.3-2.4): ``decimal_tables`` rounds ``ss_sales_price``,
``ss_ext_sales_price``, ``ss_net_profit`` and ``i_current_price`` to
cents, half to even, and keeps them as ``decimal(7,2)``; the files are
written as Spark writes them, a decimal of at most 9 digits as INT32.

- ``q3``, ``q42``, ``q52``, ``q55``: the corpus texts as they stand,
  their sums ``decimal(17,2)``;
- ``q7``: its ``AVG(ss_sales_price)`` is a ``decimal(11,6)``, a CPU
  island, as the reference places a decimal average whose scaled sum
  could pass 18 digits;
- ``q_dec_keys``: ``GROUP BY ss_sales_price`` (a decimal key: Murmur3 of
  its unscaled long, one 64-bit K3 word) with a join to ``item``,
  ordered by a decimal sum;
- ``q_dec_arith``: ``+``, ``-``, an int times a decimal (a
  ``decimal(18,2)``, on the card), a division (``decimal(17,10)``),
  ``ROUND``, ``FLOOR``, ``CEIL``, ``ABS``, ``BETWEEN`` and ``IN``;
- ``q_dec_cast``: a narrowing cast that overflows to null, casts to and
  from int, double and string (double and string to decimal on the host,
  as the reference places them), and a decimal's string as a group key;
- ``q_dec_window``: a 3-row-frame ``SUM`` by store;
- ``q_dec_wide``: three sums past 18 digits (a ``decimal(19,1)``, a
  ``decimal(28,2)`` and a ``decimal(27,10)``), which the planner runs on
  the CPU and the reference cannot run at all.

``FALLBACK`` gives ``PhysicalPlan.fallback_nodes()`` for each text at
the default conf, at every partition count. ``check`` holds a result to
the oracle: decimals, integers and strings exactly, the
``FLOAT_COLUMNS`` within a relative ``FLOAT_RTOL``.
"""
from __future__ import annotations

import decimal
from typing import Dict, List

import numpy as np
import pyarrow as pa

from .. import nds
from ..nds import _dim, _np, _ss

__all__ = ["SQL_QUERIES", "QUERIES", "FALLBACK", "FLOAT_COLUMNS",
           "FLOAT_RTOL", "MONEY", "decimal_tables", "oracle", "check"]

FLOAT_RTOL = 1e-9

#: the money columns, ``decimal(7,2)`` in TPC-DS
MONEY = {"store_sales": ("ss_sales_price", "ss_ext_sales_price",
                         "ss_net_profit"),
         "item": ("i_current_price",)}
_MONEY_T = pa.decimal128(7, 2)

_ROWS3 = ("PARTITION BY ss_store_sk ORDER BY ss_sold_date_sk, ss_item_sk, "
          "ss_customer_sk, ss_ext_sales_price ROWS BETWEEN 2 PRECEDING AND "
          "CURRENT ROW")

SQL_QUERIES = {q: nds.SQL_QUERIES[q] for q in ("q3", "q42", "q52", "q55",
                                                 "q7")}
SQL_QUERIES.update({
    "q_dec_keys": """
SELECT /*+ UNIQUE(item) */ ss_sales_price, i_category_id,
       SUM(ss_ext_sales_price) AS rev, MIN(ss_net_profit) AS lo,
       MAX(ss_net_profit) AS hi, COUNT(*) AS n
FROM store_sales, item
WHERE ss_item_sk = i_item_sk AND i_current_price > 100
GROUP BY ss_sales_price, i_category_id
ORDER BY rev DESC, ss_sales_price, i_category_id
LIMIT 100
""",
    "q_dec_arith": """
SELECT ss_store_sk,
       SUM(ss_sales_price + ss_net_profit) AS s_add,
       SUM(ss_ext_sales_price - ss_net_profit) AS s_sub,
       MAX(ss_quantity * ss_sales_price) AS max_ext,
       MIN(ss_net_profit / ss_sales_price) AS min_ratio,
       SUM(ROUND(ss_net_profit, 1)) AS s_round,
       SUM(FLOOR(ss_net_profit)) AS s_floor,
       SUM(CEIL(ss_net_profit)) AS s_ceil,
       SUM(ABS(ss_net_profit)) AS s_abs,
       SUM(CASE WHEN ss_sales_price IN (5, 7.5, 22.25) THEN 1 ELSE 0 END)
           AS n_in,
       COUNT(*) AS n
FROM store_sales
WHERE ss_sales_price BETWEEN 10 AND 150
GROUP BY ss_store_sk
ORDER BY ss_store_sk
""",
    "q_dec_cast": """
SELECT p_str, COUNT(*) AS n, COUNT(ext5) AS n_fit, SUM(p_int) AS s_int,
       SUM(q_dec) AS s_qdec, SUM(p_dbl) AS s_dbl, SUM(p_back) AS s_back,
       SUM(q_str) AS s_str
FROM (SELECT CAST(ss_sales_price AS STRING) AS p_str,
             CAST(ss_ext_sales_price AS DECIMAL(5,2)) AS ext5,
             CAST(ss_net_profit AS INT) AS p_int,
             CAST(ss_quantity AS DECIMAL(5,0)) AS q_dec,
             CAST(ss_sales_price AS DOUBLE) AS p_dbl,
             CAST(CAST(ss_net_profit AS DOUBLE) AS DECIMAL(8,2)) AS p_back,
             CAST(CAST(ss_quantity AS STRING) AS DECIMAL(4,1)) AS q_str
      FROM store_sales
      WHERE ss_sales_price < 20) t
GROUP BY p_str
ORDER BY p_str
""",
    "q_dec_window": f"""
SELECT ss_store_sk, COUNT(*) AS n, SUM(CAST(s3 AS DECIMAL(8,2))) AS t3,
       MAX(s3) AS m3
FROM (SELECT ss_store_sk,
             SUM(ss_ext_sales_price) OVER ({_ROWS3}) AS s3
      FROM store_sales) t
GROUP BY ss_store_sk
ORDER BY ss_store_sk
""",
    "q_dec_wide": """
SELECT ss_store_sk,
       SUM(CAST(ss_net_profit AS DECIMAL(9,1))) AS s_narrowed,
       SUM(ss_quantity * ss_sales_price) AS s_ext,
       SUM(ss_net_profit / ss_sales_price) AS s_ratio
FROM store_sales
GROUP BY ss_store_sk
ORDER BY ss_store_sk
""",
})

QUERIES = tuple(SQL_QUERIES)

FALLBACK = {q: [] for q in QUERIES}
FALLBACK.update({
    "q7": ["HashAggregateExec"],
    "q_dec_cast": ["ProjectExec"],
    "q_dec_wide": ["SortExec", "ProjectExec", "HashAggregateExec"],
})

FLOAT_COLUMNS = {q: () for q in QUERIES}
FLOAT_COLUMNS.update({"q7": ("avg_q",), "q_dec_cast": ("s_dbl",)})


# --- tables -------------------------------------------------------------------

def _cents_of(x: np.ndarray) -> np.ndarray:
    return np.round(x * 100).astype(np.int64)


def _decimal_from_cents(cents: np.ndarray, t=_MONEY_T) -> pa.Array:
    """A decimal128 array whose unscaled values are ``cents``."""
    words = np.empty((len(cents), 2), np.int64)
    words[:, 0] = cents
    words[:, 1] = cents >> 63
    return pa.Array.from_buffers(t, len(cents),
                                 [None, pa.py_buffer(words)], null_count=0)


def decimal_tables(tables: Dict[str, pa.Table]) -> Dict[str, pa.Table]:
    """The tables with the money columns (``MONEY``) as ``decimal(7,2)``:
    each value rounded to cents, half to even."""
    out = dict(tables)
    for name, cols in MONEY.items():
        t = tables[name]
        for c in cols:
            i = t.schema.get_field_index(c)
            t = t.set_column(i, pa.field(c, _MONEY_T),
                             _decimal_from_cents(_cents_of(_np(t, c))))
        out[name] = t
    return out


# --- the oracle ---------------------------------------------------------------

def _cents(table: pa.Table, name: str) -> np.ndarray:
    """A decimal column's unscaled values: the low words of pyarrow's
    16-byte decimal128 values (every value here fits 64 bits)."""
    arr = table.column(name).combine_chunks()
    words = np.frombuffer(arr.buffers()[1], np.int64,
                          count=2 * (arr.offset + len(arr)))
    return words[0::2][arr.offset:].copy()


_CTX = decimal.Context(prec=80)


def _dec(values, scale: int, precision: int) -> pa.Array:
    return pa.array([None if v is None else
                     decimal.Decimal(int(v)).scaleb(-scale, _CTX)
                     for v in values], pa.decimal128(precision, scale))


def _groups(keys: List[np.ndarray]):
    """``(the distinct key tuples as columns, ascending, and each row's
    group)`` of non-negative integer keys: each key's codes joined in
    one int64."""
    codes, uniqs = None, []
    for k in keys:
        u, c = np.unique(k.astype(np.int64), return_inverse=True)
        uniqs.append(u)
        codes = c.reshape(-1) if codes is None \
            else codes * len(u) + c.reshape(-1)
    ucodes, inv = np.unique(codes, return_inverse=True)
    cols = []
    for u in reversed(uniqs):
        cols.append(u[ucodes % len(u)])
        ucodes = ucodes // len(u)
    return cols[::-1], inv.reshape(-1)


_SORTED: list = [None]


def _sorted(inv: np.ndarray):
    """The rows in group order and each group's first position (the
    last ``inv`` asked for is kept)."""
    c = _SORTED[0]
    if c is None or c[0] is not inv:
        order = np.argsort(inv, kind="stable")
        sinv = inv[order]
        starts = np.flatnonzero(np.r_[True, sinv[1:] != sinv[:-1]]) \
            if len(sinv) else np.zeros(0, np.int64)
        _SORTED[0] = c = (inv, order, starts, sinv[starts])
    return c[1:]


def _isum(inv: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Exact int64 group sums (every sum here stays far below 2^63)."""
    order, starts, gid = _sorted(inv)
    out = np.zeros(n, np.int64)
    if len(order):
        out[gid] = np.add.reduceat(vals.astype(np.int64)[order], starts)
    return out


def _imin(inv, vals, n, largest=False):
    order, starts, gid = _sorted(inv)
    fill = np.iinfo(np.int64).min if largest else np.iinfo(np.int64).max
    out = np.full(n, fill, np.int64)
    if len(order):
        ufunc = np.maximum if largest else np.minimum
        out[gid] = ufunc.reduceat(vals.astype(np.int64)[order], starts)
    return out


def _half_up_div(num: np.ndarray, den) -> np.ndarray:
    """``num / den`` rounded half away from zero, in int64."""
    den = np.broadcast_to(np.asarray(den, np.int64), num.shape)
    q, r = np.divmod(np.abs(num), np.abs(den))
    q = q + (2 * r >= np.abs(den))
    return np.where((num < 0) != (den < 0), -q, q)


def _year_brand(tables, moy, year, out_name):
    ss = tables["store_sales"]
    drow = _dim(tables, "date_dim", "d_date_sk", _ss(tables, "ss_sold_date_sk"),
                lambda dd: (_np(dd, "d_moy") == moy) & (
                    True if year is None else _np(dd, "d_year") == year))
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    ok = (drow >= 0) & (irow >= 0)
    y = _np(tables["date_dim"], "d_year")[drow[ok]]
    b = _np(tables["item"], "i_brand_id")[irow[ok]]
    (gy, gb), inv = _groups([y, b])
    s = _isum(inv, _cents(ss, "ss_ext_sales_price")[ok], len(gy))
    order = np.lexsort((gb, -s, gy))[:10]
    return pa.table({"d_year": pa.array(gy[order].astype(np.int32)),
                     "i_brand_id": pa.array(gb[order].astype(np.int32)),
                     out_name: _dec(s[order], 2, 17)})


def _by_item(tables, keep_dd, keep_it, key, out_name, limit):
    ss = tables["store_sales"]
    ok = np.ones(ss.num_rows, bool)
    if keep_dd is not None:
        ok &= _dim(tables, "date_dim", "d_date_sk",
                   _ss(tables, "ss_sold_date_sk"), keep_dd) >= 0
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"),
                keep_it)
    ok &= irow >= 0
    k = _np(tables["item"], key)[irow[ok]]
    (g,), inv = _groups([k])
    s = _isum(inv, _cents(ss, "ss_ext_sales_price")[ok], len(g))
    order = np.lexsort((g, -s))[:limit]
    return pa.table({key: pa.array(g[order].astype(np.int32)),
                     out_name: _dec(s[order], 2, 17)})


def _q3(tables):
    return _year_brand(tables, 11, None, "sum_agg")


def _q52(tables):
    return _year_brand(tables, 12, 2001, "ext_price")


def _q42(tables):
    return _by_item(tables, lambda dd: (_np(dd, "d_moy") == 12)
                    & (_np(dd, "d_year") == 2000), None, "i_category_id",
                    "s", None)


def _q55(tables):
    def keep(it):
        m = _np(it, "i_manufact_id")
        return (m >= 20) & (m < 40)
    return _by_item(tables, None, keep, "i_brand_id", "rev", 20)


def _q7(tables):
    ss = tables["store_sales"]
    drow = _dim(tables, "date_dim", "d_date_sk",
                _ss(tables, "ss_sold_date_sk"),
                lambda dd: _np(dd, "d_year") == 2001)
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"))
    ok = (drow >= 0) & (irow >= 0)
    (g,), inv = _groups([_np(tables["item"], "i_category_id")[irow[ok]]])
    n = np.bincount(inv, minlength=len(g)).astype(np.int64)
    qsum = _isum(inv, _ss(tables, "ss_quantity")[ok], len(g))
    psum = _isum(inv, _cents(ss, "ss_sales_price")[ok], len(g))
    # decimal(11,6): the cents' mean, HALF_UP at 6 places
    avg_p = _half_up_div(psum * 10_000, n)
    return pa.table({"i_category_id": pa.array(g.astype(np.int32)),
                     "avg_q": pa.array(qsum / n),
                     "avg_p": _dec(avg_p, 6, 11)})


def _q_dec_keys(tables):
    ss = tables["store_sales"]
    irow = _dim(tables, "item", "i_item_sk", _ss(tables, "ss_item_sk"),
                lambda it: _cents(it, "i_current_price") > 10_000)
    ok = irow >= 0
    price = _cents(ss, "ss_sales_price")[ok]
    cat = _np(tables["item"], "i_category_id")[irow[ok]]
    (gp, gc), inv = _groups([price, cat])
    m = len(gp)
    rev = _isum(inv, _cents(ss, "ss_ext_sales_price")[ok], m)
    profit = _cents(ss, "ss_net_profit")[ok]
    order = np.lexsort((gc, gp, -rev))[:100]
    return pa.table({
        "ss_sales_price": _dec(gp[order], 2, 7),
        "i_category_id": pa.array(gc[order].astype(np.int32)),
        "rev": _dec(rev[order], 2, 17),
        "lo": _dec(_imin(inv, profit, m)[order], 2, 7),
        "hi": _dec(_imin(inv, profit, m, largest=True)[order], 2, 7),
        "n": pa.array(np.bincount(inv, minlength=m)[order]
                      .astype(np.int64))})


def _q_dec_arith(tables):
    ss = tables["store_sales"]
    price = _cents(ss, "ss_sales_price")
    ok = (price >= 1000) & (price <= 15000)
    price = price[ok]
    ext = _cents(ss, "ss_ext_sales_price")[ok]
    profit = _cents(ss, "ss_net_profit")[ok]
    qty = _ss(tables, "ss_quantity")[ok].astype(np.int64)
    (g,), inv = _groups([_ss(tables, "ss_store_sk")[ok]])
    m = len(g)
    floor = np.floor_divide(profit, 100)
    ceil = -np.floor_divide(-profit, 100)
    return pa.table({
        "ss_store_sk": pa.array(g.astype(np.int64)),
        "s_add": _dec(_isum(inv, price + profit, m), 2, 18),
        "s_sub": _dec(_isum(inv, ext - profit, m), 2, 18),
        "max_ext": _dec(_imin(inv, qty * price, m, largest=True), 2, 18),
        "min_ratio": _dec(_imin(inv, _half_up_div(profit * 10 ** 10, price),
                                m), 10, 17),
        "s_round": _dec(_isum(inv, _half_up_div(profit, 10), m), 1, 17),
        "s_floor": _dec(_isum(inv, floor, m), 0, 16),
        "s_ceil": _dec(_isum(inv, ceil, m), 0, 16),
        "s_abs": _dec(_isum(inv, np.abs(profit), m), 2, 17),
        "n_in": pa.array(_isum(inv, np.isin(price, (500, 750, 2225))
                               .astype(np.int64), m)),
        "n": pa.array(np.bincount(inv, minlength=m).astype(np.int64))})


def _q_dec_cast(tables):
    ss = tables["store_sales"]
    price = _cents(ss, "ss_sales_price")
    ok = price < 2000
    price = price[ok]
    ext = _cents(ss, "ss_ext_sales_price")[ok]
    profit = _cents(ss, "ss_net_profit")[ok]
    qty = _ss(tables, "ss_quantity")[ok].astype(np.int64)
    # the price's plain string, the group key: byte order is the order
    # of the strings
    strs = np.array([f"{c // 100}.{c % 100:02d}" for c in price.tolist()],
                    dtype=object)
    uniq, inv = np.unique(strs, return_inverse=True)
    inv = inv.reshape(-1)
    m = len(uniq)
    p_int = np.trunc(profit / 100).astype(np.int64)
    return pa.table({
        "p_str": pa.array(uniq.tolist(), pa.string()),
        "n": pa.array(np.bincount(inv, minlength=m).astype(np.int64)),
        "n_fit": pa.array(_isum(inv, (np.abs(ext) < 100_000)
                                .astype(np.int64), m)),
        "s_int": pa.array(_isum(inv, p_int, m)),
        "s_qdec": _dec(_isum(inv, qty, m), 0, 15),
        "s_dbl": pa.array(np.bincount(inv, weights=price / 100,
                                      minlength=m)),
        "s_back": _dec(_isum(inv, profit, m), 2, 18),
        "s_str": _dec(_isum(inv, qty * 10, m), 1, 14)})


def _q_dec_window(tables):
    ss = tables["store_sales"]
    store = _ss(tables, "ss_store_sk")
    ext = _cents(ss, "ss_ext_sales_price")
    date, item = _ss(tables, "ss_sold_date_sk"), _ss(tables, "ss_item_sk")
    cust = _ss(tables, "ss_customer_sk")
    if item.max(initial=0) < 1 << 15 and cust.max(initial=0) < 1 << 16:
        # store, date, item and customer in one int64 (5 + 10 + 15 + 16
        # bits up to 2^22 rows), then the amount
        order = np.lexsort((ext, (store << 41) | (date << 31)
                            | (item << 16) | cust))
    else:
        order = np.lexsort((ext, cust, item, date, store))
    st, e = store[order], ext[order]
    s3 = e.copy()
    for back in (1, 2):
        same = np.zeros(len(e), bool)
        same[back:] = st[back:] == st[:-back]
        s3[back:] += np.where(same[back:], e[:-back], 0)
    (g,), inv = _groups([st])
    m = len(g)
    return pa.table({
        "ss_store_sk": pa.array(g.astype(np.int64)),
        "n": pa.array(np.bincount(inv, minlength=m).astype(np.int64)),
        "t3": _dec(_isum(inv, s3, m), 2, 18),
        "m3": _dec(_imin(inv, s3, m, largest=True), 2, 17)})


def _q_dec_wide(tables):
    ss = tables["store_sales"]
    price = _cents(ss, "ss_sales_price")
    profit = _cents(ss, "ss_net_profit")
    qty = _ss(tables, "ss_quantity").astype(np.int64)
    (g,), inv = _groups([_ss(tables, "ss_store_sk")])
    m = len(g)
    ratio = _half_up_div(profit * 10 ** 10, price)
    # exact at any size: the high and low 32 bits summed apart, joined in
    # Python's integers
    hi, lo = _isum(inv, ratio >> 32, m), _isum(inv, ratio & 0xFFFFFFFF, m)
    s_ratio = [int(h) * (1 << 32) + int(lo_) for h, lo_ in zip(hi, lo)]
    return pa.table({
        "ss_store_sk": pa.array(g.astype(np.int64)),
        "s_narrowed": _dec(_isum(inv, _half_up_div(profit, 10), m), 1, 19),
        "s_ext": _dec(_isum(inv, qty * price, m), 2, 28),
        "s_ratio": _dec(s_ratio, 10, 27)})


_ORACLES = {"q3": _q3, "q42": _q42, "q52": _q52, "q55": _q55, "q7": _q7,
            "q_dec_keys": _q_dec_keys, "q_dec_arith": _q_dec_arith,
            "q_dec_cast": _q_dec_cast, "q_dec_window": _q_dec_window,
            "q_dec_wide": _q_dec_wide}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    """The expected result of ``SQL_QUERIES[name]`` over
    ``decimal_tables``' tables."""
    return _ORACLES[name](tables)


def check(name: str, got: pa.Table, tables: Dict[str, pa.Table]) -> None:
    """Hold a result to the oracle: names, types, row order and values
    (module docstring)."""
    want = oracle(name, tables)
    assert got.column_names == want.column_names, \
        (name, got.column_names, want.column_names)
    assert got.schema.types == want.schema.types, \
        (name, got.schema.types, want.schema.types)
    assert got.num_rows == want.num_rows, (name, got.num_rows,
                                           want.num_rows)
    for c in got.column_names:
        g, w = got.column(c).to_pylist(), want.column(c).to_pylist()
        if c in FLOAT_COLUMNS[name]:
            np.testing.assert_allclose(np.array(g, float),
                                       np.array(w, float),
                                       rtol=FLOAT_RTOL, err_msg=f"{name}.{c}")
        else:
            assert g == w, (name, c, [(i, a, b) for i, (a, b) in
                                      enumerate(zip(g, w)) if a != b][:5])

"""Nested texts over a ``ticket`` table made from the NDS star schema,
each with the nodes the planner places on the CPU and an oracle in
pyarrow and numpy that does not use the engine's code.

    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.tools import nds_nested as nn
    tables = nn.nested_tables(nds.gen_tables(1 << 12))
    paths = nn.write_tables(tables, dir)
    s = nds.session_over_files(paths, None, device="cpu")
    nn.check("q_nest_explode", nn.plan(s, "q_nest_explode").collect(),
             tables)

``nested_tables`` groups consecutive ``store_sales`` rows into baskets of
1-16 lines (drawn from the seed), one ``ticket`` a basket, the shape of
an order with its line items or an event converted from JSON:

- ``t_ticket_sk`` (int64), ``t_store_sk`` and ``t_date_sk`` (the
  basket's first line's);
- ``t_customer``: ``struct<sk: int64, birth_year: int32>``, about 2%
  null;
- ``t_lines``: ``array<struct<item_sk: int64, quantity: int32,
  sales_price: double>>``, a line's ``sales_price`` null about 1% of the
  time, and about 1% of the arrays empty and 1% null (their lines are
  dropped);
- ``t_tags``: ``map<string, int32>``, 0-3 distinct keys from
  ``TAG_WORDS``, 1% null.

``write_tables`` writes every table in row groups of ``TICKET_ROW_GROUP``
(2^16) rows. The texts, DataFrame builders ``build(session, E)`` over an
expression namespace ``E`` (``namespace``: the expression classes and the
``dt`` module of either package, so one text runs through both) unless
SQL:

- ``q_nest_explode``: ``t_lines`` beside flat columns, exploded; each
  line's ``item_sk`` and ``quantity * sales_price``, joined to ``item``,
  summed by ``i_category``, ordered;
- ``q_nest_struct``: a filter on ``t_customer.birth_year`` and a limit
  (which compacts batches that hold ``t_lines`` and ``t_tags``), then
  ``size(t_lines)``: count, sum and average by ``t_store_sk``;
- ``q_nest_item``: ``t_lines[0].sales_price``, ``t_lines[20]`` (past
  every basket, so null), a ``named_struct`` of flat columns and
  ``map_keys``/``map_values`` of ``t_tags``, downloaded;
- ``q_nest_map``: ``posexplode_outer(t_tags)`` beside ``t_store_sk``,
  counted by key;
- ``q_collect`` (SQL over flat ``store_sales``): ``collect_list`` and
  ``collect_set`` by store;
- ``q_percentiles``: ``approx_percentile`` of ``ss_sales_price`` at
  ``[0.25, 0.5, 0.75]`` by store (the reference's SQL takes only a
  scalar percentage);
- ``q_nest_fallback``: grouped by ``t_customer`` and ordered by it, both
  on the CPU, then ``t_customer.birth_year`` on the device again, so a
  struct crosses both transitions;
- ``q_nest_roundtrip``: every ticket column downloaded after a filter.

``FALLBACK`` gives ``PhysicalPlan.fallback_nodes()`` for each text at
every partition count; ``nested_columns`` counts a table's nested
columns, each a host chunk of reason ``nested`` a row group on the
device-decode path (the flat ones decode on K5). ``check`` holds a result to the oracle: names,
Arrow types, row order, floats in ``FLOAT_COLUMNS`` within a relative
``FLOAT_RTOL``, the rest exactly.
"""
from __future__ import annotations

import math
import types
from typing import Dict

import numpy as np
import pyarrow as pa

from .. import nds

__all__ = ["QUERIES", "SQL_QUERIES", "BUILDERS", "FALLBACK",
           "FLOAT_COLUMNS", "FLOAT_RTOL", "TAG_WORDS", "TICKET_ROW_GROUP",
           "namespace", "nested_tables", "write_tables", "plan", "oracle",
           "check", "nested_columns"]

FLOAT_RTOL = 1e-9
TICKET_ROW_GROUP = 1 << 16
TAG_WORDS = ("gift", "promo", "online", "member", "return", "bulk", "vip",
             "weekend")
BIRTH_FLOOR = 1970
STRUCT_LIMIT = 200_000
ROUNDTRIP_DAYS = 365
PERCENTAGES = (0.25, 0.5, 0.75)

_CUSTOMER_T = pa.struct([("sk", pa.int64()), ("birth_year", pa.int32())])
_LINE_T = pa.struct([("item_sk", pa.int64()), ("quantity", pa.int32()),
                     ("sales_price", pa.float64())])
_LINES_T = pa.list_(_LINE_T)
_TAGS_T = pa.map_(pa.string(), pa.int32())


def namespace(expr_module, aggregates_module, dt_module):
    """``E``: a package's expression classes (its ``expr`` package and
    its aggregates) and its ``datatypes`` module as ``E.dt``."""
    names = {k: getattr(expr_module, k) for k in dir(expr_module)
             if not k.startswith("_")}
    names.update({k: getattr(aggregates_module, k)
                  for k in ("Sum", "Count", "Average", "Max", "CollectList",
                            "CollectSet", "ApproxPercentile")})
    names["dt"] = dt_module
    return types.SimpleNamespace(**names)


def port_namespace():
    from .. import datatypes, expr
    from ..expr import aggregates
    return namespace(expr, aggregates, datatypes)


# --- the texts ----------------------------------------------------------------

def _q_nest_explode(s, E):
    c = E.UnresolvedColumn
    line = c("col")
    lines = s.table("ticket").select(c("t_store_sk"), c("t_date_sk"),
                                     c("t_lines")).explode(c("t_lines"))
    amounts = lines.select(
        E.Alias(E.GetStructField(line, "item_sk"), "item_sk"),
        E.Alias(E.Multiply(E.Cast(E.GetStructField(line, "quantity"),
                                  E.dt.FLOAT64),
                           E.GetStructField(line, "sales_price")),
                "amount"))
    joined = amounts.join(s.table("item"), on=[("item_sk", "i_item_sk")])
    return joined.group_by(c("i_category")).agg(
        E.Alias(E.Sum(c("amount")), "revenue"),
        E.Alias(E.Count(), "n")).order_by(c("i_category"))


def _q_nest_struct(s, E):
    c = E.UnresolvedColumn
    kept = s.table("ticket").filter(E.GreaterThanOrEqual(
        E.GetStructField(c("t_customer"), "birth_year"),
        E.Literal(BIRTH_FLOOR, E.dt.INT32))).limit(STRUCT_LIMIT)
    sizes = kept.select(c("t_store_sk"),
                        E.Alias(E.Size(c("t_lines")), "n_lines"))
    return sizes.group_by(c("t_store_sk")).agg(
        E.Alias(E.Count(), "n"), E.Alias(E.Sum(c("n_lines")), "lines"),
        E.Alias(E.Average(c("n_lines")), "avg_lines")) \
        .order_by(c("t_store_sk"))


def _q_nest_item(s, E):
    c = E.UnresolvedColumn
    return s.table("ticket").select(
        c("t_ticket_sk"),
        E.Alias(E.GetStructField(E.GetArrayItem(
            c("t_lines"), E.Literal(0, E.dt.INT32)), "sales_price"),
            "first_price"),
        E.Alias(E.GetArrayItem(c("t_lines"), E.Literal(20, E.dt.INT32)),
                "line20"),
        E.Alias(E.CreateNamedStruct(["store", "date"],
                                    [c("t_store_sk"), c("t_date_sk")]),
                "key"),
        E.Alias(E.MapKeys(c("t_tags")), "tag_keys"),
        E.Alias(E.MapValues(c("t_tags")), "tag_vals"))


def _q_nest_map(s, E):
    c = E.UnresolvedColumn
    tags = s.table("ticket").select(c("t_store_sk"), c("t_tags")).explode(
        c("t_tags"), outer=True, position=True)
    return tags.group_by(c("key")).agg(
        E.Alias(E.Count(), "n"), E.Alias(E.Count(c("value")), "n_values"),
        E.Alias(E.Sum(c("value")), "total"),
        E.Alias(E.Max(c("pos")), "last_pos")).order_by(c("key"))


def _q_percentiles(s, E):
    c = E.UnresolvedColumn
    return s.table("store_sales").group_by(c("ss_store_sk")).agg(
        E.Alias(E.ApproxPercentile(c("ss_sales_price"), list(PERCENTAGES)),
                "p")).order_by(c("ss_store_sk"))


def _q_nest_fallback(s, E):
    c = E.UnresolvedColumn
    grouped = s.table("ticket").select(
        c("t_customer"), E.Alias(E.Size(c("t_lines")), "n_lines")) \
        .group_by(c("t_customer")).agg(
            E.Alias(E.Count(), "n"), E.Alias(E.Sum(c("n_lines")), "lines"))
    return grouped.order_by(c("t_customer")).select(
        c("t_customer"),
        E.Alias(E.GetStructField(c("t_customer"), "birth_year"), "by"),
        c("n"), c("lines"))


def _q_nest_roundtrip(s, E):
    c = E.UnresolvedColumn
    return s.table("ticket").filter(E.LessThan(
        c("t_date_sk"), E.Literal(ROUNDTRIP_DAYS, E.dt.INT64)))


BUILDERS = {"q_nest_explode": _q_nest_explode,
            "q_nest_struct": _q_nest_struct,
            "q_nest_item": _q_nest_item,
            "q_nest_map": _q_nest_map,
            "q_percentiles": _q_percentiles,
            "q_nest_fallback": _q_nest_fallback,
            "q_nest_roundtrip": _q_nest_roundtrip}

SQL_QUERIES = {"q_collect": """
SELECT ss_store_sk, collect_list(ss_quantity) AS qs,
       collect_set(ss_item_sk) AS items
FROM store_sales
GROUP BY ss_store_sk
ORDER BY ss_store_sk
"""}

QUERIES = ("q_nest_explode", "q_nest_struct", "q_nest_item", "q_nest_map",
           "q_collect", "q_percentiles", "q_nest_fallback",
           "q_nest_roundtrip")

FALLBACK = {q: [] for q in QUERIES}
FALLBACK["q_nest_fallback"] = ["SortExec", "HashAggregateExec",
                               "ShuffleExchangeExec"]

FLOAT_COLUMNS = {q: () for q in QUERIES}
FLOAT_COLUMNS.update({"q_nest_explode": ("revenue",),
                      "q_nest_struct": ("avg_lines",)})


def plan(session, name: str, E=None):
    """The text's DataFrame in ``session`` (``E`` the port's namespace by
    default)."""
    if name in SQL_QUERIES:
        return session.sql(SQL_QUERIES[name])
    return BUILDERS[name](session, E or port_namespace())


# --- tables -------------------------------------------------------------------

def _bitmap(valid: np.ndarray):
    if valid.all():
        return None
    return pa.py_buffer(np.packbits(valid, bitorder="little"))


def _list_array(t, offsets: np.ndarray, child, valid: np.ndarray):
    return pa.Array.from_buffers(
        t, len(offsets) - 1,
        [_bitmap(valid), pa.py_buffer(offsets.astype(np.int32))],
        null_count=int((~valid).sum()), children=[child])


def nested_tables(tables: Dict[str, pa.Table], seed: int = 7) \
        -> Dict[str, pa.Table]:
    """The tables plus ``ticket`` (module docstring)."""
    ss = tables["store_sales"]
    n = ss.num_rows
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 17, n // 4 + 16)
    t = int(np.searchsorted(np.cumsum(sizes), n)) + 1
    sizes = sizes[:t]
    sizes[-1] -= int(sizes.sum()) - n
    roll = rng.random(t)
    lines_null = roll < 0.01
    lines_empty = (roll >= 0.01) & (roll < 0.02)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    kept_sizes = np.where(lines_null | lines_empty, 0, sizes)
    line_rows = np.repeat(starts, kept_sizes) + (
        np.arange(int(kept_sizes.sum()))
        - np.repeat(np.cumsum(kept_sizes) - kept_sizes, kept_sizes))
    offsets = np.concatenate([[0], np.cumsum(kept_sizes)])

    def col(name):
        return ss.column(name).to_numpy()

    price = col("ss_sales_price")[line_rows]
    price_valid = rng.random(len(line_rows)) >= 0.01
    lines = pa.StructArray.from_arrays(
        [pa.array(col("ss_item_sk")[line_rows]),
         pa.array(col("ss_quantity")[line_rows]),
         pa.array(price, mask=~price_valid)],
        fields=list(_LINE_T))
    cust_sk = col("ss_customer_sk")[starts]
    birth = tables["customer"].column("c_birth_year").to_numpy()[cust_sk]
    cust_valid = rng.random(t) >= 0.02
    customer = pa.Array.from_buffers(
        _CUSTOMER_T, t, [_bitmap(cust_valid)],
        null_count=int((~cust_valid).sum()),
        children=[pa.array(cust_sk), pa.array(birth.astype(np.int32))])
    n_tags = rng.integers(0, 4, t)
    tags_valid = rng.random(t) >= 0.01
    n_tags = np.where(tags_valid, n_tags, 0)
    # 0-3 distinct words a map: the first k of a random permutation
    perms = np.argsort(rng.random((t, len(TAG_WORDS))), axis=1)
    pick = np.arange(len(TAG_WORDS))[None, :] < n_tags[:, None]
    words = np.array(TAG_WORDS, dtype=object)[perms[pick]]
    tag_offsets = np.concatenate([[0], np.cumsum(n_tags)])
    entries = pa.StructArray.from_arrays(
        [pa.array(words.tolist(), pa.string()),
         pa.array(rng.integers(1, 101, len(words)).astype(np.int32))],
        fields=[_TAGS_T.key_field, _TAGS_T.item_field])
    ticket = pa.table({
        "t_ticket_sk": pa.array(np.arange(t, dtype=np.int64)),
        "t_store_sk": pa.array(col("ss_store_sk")[starts]),
        "t_date_sk": pa.array(col("ss_sold_date_sk")[starts]),
        "t_customer": customer,
        "t_lines": _list_array(_LINES_T, offsets, lines, ~lines_null),
        "t_tags": _list_array(_TAGS_T, tag_offsets, entries, tags_valid),
    })
    out = dict(tables)
    out["ticket"] = ticket
    return out


def write_tables(tables: Dict[str, pa.Table], directory: str) \
        -> Dict[str, str]:
    """Every table's Parquet file (``nds.write_tables``) in row groups of
    ``TICKET_ROW_GROUP`` rows."""
    return nds.write_tables(tables, directory,
                            row_group_size=TICKET_ROW_GROUP)


def nested_columns(table: pa.Table) -> int:
    """The table's nested columns: its host chunks a row group on the
    device-decode path."""
    return sum(pa.types.is_nested(f.type) for f in table.schema)


# --- the oracle ---------------------------------------------------------------

def _np(arr) -> np.ndarray:
    return np.asarray(arr.to_numpy(zero_copy_only=False))


def _ticket(tables):
    return tables["ticket"].combine_chunks()


def _lines(ticket: pa.Table):
    """``(offsets, valid, item_sk, quantity, price, price_valid)`` of
    ``t_lines`` (offsets from 0, every ticket's)."""
    arr = ticket.column("t_lines").chunk(0)
    offs = _np(arr.offsets).astype(np.int64)
    vals = arr.values.slice(offs[0], offs[-1] - offs[0])
    offs = offs - offs[0]
    price = vals.field("sales_price")
    return (offs, _np(arr.is_valid()), _np(vals.field("item_sk")),
            _np(vals.field("quantity")),
            _np(price.fill_null(0.0)), _np(price.is_valid()))


def _group_sums(keys: np.ndarray, vals: np.ndarray, valid=None):
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    w = vals if valid is None else np.where(valid, vals, 0)
    return uniq, inv, np.bincount(inv, weights=w, minlength=len(uniq))


def _q_nest_explode_oracle(tables):
    ticket = _ticket(tables)
    _, _, item_sk, qty, price, pvalid = _lines(ticket)
    item = tables["item"]
    cat = np.asarray(item.column("i_category").to_pylist(), dtype=object)
    isk = _np(item.column("i_item_sk"))
    pos = np.searchsorted(isk, item_sk)
    cats = cat[pos]
    uniq, inv = np.unique(cats.astype(str), return_inverse=True)
    inv = inv.reshape(-1)
    amount = qty.astype(np.float64) * price
    revenue = np.zeros(len(uniq))
    np.add.at(revenue, inv[pvalid], amount[pvalid])
    has = np.bincount(inv[pvalid], minlength=len(uniq)) > 0
    return pa.table({
        "i_category": pa.array(uniq.tolist(), pa.string()),
        "revenue": pa.array(revenue, mask=~has),
        "n": pa.array(np.bincount(inv, minlength=len(uniq))
                      .astype(np.int64))})


def _by_store(stores: np.ndarray, cols: dict) -> pa.Table:
    return pa.table(dict({"t_store_sk": pa.array(stores)}, **cols))


def _q_nest_struct_oracle(tables):
    ticket = _ticket(tables)
    cust = ticket.column("t_customer").chunk(0)
    by = _np(cust.field("birth_year"))
    keep = _np(cust.is_valid()) & (by >= BIRTH_FLOOR)
    rows = np.flatnonzero(keep)[:STRUCT_LIMIT]
    offs, lvalid, *_ = _lines(ticket)
    size = (offs[1:] - offs[:-1])[rows]
    svalid = lvalid[rows]
    store = _np(ticket.column("t_store_sk"))[rows]
    uniq, inv = np.unique(store, return_inverse=True)
    inv = inv.reshape(-1)
    m = len(uniq)
    total = np.bincount(inv, weights=np.where(svalid, size, 0),
                        minlength=m).astype(np.int64)
    cnt = np.bincount(inv[svalid], minlength=m)
    return _by_store(uniq, {
        "n": pa.array(np.bincount(inv, minlength=m).astype(np.int64)),
        "lines": pa.array(total, mask=cnt == 0),
        "avg_lines": pa.array(total / np.maximum(cnt, 1), mask=cnt == 0)})


def _list_of(arr, child_name=None, child_index=None) -> pa.Array:
    """A list array over one child of a list or map array, its offsets
    and validity kept."""
    offs = _np(arr.offsets).astype(np.int64)
    base = offs[0]
    if child_index is not None:
        child = (arr.keys if child_index == 0 else arr.items)
    else:
        child = arr.values.field(child_name)
    child = child.slice(base, offs[-1] - base)
    t = pa.list_(child.type)
    return _list_array(t, offs - base, child, _np(arr.is_valid()))


def _q_nest_item_oracle(tables):
    ticket = _ticket(tables)
    offs, lvalid, _, _, price, pvalid = _lines(ticket)
    n = ticket.num_rows
    has = lvalid & (offs[1:] > offs[:-1])
    first = np.where(has, offs[:-1], 0)
    fp_valid = has & (pvalid[first] if len(pvalid) else has)
    tags = ticket.column("t_tags").chunk(0)
    return pa.table({
        "t_ticket_sk": ticket.column("t_ticket_sk"),
        "first_price": pa.array(price[first] if len(price)
                                else np.zeros(n), mask=~fp_valid),
        "line20": pa.nulls(n, _LINE_T),
        "key": pa.StructArray.from_arrays(
            [ticket.column("t_store_sk").chunk(0),
             ticket.column("t_date_sk").chunk(0)], names=["store", "date"]),
        "tag_keys": _list_of(tags, child_index=0),
        "tag_vals": _list_of(tags, child_index=1)})


def _q_nest_map_oracle(tables):
    tags = _ticket(tables).column("t_tags").chunk(0)
    offs = _np(tags.offsets).astype(np.int64)
    sizes = np.where(_np(tags.is_valid()), offs[1:] - offs[:-1], 0)
    keys = np.asarray(tags.keys.slice(offs[0], offs[-1] - offs[0])
                      .to_pylist(), dtype=object)
    vals = _np(tags.items.slice(offs[0], offs[-1] - offs[0]))
    pos = np.arange(len(keys)) - np.repeat(offs[:-1] - offs[0], sizes)
    uniq, inv = np.unique(keys.astype(str), return_inverse=True)
    inv = inv.reshape(-1)
    m = len(uniq)
    n = np.bincount(inv, minlength=m).astype(np.int64)
    total = np.bincount(inv, weights=vals, minlength=m).astype(np.int64)
    last = np.full(m, -1, np.int64)
    np.maximum.at(last, inv, pos)
    empties = int((sizes == 0).sum())
    return pa.table({
        "key": pa.array([None] + uniq.tolist(), pa.string()),
        "n": pa.array(np.r_[empties, n].astype(np.int64)),
        "n_values": pa.array(np.r_[0, n].astype(np.int64)),
        "total": pa.array(np.r_[0, total], pa.int64(),
                          mask=np.r_[True, np.zeros(m, bool)]),
        "last_pos": pa.array(np.r_[0, last].astype(np.int32),
                             mask=np.r_[True, np.zeros(m, bool)])})


def _grouped_values(tables, value: str):
    ss = tables["store_sales"]
    store = _np(ss.column("ss_store_sk"))
    vals = _np(ss.column(value))
    order = np.lexsort((vals, store))
    s, v = store[order], vals[order]
    uniq, starts = np.unique(s, return_index=True)
    return uniq, np.split(v, starts[1:])


def _q_collect_oracle(tables):
    stores, qs = _grouped_values(tables, "ss_quantity")
    _, items = _grouped_values(tables, "ss_item_sk")
    return pa.table({
        "ss_store_sk": pa.array(stores),
        "qs": pa.array([q.tolist() for q in qs], pa.list_(pa.int32())),
        "items": pa.array([np.unique(i).tolist() for i in items],
                          pa.list_(pa.int64()))})


def _q_percentiles_oracle(tables):
    stores, prices = _grouped_values(tables, "ss_sales_price")

    def rank0(p, n):
        return min(max(int(math.ceil(p * n)) - 1, 0), n - 1)
    return pa.table({
        "ss_store_sk": pa.array(stores),
        "p": pa.array([[float(v[rank0(p, len(v))]) for p in PERCENTAGES]
                       for v in prices], pa.list_(pa.float64()))})


def _q_nest_fallback_oracle(tables):
    ticket = _ticket(tables)
    cust = ticket.column("t_customer").chunk(0)
    cvalid = _np(cust.is_valid())
    sk = np.where(cvalid, _np(cust.field("sk")), -1)
    by = np.where(cvalid, _np(cust.field("birth_year")), -1)
    offs, lvalid, *_ = _lines(ticket)
    size = offs[1:] - offs[:-1]
    # a null struct groups apart and sorts first: key (valid, sk, by)
    key = np.stack([cvalid.astype(np.int64), sk, by.astype(np.int64)], 1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    m = len(uniq)
    cnt = np.bincount(inv[lvalid], minlength=m)
    lines = np.bincount(inv, weights=np.where(lvalid, size, 0),
                        minlength=m).astype(np.int64)
    valid = uniq[:, 0] == 1
    return pa.table({
        "t_customer": pa.Array.from_buffers(
            _CUSTOMER_T, m, [_bitmap(valid)],
            null_count=int((~valid).sum()),
            children=[pa.array(uniq[:, 1]),
                      pa.array(uniq[:, 2].astype(np.int32))]),
        "by": pa.array(uniq[:, 2].astype(np.int32), mask=~valid),
        "n": pa.array(np.bincount(inv, minlength=m).astype(np.int64)),
        "lines": pa.array(lines, mask=cnt == 0)})


def _q_nest_roundtrip_oracle(tables):
    ticket = _ticket(tables)
    return ticket.filter(pa.array(_np(ticket.column("t_date_sk"))
                                  < ROUNDTRIP_DAYS))


_ORACLES = {"q_nest_explode": _q_nest_explode_oracle,
            "q_nest_struct": _q_nest_struct_oracle,
            "q_nest_item": _q_nest_item_oracle,
            "q_nest_map": _q_nest_map_oracle,
            "q_collect": _q_collect_oracle,
            "q_percentiles": _q_percentiles_oracle,
            "q_nest_fallback": _q_nest_fallback_oracle,
            "q_nest_roundtrip": _q_nest_roundtrip_oracle}


def oracle(name: str, tables: Dict[str, pa.Table]) -> pa.Table:
    """The expected result of text ``name`` over ``nested_tables``'
    tables."""
    return _ORACLES[name](tables)


def check(name: str, got: pa.Table, tables: Dict[str, pa.Table],
          want: pa.Table = None) -> None:
    """Hold a result to the oracle (module docstring)."""
    if want is None:
        want = oracle(name, tables)
    assert got.column_names == want.column_names, \
        (name, got.column_names, want.column_names)
    assert got.schema.types == want.schema.types, \
        (name, got.schema.types, want.schema.types)
    assert got.num_rows == want.num_rows, (name, got.num_rows,
                                           want.num_rows)
    for c in got.column_names:
        g, w = got.column(c).combine_chunks(), want.column(c).combine_chunks()
        if c in FLOAT_COLUMNS[name]:
            assert _np(g.is_null()).tolist() == _np(w.is_null()).tolist(), \
                (name, c)
            np.testing.assert_allclose(_np(g.fill_null(0.0)),
                                       _np(w.fill_null(0.0)),
                                       rtol=FLOAT_RTOL, err_msg=f"{name}.{c}")
        elif not g.equals(w):
            gl, wl = g.to_pylist(), w.to_pylist()
            assert gl == wl, (name, c, [(i, a, b) for i, (a, b) in
                                        enumerate(zip(gl, wl))
                                        if a != b][:5])

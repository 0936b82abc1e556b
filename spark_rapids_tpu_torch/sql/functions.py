"""SQL function registry: name -> expression constructor.

Counterpart of ``spark_rapids_tpu/sql/functions.py``. The names are the
reference's, so the compiler tells aggregates, window and scalar
functions apart as the reference does; the constructors map onto the
port's expressions. Ported: the aggregates ``sum``, ``count``, ``min``,
``max``, ``avg``, ``mean`` and ``approx_percentile`` (a scalar
percentage: a list returns an array, which raises naming ROADMAP item
2); the scalar functions ``if``,
``coalesce``, ``nullif``, ``least``, ``greatest``, ``abs`` and
``isnan``; every window function of the reference (``row_number``,
``rank``, ``dense_rank``, ``percent_rank``, ``ntile``, ``lag``,
``lead``). Every other name raises
``SqlAnalysisError(..., "unsupported_feature")`` naming the ROADMAP item
it waits for: the other aggregates item 8, the other scalar functions
item 13. An unknown name is ``unknown_function``, as in the
reference.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from ..expr.aggregates import (ApproxPercentile, Average, Count, Max,
                               Min, Sum)
from ..expr.arithmetic import Abs
from ..expr.conditional import Coalesce, Greatest, If, Least, NullIf
from ..expr.predicates import IsNaN
from ..expr.window import (DenseRank, Lag, Lead, NTile, PercentRank, Rank,
                           RowNumber)
from . import ast as A
from .errors import SqlAnalysisError

__all__ = ["SCALAR_FUNCTIONS", "AGGREGATE_FUNCTIONS",
           "WINDOW_FUNCTIONS", "is_aggregate_name", "build_scalar",
           "build_aggregate", "build_window", "dialect_function_names"]


def _err(msg, node: A.Node, detail: str, sql: str = ""):
    return SqlAnalysisError(msg, sql, node.loc, detail)


def _arity(name, node, args, lo, hi=None, sql=""):
    hi = lo if hi is None else hi
    if not (lo <= len(args) <= hi):
        want = str(lo) if lo == hi else f"{lo}..{hi}"
        raise _err(f"{name}() takes {want} argument(s), got "
                   f"{len(args)}", node, "bad_arity", sql)


def _unported(item: int) -> Callable:
    def build(node, args, sql):
        raise _err(f"{node.name}() is not ported yet (ROADMAP item "
                   f"{item})", node, "unsupported_feature", sql)
    return build


_SCALAR_NAMES = (
    "abs", "sqrt", "cbrt", "exp", "ln", "log", "log10", "log2", "pow",
    "power", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "floor", "ceil", "ceiling", "sign", "signum", "round", "bround",
    "isnan", "length", "char_length", "upper", "ucase", "lower", "lcase",
    "substring", "substr", "concat", "trim", "ltrim", "rtrim", "replace",
    "locate", "lpad", "rpad", "repeat", "reverse", "startswith",
    "endswith", "contains", "coalesce", "nullif", "least", "greatest",
    "if", "year", "month", "day", "dayofmonth", "quarter", "dayofweek",
    "weekday", "dayofyear", "last_day", "hour", "minute", "second",
    "date_add", "date_sub", "datediff", "add_months", "months_between",
    "trunc", "unix_timestamp", "from_unixtime")
_AGG_WAITING = ("first", "last", "stddev",
                "stddev_samp", "stddev_pop", "variance", "var_samp",
                "var_pop", "collect_list", "collect_set")


def _simple(cls, lo: int, hi=None):
    """A builder of ``cls`` over ``lo..hi`` arguments (``hi`` None:
    exactly ``lo``; -1: ``lo`` or more)."""
    def build(node, args, sql):
        if hi == -1:
            if len(args) < lo:
                raise _err(f"{node.name}() takes at least {lo} "
                           "arguments", node, "bad_arity", sql)
        else:
            _arity(node.name, node, args, lo, hi, sql)
        return cls(*args)
    return build


def _lit_arg(name, node: A.Func, i, types, what, sql=""):
    """The i-th AST argument, required to be a literal of given types."""
    a = node.args[i]
    if not isinstance(a, A.Lit) or not isinstance(a.value, types) \
            or isinstance(a.value, bool):
        raise _err(f"{name}() argument {i + 1} must be a {what} "
                   "literal", node, "literal_required", sql)
    return a.value


def _build_ntile(node, args, sql):
    _arity("ntile", node, args, 1, 1, sql)
    return NTile(_lit_arg("ntile", node, 0, int, "integer", sql))


def _build_offset(cls):
    def build(node, args, sql):
        name = node.name
        _arity(name, node, args, 1, 3, sql)
        offset = 1
        if len(node.args) >= 2:
            offset = _lit_arg(name, node, 1, int, "integer", sql)
        default = args[2] if len(args) == 3 else None
        return cls(args[0], offset, default)
    return build


def _build_count(node, args, sql):
    if node.star:
        return Count()
    _arity("count", node, args, 1, 1, sql)
    if isinstance(node.args[0], A.Lit) and node.args[0].value is not None:
        return Count()  # count(1) counts rows
    return Count(args[0])


def _build_approx_percentile(node, args, sql):
    _arity("approx_percentile", node, args, 2, 3, sql)
    pct = _lit_arg("approx_percentile", node, 1, (int, float),
                   "numeric", sql)
    acc = 10000
    if len(node.args) == 3:
        acc = _lit_arg("approx_percentile", node, 2, int, "integer",
                       sql)
    return ApproxPercentile(args[0], pct, acc)


SCALAR_FUNCTIONS: Dict[str, Callable] = dict(
    {n: _unported(13) for n in _SCALAR_NAMES},
    coalesce=_simple(Coalesce, 1, -1), nullif=_simple(NullIf, 2),
    least=_simple(Least, 2, -1), greatest=_simple(Greatest, 2, -1),
    abs=_simple(Abs, 1), isnan=_simple(IsNaN, 1),
    **{"if": _simple(If, 3)})
AGGREGATE_FUNCTIONS: Dict[str, Callable] = dict(
    {n: _unported(8) for n in _AGG_WAITING},
    sum=_simple(Sum, 1), count=_build_count, min=_simple(Min, 1),
    max=_simple(Max, 1), avg=_simple(Average, 1), mean=_simple(Average, 1),
    approx_percentile=_build_approx_percentile)
WINDOW_FUNCTIONS: Dict[str, Callable] = {
    "row_number": _simple(RowNumber, 0), "rank": _simple(Rank, 0),
    "dense_rank": _simple(DenseRank, 0),
    "percent_rank": _simple(PercentRank, 0), "ntile": _build_ntile,
    "lag": _build_offset(Lag), "lead": _build_offset(Lead)}


def is_aggregate_name(name: str) -> bool:
    return name in AGGREGATE_FUNCTIONS


def _no_distinct(node: A.Func, sql: str):
    if node.distinct:
        raise _err(f"{node.name}(DISTINCT ...) is not in the dialect "
                   "subset", node, "unsupported_feature", sql)


def _build(table: Dict[str, Callable], kind: str, node: A.Func,
           args: List, sql: str):
    _no_distinct(node, sql)
    b = table.get(node.name)
    if b is None:
        if kind == "scalar" and (node.name in AGGREGATE_FUNCTIONS
                                 or node.name in WINDOW_FUNCTIONS):
            other = "aggregate" if node.name in AGGREGATE_FUNCTIONS \
                else "window"
            raise _err(f"{other} function {node.name}() is not valid "
                       "here", node, "misplaced_function", sql)
        what = "function" if kind == "scalar" else f"{kind} function"
        raise _err(f"unknown {what} {node.name}()", node,
                   "unknown_function", sql)
    try:
        return b(node, args, sql)
    except (TypeError, ValueError) as e:
        raise _err(f"{node.name}(): {e}", node, "bad_arguments",
                   sql) from e


def build_scalar(node: A.Func, args: List, sql: str):
    return _build(SCALAR_FUNCTIONS, "scalar", node, args, sql)


def build_aggregate(node: A.Func, args: List, sql: str):
    return _build(AGGREGATE_FUNCTIONS, "aggregate", node, args, sql)


def build_window(node: A.Func, args: List, sql: str):
    return _build(WINDOW_FUNCTIONS, "window", node, args, sql)


def dialect_function_names() -> Dict[str, List[str]]:
    return {"scalar": sorted(SCALAR_FUNCTIONS),
            "aggregate": sorted(AGGREGATE_FUNCTIONS),
            "window": sorted(WINDOW_FUNCTIONS)}

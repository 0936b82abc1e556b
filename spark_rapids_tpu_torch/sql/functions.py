"""SQL function registry: name -> expression constructor.

Counterpart of ``spark_rapids_tpu/sql/functions.py``: every name of the
reference's ``_scalar_table`` (``:88-162``), ``_agg_table``
(``:187-209``) and window table, mapped onto the port's expressions. The
builders are the reference's, with ``_build_round`` and ``_build_log``;
a parameter Spark requires to be a literal (the pattern of
``startswith``/``endswith``/``contains``, ``replace``'s strings,
``locate``'s substring and position, the pads' length and fill,
``repeat``'s count, ``trunc``'s format, ``round``'s scale) is read from
the literal, where the reference hands the expressions its constructors
do not take, so its ``startswith``, ``endswith``, ``contains``,
``replace``, ``locate``, ``lpad``, ``rpad``, ``repeat`` and ``trunc``
fail when they run (ROADMAP "Things to know"). ``first`` and ``last``
take Spark's optional ``ignoreNulls`` literal. ``collect_list`` and
``collect_set`` build the collects (an array result); over a window they
raise ``SqlAnalysisError(..., "unsupported_feature")`` naming ROADMAP
item 8 (``sql/compiler.py``). An unknown name is ``unknown_function``, as
in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from ..expr import aggregates as G
from ..expr import datetime as D
from ..expr import math as M
from ..expr import strings as S
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
        return G.Count()
    _arity("count", node, args, 1, 1, sql)
    if isinstance(node.args[0], A.Lit) and node.args[0].value is not None:
        return G.Count()  # count(1) counts rows
    return G.Count(args[0])


def _build_approx_percentile(node, args, sql):
    _arity("approx_percentile", node, args, 2, 3, sql)
    pct = _lit_arg("approx_percentile", node, 1, (int, float),
                   "numeric", sql)
    acc = 10000
    if len(node.args) == 3:
        acc = _lit_arg("approx_percentile", node, 2, int, "integer",
                       sql)
    return G.ApproxPercentile(args[0], pct, acc)


def _with_literals(cls, n_args, spec, lo=None):
    """A builder of ``cls``: the arguments at the positions ``spec``
    names are literals (``{position: (types, what)}``), the rest
    expressions, passed in order; ``lo`` arguments at least (the rest
    take the constructor's defaults)."""
    def build(node, args, sql):
        _arity(node.name, node, args, n_args if lo is None else lo, n_args,
               sql)
        vals = []
        for i, a in enumerate(args):
            if i in spec:
                types, what = spec[i]
                vals.append(_lit_arg(node.name, node, i, types, what, sql))
            else:
                vals.append(a)
        return cls(*vals)
    return build


_STR = (str, "string")
_INT = (int, "integer")


def _build_round(half_even: bool):
    def build(node, args, sql):
        _arity(node.name, node, args, 1, 2, sql)
        digits = 0
        if len(node.args) == 2:
            digits = _lit_arg(node.name, node, 1, int, "integer", sql)
        return (M.BRound if half_even else M.Round)(args[0], digits)
    return build


def _build_log(node, args, sql):
    _arity(node.name, node, args, 1, 1, sql)
    return M.Log(args[0])


def _build_locate(node, args, sql):
    _arity("locate", node, args, 2, 3, sql)
    sub = _lit_arg("locate", node, 0, str, "string", sql)
    pos = 1
    if len(node.args) == 3:
        pos = _lit_arg("locate", node, 2, int, "integer", sql)
    return S.StringLocate(sub, args[1], pos)


def _build_first_last(cls):
    def build(node, args, sql):
        _arity(node.name, node, args, 1, 2, sql)
        ignore = False
        if len(node.args) == 2:
            a = node.args[1]
            if not isinstance(a, A.Lit) or not isinstance(a.value, bool):
                raise _err(f"{node.name}() argument 2 must be a boolean "
                           "literal", node, "literal_required", sql)
            ignore = a.value
        return cls(args[0], ignore)
    return build


_U = _simple
SCALAR_FUNCTIONS: Dict[str, Callable] = {
    "abs": _U(Abs, 1), "sqrt": _U(M.Sqrt, 1), "cbrt": _U(M.Cbrt, 1),
    "exp": _U(M.Exp, 1), "ln": _build_log, "log": _build_log,
    "log10": _U(M.Log10, 1), "log2": _U(M.Log2, 1),
    "pow": _U(M.Pow, 2), "power": _U(M.Pow, 2),
    "sin": _U(M.Sin, 1), "cos": _U(M.Cos, 1), "tan": _U(M.Tan, 1),
    "asin": _U(M.Asin, 1), "acos": _U(M.Acos, 1), "atan": _U(M.Atan, 1),
    "atan2": _U(M.Atan2, 2),
    "floor": _U(M.Floor, 1), "ceil": _U(M.Ceil, 1),
    "ceiling": _U(M.Ceil, 1),
    "sign": _U(M.Signum, 1), "signum": _U(M.Signum, 1),
    "round": _build_round(False), "bround": _build_round(True),
    "isnan": _U(IsNaN, 1),
    "length": _U(S.Length, 1), "char_length": _U(S.Length, 1),
    "upper": _U(S.Upper, 1), "ucase": _U(S.Upper, 1),
    "lower": _U(S.Lower, 1), "lcase": _U(S.Lower, 1),
    "substring": _U(S.Substring, 3), "substr": _U(S.Substring, 3),
    "concat": _U(S.ConcatStrings, 1, -1),
    "trim": _U(S.StringTrim, 1), "ltrim": _U(S.StringTrimLeft, 1),
    "rtrim": _U(S.StringTrimRight, 1),
    "replace": _with_literals(S.StringReplace, 3, {1: _STR, 2: _STR}),
    "locate": _build_locate,
    "lpad": _with_literals(S.StringLpad, 3, {1: _INT, 2: _STR}, lo=2),
    "rpad": _with_literals(S.StringRpad, 3, {1: _INT, 2: _STR}, lo=2),
    "repeat": _with_literals(S.StringRepeat, 2, {1: _INT}),
    "reverse": _U(S.Reverse, 1),
    "startswith": _with_literals(S.StartsWith, 2, {1: _STR}),
    "endswith": _with_literals(S.EndsWith, 2, {1: _STR}),
    "contains": _with_literals(S.Contains, 2, {1: _STR}),
    "coalesce": _U(Coalesce, 1, -1), "nullif": _U(NullIf, 2),
    "least": _U(Least, 2, -1), "greatest": _U(Greatest, 2, -1),
    "if": _U(If, 3),
    "year": _U(D.Year, 1), "month": _U(D.Month, 1),
    "day": _U(D.DayOfMonth, 1), "dayofmonth": _U(D.DayOfMonth, 1),
    "quarter": _U(D.Quarter, 1), "dayofweek": _U(D.DayOfWeek, 1),
    "weekday": _U(D.WeekDay, 1), "dayofyear": _U(D.DayOfYear, 1),
    "last_day": _U(D.LastDay, 1),
    "hour": _U(D.Hour, 1), "minute": _U(D.Minute, 1),
    "second": _U(D.Second, 1),
    "date_add": _U(D.DateAdd, 2), "date_sub": _U(D.DateSub, 2),
    "datediff": _U(D.DateDiff, 2), "add_months": _U(D.AddMonths, 2),
    "months_between": _U(D.MonthsBetween, 2),
    "trunc": _with_literals(D.TruncDate, 2, {1: _STR}),
    "unix_timestamp": _U(D.UnixTimestamp, 1),
    "from_unixtime": _U(D.FromUnixTime, 1),
}
AGGREGATE_FUNCTIONS: Dict[str, Callable] = {
    "sum": _U(G.Sum, 1), "count": _build_count,
    "min": _U(G.Min, 1), "max": _U(G.Max, 1),
    "avg": _U(G.Average, 1), "mean": _U(G.Average, 1),
    "first": _build_first_last(G.First), "last": _build_first_last(G.Last),
    "stddev": _U(G.StddevSamp, 1), "stddev_samp": _U(G.StddevSamp, 1),
    "stddev_pop": _U(G.StddevPop, 1),
    "variance": _U(G.VarianceSamp, 1), "var_samp": _U(G.VarianceSamp, 1),
    "var_pop": _U(G.VariancePop, 1),
    "collect_list": _U(G.CollectList, 1),
    "collect_set": _U(G.CollectSet, 1),
    "approx_percentile": _build_approx_percentile,
}
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

"""Comparisons, Kleene logic, null tests and ``In``.

Counterpart of ``spark_rapids_tpu/expr/predicates.py:33-489``, the
reference's device path. Spark semantics:
- comparisons propagate null (null op x -> null); ``EqualNullSafe``
  (``<=>``) never returns null;
- float order is Spark's total order, not IEEE: NaN is greater than
  everything and NaN == NaN; -0.0 == 0.0 (``_total_key_j``, ``:99``);
- strings compare unsigned and byte-wise, a shorter prefix first
  (``ops/strings.string_compare``);
- AND and OR are Kleene three-valued logic; NOT of null is null;
- ``x IN (v, ...)`` is null when x is null, true on a match, and null
  rather than false when the list holds a null (``:446-489``); a float
  matches as ``=`` does, so ``NaN IN (NaN)`` is true (Spark's
  ``ordering.equiv``; here the port follows Spark, not the reference,
  whose ``In`` tests IEEE equality).

A string compared with a non-null literal, and each string of an
``In`` list, is held against the literal's bytes without building the
literal as a column (``ops/strings.compare_with_literals``).

Decimals compare by their unscaled lanes once both sides share one type
(the analyzer casts them to their wider decimal, ``session._analyze``);
a decimal past 18 digits, on the host, by its two words
(``ops/decimals.orderable_words``). An ``In`` over a decimal matches an
integer or decimal item exactly at the column's scale (an item with
more digits than the column holds matches nothing) and a float item as
doubles, as Spark's ``InConversion`` widens them.
"""
from __future__ import annotations

import decimal
import math
from typing import Optional

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity, is_string_like
from ..ops import decimals as dec
from ..ops.strings import compare_with_literals, string_compare
from .base import Expression, Literal

__all__ = ["BinaryComparison", "EqualTo", "EqualNullSafe", "LessThan",
           "LessThanOrEqual", "GreaterThan", "GreaterThanOrEqual", "And",
           "Or", "Not", "IsNull", "IsNotNull", "IsNaN", "In", "float_lt",
           "float_eq"]


def float_lt(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``l < r`` in Spark's float order (NaN greatest)."""
    ln, rn = torch.isnan(l), torch.isnan(r)
    return ~ln & (rn | (l < r))


def float_eq(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``l == r`` in Spark's float order (NaN == NaN)."""
    return (l == r) | (torch.isnan(l) & torch.isnan(r))


def _literal_bytes(e: Expression) -> Optional[bytes]:
    """A non-null string literal's bytes, else None."""
    return e.string_bytes if isinstance(e, Literal) else None


def _all_true(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


class BinaryComparison(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def validate(self):
        left, right = self.children
        if left.dtype != right.dtype:
            raise TypeError(f"comparison children differ: {left.dtype} vs "
                            f"{right.dtype}")
        t = left.dtype
        if not (is_string_like(t) or dt.is_integral(t) or dt.is_floating(t)
                or isinstance(t, (dt.BooleanType, dt.DateType,
                                  dt.TimestampType, dt.DecimalType))):
            raise NotImplementedError(
                f"{t.simple_string()} comparison is not ported yet "
                "(ROADMAP item 2)")

    @property
    def dtype(self):
        return dt.BOOL

    def _raw(self, batch, ctx):
        """``(left validity, right validity, data)``: the comparison
        where both operands are valid (a validity of None: all valid).
        A non-null string literal against a column is not evaluated as a
        column."""
        left, right = self.children
        if is_string_like(left.dtype):
            lit_l, lit_r = _literal_bytes(left), _literal_bytes(right)
            if lit_r is not None and lit_l is None:
                col = left.eval_gpu(batch, ctx)
                cmp, = compare_with_literals(col, [lit_r])
                return col.validity, None, self._from_cmp(cmp)
            if lit_l is not None and lit_r is None:
                col = right.eval_gpu(batch, ctx)
                cmp, = compare_with_literals(col, [lit_l])
                return None, col.validity, self._from_cmp(-cmp)
        l = left.eval_gpu(batch, ctx)
        r = right.eval_gpu(batch, ctx)
        if is_string_like(left.dtype):
            data = self._from_cmp(string_compare(l, r))
        elif dt.is_wide_decimal(left.dtype):
            data = self._from_cmp(_wide_compare(l, r))
        elif dt.is_floating(left.dtype):
            data = self._float_cmp(l.data, r.data)
        else:
            data = self._op(l.data, r.data)
        return l.validity, r.validity, data

    def eval_gpu(self, batch, ctx):
        lv, rv, data = self._raw(batch, ctx)
        return GpuColumnVector(dt.BOOL, data, and_validity(lv, rv))

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


def _wide_compare(l: GpuColumnVector, r: GpuColumnVector) -> torch.Tensor:
    """-1, 0 or 1 a row: two wide decimals of one type, by their
    words."""
    lh, ll = dec.orderable_words(l)
    rh, rl = dec.orderable_words(r)
    lt = (lh < rh) | ((lh == rh) & (ll < rl))
    gt = (lh > rh) | ((lh == rh) & (ll > rl))
    return gt.to(torch.int32) - lt.to(torch.int32)


class EqualTo(BinaryComparison):
    symbol = "="

    @staticmethod
    def _op(l, r):
        return l == r

    @staticmethod
    def _float_cmp(l, r):
        return float_eq(l, r)

    @staticmethod
    def _from_cmp(cmp):
        return cmp == 0


class EqualNullSafe(EqualTo):
    """``<=>``: null-safe equality, never null."""
    symbol = "<=>"

    @property
    def nullable(self):
        return False

    def eval_gpu(self, batch, ctx):
        lv, rv, data = self._raw(batch, ctx)
        if lv is None and rv is None:
            return GpuColumnVector(dt.BOOL, data, None)
        lv = torch.ones_like(data) if lv is None else lv
        rv = torch.ones_like(data) if rv is None else rv
        data = torch.where(lv & rv, data, ~lv & ~rv)
        return GpuColumnVector(dt.BOOL, data, None)


class LessThan(BinaryComparison):
    symbol = "<"

    @staticmethod
    def _op(l, r):
        return l < r

    @staticmethod
    def _float_cmp(l, r):
        return float_lt(l, r)

    @staticmethod
    def _from_cmp(cmp):
        return cmp < 0


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    @staticmethod
    def _op(l, r):
        return l <= r

    @staticmethod
    def _float_cmp(l, r):
        return float_lt(l, r) | float_eq(l, r)

    @staticmethod
    def _from_cmp(cmp):
        return cmp <= 0


class GreaterThan(BinaryComparison):
    symbol = ">"

    @staticmethod
    def _op(l, r):
        return l > r

    @staticmethod
    def _float_cmp(l, r):
        return float_lt(r, l)

    @staticmethod
    def _from_cmp(cmp):
        return cmp > 0


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    @staticmethod
    def _op(l, r):
        return l >= r

    @staticmethod
    def _float_cmp(l, r):
        return float_lt(r, l) | float_eq(l, r)

    @staticmethod
    def _from_cmp(cmp):
        return cmp >= 0


class _BoolBinary(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def validate(self):
        if not all(c.dtype == dt.BOOL for c in self.children):
            raise TypeError(f"{self.word} children must be boolean")

    @property
    def dtype(self):
        return dt.BOOL

    def __repr__(self):
        return (f"({self.children[0]!r} {self.word} "
                f"{self.children[1]!r})")


class And(_BoolBinary):
    """Kleene AND: false & null = false, true & null = null."""
    word = "AND"

    def eval_gpu(self, batch, ctx):
        l = self.children[0].eval_gpu(batch, ctx)
        r = self.children[1].eval_gpu(batch, ctx)
        data = l.data & r.data
        if l.validity is None and r.validity is None:
            return GpuColumnVector(dt.BOOL, data, None)
        lvalid, rvalid = l.valid_mask(), r.valid_mask()
        lfalse = ~l.data & lvalid
        rfalse = ~r.data & rvalid
        # a null side leaves data garbage: only TRUE & TRUE stays TRUE
        data = data & lvalid & rvalid
        valid = (lvalid & rvalid) | lfalse | rfalse
        return GpuColumnVector(dt.BOOL, data, valid)


class Or(_BoolBinary):
    """Kleene OR: true | null = true, false | null = null."""
    word = "OR"

    def eval_gpu(self, batch, ctx):
        l = self.children[0].eval_gpu(batch, ctx)
        r = self.children[1].eval_gpu(batch, ctx)
        if l.validity is None and r.validity is None:
            return GpuColumnVector(dt.BOOL, l.data | r.data, None)
        lvalid, rvalid = l.valid_mask(), r.valid_mask()
        ltrue = l.data & lvalid
        rtrue = r.data & rvalid
        return GpuColumnVector(dt.BOOL, ltrue | rtrue,
                               (lvalid & rvalid) | ltrue | rtrue)


class Not(Expression):
    def __init__(self, child):
        self.children = (child,)

    def validate(self):
        if self.children[0].dtype != dt.BOOL:
            raise TypeError("NOT needs a boolean child")

    @property
    def dtype(self):
        return dt.BOOL

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        return GpuColumnVector(dt.BOOL, ~c.data, c.validity)

    def __repr__(self):
        return f"(NOT {self.children[0]!r})"


class _NullTest(Expression):
    def __init__(self, child):
        self.children = (child,)

    @property
    def dtype(self):
        return dt.BOOL

    @property
    def nullable(self):
        return False

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        valid = c.valid_mask() if c.validity is not None \
            else _all_true(batch.capacity, batch.device)
        return GpuColumnVector(dt.BOOL, self._test(c, valid), None)


class IsNull(_NullTest):
    @staticmethod
    def _test(c, valid):
        return ~valid


class IsNotNull(_NullTest):
    @staticmethod
    def _test(c, valid):
        return valid


class IsNaN(_NullTest):
    """``isnan(x)``: false for a null x."""

    def validate(self):
        if not dt.is_floating(self.children[0].dtype):
            raise TypeError("isnan needs a float child")

    @staticmethod
    def _test(c, valid):
        return torch.isnan(c.data) & valid


class In(Expression):
    """``value IN (literals...)``: null when the value is null; on no
    match, null when the list holds a null, else false."""

    def __init__(self, value: Expression, items):
        self.children = (value,)
        self.items = tuple(items)  # python literal values, None allowed

    @property
    def dtype(self):
        return dt.BOOL

    def validate(self):
        t = self.children[0].dtype
        if not (is_string_like(t) or dt.is_integral(t) or dt.is_floating(t)
                or isinstance(t, (dt.BooleanType, dt.DateType,
                                  dt.DecimalType))):
            raise NotImplementedError(
                f"IN over {t.simple_string()} is not ported yet (ROADMAP "
                "item 2)")

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        t = self.children[0].dtype
        has_null = any(v is None for v in self.items)
        m = torch.zeros(batch.capacity, dtype=torch.bool,
                        device=batch.device)
        items = [v for v in self.items if v is not None]
        if isinstance(t, dt.DecimalType):
            hits = _decimal_hits(c, t, items)
        elif is_string_like(t):
            hits = [cmp == 0 for cmp in compare_with_literals(
                c, [Literal(v, t).string_bytes for v in items])] \
                if items else []
        else:
            lits = [Literal(v, t) for v in items]
            hits = [torch.isnan(c.data) if dt.is_floating(t)
                    and math.isnan(lit.lane_value)
                    else c.data == lit.lane_value for lit in lits]
        for hit in hits:
            m = m | hit
        valid = c.validity
        if has_null:
            valid = and_validity(valid, m)
        return GpuColumnVector(dt.BOOL, m, valid)

    def __repr__(self):
        return f"({self.children[0]!r} IN {self.items!r})"


def _decimal_hits(c: GpuColumnVector, t: dt.DecimalType, items):
    """Each item's matches in a decimal column (the module docstring's
    rule)."""
    hits = []
    if any(isinstance(v, float) for v in items):
        x = dec.as_double(c)
    for v in items:
        if isinstance(v, float):
            hits.append(x == v)
            continue
        u = decimal.Decimal(v).scaleb(t.scale, dec.EXACT)
        if u != u.to_integral_value() \
                or abs(int(u)) >= dec.POW10[t.precision]:
            hits.append(torch.zeros(c.capacity, dtype=torch.bool,
                                    device=c.device))
        elif dt.is_wide_decimal(t):
            hits.append(torch.from_numpy(dec.to_ints(c) == int(u))
                        .to(c.device))
        else:
            hits.append(c.data == int(u))
    return hits

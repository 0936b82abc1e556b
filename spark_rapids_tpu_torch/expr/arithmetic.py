"""Arithmetic: ``Add``, ``Subtract``, ``Multiply``, ``Divide``,
``IntegralDivide``, ``Remainder``, ``Pmod``, ``UnaryMinus`` and ``Abs``.

Counterpart of ``spark_rapids_tpu/expr/arithmetic.py:58-320``, the
reference's device path (``eval_tpu``). Spark's non-ANSI semantics on
the fixed-width lanes:

- the result keeps the operands' type (float32 x float32 stays float32,
  rounded once an operation) and integers wrap two's-complement (Java
  overflow, ``_wrap_int``, ``:28``), as torch's integer ops do;
- ``/`` divides the operands' type; the analyzer makes it double when
  the operands are integral (``session._analyze``). A zero divisor gives
  null;
- ``DIV`` is long division truncated toward zero (torch's ``//``
  floors, so ``torch.div(..., rounding_mode="trunc")``) of the operands
  widened to long; a zero divisor gives null; ``INT64_MIN DIV -1`` wraps
  to ``INT64_MIN`` (that one quotient traps an x86 divide, so it is
  taken apart);
- ``%`` takes the dividend's sign (Java); ``pmod(a, n)`` is Spark's
  ``r = a % n; if (r < 0) (r + n) % n else r``, in the lane's own
  arithmetic (tinyint and smallint promote to int), so it is never
  negative for a positive ``n`` and ``pmod(-7, -3)`` is -1; a zero
  divisor gives null.

The reference's device path gives the same values under
``spark.sql.ansi.enabled`` (its ANSI raises live in its host path), and
so does the port.

Decimals (the reference's ``:37-56,112-207,339-354``) follow Spark's
``DecimalPrecision``: the analyzer casts an integral operand to a
decimal (``session._analyze``) and leaves two decimals as they are; the
result type is ``datatypes.decimal_result_type`` (``+``/``-``: the
larger scale and one more integral digit; ``*``: the sums; ``/``: at
least 6 fraction digits; ``%`` and ``pmod``: the smaller integral part;
``div``: a long). On the device the operands are rescaled to the
result's scale on their int64 lanes (``ops/decimals.py``) and ``/``
divides ``HALF_UP`` with a numerator of exactly the result's precision,
so nothing wraps. Where the result or an operand is past 18 digits, or
``%``, ``pmod`` or ``div`` would rescale an operand past them, the
planner puts the operator on the CPU (``gpu_supported``), and there the
operation runs on Python's integers (``_exact``): a result that does
not fit its precision is null (under ANSI it raises), a zero divisor
null. The reference keeps the left operand's type for ``+`` and ``-``
and never nulls an overflow; the port follows Spark.

Where the reference's device path and Spark part ways the port follows
Spark: the reference takes ``|INT64_MIN|``, which wraps, so its ``DIV``
and ``%`` of ``INT64_MIN`` by a divisor other than +-1 are wrong there;
and its ``pmod`` adds ``|n|`` to a negative ``%``, which is never
negative even where ``n`` is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity
from ..ops import decimals as dec
from .base import Expression, ExprError

__all__ = ["BinaryArithmetic", "Add", "Subtract", "Multiply", "Divide",
           "IntegralDivide", "Remainder", "Pmod", "UnaryMinus", "Abs"]

_I64_MIN = -(1 << 63)


def _check_lane(name: str, t: dt.DataType) -> None:
    if dt.is_nested(t):
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not ported yet (nested "
            "types, ROADMAP item 2)")
    if not (dt.is_integral(t) or dt.is_floating(t)
            or isinstance(t, dt.DecimalType)):
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not on the device")


def _trunc_div(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """int64 quotient truncated toward zero, ``r`` never 0; the one
    overflowing quotient, ``INT64_MIN / -1``, wraps to ``INT64_MIN``."""
    flip = (l == _I64_MIN) & (r == -1)
    q = torch.div(l, torch.where(flip, torch.ones_like(r), r),
                  rounding_mode="trunc")
    return torch.where(flip, -q, q)


def _nonzero(r: torch.Tensor):
    """``(r with 1 where it is 0, r != 0)``."""
    nz = r != 0
    return torch.where(nz, r, torch.ones_like(r)), nz


class BinaryArithmetic(Expression):
    symbol = "?"
    #: the ``decimal_result_type`` rule of this operator
    decimal_op = ""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def validate(self):
        left, right = self.children
        if left.dtype != right.dtype and not self.is_decimal:
            raise TypeError(
                f"{type(self).__name__} children differ: "
                f"{left.dtype} vs {right.dtype} (insert casts first)")
        _check_lane(type(self).__name__, left.dtype)
        _check_lane(type(self).__name__, right.dtype)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def is_decimal(self) -> bool:
        return isinstance(self.left.dtype, dt.DecimalType) \
            and isinstance(self.right.dtype, dt.DecimalType)

    @property
    def dtype(self):
        if self.is_decimal:
            return dt.decimal_result_type(self.decimal_op, self.left.dtype,
                                          self.right.dtype)
        return self.left.dtype

    # --- decimals -----------------------------------------------------------

    def _work_scale(self) -> int:
        """The scale both operands take on their lanes."""
        return self.dtype.scale

    #: the operands move to ``_work_scale`` on their lanes (not ``*`` or
    #: ``/``, whose lanes keep their scales)
    rescales = True

    def _on_lanes(self) -> bool:
        """Every operand, its rescaled form and the result within the
        int64 lane's 18 digits."""
        lt, rt, t = self.left.dtype, self.right.dtype, self.dtype
        if any(dt.is_wide_decimal(x) for x in (lt, rt, t)):
            return False
        s = self._work_scale()
        return not self.rescales or all(
            x.precision - x.scale + s <= dec.MAX_LANE_DIGITS
            for x in (lt, rt))

    def gpu_supported(self) -> Optional[str]:
        if self.is_decimal and not self._on_lanes():
            return (f"decimal {self.symbol} of "
                    f"{self.left.dtype.simple_string()} and "
                    f"{self.right.dtype.simple_string()} needs more than "
                    "the device's 18 digits")
        return None

    def _decimal_lanes(self, l: torch.Tensor, r: torch.Tensor):
        s = self._work_scale()
        return (dec.rescale(l, self.left.dtype.scale, s),
                dec.rescale(r, self.right.dtype.scale, s))

    def _exact_rows(self, a: np.ndarray, b: np.ndarray):
        """The unscaled results over Python ints (object arrays), before
        the overflow test, and the rows where they are defined."""
        raise NotImplementedError

    def _at_scale(self, a: np.ndarray, b: np.ndarray):
        """Both operands' unscaled values at the larger scale, and it."""
        s1, s2 = self.left.dtype.scale, self.right.dtype.scale
        s = max(s1, s2)
        return a * dec.POW10[s - s1], b * dec.POW10[s - s2], s

    def _to_result_scale(self, v: np.ndarray, scale: int) -> np.ndarray:
        return dec.round_ints(v, scale, self.dtype.scale)

    def _exact(self, l: GpuColumnVector, r: GpuColumnVector, valid,
               ctx) -> GpuColumnVector:
        """The host's exact form (module docstring)."""
        out, defined = self._exact_rows(dec.to_ints(l), dec.to_ints(r))
        ok = valid.cpu().numpy() & defined
        out = np.where(ok, out, 0)
        t = self.dtype
        if isinstance(t, dt.DecimalType):
            fit = dec.fits_ints(out, t.precision)
        else:  # div: a long, wrapped as Java's
            out = ((out + (1 << 63)) & ((1 << 64) - 1)) - (1 << 63)
            fit = np.ones(len(out), dtype=np.bool_)
        if ctx.ansi and bool((ok & ~fit).any()):
            raise ExprError(f"decimal overflow in {self.symbol} (ANSI "
                            "mode)")
        ok &= fit
        if isinstance(t, dt.DecimalType):
            return dec.column_from_ints(t, out, ok, l.device)
        return GpuColumnVector(t, torch.from_numpy(
            np.array(np.where(ok, out, 0), dtype=np.int64)).to(l.device),
            torch.from_numpy(ok).to(l.device))

    def eval_gpu(self, batch, ctx):
        l = self.left.eval_gpu(batch, ctx)
        r = self.right.eval_gpu(batch, ctx)
        valid = and_validity(l.validity, r.validity)
        if self.is_decimal and not self._on_lanes():
            return self._exact(l, r, valid if valid is not None
                               else l.valid_mask(), ctx)
        if self.is_decimal:
            data, ok = self._compute(*self._decimal_lanes(l.data, r.data))
            if isinstance(self.dtype, dt.DecimalType):
                # pmod's r + n can pass the result's precision: null
                ok = and_validity(ok, dec.fits(data, self.dtype.precision))
        else:
            data, ok = self._compute(l.data, r.data)
        return GpuColumnVector(self.dtype, data, and_validity(valid, ok))

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class Add(BinaryArithmetic):
    symbol = "+"
    decimal_op = "add"

    @staticmethod
    def _compute(l, r):
        return l + r, None

    def _exact_rows(self, a, b):
        a, b, s = self._at_scale(a, b)
        return self._to_result_scale(a + b, s), True


class Subtract(BinaryArithmetic):
    symbol = "-"
    decimal_op = "sub"

    @staticmethod
    def _compute(l, r):
        return l - r, None

    def _exact_rows(self, a, b):
        a, b, s = self._at_scale(a, b)
        return self._to_result_scale(a - b, s), True


class Multiply(BinaryArithmetic):
    """On the lanes the product's scale is already the result's, the
    sum of the operands' scales."""
    symbol = "*"
    decimal_op = "mul"
    rescales = False

    @staticmethod
    def _compute(l, r):
        return l * r, None

    def _decimal_lanes(self, l, r):
        return l, r

    def _exact_rows(self, a, b):
        return self._to_result_scale(
            a * b, self.left.dtype.scale + self.right.dtype.scale), True


class Divide(BinaryArithmetic):
    """Spark ``/`` over float or decimal operands (the analyzer casts
    integral ones to double): a zero divisor gives null, NaN in a float
    lane. A decimal quotient is the numerator scaled to the result's
    precision, divided ``HALF_UP``."""
    symbol = "/"
    decimal_op = "div"
    rescales = False

    def validate(self):
        super().validate()
        if not (dt.is_floating(self.left.dtype) or self.is_decimal):
            raise TypeError(f"/ needs float operands (the analyzer casts "
                            f"{self.left.dtype.simple_string()} to double)")

    def _compute(self, l, r):
        safe, nz = _nonzero(r)
        if self.is_decimal:
            return dec.div_half_up(l, safe), nz
        return torch.where(nz, l / safe,
                           torch.full_like(l, float("nan"))), nz

    def _decimal_lanes(self, l, r):
        shift = self.dtype.scale + self.right.dtype.scale \
            - self.left.dtype.scale
        return l * dec.POW10[shift], r

    def _exact_rows(self, a, b):
        nz = b != 0
        num = a * dec.POW10[self.right.dtype.scale + self.dtype.scale]
        den = np.where(nz, b, 1) * dec.POW10[self.left.dtype.scale]
        return dec.div_half_up_ints(num, den), nz


class IntegralDivide(BinaryArithmetic):
    """Spark ``div``: long division of integral or decimal operands,
    truncated (decimals at their larger scale)."""
    symbol = "div"

    def validate(self):
        super().validate()
        if not (dt.is_integral(self.left.dtype) or self.is_decimal):
            raise TypeError(f"div needs integral operands, got "
                            f"{self.left.dtype.simple_string()}")

    @property
    def dtype(self):
        return dt.INT64

    def _work_scale(self):
        return max(self.left.dtype.scale, self.right.dtype.scale)

    def _exact_rows(self, a, b):
        a, b, _ = self._at_scale(a, b)
        nz = b != 0
        b = np.where(nz, b, 1)
        q = np.abs(a) // np.abs(b)
        return np.where((a < 0) != (b < 0), -q, q), nz

    @staticmethod
    def _compute(l, r):
        safe, nz = _nonzero(r.to(torch.int64))
        return _trunc_div(l.to(torch.int64), safe), nz


def _java_rem(l: torch.Tensor, r: torch.Tensor, positive: bool):
    """``(l % r, r != 0)`` with the dividend's sign (Java), or Spark's
    ``pmod`` (module docstring); integers in int64, back in ``l``'s
    lane."""
    if l.is_floating_point():
        safe, nz = _nonzero(r)
        m = torch.fmod(l, safe)
        if positive:
            m = torch.where(m < 0, torch.fmod(m + safe, safe), m)
        return m, nz
    safe, nz = _nonzero(r.to(torch.int64))
    m = l.to(torch.int64)
    m = m - safe * _trunc_div(m, safe)
    if positive:
        # r + n in the lane's arithmetic: int wraps at 32 bits, long at
        # 64 (torch's int64 add), tinyint and smallint cannot overflow
        s = m + safe
        if l.dtype == torch.int32:
            s = s.to(torch.int32).to(torch.int64)
        m = torch.where(m < 0, s - safe * _trunc_div(s, safe), m)
    return m.to(l.dtype), nz


def _jrem(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Java's ``x % y`` over Python ints: the dividend's sign."""
    m = np.abs(x) % np.abs(y)
    return np.where(x < 0, -m, m)


class Remainder(BinaryArithmetic):
    """``%`` with Java's sign rule: the result takes the dividend's
    sign; decimals at their larger scale."""
    symbol = "%"
    decimal_op = "mod"
    positive = False

    def _work_scale(self):
        return max(self.left.dtype.scale, self.right.dtype.scale)

    def _compute(self, l, r):
        return _java_rem(l, r, positive=self.positive)

    def _exact_rows(self, a, b):
        a, b, s = self._at_scale(a, b)
        nz = b != 0
        b = np.where(nz, b, 1)
        m = _jrem(a, b)
        if self.positive:
            m = np.where(m < 0, _jrem(m + b, b), m)
        return self._to_result_scale(m, s), nz


class Pmod(Remainder):
    """Spark's ``pmod``: ``%``, then ``(r + n) % n`` where that is
    negative."""
    symbol = "pmod"
    positive = True


def _wide_unary(c: GpuColumnVector, fn) -> GpuColumnVector:
    """A wide decimal's ``fn`` over its Python ints (an object array),
    on the host (the value stays within its precision)."""
    out = dec.column_from_ints(c.dtype, fn(dec.to_ints(c)), None, c.device)
    return out.with_validity(c.validity)


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check_lane("unary minus", self.children[0].dtype)

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        if dt.is_wide_decimal(self.dtype):
            return _wide_unary(c, np.negative)
        return GpuColumnVector(self.dtype, -c.data, c.validity)

    def __repr__(self):
        return f"(-{self.children[0]!r})"


class Abs(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check_lane("abs", self.children[0].dtype)

    @property
    def dtype(self):
        return self.children[0].dtype

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        if dt.is_wide_decimal(self.dtype):
            return _wide_unary(c, np.abs)
        return GpuColumnVector(self.dtype, c.data.abs(), c.validity)

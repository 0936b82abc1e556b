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
so does the port. Decimal arithmetic (``result_decimal_type``, ``:37``)
raises ``NotImplementedError`` naming ROADMAP item 2.

Where the reference's device path and Spark part ways the port follows
Spark: the reference takes ``|INT64_MIN|``, which wraps, so its ``DIV``
and ``%`` of ``INT64_MIN`` by a divisor other than +-1 are wrong there;
and its ``pmod`` adds ``|n|`` to a negative ``%``, which is never
negative even where ``n`` is.
"""
from __future__ import annotations

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity
from .base import Expression

__all__ = ["BinaryArithmetic", "Add", "Subtract", "Multiply", "Divide",
           "IntegralDivide", "Remainder", "Pmod", "UnaryMinus", "Abs"]

_I64_MIN = -(1 << 63)


def _check_lane(name: str, t: dt.DataType) -> None:
    if isinstance(t, dt.DecimalType):
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not ported yet (decimal "
            "arithmetic, ROADMAP item 2)")
    if not (dt.is_integral(t) or dt.is_floating(t)):
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

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def validate(self):
        left, right = self.children
        if left.dtype != right.dtype:
            raise TypeError(
                f"{type(self).__name__} children differ: "
                f"{left.dtype} vs {right.dtype} (insert casts first)")
        _check_lane(type(self).__name__, left.dtype)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def dtype(self):
        return self.left.dtype

    def eval_gpu(self, batch, ctx):
        l = self.left.eval_gpu(batch, ctx)
        r = self.right.eval_gpu(batch, ctx)
        data, ok = self._compute(l.data, r.data)
        valid = and_validity(and_validity(l.validity, r.validity), ok)
        return GpuColumnVector(self.dtype, data, valid)

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class Add(BinaryArithmetic):
    symbol = "+"

    @staticmethod
    def _compute(l, r):
        return l + r, None


class Subtract(BinaryArithmetic):
    symbol = "-"

    @staticmethod
    def _compute(l, r):
        return l - r, None


class Multiply(BinaryArithmetic):
    symbol = "*"

    @staticmethod
    def _compute(l, r):
        return l * r, None


class Divide(BinaryArithmetic):
    """Spark ``/`` over float operands (the analyzer casts integral ones
    to double): a zero divisor gives null, NaN in the lane."""
    symbol = "/"

    def validate(self):
        super().validate()
        if not dt.is_floating(self.left.dtype):
            raise TypeError(f"/ needs float operands (the analyzer casts "
                            f"{self.left.dtype.simple_string()} to double)")

    @staticmethod
    def _compute(l, r):
        safe, nz = _nonzero(r)
        return torch.where(nz, l / safe,
                           torch.full_like(l, float("nan"))), nz


class IntegralDivide(BinaryArithmetic):
    """Spark ``div``: long division of integral operands, truncated."""
    symbol = "div"

    def validate(self):
        super().validate()
        if not dt.is_integral(self.left.dtype):
            raise TypeError(f"div needs integral operands, got "
                            f"{self.left.dtype.simple_string()}")

    @property
    def dtype(self):
        return dt.INT64

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


class Remainder(BinaryArithmetic):
    """``%`` with Java's sign rule: the result takes the dividend's
    sign."""
    symbol = "%"

    @staticmethod
    def _compute(l, r):
        return _java_rem(l, r, positive=False)


class Pmod(BinaryArithmetic):
    """Spark's ``pmod``: ``%``, then ``(r + n) % n`` where that is
    negative."""
    symbol = "pmod"

    @staticmethod
    def _compute(l, r):
        return _java_rem(l, r, positive=True)


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
        return GpuColumnVector(self.dtype, c.data.abs(), c.validity)

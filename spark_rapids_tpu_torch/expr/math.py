"""Math expressions.

Counterpart of ``spark_rapids_tpu/expr/math.py``, with Spark's rules:

- the unary functions (``_mk_unary``: sqrt, cbrt, exp, expm1, the trig
  and hyperbolic functions, signum, degrees, radians, rint) map a double
  to a double; ``sqrt`` of a negative is NaN;
- ``ln``/``log``, ``log10``, ``log2`` of a value at or below 0, and
  ``log1p`` at or below -1, are null, not NaN (``_LogBase``, ``Log1p``);
- ``pow``, ``atan2`` and ``hypot`` take two doubles (``_BinaryDouble``);
- ``floor`` and ``ceil`` of a double are a long, Java's ``(long)`` of the
  rounded value: saturated at the long's bounds, NaN to 0
  (``_FloorCeil``); of an integer, the value as a long;
- ``round`` is HALF_UP and ``bround`` HALF_EVEN (``Round``, ``BRound``).
  An integer rounds exactly in integer arithmetic (a negative scale
  rounds to tens, hundreds...). A double rounds through
  ``decimal`` on the CPU path, exactly as Spark's BigDecimal does; the
  device path scales by ``10^d`` in float64, which can differ in the last
  digit, so ``gpu_supported`` refuses a double's round as the
  reference's ``tpu_supported`` does (``:353-357``), and the planner
  puts its operator on the CPU whatever ``incompatibleOps`` says (the
  reference's planner reads the refusal before and apart from that
  switch).

Where the reference departs from Spark the port follows Spark: the
reference asserts a double input, so its SQL ``sqrt(int_col)``,
``pow(int_col, 2)`` and ``sign(int_col)`` fail; the port casts an
integer or float input to double, as Spark's analyzer does.

Decimals (the reference's ``:140-180,242-311``): the double functions
(``sqrt``, ``sign``, ``pow``...) take the decimal's value as a double,
as Spark's implicit cast does (``_as_double``). ``floor`` and ``ceil``
of a ``decimal(p,s)`` are a ``decimal(p-s+1,0)``; ``round``/``bround``
to ``d`` digits follow Spark 3.4's ``RoundBase``: ``decimal(p-s+1+
min(s,d), min(s,d))`` for ``d >= 0`` and ``decimal(max(p-s+1, 1-d), 0)``
rounded to ``10^-d`` for ``d < 0``; ``abs`` keeps the type. They round
the unscaled int64 lane exactly (``_decimal_round``); a decimal past 18
digits rounds over Python's integers on the host. The reference gives
``round`` the type ``decimal(p-(s-min(s,d)), min(s,d))``
(``ROUND(decimal(7,2), 1)`` is ``decimal(6,1)`` there, ``decimal(7,1)``
in Spark) and rounds a negative ``d`` to units; the port follows Spark
(ROADMAP "Things to know").
"""
from __future__ import annotations

import decimal
import math
from typing import Optional

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity, torch_dtype
from ..ops import decimals as dec
from .base import Expression

__all__ = ["UnaryMathExpression", "Sqrt", "Cbrt", "Exp", "Expm1", "Log",
           "Log10", "Log2", "Log1p", "Sin", "Cos", "Tan", "Asin", "Acos",
           "Atan", "Sinh", "Cosh", "Tanh", "Signum", "ToDegrees",
           "ToRadians", "Floor", "Ceil", "Rint", "Pow", "Atan2", "Hypot",
           "Round", "BRound"]

_F64 = torch.float64
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _check_number(name: str, t: dt.DataType) -> None:
    if dt.is_nested(t):
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not ported yet (nested "
            "types, ROADMAP item 2)")
    if not dt.is_numeric(t):
        raise TypeError(f"{name} needs a number, got {t.simple_string()}")


_as_double = dec.as_double


def _decimal_round(c: GpuColumnVector, out_t: dt.DecimalType, drop: int,
                   back: int, mode: str) -> GpuColumnVector:
    """The unscaled values with ``drop`` trailing digits rounded off
    (``mode``: ``half_up``, ``half_even``, ``floor`` or ``ceil``) and
    ``back`` zeros put back, as ``out_t``."""
    if drop <= 0:
        if dt.is_wide_decimal(c.dtype) or dt.is_wide_decimal(out_t):
            return dec.column_from_ints(out_t, dec.to_ints(c), None,
                                        c.device).with_validity(c.validity)
        return GpuColumnVector(out_t, c.data, c.validity)
    if dt.is_wide_decimal(c.dtype) or dt.is_wide_decimal(out_t):
        m = dec.POW10[drop]
        v = dec.to_ints(c)
        q = v // m  # floor
        if mode == "ceil":
            q = q + (v - q * m != 0)
        elif mode in ("half_up", "half_even"):
            a = np.abs(v) // m
            r2 = 2 * (np.abs(v) - a * m)
            up = (r2 > m) | ((r2 == m) & (
                True if mode == "half_up" else a % 2 == 1))
            q = np.where(v < 0, -(a + up), a + up)
        return dec.column_from_ints(out_t, q * dec.POW10[back], None,
                                    c.device).with_validity(c.validity)
    x = c.data
    if drop > dec.MAX_LANE_DIGITS:
        # |x| < 10^18: rounds to 0, floors to -1 or ceils to 1 (scaled)
        if mode == "floor":
            q = -(x < 0).to(torch.int64)
        elif mode == "ceil":
            q = (x > 0).to(torch.int64)
        else:
            q = torch.zeros_like(x)
    else:
        m = dec.POW10[drop]
        if mode in ("floor", "ceil"):
            q = torch.div(x, m, rounding_mode="floor")
            if mode == "ceil":
                q = q + (q * m != x).to(torch.int64)
        else:
            av = x.abs()
            a = torch.div(av, m, rounding_mode="floor")
            rem = av - a * m
            q = torch.sign(x) * (a + _round_up(rem, a, m, mode == "half_even")
                                 .to(torch.int64))
    return GpuColumnVector(out_t, q * dec.POW10[back], c.validity)


class UnaryMathExpression(Expression):
    """double -> double, elementwise."""

    fn = None

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check_number(self.pretty_name(), self.children[0].dtype)

    @property
    def dtype(self):
        return dt.FLOAT64

    def _compute(self, x: torch.Tensor):
        """``(values, extra validity or None)``."""
        return type(self).fn(x), None

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        data, extra = self._compute(_as_double(c))
        return GpuColumnVector(dt.FLOAT64, data,
                               and_validity(c.validity, extra))


def _mk_unary(name, fn, doc=""):
    return type(name, (UnaryMathExpression,),
                {"fn": staticmethod(fn), "__doc__": doc})


def _signum(x):
    # Java's Math.signum: NaN stays NaN (torch.sign gives 0), -0.0
    # stays -0.0
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


Sqrt = _mk_unary("Sqrt", torch.sqrt)
Cbrt = _mk_unary("Cbrt", lambda x: torch.sign(x) * torch.abs(x).pow(
    1.0 / 3.0))
Exp = _mk_unary("Exp", torch.exp)
Expm1 = _mk_unary("Expm1", torch.expm1)
Sin = _mk_unary("Sin", torch.sin)
Cos = _mk_unary("Cos", torch.cos)
Tan = _mk_unary("Tan", torch.tan)
Asin = _mk_unary("Asin", torch.asin)
Acos = _mk_unary("Acos", torch.acos)
Atan = _mk_unary("Atan", torch.atan)
Sinh = _mk_unary("Sinh", torch.sinh)
Cosh = _mk_unary("Cosh", torch.cosh)
Tanh = _mk_unary("Tanh", torch.tanh)
Signum = _mk_unary("Signum", _signum)
ToDegrees = _mk_unary("ToDegrees", torch.rad2deg)
ToRadians = _mk_unary("ToRadians", torch.deg2rad)
Rint = _mk_unary("Rint", torch.round)  # half to even, as Math.rint


class _LogBase(UnaryMathExpression):
    """A log is null for an input at or below 0 (Spark)."""

    def _compute(self, x):
        ok = x > 0
        return type(self).fn(torch.where(ok, x, torch.ones_like(x))), ok


Log = type("Log", (_LogBase,), {"fn": staticmethod(torch.log)})
Log10 = type("Log10", (_LogBase,), {"fn": staticmethod(torch.log10)})
Log2 = type("Log2", (_LogBase,), {"fn": staticmethod(torch.log2)})


class Log1p(UnaryMathExpression):
    def _compute(self, x):
        ok = x > -1.0
        return torch.log1p(torch.where(ok, x, torch.zeros_like(x))), ok


def saturate_to_long(x: torch.Tensor) -> torch.Tensor:
    """Java's ``(long)`` of a double already rounded to an integer:
    saturate at the bounds, NaN to 0."""
    big = x >= float(1 << 63)
    small = x <= float(-(1 << 63) - 1)
    mid = torch.where(big | small | torch.isnan(x), torch.zeros_like(x),
                      x).to(torch.int64)
    return torch.where(big, torch.full_like(mid, _I64_MAX),
                       torch.where(small, torch.full_like(mid, _I64_MIN),
                                   mid))


class _FloorCeil(Expression):
    """floor/ceil: a double to a long, an integer to itself as a long, a
    ``decimal(p,s)`` to a ``decimal(p-s+1,0)``."""

    is_ceil = False

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check_number(self.pretty_name(), self.children[0].dtype)

    @property
    def dtype(self):
        t = self.children[0].dtype
        if isinstance(t, dt.DecimalType):
            return dt.DecimalType(min(t.precision - t.scale + 1,
                                      dt.DecimalType.MAX_PRECISION), 0)
        return dt.INT64

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        t = self.children[0].dtype
        if isinstance(t, dt.DecimalType):
            return _decimal_round(c, self.dtype, t.scale, 0,
                                  "ceil" if self.is_ceil else "floor")
        if dt.is_integral(self.children[0].dtype):
            return GpuColumnVector(dt.INT64, c.data.to(torch.int64),
                                   c.validity)
        f = torch.ceil if self.is_ceil else torch.floor
        return GpuColumnVector(dt.INT64, saturate_to_long(f(_as_double(c))),
                               c.validity)


class Floor(_FloorCeil):
    is_ceil = False


class Ceil(_FloorCeil):
    is_ceil = True


class _BinaryDouble(Expression):
    fn = None

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def validate(self):
        for c in self.children:
            _check_number(self.pretty_name(), c.dtype)

    @property
    def dtype(self):
        return dt.FLOAT64

    def eval_gpu(self, batch, ctx):
        l = self.children[0].eval_gpu(batch, ctx)
        r = self.children[1].eval_gpu(batch, ctx)
        return GpuColumnVector(dt.FLOAT64,
                               type(self).fn(_as_double(l), _as_double(r)),
                               and_validity(l.validity, r.validity))


Pow = type("Pow", (_BinaryDouble,), {"fn": staticmethod(torch.pow)})
Atan2 = type("Atan2", (_BinaryDouble,), {"fn": staticmethod(torch.atan2)})
Hypot = type("Hypot", (_BinaryDouble,), {"fn": staticmethod(torch.hypot)})


def _round_up(rem: torch.Tensor, q: torch.Tensor, m, half_even: bool):
    """Whether a magnitude with quotient ``q`` and remainder ``rem`` by
    ``m`` rounds away from zero."""
    if half_even:
        return (rem * 2 > m) | ((rem * 2 == m) & (q % 2 == 1))
    return rem * 2 >= m


class Round(Expression):
    """round(x, d): HALF_UP (module docstring)."""

    half_even = False

    def __init__(self, child: Expression, digits: int = 0):
        self.children = (child,)
        self.digits = int(digits)

    def validate(self):
        _check_number(self.pretty_name(), self.children[0].dtype)

    @property
    def dtype(self):
        t = self.children[0].dtype
        if isinstance(t, dt.DecimalType):
            if self.digits < 0:
                return dt.DecimalType(min(max(t.precision - t.scale + 1,
                                              1 - self.digits),
                                          dt.DecimalType.MAX_PRECISION), 0)
            ns = min(t.scale, self.digits)
            return dt.DecimalType(min(t.precision - t.scale + 1 + ns,
                                      dt.DecimalType.MAX_PRECISION), ns)
        return t

    def gpu_supported(self) -> Optional[str]:
        if dt.is_floating(self.children[0].dtype):
            return ("round() on doubles uses float scaling on device "
                    "(BigDecimal-exact on CPU); enable via incompatibleOps")
        return None

    def _integral(self, c: GpuColumnVector) -> GpuColumnVector:
        t = self.dtype
        d = self.digits
        if d >= 0:
            return c
        v = c.data.to(torch.int64)
        if -d >= 19:
            # 10^19 passes the long: a magnitude from 5 x 10^18 (above it
            # for HALF_EVEN: the quotient 0 is even) rounds to 10^19,
            # which wraps as Java's longValue() does; 10^20 and up round
            # every long to 0
            mag = torch.where(v == _I64_MIN, torch.full_like(v, _I64_MAX),
                              v.abs())
            half = 5 * 10 ** 18
            up = (mag > half) if self.half_even else (mag >= half)
            if -d > 19:
                up = torch.zeros_like(up)
            wrapped = (10 ** 19 + (1 << 63)) % (1 << 64) - (1 << 63)
            out = torch.where(up, torch.sign(v) * wrapped,
                              torch.zeros_like(v))
            return GpuColumnVector(t, out.to(torch_dtype(t)), c.validity)
        m = 10 ** (-d)
        # the magnitude in int64: |INT64_MIN| wraps, so take it apart
        av = torch.where(v == _I64_MIN, torch.full_like(v, _I64_MAX),
                         v.abs())
        q = av // m
        rem = av - q * m + (v == _I64_MIN).to(torch.int64)
        up = _round_up(rem, q, m, self.half_even)
        out = torch.sign(v) * (q + up.to(torch.int64)) * m
        return GpuColumnVector(t, out.to(torch_dtype(t)), c.validity)

    def _double_scaled(self, x: torch.Tensor) -> torch.Tensor:
        """The device form (the reference's ``eval_tpu``): scale, round,
        unscale in float64."""
        m = 10.0 ** self.digits
        y = x.to(_F64) * m
        r = torch.round(y) if self.half_even \
            else torch.trunc(y + torch.sign(y) * 0.5)
        out = r / m
        return torch.where(torch.isfinite(x.to(_F64)), out, x.to(_F64))

    def _double_exact(self, x: torch.Tensor) -> torch.Tensor:
        """The CPU form: each value through ``decimal``, as Spark's
        BigDecimal, once a distinct value."""
        mode = decimal.ROUND_HALF_EVEN if self.half_even \
            else decimal.ROUND_HALF_UP
        quantum = decimal.Decimal(1).scaleb(-self.digits)
        vals = x.to(_F64).tolist()
        memo = {}
        out = []
        # a double has at most 767 significant digits: exact, like
        # BigDecimal, at any scale
        with decimal.localcontext() as dctx:
            dctx.prec = 800
            for v in vals:
                if not math.isfinite(v):
                    out.append(v)
                    continue
                r = memo.get(v)
                if r is None:
                    r = memo[v] = float(decimal.Decimal(v).quantize(
                        quantum, rounding=mode))
                out.append(r)
        return torch.tensor(out, dtype=_F64, device=x.device)

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        t = self.dtype
        src = self.children[0].dtype
        if isinstance(src, dt.DecimalType):
            d = self.digits
            return _decimal_round(
                c, t, src.scale - t.scale if d >= 0 else src.scale - d,
                max(-d, 0), "half_even" if self.half_even else "half_up")
        if dt.is_integral(t):
            return self._integral(c)
        x = c.data
        if ctx.host and x.device.type == "cpu":
            data = self._double_exact(x)
        else:
            data = self._double_scaled(x)
        return GpuColumnVector(t, data.to(torch_dtype(t)), c.validity)

    def __repr__(self):
        return f"{self.pretty_name()}({self.children[0]!r}, {self.digits})"


class BRound(Round):
    half_even = True

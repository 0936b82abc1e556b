"""Cast: the numeric, string, date and timestamp pairs.

Counterpart of ``spark_rapids_tpu/expr/cast.py`` (``Cast.eval_tpu``,
``_num_cast_tpu``, ``_from_string_tpu``, ``_to_string_tpu``, the host
path ``eval_cpu``), with Spark's non-ANSI rules as the reference's device
path applies them:

- integer narrowing wraps two's-complement (Java's ``(int)`` of a long);
- float -> integer is Java's narrowing (JLS 5.1.3): truncate toward
  zero, saturate at the bounds of long for a long and of int otherwise,
  NaN to 0; to tinyint or smallint the int then wraps, so
  ``cast(300.0 as tinyint)`` is 44. Here the port follows Spark, not the
  reference, which saturates at the target's own bounds
  (``_int_bounds``, ``:36``) and makes a NaN row null
  (``ok = ~isnan(x)``);
- integer or float -> boolean is ``x != 0``; boolean -> number is 0/1;
- string -> integral, float, boolean and date parse on the device
  (``ops/string_parse.py``; an unparsable row is null);
- integral, boolean, date and timestamp -> string format on the device
  (``ops/numeric_format.py``);
- date <-> timestamp (UTC), timestamp -> a number of seconds, an
  integer of seconds -> timestamp.

The placement is the reference's (``tpu_supported``, ``:56-85``):
string -> timestamp parses on the host; float -> string formats on the
host (Java's ``Double.toString``, ``_java_float_str``); under
``spark.sql.ansi.enabled`` every string parse runs on the host, which
raises ``ExprError`` on the first unparsable live row. ``gpu_supported``
and ``gpu_supported_conf`` refuse those, and the planner puts their
operator on the CPU, where ``eval_gpu`` runs under a host ctx and takes
the host path: the reference's Python parser (``_parse_string``) and
formatters.

Decimals (the reference's ``:132-160,207-220,244-262,456-494``), with
Spark's rules:

- decimal -> decimal rescales on the int64 lane, ``HALF_UP`` when the
  scale falls (``ops/decimals.rescale``); a value past the target's
  precision is null (``CAST(12345.67 AS DECIMAL(5,2))``);
- an integer or a boolean -> decimal is null past the precision;
- decimal -> integer truncates toward zero and, as Java's
  ``toLong.toInt``, wraps to a narrower integer (the reference nulls
  it); decimal -> float divides by ``10^scale`` in float64; decimal ->
  boolean is ``x != 0``;
- decimal -> string is Java's ``toPlainString`` on the device
  (``ops/numeric_format.decimal_to_string``);
- float -> decimal rounds Java's ``Double.toString`` form ``HALF_UP``
  (Spark's ``Decimal(double)``) and string -> decimal parses as the
  reference's host parser (``:418-425``): both run on the host, where
  the planner places them; NaN, infinities and unparsable strings are
  null.

Under ANSI an overflow raises ``ExprError`` instead: a cast that can
overflow runs on the host there (``gpu_supported_conf``), which checks
the live rows. A decimal past 18 digits on either side runs on the host
over Python's integers (``_decimal_host``).
"""
from __future__ import annotations

import datetime
import decimal
import math
import re
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity, \
    is_string_like, torch_dtype
from ..ops import decimals as dec
from ..ops import numeric_format as nf
from ..ops import string_parse as sp
from .base import Expression, ExprError, column_to_arrow
from .strings import _from_arrow

__all__ = ["Cast", "cast_supported", "int_bounds"]

_SIMPLE = (dt.BooleanType, dt.ByteType, dt.ShortType, dt.IntegerType,
           dt.LongType, dt.FloatType, dt.DoubleType)
_US_PER_SECOND = 1_000_000
_US_PER_DAY = 86400 * _US_PER_SECOND


def int_bounds(t: dt.DataType):
    """``(min, max)`` of an integral type's lane."""
    info = torch.iinfo(torch_dtype(t))
    return info.min, info.max


def _parses_to(t: dt.DataType) -> bool:
    return dt.is_integral(t) or dt.is_floating(t) \
        or isinstance(t, (dt.BooleanType, dt.DateType, dt.TimestampType))


def cast_supported(f: dt.DataType, t: dt.DataType) -> bool:
    """The pairs this port casts: identity, a NULL literal, any two of
    boolean, the integral, float and decimal types, a string to any of
    those or to a date or timestamp, any of those, a date or a timestamp
    to a string, date <-> timestamp, timestamp -> a number and an
    integer -> timestamp."""
    if f == t or isinstance(f, dt.NullType):
        return True
    simple = _SIMPLE + (dt.DecimalType,)
    if isinstance(f, simple) and isinstance(t, simple):
        return True
    if isinstance(f, dt.StringType):
        return _parses_to(t) or isinstance(t, dt.DecimalType)
    if isinstance(t, dt.StringType):
        return isinstance(f, simple + (dt.DateType, dt.TimestampType))
    if isinstance(f, dt.DateType):
        return isinstance(t, dt.TimestampType)
    if isinstance(f, dt.TimestampType):
        return isinstance(t, dt.DateType) or dt.is_integral(t) \
            or dt.is_floating(t)
    return dt.is_integral(f) and isinstance(t, dt.TimestampType)


def _float_to_int(x: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """Java's ``(long)``/``(int)``/``(short)``/``(byte)`` of a float:
    truncate, saturate at long's or int's bounds, NaN to 0, then wrap to
    a narrower ``t``. Saturation is where-based: a float lane cannot hold
    2^31 - 1 or 2^63 - 1 exactly."""
    if not isinstance(t, (dt.IntegerType, dt.LongType)):
        return _wrap_int(_float_to_int(x, dt.INT32), t)
    lo, hi = int_bounds(t)
    bits = torch.iinfo(torch_dtype(t)).bits
    trunc = torch.trunc(x.to(torch.float64))
    too_big = trunc >= float(1 << (bits - 1))
    too_small = trunc <= float(-(1 << (bits - 1)) - 1)
    mid = torch.where(too_big | too_small | torch.isnan(trunc),
                      torch.zeros_like(trunc), trunc).to(torch.int64)
    out = torch.where(too_big, torch.full_like(mid, hi),
                      torch.where(too_small, torch.full_like(mid, lo), mid))
    return out.to(torch_dtype(t))


def _wrap_int(x: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """Two's-complement narrowing: the low bits of the int64 value."""
    return x.to(torch.int64).to(torch_dtype(t))


class Cast(Expression):
    def __init__(self, child: Expression, to: dt.DataType):
        self.children = (child,)
        self._to = to

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self._to

    def validate(self):
        f, t = self.child.dtype, self._to
        if dt.is_nested(f) or dt.is_nested(t):
            raise NotImplementedError(
                f"cast {f.simple_string()} -> {t.simple_string()} is not "
                "ported yet (nested types, ROADMAP item 2)")
        if not cast_supported(f, t):
            raise NotImplementedError(
                f"cast {f.simple_string()} -> {t.simple_string()} is not "
                "supported")

    def _may_overflow(self) -> bool:
        """A value of the source type may not fit the target."""
        f, t = self.child.dtype, self._to
        if isinstance(t, dt.DecimalType):
            if isinstance(f, dt.DecimalType):
                return t.precision - t.scale < f.precision - f.scale \
                    or t.scale < f.scale
            if dt.is_integral(f):
                return t.precision - t.scale < dt.decimal_for(f).precision
            return isinstance(f, (dt.BooleanType, dt.StringType)) \
                or dt.is_floating(f)
        if isinstance(f, dt.DecimalType) and dt.is_integral(t):
            return f.precision - f.scale > len(str(int_bounds(t)[1])) - 1
        return False

    def gpu_supported(self) -> Optional[str]:
        f, t = self.child.dtype, self._to
        if dt.is_floating(f) and isinstance(t, dt.DecimalType):
            return ("float->decimal rounds Java's shortest decimal form; "
                    "runs on host")
        if isinstance(f, dt.StringType) and isinstance(t, dt.DecimalType):
            return f"cast {f} -> {t} runs on host (string parsing)"
        if isinstance(f, dt.StringType) and not is_string_like(t) \
                and not (dt.is_integral(t) or dt.is_floating(t)
                         or isinstance(t, (dt.BooleanType, dt.DateType))):
            return f"cast {f} -> {t} runs on host (string parsing)"
        if isinstance(t, dt.StringType) and dt.is_floating(f):
            return "float->string formatting runs on host (Java repr)"
        return None

    def gpu_supported_conf(self, conf) -> Optional[str]:
        f, t = self.child.dtype, self._to
        if conf.ansi and isinstance(f, dt.StringType) \
                and not is_string_like(t):
            return (f"ANSI cast {f} -> {t} raises on invalid input; "
                    "runs on host")
        if conf.ansi and self._may_overflow():
            return (f"ANSI cast {f} -> {t} raises on overflow; runs on "
                    "host")
        return None

    def eval_gpu(self, batch, ctx):
        f, t = self.child.dtype, self._to
        c = self.child.eval_gpu(batch, ctx)
        if f == t:
            return c
        if isinstance(f, dt.NullType):
            return GpuColumnVector.nulls(t, batch.capacity, batch.device)
        if isinstance(f, dt.DecimalType) or isinstance(t, dt.DecimalType):
            return self._decimal_cast(c, f, t, ctx, batch)
        if isinstance(f, dt.StringType):
            if ctx.host:
                return self._from_string_host(c, t, ctx, batch)
            return self._from_string(c, t)
        if isinstance(t, dt.StringType):
            if ctx.host:
                return self._to_string_host(c, f)
            return self._to_string(c, f)
        if isinstance(f, (dt.DateType, dt.TimestampType)) \
                or isinstance(t, dt.TimestampType):
            return GpuColumnVector(t, self._time_cast(c.data, f, t),
                                   c.validity)
        return GpuColumnVector(t, self._num_cast(c.data, f, t), c.validity)

    # --- strings ------------------------------------------------------------

    @staticmethod
    def _from_string(c: GpuColumnVector, t: dt.DataType) -> GpuColumnVector:
        if dt.is_integral(t):
            v, ok = sp.parse_int(c, t)
            v = v.to(torch_dtype(t))
        elif dt.is_floating(t):
            v, ok = sp.parse_float(c, t)
        elif isinstance(t, dt.BooleanType):
            v, ok = sp.parse_bool(c)
        elif isinstance(t, dt.DateType):
            v, ok = sp.parse_date(c)
        else:
            raise NotImplementedError(
                f"cast string -> {t.simple_string()} runs on the CPU, "
                "where the planner places it")
        return GpuColumnVector(t, v, and_validity(c.validity, ok))

    @staticmethod
    def _from_string_host(c, t, ctx, batch) -> GpuColumnVector:
        """The reference's host parser, each distinct string once; under
        ANSI an unparsable live row raises."""
        arr = column_to_arrow(c, c.capacity)
        vals = arr.to_pylist()
        memo = {}
        out = []
        for v in vals:
            if v is None:
                out.append(None)
                continue
            if v not in memo:
                memo[v] = _parse_string(v, t)
            out.append(memo[v])
        if ctx.ansi:
            live = batch.live_mask().tolist()
            for v, o, lv in zip(vals, out, live):
                if lv and v is not None and o is None:
                    raise ExprError(f"invalid input for cast to {t}: "
                                    f"{v!r}")
        return _from_arrow(pa.array(out, dt.to_arrow(t)), t, c.capacity,
                           c.device)

    @staticmethod
    def _to_string(c: GpuColumnVector, f: dt.DataType) -> GpuColumnVector:
        if dt.is_integral(f):
            return nf.int_to_string(c)
        if isinstance(f, dt.BooleanType):
            return nf.bool_to_string(c)
        if isinstance(f, dt.DateType):
            return nf.date_to_string(c)
        if isinstance(f, dt.TimestampType):
            return nf.timestamp_to_string(c)
        raise NotImplementedError(
            f"cast {f.simple_string()} -> string runs on the CPU, where the "
            "planner places it")

    @staticmethod
    def _to_string_host(c: GpuColumnVector, f: dt.DataType) \
            -> GpuColumnVector:
        """The reference's host formatting (``_to_string_cpu``)."""
        arr = column_to_arrow(c, c.capacity)
        if dt.is_floating(f):
            out = pa.array([None if v is None else _java_float_str(v)
                            for v in arr.to_pylist()], pa.string())
        elif isinstance(f, dt.TimestampType):
            strs = []
            for v in arr.to_pylist():
                if v is None:
                    strs.append(None)
                    continue
                text = v.strftime("%Y-%m-%d %H:%M:%S")
                if v.microsecond:
                    text += "." + f"{v.microsecond:06d}".rstrip("0")
                strs.append(text)
            out = pa.array(strs, pa.string())
        elif isinstance(f, dt.BooleanType):
            out = pa.array([None if v is None else ("true" if v else
                                                    "false")
                            for v in arr.to_pylist()], pa.string())
        else:
            out = pc.cast(arr, pa.string())
        return _from_arrow(out, dt.STRING, c.capacity, c.device)

    # --- decimals ---------------------------------------------------------

    def _decimal_cast(self, c, f, t, ctx, batch) -> GpuColumnVector:
        if dt.is_wide_decimal(f) or dt.is_wide_decimal(t) or (
                ctx.host and (dt.is_floating(f) or isinstance(
                    f, dt.StringType))):
            return self._decimal_host(c, f, t, ctx, batch)
        if isinstance(t, dt.StringType):
            return nf.decimal_to_string(c, f.scale)
        if isinstance(f, dt.StringType) or dt.is_floating(f):
            raise NotImplementedError(
                f"cast {f.simple_string()} -> {t.simple_string()} runs on "
                "the CPU, where the planner places it")
        data, ok, ansi_ok = _decimal_lanes(c.data, f, t)
        if ansi_ok is not None and ctx.ansi and ctx.host:
            bad = batch.live_mask() & c.valid_mask() & ~ansi_ok
            if bool(bad.any()):
                raise ExprError(f"cast {f.simple_string()} -> "
                                f"{t.simple_string()} overflows (ANSI)")
        return GpuColumnVector(t, data, and_validity(c.validity, ok))

    def _decimal_host(self, c, f, t, ctx, batch) -> GpuColumnVector:
        """Every decimal cast over Python values, once a distinct value:
        the path of a decimal past 18 digits, a float or a string
        source. A null result of a live, non-null row raises under
        ANSI."""
        if isinstance(f, dt.DecimalType):
            arr = pa.array(dec.to_decimals(c, f.scale),
                           pa.decimal128(dt.DecimalType.MAX_PRECISION,
                                         f.scale))
        else:
            arr = column_to_arrow(c, c.capacity)
        enc = pc.dictionary_encode(arr)
        if isinstance(f, dt.StringType):
            res = [_parse_decimal(v, t) for v in enc.dictionary.to_pylist()]
        else:
            res = [_decimal_value(v, f, t)
                   for v in enc.dictionary.to_pylist()]
        given = pc.is_valid(enc.indices).to_numpy(zero_copy_only=False)
        idx = pc.fill_null(enc.indices, 0).to_numpy(zero_copy_only=False)
        found = np.array([r is not None for r in res] + [False])[
            np.where(given, idx, len(res))]
        if ctx.ansi:
            bad = batch.live_mask().cpu().numpy() & given & ~found
            if bool(bad.any()):
                raise ExprError(f"cast {f.simple_string()} -> "
                                f"{t.simple_string()}: invalid or "
                                "overflowing input (ANSI)")
        if isinstance(t, dt.DecimalType):
            ints = np.array([0 if r is None else
                             int(r.scaleb(t.scale, dec.EXACT))
                             for r in res] + [0], dtype=object)
            return dec.column_from_ints(
                t, ints[np.where(given, idx, len(res))], found, c.device)
        out = pa.array(res, dt.to_arrow(t)).take(enc.indices)
        return _from_arrow(out, t, c.capacity, c.device)

    # --- dates and timestamps -------------------------------------------------

    @staticmethod
    def _time_cast(x: torch.Tensor, f: dt.DataType,
                   t: dt.DataType) -> torch.Tensor:
        x = x.to(torch.int64)
        if isinstance(f, dt.DateType):  # -> timestamp
            return x * _US_PER_DAY
        if isinstance(f, dt.TimestampType):
            if isinstance(t, dt.DateType):
                return torch.div(x, _US_PER_DAY, rounding_mode="floor") \
                    .to(torch.int32)
            if dt.is_floating(t):
                return (x.to(torch.float64) / 1e6).to(torch_dtype(t))
            return _wrap_int(torch.div(x, _US_PER_SECOND,
                                       rounding_mode="floor"), t)
        return x * _US_PER_SECOND  # integer seconds -> timestamp

    @staticmethod
    def _num_cast(x: torch.Tensor, f: dt.DataType,
                  t: dt.DataType) -> torch.Tensor:
        if isinstance(t, dt.BooleanType):
            return x != 0
        if isinstance(f, dt.BooleanType):
            return x.to(torch_dtype(t))
        if dt.is_floating(f) and dt.is_integral(t):
            return _float_to_int(x, t)
        if dt.is_integral(f) and dt.is_integral(t):
            return _wrap_int(x, t)
        return x.to(torch_dtype(t))

    def __repr__(self):
        return f"cast({self.child!r} as {self._to.simple_string()})"



def _decimal_lanes(x: torch.Tensor, f: dt.DataType, t: dt.DataType):
    """A Decimal64 cast on int64 lanes: ``(values, null where false or
    None, ANSI raises where false or None)`` (module docstring)."""
    if isinstance(f, dt.DecimalType) and isinstance(t, dt.DecimalType):
        if t.scale >= f.scale:
            k = t.scale - f.scale
            ok = dec.fits(x, t.precision - k)
            v = torch.where(ok, x, torch.zeros_like(x)) * dec.POW10[k]
            return v, ok, ok
        v = dec.rescale(x, f.scale, t.scale)
        ok = dec.fits(v, t.precision)
        return v, ok, ok
    if isinstance(f, dt.DecimalType):
        if isinstance(t, dt.BooleanType):
            return x != 0, None, None
        if dt.is_floating(t):
            return (x.to(torch.float64) / float(dec.POW10[f.scale])) \
                .to(torch_dtype(t)), None, None
        v = torch.div(x, dec.POW10[f.scale], rounding_mode="trunc")
        if isinstance(t, dt.LongType):
            return v, None, None
        lo, hi = int_bounds(t)
        # non-ANSI wraps, as Java's toLong.toInt; ANSI raises
        return _wrap_int(v, t), None, (v >= lo) & (v <= hi)
    if isinstance(f, dt.BooleanType):
        one = dec.POW10[t.scale] if t.precision > t.scale else 0
        ok = ~x if t.precision == t.scale else None
        return x.to(torch.int64) * one, ok, ok
    ok = dec.fits(x.to(torch.int64), t.precision - t.scale)
    v = torch.where(ok, x.to(torch.int64), torch.zeros((), dtype=torch.int64,
                                                       device=x.device))
    return v * dec.POW10[t.scale], ok, ok


def _decimal_value(v, f: dt.DataType, t: dt.DataType):
    """One value of a decimal cast on the host, None where Spark's
    non-ANSI cast gives null."""
    if isinstance(t, dt.DecimalType):
        if isinstance(v, float):
            if math.isnan(v) or math.isinf(v):
                return None
            v = decimal.Decimal(repr(v))
        elif isinstance(v, bool):
            v = decimal.Decimal(int(v))
        elif not isinstance(v, decimal.Decimal):
            v = decimal.Decimal(v)
        return _quantize(v, t)
    if isinstance(t, dt.StringType):
        return format(v, "f")
    if isinstance(t, dt.BooleanType):
        return v != 0
    if dt.is_floating(t):
        return float(v) if isinstance(t, dt.DoubleType) \
            else float(np.float32(float(v)))
    lo, hi = int_bounds(t)
    bits = hi.bit_length() + 1
    w = int(v) & ((1 << bits) - 1)  # truncated, then Java's wrap
    return w - (1 << bits) if w > hi else w


def _quantize(d: decimal.Decimal, t: dt.DecimalType):
    """``d`` at ``t``'s scale, ``HALF_UP``; None past its precision."""
    q = d.quantize(decimal.Decimal(1).scaleb(-t.scale, dec.EXACT),
                   rounding=decimal.ROUND_HALF_UP, context=dec.EXACT)
    unscaled = int(q.scaleb(t.scale, dec.EXACT))
    return q if abs(unscaled) < dec.POW10[t.precision] else None


def _parse_decimal(s: str, t: dt.DecimalType):
    """The reference's host parse of a decimal (``:418-425``): the
    trimmed text as a decimal, ``HALF_UP`` to the scale, None where it is
    not a number or does not fit."""
    try:
        d = decimal.Decimal(s.strip())
    except (decimal.InvalidOperation, ValueError):
        return None
    if not d.is_finite():
        return None
    return _quantize(d, t)


def _java_float_str(v: float) -> str:
    """Java's ``Double.toString`` as the reference's host path writes it
    (``spark_rapids_tpu/expr/cast.py:358``)."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == int(v) and abs(v) < 1e16:
        if v == 0 and math.copysign(1, v) < 0:
            return "-0.0"
        return f"{int(v)}.0"
    r = repr(v)
    if "e" in r or "E" in r:
        m, e = r.split("e")
        return f"{m}E{int(e)}"
    return r


_TS_FORMATS = ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
               "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d")


def _parse_string(s: str, t: dt.DataType):
    """The reference's host parser (``_parse_string``): a Python value,
    or None where Spark's non-ANSI cast gives null."""
    s = s.strip()
    try:
        if isinstance(t, dt.BooleanType):
            ls = s.lower()
            if ls in ("t", "true", "y", "yes", "1"):
                return True
            if ls in ("f", "false", "n", "no", "0"):
                return False
            return None
        if dt.is_integral(t):
            m = re.fullmatch(r"([+-]?\d+)(\.\d*)?", s)
            if m is None:
                return None
            v = int(m.group(1))
            lo, hi = int_bounds(t)
            return v if lo <= v <= hi else None
        if dt.is_floating(t):
            ls = s.lower()
            if ls == "nan":
                return float("nan")
            if ls in ("inf", "+inf", "infinity", "+infinity"):
                return float("inf")
            if ls in ("-inf", "-infinity"):
                return float("-inf")
            if re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?",
                            s) is None:
                return None
            v = float(s)
            return float(np.float32(v)) if isinstance(t, dt.FloatType) \
                else v
        if isinstance(t, dt.DateType):
            m = re.fullmatch(r"(\d{4})-(\d{1,2})-(\d{1,2})([T ].*)?", s)
            if not m:
                return None
            return datetime.date(int(m.group(1)), int(m.group(2)),
                                 int(m.group(3)))
        if isinstance(t, dt.TimestampType):
            for fmt in _TS_FORMATS:
                try:
                    return datetime.datetime.strptime(s, fmt).replace(
                        tzinfo=datetime.timezone.utc)
                except ValueError:
                    continue
            return None
    except (ValueError, OverflowError):
        return None
    return None

"""Cast between the boolean, integral and float types.

Counterpart of the numeric part of ``spark_rapids_tpu/expr/cast.py:41``
(``Cast.eval_tpu`` and ``_num_cast_tpu``), with Spark's non-ANSI rules
as the reference's device path applies them:

- integer narrowing wraps two's-complement (Java's ``(int)`` of a long);
- float -> integer is Java's narrowing (JLS 5.1.3): truncate toward
  zero, saturate at the bounds of long for a long and of int otherwise,
  NaN to 0; to tinyint or smallint the int then wraps, so
  ``cast(300.0 as tinyint)`` is 44. Here the port follows Spark, not the
  reference, which saturates at the target's own bounds
  (``_int_bounds``, ``:36``) and makes a NaN row null
  (``ok = ~isnan(x)``);
- integer or float -> boolean is ``x != 0``; boolean -> number is 0/1.

Under ``spark.sql.ansi.enabled`` the reference's device path gives the
same values (its overflow checks live in its host path), and so does
the port. Casts from or to string, decimal, date and timestamp raise
``NotImplementedError`` naming ROADMAP item 13 (the SQL compiler raises
``SqlAnalysisError("unsupported_feature")`` for them first): they are
not this slice's.
"""
from __future__ import annotations

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, torch_dtype
from .base import Expression

__all__ = ["Cast", "cast_supported", "int_bounds"]

_SIMPLE = (dt.BooleanType, dt.ByteType, dt.ShortType, dt.IntegerType,
           dt.LongType, dt.FloatType, dt.DoubleType)


def int_bounds(t: dt.DataType):
    """``(min, max)`` of an integral type's lane."""
    info = torch.iinfo(torch_dtype(t))
    return info.min, info.max


def cast_supported(f: dt.DataType, t: dt.DataType) -> bool:
    """The pairs this port casts: identity, a NULL literal, and any two
    of boolean and the integral and float types."""
    return f == t or isinstance(f, dt.NullType) or (
        isinstance(f, _SIMPLE) and isinstance(t, _SIMPLE))


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
        if not cast_supported(f, t):
            raise NotImplementedError(
                f"cast {f.simple_string()} -> {t.simple_string()} is not "
                "ported yet (string, decimal, date and timestamp casts, "
                "ROADMAP item 13)")

    def eval_gpu(self, batch, ctx):
        f, t = self.child.dtype, self._to
        c = self.child.eval_gpu(batch, ctx)
        if f == t:
            return c
        if isinstance(f, dt.NullType):
            return GpuColumnVector.nulls(t, batch.capacity, batch.device)
        return GpuColumnVector(t, self._num_cast(c.data, f, t), c.validity)

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

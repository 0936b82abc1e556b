"""Binary arithmetic: ``Subtract`` and ``Multiply``.

Counterpart of ``spark_rapids_tpu/expr/arithmetic.py:58-165``. Spark
semantics for the fixed-width lanes: the result keeps the operands' type
(float32 x float32 stays float32, rounded once per product); integers
wrap two's-complement (Java overflow), as torch's integer ops do.
Decimals, ``Add``/``Divide`` and the ANSI checks wait for a later
slice.
"""
from __future__ import annotations

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity
from .base import Expression

__all__ = ["BinaryArithmetic", "Subtract", "Multiply"]


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
        if not (dt.is_integral(left.dtype) or dt.is_floating(left.dtype)):
            raise NotImplementedError(
                f"{type(self).__name__} over "
                f"{left.dtype.simple_string()} is not on the device yet")

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
        return GpuColumnVector(self.dtype, self._compute(l.data, r.data),
                               and_validity(l.validity, r.validity))

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class Subtract(BinaryArithmetic):
    symbol = "-"

    @staticmethod
    def _compute(l, r):
        return l - r


class Multiply(BinaryArithmetic):
    symbol = "*"

    @staticmethod
    def _compute(l, r):
        return l * r

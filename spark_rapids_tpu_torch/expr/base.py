"""Expression framework.

Counterpart of ``spark_rapids_tpu/expr/base.py:37-305``. Every
expression evaluates eagerly over a ``GpuBatch`` with ``eval_gpu(batch,
ctx)`` and returns a ``GpuColumnVector`` (data lane + validity lane).
A string literal evaluates to its bytes once a row, as the reference's
does (``:186-200``).

The CPU path (the reference's ``eval_cpu``, ``:71,125,205,236``) is the
same code on CPU tensors: ``eval_cpu(rb, ctx)`` puts a host Arrow batch
into CPU tensors, runs ``eval_gpu`` under a host ``EvalCtx``
(``host=True``) and returns an Arrow array. The host flag is set only
inside an operator the planner placed on the CPU; an expression that the
device refuses (a LIKE pattern outside the device regex dialect) runs
its host branch there, and only there. ``BoundReference``, ``Literal``
and ``Alias`` answer on Arrow directly.

Expressions are constructed type-resolved: these classes require
already-coerced children.
"""
from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from .. import datatypes as dt
from ..columnar.arrow_bridge import arrow_to_device, device_to_arrow
from ..columnar.batch import GpuBatch
from ..columnar.column import GpuColumnVector, is_string_like, torch_dtype

__all__ = ["EvalCtx", "ExprError", "Expression", "BoundReference",
           "UnresolvedColumn", "Literal", "Alias", "bind_expr",
           "infer_literal_type", "column_to_arrow"]


@dataclasses.dataclass(frozen=True)
class EvalCtx:
    """Per-query evaluation context (immutable, like a conf snapshot)."""
    ansi: bool = False
    timezone: str = "UTC"
    # evaluating inside a CPU island (an operator the planner placed off
    # the device): the batches are CPU tensors and host-only branches run
    host: bool = False


class ExprError(Exception):
    """Raised for ANSI-mode runtime errors (overflow, bad cast, div by 0)."""


class Expression:
    """Base expression; children in the ``children`` tuple."""

    children: Tuple["Expression", ...] = ()

    @property
    def dtype(self) -> dt.DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children) if self.children \
            else True

    def pretty_name(self) -> str:
        return type(self).__name__

    def eval_gpu(self, batch: GpuBatch, ctx: EvalCtx) -> GpuColumnVector:
        raise NotImplementedError(type(self).__name__)

    def eval_cpu(self, rb: pa.RecordBatch, ctx: EvalCtx) -> pa.Array:
        """Spark's result over a host Arrow batch (module docstring):
        ``eval_gpu`` on CPU tensors under a host ctx."""
        batch = arrow_to_device(rb, None, torch.device("cpu"))
        col = self.eval_gpu(batch, dataclasses.replace(ctx, host=True))
        return column_to_arrow(col, rb.num_rows)

    def validate(self) -> None:
        """Type checks, run after binding (children types are known)."""

    def gpu_supported(self) -> Optional[str]:
        """None when the device can evaluate this node, else the reason
        the planner gives for placing its operator on the CPU (the
        reference's ``tpu_supported``). Children answer for
        themselves."""
        return None

    def gpu_supported_conf(self, conf) -> Optional[str]:
        """The same under the session's conf."""
        return None

    def with_children(self, children: Sequence["Expression"]) \
            -> "Expression":
        if not children and not self.children:
            return self
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)
        c.children = tuple(children)
        return c

    def transform(self, fn):
        """Bottom-up rewrite."""
        new_children = [c.transform(fn) for c in self.children]
        node = self.with_children(new_children) if new_children else self
        return fn(node)

    def __repr__(self):
        if self.children:
            return (f"{self.pretty_name()}("
                    + ", ".join(repr(c) for c in self.children) + ")")
        return self.pretty_name()


class BoundReference(Expression):
    """Column reference resolved to an ordinal (post-bind)."""

    def __init__(self, ordinal: int, dtype_: dt.DataType,
                 nullable_: bool = True, name: str = ""):
        self.ordinal = ordinal
        self._dtype = dtype_
        self._nullable = nullable_
        self.name = name or f"c{ordinal}"

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def eval_gpu(self, batch, ctx):
        return batch.columns[self.ordinal]

    def eval_cpu(self, rb, ctx):
        a = rb.column(self.ordinal)
        return a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a

    def __repr__(self):
        return f"{self.name}#{self.ordinal}"


class UnresolvedColumn(Expression):
    """Named column, resolved by ``bind_expr`` against a schema."""

    def __init__(self, name: str):
        self.name = name

    @property
    def dtype(self):
        raise TypeError(f"unresolved column {self.name!r} has no type; "
                        "bind the expression first")

    def __repr__(self):
        return f"'{self.name}"


def _lane_value(value, t: dt.DataType):
    if value is None:
        return None
    if isinstance(t, dt.DecimalType):
        # the unscaled value (the reference's ``:151-153``)
        from ..ops.decimals import EXACT
        return int(decimal.Decimal(value).scaleb(t.scale, EXACT))
    if isinstance(t, dt.DateType) and isinstance(value, datetime.date):
        return (value - datetime.date(1970, 1, 1)).days
    if isinstance(t, dt.TimestampType) \
            and isinstance(value, datetime.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=datetime.timezone.utc)
        return int(value.timestamp() * 1_000_000)
    if isinstance(t, (dt.DateType, dt.TimestampType)):
        return int(value)
    return value


class Literal(Expression):
    def __init__(self, value: Any, dtype_: Optional[dt.DataType] = None):
        if dtype_ is None:
            dtype_ = infer_literal_type(value)
        self._dtype = dtype_
        self.value = value
        self.lane_value = _lane_value(value, dtype_)

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    @property
    def string_bytes(self) -> Optional[bytes]:
        """A string or binary literal's bytes (None for other types)."""
        if self.value is None or not is_string_like(self._dtype):
            return None
        return self.value.encode() if isinstance(self.value, str) \
            else bytes(self.value)

    def eval_gpu(self, batch, ctx):
        cap = batch.capacity
        if self.value is None:
            return GpuColumnVector.nulls(self._dtype, cap, batch.device)
        raw = self.string_bytes
        if raw is not None:
            # the value once a row: cap x len(raw) chars, no readback
            offsets = torch.arange(cap + 1, dtype=torch.int32,
                                   device=batch.device) * len(raw)
            one = torch.frombuffer(bytearray(raw), dtype=torch.uint8) \
                if raw else torch.zeros(0, dtype=torch.uint8)
            chars = one.to(batch.device).repeat(cap)
            return GpuColumnVector(self._dtype, None, None, offsets, chars)
        if dt.is_wide_decimal(self._dtype):
            from ..ops.decimals import column_from_ints
            vals = np.empty(cap, dtype=object)
            vals[:] = self.lane_value
            return column_from_ints(self._dtype, vals, None, batch.device)
        data = torch.full((cap,), self.lane_value,
                          dtype=torch_dtype(self._dtype),
                          device=batch.device)
        return GpuColumnVector(self._dtype, data, None)

    def eval_cpu(self, rb, ctx):
        at = dt.to_arrow(self._dtype)
        if self.value is None:
            return pa.nulls(rb.num_rows, at)
        return pa.array([self.value] * rb.num_rows, type=at)

    def __repr__(self):
        return f"lit({self.value!r})"


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    @property
    def child(self):
        return self.children[0]

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return self.child.nullable

    def eval_gpu(self, batch, ctx):
        return self.child.eval_gpu(batch, ctx)

    def eval_cpu(self, rb, ctx):
        return self.child.eval_cpu(rb, ctx)

    def __repr__(self):
        return f"{self.children[0]!r} AS {self.name}"


def column_to_arrow(col: GpuColumnVector, n: int) -> pa.Array:
    """The first ``n`` rows of one column as an Arrow array."""
    schema = dt.Schema([dt.StructField("c", col.dtype, True)])
    return device_to_arrow(GpuBatch([col], schema, n)).column(0)


def infer_literal_type(value) -> dt.DataType:
    if value is None:
        return dt.NULL
    if isinstance(value, bool):
        return dt.BOOL
    if isinstance(value, int):
        return dt.INT32 if -(2**31) <= value < 2**31 else dt.INT64
    if isinstance(value, float):
        return dt.FLOAT64
    if isinstance(value, decimal.Decimal):
        # the reference's ``:245-262``: the literal's own digits and scale
        _, digits, exp = value.as_tuple()
        scale = max(0, -exp)
        return dt.DecimalType(max(len(digits) + max(exp, 0), scale, 1), scale)
    if isinstance(value, datetime.datetime):
        return dt.TIMESTAMP
    if isinstance(value, datetime.date):
        return dt.DATE
    if isinstance(value, str):
        return dt.STRING
    if isinstance(value, (bytes, bytearray)):
        return dt.BINARY
    raise TypeError(f"cannot infer a device literal type for {value!r}")


def bind_expr(expr: Expression, schema: dt.Schema,
              case_sensitive: bool = False,
              validate: bool = True) -> Expression:
    """Resolve ``UnresolvedColumn`` nodes to ``BoundReference`` ordinals."""

    def resolve(node):
        if isinstance(node, UnresolvedColumn):
            name = node.name
            if case_sensitive:
                idx = schema.index_of(name)
            else:
                matches = [i for i, f in enumerate(schema.fields)
                           if f.name.lower() == name.lower()]
                if not matches:
                    raise KeyError(
                        f"column {name!r} not found in {schema.names}")
                idx = matches[0]
            f = schema[idx]
            return BoundReference(idx, f.dtype, f.nullable, f.name)
        return node

    bound = expr.transform(resolve)
    if not validate:
        return bound

    def check(node):
        node.validate()
        return node

    bound.transform(check)
    return bound

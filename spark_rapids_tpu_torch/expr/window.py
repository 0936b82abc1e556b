"""Window expressions: frames, specs and the ranking and offset
functions.

The port's copy of ``spark_rapids_tpu/expr/window.py:34-313``
(``WindowFrame``, ``RowNumber``, ``Rank``, ``DenseRank``,
``PercentRank``, ``NTile``, ``Lag``, ``Lead``, ``WindowExpression``) over
the port's expressions. A ``WindowExpression`` packages a window function
(a ranking or offset function from this module, or one of the port's
aggregates) with its partition spec, order spec and frame. It is not
evaluable on its own: ``exec/window.GpuWindowExec`` computes every window
expression of one spec in one sorted, segmented pass.

``gpu_supported`` is the reference's device gate (``tpu_supported``,
``:247-303``). The planner reads it and places a window it refuses on
the CPU (``exec/window.py``'s host branches): RANGE offsets over
anything but one ascending integer or date key of at most 32 bits, a
lag or lead with a string default, and a decimal ``AVG`` or moment
(``:260-263``; a decimal ``SUM`` runs on the device while its result
keeps to 18 digits). Every aggregate of the
reference's window set computes over a frame (First, Last and the
central moments since item 8's rest); the collects wait for item 2.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import datatypes as dt
from .aggregates import (AggregateFunction, Average, Count, First, Last,
                         Max, Min, Sum, _CentralMoment)
from .base import Expression, Literal

__all__ = ["WindowFrame", "WindowExpression", "WindowFunction",
           "RowNumber", "Rank", "DenseRank", "PercentRank", "NTile",
           "Lag", "Lead", "ROWS_UNBOUNDED", "RANGE_CURRENT"]


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """Frame boundaries. ``lower``/``upper`` are signed offsets from the
    current row (rows frames) or the current order value (range frames);
    ``None`` means UNBOUNDED, 0 is CURRENT ROW."""
    frame_type: str = "range"            # "rows" | "range"
    lower: Optional[int] = None          # None = UNBOUNDED PRECEDING
    upper: Optional[int] = 0             # None = UNBOUNDED FOLLOWING

    def __post_init__(self):
        if self.frame_type not in ("rows", "range"):
            raise ValueError(f"bad frame type {self.frame_type!r}")
        if self.lower is not None and self.upper is not None \
                and self.lower > self.upper:
            raise ValueError(f"frame lower {self.lower} > upper "
                             f"{self.upper}")

    @property
    def unbounded_both(self) -> bool:
        return self.lower is None and self.upper is None

    def describe(self) -> str:
        def b(v, side):
            if v is None:
                return f"UNBOUNDED {side}"
            if v == 0:
                return "CURRENT ROW"
            return f"{abs(v)} {'PRECEDING' if v < 0 else 'FOLLOWING'}"
        return (f"{self.frame_type.upper()} BETWEEN "
                f"{b(self.lower, 'PRECEDING')} AND "
                f"{b(self.upper, 'FOLLOWING')}")


ROWS_UNBOUNDED = WindowFrame("rows", None, None)
RANGE_CURRENT = WindowFrame("range", None, 0)  # Spark's default with ORDER BY


class WindowFunction(Expression):
    """A ranking or offset function: evaluable only inside a window
    spec."""

    @property
    def nullable(self):
        return False


class RowNumber(WindowFunction):
    @property
    def dtype(self):
        return dt.INT32


class Rank(WindowFunction):
    @property
    def dtype(self):
        return dt.INT32


class DenseRank(WindowFunction):
    @property
    def dtype(self):
        return dt.INT32


class PercentRank(WindowFunction):
    @property
    def dtype(self):
        return dt.FLOAT64


class NTile(WindowFunction):
    """n roughly equal buckets a partition: the first ``rows % n``
    buckets get one row more (Spark's rule)."""

    def __init__(self, buckets: int):
        if buckets <= 0:
            raise ValueError("ntile buckets must be positive")
        self.buckets = int(buckets)

    @property
    def dtype(self):
        return dt.INT32

    def __repr__(self):
        return f"NTile({self.buckets})"


class _OffsetFunction(WindowFunction):
    """lag/lead: the value ``offset`` rows before/after the current row in
    the partition's order, or ``default`` (NULL when absent) past the
    partition's edge. It ignores the frame, as Spark's does."""

    direction = -1  # lag looks backward

    def __init__(self, child: Expression, offset: int = 1,
                 default: Optional[Expression] = None):
        if offset < 0:
            raise ValueError("offset must be >= 0")
        self.offset = int(offset)
        self.children = (child,) if default is None else (child, default)

    @property
    def child(self):
        return self.children[0]

    @property
    def default(self) -> Optional[Expression]:
        return self.children[1] if len(self.children) > 1 else None

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return True

    def validate(self):
        d = self.default
        if d is not None and not isinstance(d, Literal):
            raise TypeError("lag/lead default must be a literal")

    def __repr__(self):
        return (f"{self.pretty_name()}({self.children[0]!r}, "
                f"{self.offset})")


class Lag(_OffsetFunction):
    direction = -1


class Lead(_OffsetFunction):
    direction = 1


# the aggregates the port computes over a frame (exec/window.py), the
# reference's set (``spark_rapids_tpu/expr/window.py:175``)
_DEVICE_WINDOW_AGGS = (Sum, Count, Min, Max, Average, First, Last,
                       _CentralMoment)


class WindowExpression(Expression):
    """func OVER (PARTITION BY ... ORDER BY ... frame)."""

    def __init__(self, func: Expression,
                 partition_by: Sequence[Expression] = (),
                 order_by: Sequence["SortOrder"] = (),
                 frame: Optional[WindowFrame] = None):
        self.order_specs: Tuple = tuple(
            (o.ascending, o.nulls_first) for o in order_by)
        if frame is None:
            # Spark's defaults: RANGE UNBOUNDED..CURRENT with an order
            # spec, the whole partition without one
            frame = RANGE_CURRENT if order_by else ROWS_UNBOUNDED
        self.frame = frame
        self._n_part = len(partition_by)
        self._n_order = len(order_by)
        self.children = (func, *partition_by,
                         *[o.child for o in order_by])

    @property
    def func(self) -> Expression:
        return self.children[0]

    @property
    def partition_by(self) -> Tuple[Expression, ...]:
        return self.children[1:1 + self._n_part]

    @property
    def order_by(self) -> List["SortOrder"]:
        from ..exec.sort import SortOrder
        keys = self.children[1 + self._n_part:]
        return [SortOrder(k, asc, nf) for k, (asc, nf)
                in zip(keys, self.order_specs)]

    @property
    def dtype(self):
        return self.func.dtype

    @property
    def nullable(self):
        f = self.func
        if isinstance(f, WindowFunction):
            return f.nullable
        if isinstance(f, Count):
            return False
        return True

    def spec_signature(self) -> str:
        """Partition and order identity: one ``GpuWindowExec`` computes
        one spec (Spark plans one WindowExec a distinct spec)."""
        order = ", ".join(f"{o.child!r} {o.ascending} {o.nulls_first}"
                          for o in self.order_by)
        return (f"partition=[{', '.join(map(repr, self.partition_by))}] "
                f"order=[{order}]")

    def validate(self):
        f = self.func
        if not isinstance(f, (WindowFunction, AggregateFunction)):
            raise TypeError(f"not a window function: {f!r}")
        if isinstance(f, (Rank, DenseRank, PercentRank, NTile,
                          _OffsetFunction)) and not self.order_specs:
            raise ValueError(f"{f.pretty_name()} requires an ORDER BY")
        if self.frame.frame_type == "range" and not self.frame.unbounded_both \
                and not self.order_specs:
            raise ValueError("a bounded RANGE frame requires an ORDER BY")

    def gpu_supported(self) -> Optional[str]:
        """Why the device cannot compute this window, naming the ROADMAP
        item it waits for; None when it can."""
        f = self.func
        fr = self.frame
        for e in self.partition_by:
            if dt.is_nested(e.dtype):
                return "window partition by nested type not on device"
        for o in self.order_by:
            if dt.is_nested(o.child.dtype):
                return "window order by nested type not on device"
        if isinstance(f, AggregateFunction) \
                and not isinstance(f, _DEVICE_WINDOW_AGGS):
            return (f"window aggregate {f.pretty_name()} is not ported "
                    "yet (ROADMAP item 8)")
        if isinstance(f, (Average, _CentralMoment)) \
                and isinstance(f.children[0].dtype, dt.DecimalType):
            return (f"decimal {f.pretty_name().lower()} over a window runs "
                    "on the CPU")
        if isinstance(f, _OffsetFunction) and f.default is not None \
                and f.dtype.is_variable_width:
            return "a lag/lead default over strings runs on the CPU"
        if fr.frame_type == "range":
            bounded = [v for v in (fr.lower, fr.upper)
                       if v is not None and v != 0]
            if bounded:
                # literal value offsets map to index spans through a
                # compound (segment << 33 | region << 32 | orderable)
                # searchsorted (exec/window.py _range_literal_bound),
                # which needs one ascending order key whose orderable
                # lane fits 32 bits
                if self._n_order != 1:
                    return ("RANGE literal offsets need exactly one order "
                            "key on the device; others run on the CPU")
                if not self.order_specs[0][0]:
                    return ("RANGE literal offsets over a descending order "
                            "key run on the CPU")
                ot = self.children[1 + self._n_part].dtype
                # floats are excluded: the device would add the offset in
                # the key's type where Spark computes in float64
                ok32 = ot.np_dtype is not None and not dt.is_nested(ot) \
                    and np.dtype(ot.np_dtype).itemsize <= 4 \
                    and not isinstance(ot, dt.BooleanType) \
                    and not dt.is_floating(ot)
                if not ok32:
                    return (f"RANGE literal offsets over "
                            f"{ot.simple_string()} run on the CPU (the "
                            "device needs an integer or date order lane "
                            "of at most 32 bits)")
        return None

    def __repr__(self):
        return (f"{self.func!r} OVER ({self.spec_signature()} "
                f"{self.frame.describe()})")

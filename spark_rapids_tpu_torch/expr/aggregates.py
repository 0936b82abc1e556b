"""Aggregate functions: ``Sum``, ``Count``, ``Min``, ``Max`` and
``Average``.

Counterpart of ``spark_rapids_tpu/expr/aggregates.py:41-440``: the
update -> merge -> evaluate contract, in two forms.

- Global (no key), the reference's ``seg is None`` path: ``update``,
  ``merge`` and ``evaluate`` over a live mask. As there, a partial
  buffer is ``GLOBAL_LANES`` wide with the value in lane 0.
- Grouped: ``update_device``, ``merge_device`` and ``evaluate_device``
  over ``(seg, sorted_live, out_live)``, the rows already sorted by key,
  reducing per sorted segment with ``ops/segments.seg_reduce_sorted``;
  the buffers are as long as the segment ids, with ``out_live`` marking
  the groups.

Sum of a float accumulates in float64 (Spark's result type) and is null
when no row contributed (``_sum_lanes``, ``:124``; ``Sum._acc``,
``:161``). Min and Max (``_MinMax``, ``:265``) reduce an orderable
integer lane (floats through the total-order bit map, so NaN is the
largest value and -0.0 reads 0.0) with ``ops/segments`` min/max, and are
null for a group without a non-null value. Average (``:349``) keeps a
float64 sum and an int64 count; the final is ``sum / count``, null at
count 0. First/Last, the variances, ApproxPercentile, the collects, Min
and Max over strings, and the decimal forms (Sum's overflow to null,
Average's scale + 4) wait for ROADMAP items 8 and 2.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector
from ..ops.segments import seg_reduce_sorted
from ..ops.sort_keys import orderable_int
from .base import Expression

__all__ = ["AggregateFunction", "Sum", "Count", "Min", "Max", "Average",
           "GLOBAL_LANES"]

GLOBAL_LANES = 128


def _lane0(value: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    out = torch.zeros(GLOBAL_LANES, dtype=dtype, device=value.device)
    out[0] = value
    return out


def _masked(col: GpuColumnVector, live: torch.Tensor) -> torch.Tensor:
    """Rows that are live and non-null."""
    return live if col.validity is None else col.validity & live


class AggregateFunction(Expression):
    """Base aggregate. ``children`` are the input value expressions."""

    is_aggregate = True

    @property
    def nullable(self):
        return True

    @property
    def buffer_fields(self) -> List[dt.StructField]:
        raise NotImplementedError

    def update(self, vals: List[GpuColumnVector], live: torch.Tensor) \
            -> List[GpuColumnVector]:
        raise NotImplementedError

    def merge(self, bufs: List[GpuColumnVector], live: torch.Tensor) \
            -> List[GpuColumnVector]:
        raise NotImplementedError

    def evaluate(self, bufs: List[GpuColumnVector]) -> GpuColumnVector:
        return bufs[0]

    def update_device(self, vals: List[GpuColumnVector], seg: torch.Tensor,
                      sorted_live: torch.Tensor, out_live: torch.Tensor) \
            -> List[GpuColumnVector]:
        raise NotImplementedError

    def merge_device(self, bufs: List[GpuColumnVector], seg: torch.Tensor,
                     sorted_live: torch.Tensor, out_live: torch.Tensor) \
            -> List[GpuColumnVector]:
        raise NotImplementedError

    def evaluate_device(self, bufs: List[GpuColumnVector]) \
            -> GpuColumnVector:
        return bufs[0]


def _seg_count(valid: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    return seg_reduce_sorted(valid.to(torch.int64), seg, seg.shape[0],
                             "sum")


class Sum(AggregateFunction):
    """Spark sum: integral -> long (wrapping), float -> double."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        t = self.children[0].dtype
        if not (dt.is_integral(t) or dt.is_floating(t)):
            raise NotImplementedError(
                f"sum over {t.simple_string()} is not on the device yet")

    @property
    def dtype(self):
        return dt.FLOAT64 if dt.is_floating(self.children[0].dtype) \
            else dt.INT64

    @property
    def buffer_fields(self):
        return [dt.StructField("sum", self.dtype, True)]

    def _acc(self) -> torch.dtype:
        return torch.float64 if self.dtype == dt.FLOAT64 else torch.int64

    def buffer(self, s: torch.Tensor, count: torch.Tensor) \
            -> GpuColumnVector:
        """The partial buffer for a sum and the count of rows in it."""
        return GpuColumnVector(self.dtype, _lane0(s, self._acc()),
                               _lane0(count > 0, torch.bool))

    def _sum_lanes(self, col: GpuColumnVector, live: torch.Tensor):
        valid = _masked(col, live)
        zero = torch.zeros((), dtype=self._acc(), device=live.device)
        s = torch.where(valid, col.data.to(self._acc()), zero).sum()
        return s, valid.sum(dtype=torch.int64)

    def update(self, vals, live):
        return [self.buffer(*self._sum_lanes(vals[0], live))]

    def merge(self, bufs, live):
        return [self.buffer(*self._sum_lanes(bufs[0], live))]

    def _seg_sum_lanes(self, col, seg, sorted_live, out_live):
        valid = _masked(col, sorted_live)
        zero = torch.zeros((), dtype=self._acc(), device=seg.device)
        s = seg_reduce_sorted(torch.where(valid, col.data.to(self._acc()),
                                          zero), seg, seg.shape[0], "sum")
        cnt = _seg_count(valid, seg)
        return [GpuColumnVector(self.dtype, s, (cnt > 0) & out_live)]

    def update_device(self, vals, seg, sorted_live, out_live):
        return self._seg_sum_lanes(vals[0], seg, sorted_live, out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        return self._seg_sum_lanes(bufs[0], seg, sorted_live, out_live)


class Count(AggregateFunction):
    """count(expr) counts non-null rows; count(*) (no child) counts rows."""

    def __init__(self, child: Optional[Expression] = None):
        self.children = (child,) if child is not None else ()

    @property
    def dtype(self):
        return dt.INT64

    @property
    def nullable(self):
        return False

    @property
    def buffer_fields(self):
        return [dt.StructField("count", dt.INT64, False)]

    def update(self, vals, live):
        valid = _masked(vals[0], live) if vals else live
        return [GpuColumnVector(
            dt.INT64, _lane0(valid.sum(dtype=torch.int64), torch.int64))]

    def merge(self, bufs, live):
        data = torch.where(_masked(bufs[0], live), bufs[0].data,
                           torch.zeros((), dtype=torch.int64,
                                       device=live.device))
        return [GpuColumnVector(dt.INT64, _lane0(data.sum(), torch.int64))]

    def update_device(self, vals, seg, sorted_live, out_live):
        valid = _masked(vals[0], sorted_live) if vals else sorted_live
        return [GpuColumnVector(dt.INT64, _seg_count(valid, seg), out_live)]

    def merge_device(self, bufs, seg, sorted_live, out_live):
        data = torch.where(_masked(bufs[0], sorted_live), bufs[0].data,
                           torch.zeros((), dtype=torch.int64,
                                       device=seg.device))
        return [GpuColumnVector(
            dt.INT64, seg_reduce_sorted(data, seg, seg.shape[0], "sum"),
            out_live)]


def _check_numeric(name: str, t: dt.DataType) -> None:
    if isinstance(t, dt.DecimalType):
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not ported yet (decimal "
            "aggregates, ROADMAP item 2)")
    if not (dt.is_integral(t) or dt.is_floating(t)
            or isinstance(t, (dt.BooleanType, dt.DateType,
                              dt.TimestampType))):
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not ported yet (ROADMAP "
            "item 8)")


class _MinMax(AggregateFunction):
    largest = False

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check_numeric(type(self).__name__.lower(), self.children[0].dtype)

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def buffer_fields(self):
        return [dt.StructField("m", self.dtype, True)]

    @property
    def _kind(self) -> str:
        return "max" if self.largest else "min"

    def _keys(self, col: GpuColumnVector, valid: torch.Tensor):
        """The orderable integer lane, with rows outside ``valid`` at the
        value that never wins."""
        keys = orderable_int(GpuColumnVector(col.dtype, col.data))
        info = torch.iinfo(keys.dtype)
        fill = info.min if self.largest else info.max
        return torch.where(valid, keys, torch.full_like(keys, fill))

    def _values(self, red: torch.Tensor) -> torch.Tensor:
        """The reduced keys back as the column's lane."""
        t = self.dtype
        if isinstance(t, dt.BooleanType):
            return red.to(torch.bool)
        if dt.is_floating(t):
            flip = 0x7FFFFFFF if red.dtype == torch.int32 \
                else (1 << 63) - 1
            bits = torch.where(red < 0, red ^ flip, red)
            return bits.view(torch.float32 if red.dtype == torch.int32
                             else torch.float64)
        return red

    def _global(self, col: GpuColumnVector, live: torch.Tensor):
        valid = _masked(col, live)
        keys = self._keys(col, valid)
        red = keys.max() if self.largest else keys.min()
        return [GpuColumnVector(
            self.dtype, _lane0(self._values(red.reshape(1))[0],
                               col.data.dtype),
            _lane0(valid.any(), torch.bool))]

    def update(self, vals, live):
        return self._global(vals[0], live)

    def merge(self, bufs, live):
        return self._global(bufs[0], live)

    def _reduce(self, col, seg, sorted_live, out_live):
        valid = _masked(col, sorted_live)
        red = seg_reduce_sorted(self._keys(col, valid), seg, seg.shape[0],
                                self._kind)
        cnt = _seg_count(valid, seg)
        return [GpuColumnVector(self.dtype, self._values(red),
                                (cnt > 0) & out_live)]

    def update_device(self, vals, seg, sorted_live, out_live):
        return self._reduce(vals[0], seg, sorted_live, out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        return self._reduce(bufs[0], seg, sorted_live, out_live)


class Max(_MinMax):
    largest = True


class Min(_MinMax):
    largest = False


class Average(AggregateFunction):
    """Spark avg over a number: a double, from a float64 sum and an int64
    count."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        t = self.children[0].dtype
        _check_numeric("avg", t)
        if not (dt.is_integral(t) or dt.is_floating(t)):
            raise NotImplementedError(
                f"avg over {t.simple_string()} is not ported yet (ROADMAP "
                "item 8)")

    @property
    def dtype(self):
        return dt.FLOAT64

    @property
    def buffer_fields(self):
        return [dt.StructField("sum", dt.FLOAT64, True),
                dt.StructField("count", dt.INT64, False)]

    @staticmethod
    def _global_bufs(s, cnt):
        return [GpuColumnVector(dt.FLOAT64, _lane0(s, torch.float64),
                                _lane0(cnt > 0, torch.bool)),
                GpuColumnVector(dt.INT64, _lane0(cnt, torch.int64))]

    def update(self, vals, live):
        valid = _masked(vals[0], live)
        s = torch.where(valid, vals[0].data.to(torch.float64),
                        torch.zeros((), dtype=torch.float64,
                                    device=live.device)).sum()
        return self._global_bufs(s, valid.sum(dtype=torch.int64))

    def merge(self, bufs, live):
        svalid = _masked(bufs[0], live)
        s = torch.where(svalid, bufs[0].data,
                        torch.zeros((), dtype=torch.float64,
                                    device=live.device)).sum()
        cnt = torch.where(_masked(bufs[1], live), bufs[1].data,
                          torch.zeros((), dtype=torch.int64,
                                      device=live.device)).sum()
        return self._global_bufs(s, cnt)

    def _seg_bufs(self, s, scnt, cnt, out_live):
        return [GpuColumnVector(dt.FLOAT64, s, (scnt > 0) & out_live),
                GpuColumnVector(dt.INT64, cnt, out_live)]

    def update_device(self, vals, seg, sorted_live, out_live):
        valid = _masked(vals[0], sorted_live)
        zero = torch.zeros((), dtype=torch.float64, device=seg.device)
        s = seg_reduce_sorted(torch.where(valid, vals[0].data.to(
            torch.float64), zero), seg, seg.shape[0], "sum")
        cnt = _seg_count(valid, seg)
        return self._seg_bufs(s, cnt, cnt, out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        svalid = _masked(bufs[0], sorted_live)
        zero = torch.zeros((), dtype=torch.float64, device=seg.device)
        s = seg_reduce_sorted(torch.where(svalid, bufs[0].data, zero), seg,
                              seg.shape[0], "sum")
        counts = torch.where(_masked(bufs[1], sorted_live), bufs[1].data,
                             torch.zeros((), dtype=torch.int64,
                                         device=seg.device))
        cnt = seg_reduce_sorted(counts, seg, seg.shape[0], "sum")
        return self._seg_bufs(s, _seg_count(svalid, seg), cnt, out_live)

    def evaluate(self, bufs):
        s, cnt = bufs
        valid = s.valid_mask() & (cnt.data > 0)
        den = torch.where(cnt.data > 0, cnt.data,
                          torch.ones_like(cnt.data)).to(torch.float64)
        return GpuColumnVector(dt.FLOAT64, s.data / den, valid)

    def evaluate_device(self, bufs):
        return self.evaluate(bufs)

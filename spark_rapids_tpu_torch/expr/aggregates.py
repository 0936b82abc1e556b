"""Aggregate functions: ``Sum``, ``Count``, ``Min``, ``Max``,
``Average`` and ``ApproxPercentile``.

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
count 0. ApproxPercentile (``:683-900``) has the reference's two
strategies: the exact rank over the aggregate's single pass
(``exec/aggregate.py``), and a mergeable K-point sketch that rides the
partial and final phases (``update_device``, ``merge_device``,
``evaluate_device``).

Min and Max over a string order by bytes, unsigned, a shorter prefix
first: each row's dense rank among the live non-null rows
(``ops/sort_keys.string_order_ranks``, K3 passes) packed above its
position reduces per segment like any integer lane, and the winning row
is gathered (K4). The reference places them on its host path; the port
runs them on the device.

First and Last (``_FirstLast``, ``:442-509``) take the group's first or
last row in input order (the segment sort is stable), skipping nulls
under ``ignoreNulls``; a merge takes the first or last partial the same
way. Over a string they run on the CPU, where the reference places them.

The central moments (``_CentralMoment``, ``:510-610``: ``VarianceSamp``,
``VariancePop``, ``StddevSamp``, ``StddevPop``) keep the reference's
mergeable ``(n, mean, m2)`` buffers in float64: an update is two passes
within a segment (the mean, then the centered sum of squares), a merge
is the parallel (Chan) combination ``m2 = sum(m2_i + n_i (mean_i -
mean)^2)``. A sample moment of one row, and any moment of no row, is
null (Spark 3.1+). A merge in another order changes the last bits: the
tests hold the port to the reference at rel 1e-9.

Decimals (the reference's ``:134-212,348-440``). ``Sum`` of a
``decimal(p,s)`` is a ``decimal(p+10,s)``; ``Average`` a
``decimal(p+4,s+4)`` from a ``decimal(p+10,s)`` sum and an int64 count,
``HALF_UP`` (``_decimal_average``). On the device a Decimal64 sum
accumulates its int64 lanes and is null past the result's precision,
which it can tell up to ``|sum| < 2^63``, the reference's bound
(``_decimal_sum``). The gates are the reference's: a sum past 18 digits
(``p > 8``) and an average whose ``10^4``-scaled sum could pass them
(``p + 14 > 18``) run on the CPU (``gpu_supported``), and there the
sum is exact at any width: four 32-bit limbs a row summed in int64 and
joined in Python's integers, null past the precision. ``Min``, ``Max``,
``First``, ``Last``, ``Count`` and ``ApproxPercentile`` take a Decimal64
as they take a long; the moments take its value as a double, as Spark's
implicit cast does (the reference's moments read the unscaled lane).
``Min``, ``Max`` and ``ApproxPercentile`` of a decimal past 18 digits
raise, naming ROADMAP item 2.

The collects (``_Collect``, ``CollectList``, ``CollectSet``, the
reference's ``:620-680``) group values into an array. They have no
partial buffers: the aggregate's single pass computes them over its
whole input (``exec/aggregate.py`` ``_collect_column``), each group's
elements in value order (the reference's, which the dual runs compare
exactly): strings by UTF-8 bytes, NaN last, nulls skipped, never null
(an empty array). ``collect_set`` keeps one of each value, one NaN, and
``-0.0`` equal to ``0.0``. A list of percentiles returns an array of the
input type, ``k`` elements a group.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.batch import row_mask
from ..columnar.column import GpuColumnVector, is_string_like, lane_shape
from ..ops import decimals as dec
from ..ops.gather import gather_column
from ..ops.segments import seg_reduce_sorted
from ..ops.sort_keys import (key_lane_bits, orderable_int, pack_words,
                             sort_packed, string_order_ranks)
from .base import Expression

__all__ = ["AggregateFunction", "Sum", "Count", "Min", "Max", "Average",
           "First", "Last", "VarianceSamp", "VariancePop", "StddevSamp",
           "StddevPop", "ApproxPercentile", "GLOBAL_LANES", "group_value_order",
           "value_sorted_groups", "spark_rank0", "GROUP_VALUE_BITS"]

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


def _limb_sums(col: GpuColumnVector, valid: torch.Tensor,
               seg: Optional[torch.Tensor], at: torch.Tensor) -> np.ndarray:
    """The exact sums of a decimal column's valid rows at the non-empty
    sorted segments ``at`` (or of all of them, ``seg`` None), as Python
    ints: each limb's prefix sum (``ops/decimals.limbs``) read at the
    segments' edges only."""
    if seg is not None:
        ids = at.to(seg.dtype)
        left = torch.searchsorted(seg, ids, right=False)
        right = torch.searchsorted(seg, ids, right=True)
    sums = []
    for limb in dec.limbs(col.data):
        v = torch.where(valid, limb, torch.zeros_like(limb))
        if seg is None:
            sums.append(v.sum().reshape(1))
            continue
        ps = torch.cumsum(v, 0)
        before = torch.where(left > 0, ps[(left - 1).clamp(min=0)],
                             torch.zeros_like(left, dtype=ps.dtype))
        sums.append(ps[right - 1] - before)
    return dec.join_limbs(sums)


def _scatter_decimal(t: dt.DecimalType, n: int, at: torch.Tensor,
                     values: np.ndarray, keep: np.ndarray,
                     device) -> GpuColumnVector:
    """A decimal column of ``n`` rows holding Python-int ``values`` at
    the rows ``at`` (valid where ``keep``), null elsewhere."""
    small = dec.column_from_ints(t, values, keep, device)
    shape, lane = lane_shape(t, n, device)
    data = torch.zeros(shape, dtype=lane, device=device)
    valid = torch.zeros(n, dtype=torch.bool, device=device)
    data[at] = small.data
    valid[at] = small.validity
    return GpuColumnVector(t, data, valid)


def _overflowed(s: GpuColumnVector, cnt: GpuColumnVector,
                live: torch.Tensor) -> torch.Tensor:
    """Partials that counted rows but hold a null sum: the sum
    overflowed, and the merged sum is null (Spark's ``isEmpty``)."""
    return _masked(cnt, live) & (cnt.data > 0) & ~s.valid_mask()


def _decimal_sum(t: dt.DecimalType, col: GpuColumnVector,
                 valid: torch.Tensor, seg: Optional[torch.Tensor],
                 out_live: Optional[torch.Tensor],
                 lost: Optional[torch.Tensor] = None) -> GpuColumnVector:
    """A decimal sum of ``t`` per segment (``seg`` None: one, in lane 0
    of a ``GLOBAL_LANES`` buffer), null where no row counted, where a
    row is ``lost`` (a merged partial that overflowed, ``_overflowed``)
    or past ``t``'s precision (module docstring). Past 18 digits only
    the groups (``out_live``) go through Python's integers."""
    def count(rows):
        return _seg_count(rows, seg) if seg is not None \
            else _lane0(rows.sum(dtype=torch.int64), torch.int64)
    cnt = count(valid)
    ok = cnt > 0 if out_live is None else (cnt > 0) & out_live
    if lost is not None:
        ok = ok & (count(lost) == 0)
    if not dt.is_wide_decimal(t) and not dt.is_wide_decimal(col.dtype):
        v = torch.where(valid, col.data, torch.zeros_like(col.data))
        s = v.sum() if seg is None \
            else seg_reduce_sorted(v, seg, seg.shape[0], "sum")
        if seg is None:
            s = _lane0(s, torch.int64)
        return GpuColumnVector(t, s, ok & dec.fits(s, t.precision))
    at = torch.nonzero(ok).flatten()
    sums = _limb_sums(col, valid, seg, at)
    return _scatter_decimal(t, ok.shape[0], at, sums,
                            dec.fits_ints(sums, t.precision), valid.device)


class Sum(AggregateFunction):
    """Spark sum: integral -> long (wrapping), float -> double,
    ``decimal(p,s)`` -> ``decimal(p+10,s)``, null past its precision.

    Past 18 digits (on the host only) the buffer also counts its rows,
    as Spark's ``isEmpty`` does: a partial whose sum overflowed is null
    but not empty, and a merge with it is null. A Decimal64 sum (p <= 8)
    keeps the reference's one buffer: its partial would need 10^10 rows
    to pass 18 digits."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        t = self.children[0].dtype
        if not dt.is_numeric(t):
            raise NotImplementedError(
                f"sum over {t.simple_string()} is not on the device yet")

    @property
    def dtype(self):
        t = self.children[0].dtype
        if isinstance(t, dt.DecimalType):
            return dt.DecimalType(min(t.precision + 10,
                                      dt.DecimalType.MAX_PRECISION), t.scale)
        return dt.FLOAT64 if dt.is_floating(t) else dt.INT64

    def gpu_supported(self) -> Optional[str]:
        if dt.is_wide_decimal(self.dtype):
            return (f"sum result {self.dtype.simple_string()} exceeds "
                    "device decimal")
        return None

    @property
    def is_decimal(self) -> bool:
        return isinstance(self.dtype, dt.DecimalType)

    @property
    def _counted(self) -> bool:
        return dt.is_wide_decimal(self.dtype)

    @property
    def buffer_fields(self):
        return [dt.StructField("sum", self.dtype, True)] + (
            [dt.StructField("count", dt.INT64, False)] if self._counted
            else [])

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
        if self.is_decimal:
            valid = _masked(vals[0], live)
            out = [_decimal_sum(self.dtype, vals[0], valid, None, None)]
            return out + self._count(_lane0(valid.sum(dtype=torch.int64),
                                            torch.int64), None)
        return [self.buffer(*self._sum_lanes(vals[0], live))]

    def merge(self, bufs, live):
        if not self._counted:
            return self.update(bufs, live)
        cnt = torch.where(_masked(bufs[1], live), bufs[1].data,
                          torch.zeros_like(bufs[1].data)).sum()
        return [_decimal_sum(self.dtype, bufs[0], _masked(bufs[0], live),
                             None, None, _overflowed(*bufs, live)),
                GpuColumnVector(dt.INT64, _lane0(cnt, torch.int64))]

    def _count(self, cnt: torch.Tensor,
               out_live: Optional[torch.Tensor]) -> List[GpuColumnVector]:
        """The count buffer of a sum past 18 digits, else none."""
        return [GpuColumnVector(dt.INT64, cnt, out_live)] \
            if self._counted else []

    def _seg_sum_lanes(self, col, seg, sorted_live, out_live):
        valid = _masked(col, sorted_live)
        if self.is_decimal:
            return [_decimal_sum(self.dtype, col, valid, seg, out_live)] \
                + self._count(_seg_count(valid, seg), out_live)
        zero = torch.zeros((), dtype=self._acc(), device=seg.device)
        s = seg_reduce_sorted(torch.where(valid, col.data.to(self._acc()),
                                          zero), seg, seg.shape[0], "sum")
        cnt = _seg_count(valid, seg)
        return [GpuColumnVector(self.dtype, s, (cnt > 0) & out_live)]

    def update_device(self, vals, seg, sorted_live, out_live):
        return self._seg_sum_lanes(vals[0], seg, sorted_live, out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        if not self._counted:
            return self._seg_sum_lanes(bufs[0], seg, sorted_live, out_live)
        counts = torch.where(_masked(bufs[1], sorted_live), bufs[1].data,
                             torch.zeros_like(bufs[1].data))
        return [_decimal_sum(self.dtype, bufs[0],
                             _masked(bufs[0], sorted_live), seg, out_live,
                             _overflowed(*bufs, sorted_live)),
                GpuColumnVector(dt.INT64, seg_reduce_sorted(
                    counts, seg, seg.shape[0], "sum"), out_live)]


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


def _check_numeric(name: str, t: dt.DataType,
                   wide_ok: bool = True) -> None:
    if dt.is_wide_decimal(t) and not wide_ok:
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not ported yet (a decimal "
            "past 18 digits, ROADMAP item 2)")
    if not (dt.is_numeric(t)
            or isinstance(t, (dt.BooleanType, dt.DateType,
                              dt.TimestampType))):
        raise NotImplementedError(
            f"{name} over {t.simple_string()} is not ported yet (ROADMAP "
            "item 8)")


_POS_BITS = 32
_POS_MASK = (1 << _POS_BITS) - 1


def _rank_pos_key(col: GpuColumnVector, valid: torch.Tensor,
                  largest: bool) -> torch.Tensor:
    """A string row's byte-order rank above its position, as one int64
    whose min (or max, with ``largest``) picks the smallest (largest)
    string; rows outside ``valid`` never win."""
    rank = string_order_ranks(col, valid).to(torch.int64)
    if largest:
        rank = torch.where(valid, rank, torch.full_like(rank, -1))
    pos = torch.arange(rank.shape[0], dtype=torch.int64,
                       device=rank.device)
    return (rank << _POS_BITS) | pos


def _winning_rows(col: GpuColumnVector, key: torch.Tensor,
                  found: torch.Tensor) -> GpuColumnVector:
    """The rows whose positions the reduced keys hold, gathered (K4)
    under ``found``."""
    pos = (key & _POS_MASK).clamp(0, max(col.capacity - 1, 0))
    return gather_column(col, pos, found)


class _MinMax(AggregateFunction):
    largest = False

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        t = self.children[0].dtype
        if not is_string_like(t):
            _check_numeric(type(self).__name__.lower(), t, wide_ok=False)

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
        if col.is_string_like:
            key = _rank_pos_key(col, valid, self.largest)
            red = key.max() if self.largest else key.min()
            lane0 = row_mask(GLOBAL_LANES, 1, live.device)
            return [_winning_rows(col, torch.where(
                lane0, red, torch.zeros_like(red)), lane0 & valid.any())]
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
        cnt = _seg_count(valid, seg)
        if col.is_string_like:
            red = seg_reduce_sorted(_rank_pos_key(col, valid, self.largest),
                                    seg, seg.shape[0], self._kind)
            return [_winning_rows(col, red, (cnt > 0) & out_live)]
        red = seg_reduce_sorted(self._keys(col, valid), seg, seg.shape[0],
                                self._kind)
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
    """Spark avg: a number -> a double, from a float64 sum and an int64
    count; a ``decimal(p,s)`` -> a ``decimal(p+4,s+4)``, from a
    ``decimal(p+10,s)`` sum (module docstring)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        t = self.children[0].dtype
        _check_numeric("avg", t)

    @property
    def is_decimal(self) -> bool:
        return isinstance(self.children[0].dtype, dt.DecimalType)

    @property
    def dtype(self):
        t = self.children[0].dtype
        if isinstance(t, dt.DecimalType):
            cap = dt.DecimalType.MAX_PRECISION
            return dt.DecimalType(min(t.precision + 4, cap),
                                  min(t.scale + 4, cap))
        return dt.FLOAT64

    def gpu_supported(self) -> Optional[str]:
        t = self.children[0].dtype
        # the evaluation scales the int64 sum by 10^4 before it divides,
        # so the sum needs p + 10 + 4 digits of headroom
        if isinstance(t, dt.DecimalType) \
                and t.precision + 14 > dt.DecimalType.MAX_INT64_PRECISION:
            return "decimal average exceeds device decimal range"
        return None

    @property
    def _sum_type(self) -> dt.DataType:
        t = self.children[0].dtype
        if isinstance(t, dt.DecimalType):
            return dt.DecimalType(min(t.precision + 10,
                                      dt.DecimalType.MAX_PRECISION), t.scale)
        return dt.FLOAT64

    @property
    def buffer_fields(self):
        return [dt.StructField("sum", self._sum_type, True),
                dt.StructField("count", dt.INT64, False)]

    @staticmethod
    def _global_bufs(s, cnt):
        return [GpuColumnVector(dt.FLOAT64, _lane0(s, torch.float64),
                                _lane0(cnt > 0, torch.bool)),
                GpuColumnVector(dt.INT64, _lane0(cnt, torch.int64))]

    def update(self, vals, live):
        valid = _masked(vals[0], live)
        if self.is_decimal:
            return [_decimal_sum(self._sum_type, vals[0], valid, None,
                                 None),
                    GpuColumnVector(dt.INT64, _lane0(
                        valid.sum(dtype=torch.int64), torch.int64))]
        s = torch.where(valid, vals[0].data.to(torch.float64),
                        torch.zeros((), dtype=torch.float64,
                                    device=live.device)).sum()
        return self._global_bufs(s, valid.sum(dtype=torch.int64))

    def merge(self, bufs, live):
        svalid = _masked(bufs[0], live)
        cnt = torch.where(_masked(bufs[1], live), bufs[1].data,
                          torch.zeros((), dtype=torch.int64,
                                      device=live.device)).sum()
        if self.is_decimal:
            return [_decimal_sum(self._sum_type, bufs[0], svalid, None,
                                 None, _overflowed(*bufs, live)),
                    GpuColumnVector(dt.INT64, _lane0(cnt, torch.int64))]
        s = torch.where(svalid, bufs[0].data,
                        torch.zeros((), dtype=torch.float64,
                                    device=live.device)).sum()
        return self._global_bufs(s, cnt)

    def _seg_bufs(self, s, scnt, cnt, out_live):
        return [GpuColumnVector(dt.FLOAT64, s, (scnt > 0) & out_live),
                GpuColumnVector(dt.INT64, cnt, out_live)]

    def update_device(self, vals, seg, sorted_live, out_live):
        valid = _masked(vals[0], sorted_live)
        cnt = _seg_count(valid, seg)
        if self.is_decimal:
            return [_decimal_sum(self._sum_type, vals[0], valid, seg,
                                 out_live),
                    GpuColumnVector(dt.INT64, cnt, out_live)]
        zero = torch.zeros((), dtype=torch.float64, device=seg.device)
        s = seg_reduce_sorted(torch.where(valid, vals[0].data.to(
            torch.float64), zero), seg, seg.shape[0], "sum")
        return self._seg_bufs(s, cnt, cnt, out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        svalid = _masked(bufs[0], sorted_live)
        counts = torch.where(_masked(bufs[1], sorted_live), bufs[1].data,
                             torch.zeros((), dtype=torch.int64,
                                         device=seg.device))
        cnt = seg_reduce_sorted(counts, seg, seg.shape[0], "sum")
        if self.is_decimal:
            return [_decimal_sum(self._sum_type, bufs[0], svalid, seg,
                                 out_live, _overflowed(*bufs, sorted_live)),
                    GpuColumnVector(dt.INT64, cnt, out_live)]
        zero = torch.zeros((), dtype=torch.float64, device=seg.device)
        s = seg_reduce_sorted(torch.where(svalid, bufs[0].data, zero), seg,
                              seg.shape[0], "sum")
        return self._seg_bufs(s, _seg_count(svalid, seg), cnt, out_live)

    def evaluate(self, bufs):
        s, cnt = bufs
        valid = s.valid_mask() & (cnt.data > 0)
        if self.is_decimal:
            return _decimal_average(self.dtype, s, cnt.data, valid)
        den = torch.where(cnt.data > 0, cnt.data,
                          torch.ones_like(cnt.data)).to(torch.float64)
        return GpuColumnVector(dt.FLOAT64, s.data / den, valid)

    def evaluate_device(self, bufs):
        return self.evaluate(bufs)


def _decimal_average(t: dt.DecimalType, s: GpuColumnVector,
                     cnt: torch.Tensor, valid: torch.Tensor) \
        -> GpuColumnVector:
    """``sum x 10^4 / count``, ``HALF_UP``, at ``t``: on the int64 lanes
    while the scaled sum fits them (the device's gate), else over
    Python's integers at the valid rows, null past ``t``'s precision."""
    shift = t.scale - s.dtype.scale
    if s.dtype.precision + shift <= dec.MAX_LANE_DIGITS \
            and not dt.is_wide_decimal(t):
        den = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
        return GpuColumnVector(t, dec.div_half_up(
            s.data * dec.POW10[shift], den), valid)
    at = torch.nonzero(valid).flatten()
    sums = dec.to_ints(GpuColumnVector(s.dtype, s.data[at]))
    out = dec.div_half_up_ints(sums * dec.POW10[shift],
                               cnt[at].cpu().numpy().astype(object))
    return _scatter_decimal(t, valid.shape[0], at, out,
                            dec.fits_ints(out, t.precision), s.device)


class _FirstLast(AggregateFunction):
    """The group's first (last) row in input order; with
    ``ignore_nulls``, its first (last) non-null one. As Spark's, the
    buffer is the value and whether one was set, so a merge skips a
    partial that saw no row."""

    take_last = False

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        self.children = (child,)
        self.ignore_nulls = ignore_nulls

    def validate(self):
        t = self.children[0].dtype
        if not is_string_like(t):
            _check_numeric(type(self).__name__.lower(), t)

    def gpu_supported(self) -> Optional[str]:
        if is_string_like(self.children[0].dtype):
            return "first/last over strings runs on the CPU"
        return None

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def buffer_fields(self):
        return [dt.StructField("v", self.dtype, True),
                dt.StructField("set", dt.BOOL, False)]

    def _marked(self, cand: torch.Tensor) -> torch.Tensor:
        """Each row's position where it is a candidate, else the value
        that never wins."""
        n = cand.shape[0]
        pos = torch.arange(n, dtype=torch.int64, device=cand.device)
        never = -1 if self.take_last else n
        return torch.where(cand, pos, torch.full_like(pos, never))

    @staticmethod
    def _picked(col, picked, found):
        idx = picked.clamp(0, max(col.capacity - 1, 0))
        out = gather_column(col, idx, found)
        return [out.with_validity(found & col.valid_mask()[idx]),
                GpuColumnVector(dt.BOOL, found, None)]

    def _global(self, col, cand):
        m = self._marked(cand)
        picked = m.max() if self.take_last else m.min()
        lane0 = row_mask(GLOBAL_LANES, 1, cand.device)
        idx = torch.where(lane0, picked, torch.zeros_like(picked))
        return self._picked(col, idx, lane0 & cand.any())

    def _reduce(self, col, cand, seg, out_live):
        picked = seg_reduce_sorted(self._marked(cand), seg, seg.shape[0],
                                   "max" if self.take_last else "min")
        found = (_seg_count(cand, seg) > 0) & out_live
        return self._picked(col, picked, found)

    def _update_cand(self, col, live):
        return _masked(col, live) if self.ignore_nulls else live

    @staticmethod
    def _merge_cand(bufs, live):
        return live & bufs[1].data

    def update(self, vals, live):
        return self._global(vals[0], self._update_cand(vals[0], live))

    def merge(self, bufs, live):
        return self._global(bufs[0], self._merge_cand(bufs, live))

    def update_device(self, vals, seg, sorted_live, out_live):
        return self._reduce(vals[0], self._update_cand(vals[0], sorted_live),
                            seg, out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        return self._reduce(bufs[0], self._merge_cand(bufs, sorted_live),
                            seg, out_live)

    def __repr__(self):
        nulls = ", ignoreNulls" if self.ignore_nulls else ""
        return f"{self.pretty_name()}({self.children[0]!r}{nulls})"


class First(_FirstLast):
    take_last = False


class Last(_FirstLast):
    take_last = True


class _CentralMoment(AggregateFunction):
    """Variance and standard deviation through mergeable float64
    ``(n, mean, m2)`` buffers (module docstring)."""

    sample = True
    take_sqrt = False

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check_numeric(type(self).__name__.lower(), self.children[0].dtype)

    @property
    def dtype(self):
        return dt.FLOAT64

    @property
    def buffer_fields(self):
        return [dt.StructField("n", dt.FLOAT64, False),
                dt.StructField("mean", dt.FLOAT64, False),
                dt.StructField("m2", dt.FLOAT64, False)]

    @staticmethod
    def _sum(v: torch.Tensor, seg: Optional[torch.Tensor]) -> torch.Tensor:
        if seg is None:
            return _lane0(v.sum(), torch.float64)
        return seg_reduce_sorted(v, seg, seg.shape[0], "sum")

    @staticmethod
    def _at_rows(lane: torch.Tensor, seg: Optional[torch.Tensor],
                 n: int) -> torch.Tensor:
        """A per-group lane read back at each input row."""
        if seg is None:
            return lane[0].expand(n)
        return lane[seg.long()]

    @staticmethod
    def _bufs(lanes, out_live):
        return [GpuColumnVector(dt.FLOAT64, lane, out_live)
                for lane in lanes]

    def _update(self, col, seg, live, out_live):
        valid = _masked(col, live)
        zero = torch.zeros((), dtype=torch.float64, device=live.device)
        x = torch.where(valid, dec.as_double(col), zero)
        n = self._sum(valid.to(torch.float64), seg)
        mean = self._sum(x, seg) / torch.where(n > 0, n, torch.ones_like(n))
        # the second pass: the exact centered sum of squares
        d = torch.where(valid, x - self._at_rows(mean, seg, x.shape[0]),
                        zero)
        return self._bufs((n, mean, self._sum(d * d, seg)), out_live)

    def _merge(self, bufs, seg, live, out_live):
        nb, mb, m2b = bufs
        ok = _masked(nb, live)
        zero = torch.zeros((), dtype=torch.float64, device=live.device)
        n_i = torch.where(ok, nb.data, zero)
        mean_i = torch.where(ok, mb.data, zero)  # 0 x garbage may be NaN
        n = self._sum(n_i, seg)
        mean = self._sum(n_i * mean_i, seg) \
            / torch.where(n > 0, n, torch.ones_like(n))
        delta = mean_i - self._at_rows(mean, seg, n_i.shape[0])
        m2 = self._sum(torch.where(ok, m2b.data + n_i * delta * delta,
                                   zero), seg)
        return self._bufs((n, mean, m2), out_live)

    def update(self, vals, live):
        return self._update(vals[0], None, live, None)

    def merge(self, bufs, live):
        return self._merge(bufs, None, live, None)

    def update_device(self, vals, seg, sorted_live, out_live):
        return self._update(vals[0], seg, sorted_live, out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        return self._merge(bufs, seg, sorted_live, out_live)

    def finish(self, n: torch.Tensor, m2: torch.Tensor):
        """``(value, defined)`` from a count and a centered sum of
        squares: a sample moment needs two rows, a population one
        one."""
        m2 = m2.clamp(min=0.0)
        floor = 1.0 if self.sample else 0.0
        defined = n > floor
        den = torch.where(defined, n - floor, torch.ones_like(n))
        var = m2 / den
        return (var.sqrt() if self.take_sqrt else var), defined

    def evaluate(self, bufs):
        n, _, m2 = bufs
        out, defined = self.finish(n.data, m2.data)
        return GpuColumnVector(dt.FLOAT64, out,
                               n.valid_mask() & defined)

    def evaluate_device(self, bufs):
        return self.evaluate(bufs)


class VarianceSamp(_CentralMoment):
    sample, take_sqrt = True, False


class VariancePop(_CentralMoment):
    sample, take_sqrt = False, False


class StddevSamp(_CentralMoment):
    sample, take_sqrt = True, True


class StddevPop(_CentralMoment):
    sample, take_sqrt = False, True


# bits of group_value_order's sort key ahead of the value lane: the
# dropped bit and the 32-bit group id
GROUP_VALUE_BITS = 1 + 32


def group_value_order(lane: torch.Tensor, width: int, keep: torch.Tensor,
                      seg: torch.Tensor) -> torch.Tensor:
    """The permutation that orders rows by ``(dropped, group, value)``,
    stably (K3 words, ``sort_keys.sort_packed``): the kept rows come
    first, by group and then by the value's unsigned ``width``-bit lane
    (the reference's sort of ``(drop, seg, lane, idx)``)."""
    return sort_packed(pack_words([
        ((~keep).to(torch.int64), 1), (seg.to(torch.int64), 32),
        (lane, width)]))[1].long()


def value_lane(col: GpuColumnVector,
               valid: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(lane, width)``: a value's unsigned orderable lane, a string's
    byte-order rank among the ``valid`` rows (K3 passes), zero where not
    ``valid``."""
    if is_string_like(col.dtype):
        lane, width = string_order_ranks(col, valid).to(torch.int64), 32
    else:
        lane, width = key_lane_bits(col)
    return torch.where(valid, lane, torch.zeros_like(lane)), width


def value_sorted_groups(col: GpuColumnVector, seg: torch.Tensor,
                        live: torch.Tensor, out_cap: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(perm, lo, n)``: the rows ordered by ``(dropped, group, value)``
    (``group_value_order``: the live non-null rows first, by group, then
    by value), and each of ``out_cap`` groups' first position and count
    of values in that order (the reference's ``_value_sorted_groups``,
    ``exec/aggregate.py:276``; its kept rows are a prefix of the order,
    so no compaction is needed)."""
    valid = _masked(col, live)
    lane, width = value_lane(col, valid)
    perm = group_value_order(lane, width, valid, seg)
    pos = torch.arange(live.shape[0], device=live.device)
    kseg = torch.where(pos < valid.sum(), seg[perm].to(torch.int64),
                       torch.full((), out_cap, dtype=torch.int64,
                                  device=live.device))
    g = torch.arange(out_cap, dtype=torch.int64, device=live.device)
    lo = torch.searchsorted(kseg, g, right=False)
    return perm, lo, torch.searchsorted(kseg, g, right=True) - lo


def spark_rank0(p: float, n: torch.Tensor) -> torch.Tensor:
    """Spark's 0-based percentile rank, ``ceil(p * n) - 1`` clamped to
    ``[0, n - 1]``, in float64 (a float32 product picks another row for
    large n); ``ApproxPercentile.rank0`` on the device."""
    r = torch.ceil(p * n.to(torch.float64)).to(torch.int64) - 1
    return torch.minimum(r.clamp(min=0), (n.to(torch.int64) - 1)
                         .clamp(min=0))


class _Collect(AggregateFunction):
    """collect_list / collect_set: each group's values as an array
    (module docstring). ``single_pass``: no partial buffers, the
    aggregate groups its whole input in one pass."""

    single_pass = True
    dedupe = False

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return dt.ArrayType(self.children[0].dtype)

    @property
    def nullable(self):
        return False

    @property
    def buffer_fields(self):
        return []

    def gpu_supported(self) -> Optional[str]:
        if dt.is_nested(self.children[0].dtype):
            return (f"{self.pretty_name().lower()} of nested elements "
                    "not on device")
        return None

    def cpu_agg(self, values):
        """The collect of Python values (the reference's ``:641``): the
        tests' oracle."""
        vals = [v for v in values if v is not None]
        if self.dedupe:
            seen, out = set(), []
            for v in vals:
                if isinstance(v, float):
                    k = ("fnan",) if math.isnan(v) else ("f", v + 0.0)
                    v = float("nan") if math.isnan(v) else v + 0.0
                else:
                    k = ("v", v)
                if k not in seen:
                    seen.add(k)
                    out.append(v)
            vals = out

        def key(v):
            if isinstance(v, float):
                return (1, 0.0) if math.isnan(v) else (0, v + 0.0)
            if isinstance(v, str):
                return v.encode()
            return v
        return sorted(vals, key=key)


class CollectList(_Collect):
    dedupe = False


class CollectSet(_Collect):
    dedupe = True


def collect_column(agg: _Collect, col: GpuColumnVector, seg: torch.Tensor,
                   live: torch.Tensor, out_cap: int,
                   out_live: torch.Tensor) -> GpuColumnVector:
    """The array column of a collect over rows grouped by ``seg`` (the
    reference's ``_collect_column``, ``exec/aggregate.py:300``): one K3
    sort by ``(dropped, group, value)`` puts each group's non-null values
    in order, a set keeps the first of each run of equal values by a K3
    compaction, and one K4 launch gathers the elements; each group's
    offset is a search over the kept rows' group ids."""
    from ..ops.gather import compaction_indices, gather_columns
    dev = live.device
    cap = live.shape[0]
    valid = _masked(col, live)
    lane, width = value_lane(col, valid)
    perm = group_value_order(lane, width, valid, seg)
    pos = torch.arange(cap, device=dev)
    total = valid.sum()
    sseg = seg[perm].to(torch.int64)
    if agg.dedupe:
        slane = lane[perm]
        first = torch.ones(cap, dtype=torch.bool, device=dev)
        first[1:] = (sseg[1:] != sseg[:-1]) | (slane[1:] != slane[:-1])
        cidx, total = compaction_indices(first & (pos < total))
        cidx = cidx.long()
        perm, sseg = perm[cidx], sseg[cidx]
    elem_live = pos < total
    kseg = torch.where(elem_live, sseg,
                       torch.full((), out_cap, dtype=torch.int64,
                                  device=dev))
    offsets = torch.searchsorted(
        kseg, torch.arange(out_cap + 1, dtype=torch.int64, device=dev),
        right=False).to(torch.int32)
    elem = gather_columns([col], perm.to(torch.int32), elem_live)[0]
    return GpuColumnVector(agg.dtype, None, out_live, offsets,
                           children=[elem])


def percentile_list_column(agg: "ApproxPercentile", col: GpuColumnVector,
                           picked: List[torch.Tensor],
                           has_vals: torch.Tensor) -> GpuColumnVector:
    """A list of percentiles: each group's ``k`` picked rows as one
    array, ``offsets = arange * k`` (the reference's
    ``exec/aggregate.py:373-380``), the elements in one K4 launch."""
    from ..ops.gather import gather_columns
    k = len(picked)
    out_cap = has_vals.shape[0]
    src = torch.stack(picked, 1).reshape(-1).to(torch.int32)
    elem = gather_columns([col], src, has_vals.repeat_interleave(k))[0]
    offsets = torch.arange(out_cap + 1, dtype=torch.int32,
                           device=has_vals.device) * k
    return GpuColumnVector(agg.dtype, None, has_vals, offsets,
                           children=[elem])


class ApproxPercentile(AggregateFunction):
    """approx_percentile(col, percentage[, accuracy]) of a number, date or
    timestamp: the value at Spark's rank ``ceil(p * n)`` among a group's
    non-null values.

    - The exact strategy (``spark.rapids.sql.approxPercentile.exact``,
      the default): the aggregate's single pass orders each group's
      values and gathers the rank (``exec/aggregate.py``
      ``_percentile_column``), rank error 0.
    - The mergeable sketch (that conf false): a group's buffer is K
      values at evenly spaced ranks (endpoints included, actual data
      values) and its count; a merge weights each member's K points by
      its count and re-extracts K ranks; the result is the point nearest
      the rank. It rides the partial and final phases like any
      fixed-width aggregate, with a rank error of about 1/K a merge
      level.

    A list of percentages returns an array of the input type, ``k``
    elements a group (``percentile_list_column``)."""

    # the compound key (group, mass) of the sketch's merge: a group's
    # stride
    _MASS_SCALE = 1 << 42

    # the exact path's preference (the reference's ``single_pass``): the
    # plan verifier counts the aggregate as device-resident; the exec
    # consults the conf for the path it takes
    single_pass = True

    def __init__(self, child: Expression, percentage,
                 accuracy: int = 10000):
        self.children = (child,)
        self.is_list = isinstance(percentage, (list, tuple))
        ps = list(percentage) if self.is_list else [percentage]
        for p in ps:
            if not 0.0 <= float(p) <= 1.0:
                raise ValueError(f"percentage {p} not in [0, 1]")
        self.percentages = tuple(float(p) for p in ps)
        self.accuracy = accuracy
        # the sketch's width: sqrt(accuracy), 64 at Spark's default
        self.K = int(min(64, max(16, round(accuracy ** 0.5))))

    def validate(self):
        t = self.children[0].dtype
        if is_string_like(t) or isinstance(t, (dt.BooleanType,
                                               dt.NullType)):
            raise NotImplementedError(
                f"approx_percentile over {t.simple_string()} is not on the "
                "device (the reference runs it on the host: the CPU "
                "fallback, ROADMAP item 12)")
        _check_numeric("approx_percentile", t, wide_ok=False)

    @property
    def dtype(self):
        t = self.children[0].dtype
        return dt.ArrayType(t) if self.is_list else t

    @property
    def buffer_fields(self):
        t = self.children[0].dtype
        return [dt.StructField(f"q{k}", t, True) for k in range(self.K)] \
            + [dt.StructField("cnt", dt.INT64, True)]

    @staticmethod
    def rank0(p: float, n: int) -> int:
        """0-based rank of percentile p among n ordered values (Spark's
        ceil(p * n), 1-based, clamped), the one definition the device
        and the host oracle share."""
        return min(max(int(math.ceil(p * n)) - 1, 0), n - 1)

    def cpu_agg(self, values):
        """The percentile of Python values (None skipped; NaN largest,
        -0.0 equal to 0.0): the tests' oracle."""
        vals = [v for v in values if v is not None]

        def key(v):
            if isinstance(v, float):
                return (1, 0.0) if math.isnan(v) else (0, v + 0.0)
            return (0, v)
        vals.sort(key=key)
        if not vals:
            return None
        out = [vals[self.rank0(p, len(vals))] for p in self.percentages]
        return out if self.is_list else out[0]

    # --- the mergeable sketch ---------------------------------------------

    def _sketch_update(self, col: GpuColumnVector, seg: torch.Tensor,
                       live: torch.Tensor, out_cap: int,
                       out_live: torch.Tensor) -> List[GpuColumnVector]:
        """K points at evenly spaced ranks of each group's sorted
        non-null values, and the group's count (``:745``)."""
        cap = live.shape[0]
        perm, lo, n_g = value_sorted_groups(col, seg, live, out_cap)
        qvalid = out_live & (n_g > 0)
        out = []
        for k in range(self.K):
            r = ((n_g - 1) * k) // (self.K - 1)
            pos = (lo + r).clamp(0, cap - 1)
            out.append(GpuColumnVector(self.children[0].dtype, col.data[perm[pos]],
                                       qvalid))
        out.append(GpuColumnVector(dt.INT64, n_g, out_live))
        return out

    def _sketch_merge(self, bufs: List[GpuColumnVector], seg: torch.Tensor,
                      live: torch.Tensor, out_cap: int,
                      out_live: torch.Tensor) -> List[GpuColumnVector]:
        """Each member's K points weighted by its count, sorted by group
        and value, and K points re-extracted at evenly spaced mass ranks
        (``:771``)."""
        K = self.K
        qcols, cnt = bufs[:K], bufs[K]
        rows = live.shape[0]
        dev = live.device
        live_row = _masked(cnt, live) & (cnt.data > 0)
        lanes = [key_lane_bits(q) for q in qcols]
        width = lanes[0][1]
        vlane = torch.stack([v for v, _ in lanes], 1).reshape(-1)
        vorig = torch.stack([q.data for q in qcols], 1).reshape(-1)
        seg_pt = seg.repeat_interleave(K)
        keep = live_row.repeat_interleave(K)
        w_pt = torch.where(live_row, cnt.data,
                           torch.zeros_like(cnt.data)).repeat_interleave(K)
        perm = group_value_order(vlane, width, keep, seg_pt)
        kept = keep[perm]
        sseg = seg_pt[perm].to(torch.int64).clamp(0, out_cap - 1)
        sw = torch.where(kept, w_pt[perm], torch.zeros_like(w_pt))
        # a group's mass: a scatter-add (the dropped points, sorted last
        # by their own group ids, carry no weight)
        totals = torch.zeros(out_cap, dtype=torch.int64, device=dev) \
            .index_add_(0, sseg, sw)
        starts_mass = torch.cumsum(totals, 0) - totals
        cum_within = torch.cumsum(sw, 0) - starts_mass[sseg]
        scale = self._MASS_SCALE
        imax = (1 << 63) - 1
        if out_cap * scale > imax:
            # the largest power-of-two stride whose keys fit int64;
            # masses clip at scale - 1 (the reference's clamp)
            scale = 1 << max(1, (imax // out_cap).bit_length() - 1)
        compound = torch.where(
            kept, sseg * scale + cum_within.clamp(0, scale - 1),
            torch.full((), imax, dtype=torch.int64, device=dev))
        g = torch.arange(out_cap, dtype=torch.int64, device=dev)
        qvalid = out_live & (totals > 0)
        total_c = totals.clamp(min=1)
        out = []
        for k in range(K):
            # the mass rank of fraction k / (K - 1), 1-based, kept inside
            # the stride
            tgt = (1 + ((total_c - 1) * k) // (K - 1)).clamp(1, scale - 1)
            pos = torch.searchsorted(compound, g * scale + tgt,
                                     right=False).clamp(0, rows * K - 1)
            out.append(GpuColumnVector(self.children[0].dtype, vorig[perm[pos]],
                                       qvalid))
        # each member's K points weigh its full count, so the mass is K
        # times the rows: the count lane stays a count
        out.append(GpuColumnVector(dt.INT64, totals // K, out_live))
        return out

    def update_device(self, vals, seg, sorted_live, out_live):
        return self._sketch_update(vals[0], seg, sorted_live,
                                   seg.shape[0], out_live)

    def merge_device(self, bufs, seg, sorted_live, out_live):
        return self._sketch_merge(bufs, seg, sorted_live, seg.shape[0],
                                  out_live)

    def _one_group(self, live: torch.Tensor):
        seg = torch.zeros(live.shape[0], dtype=torch.int32,
                          device=live.device)
        return seg, row_mask(GLOBAL_LANES, 1, live.device)

    def update(self, vals, live):
        seg, out_live = self._one_group(live)
        return self._sketch_update(vals[0], seg, live, GLOBAL_LANES,
                                   out_live)

    def merge(self, bufs, live):
        seg, out_live = self._one_group(live)
        return self._sketch_merge(bufs, seg, live, GLOBAL_LANES, out_live)

    def evaluate_device(self, bufs):
        """The sketch point nearest Spark's rank: the smallest point
        index whose summary rank ``floor((n - 1) k / (K - 1))`` reaches
        it, in exact integer arithmetic (``:847``)."""
        K = self.K
        qcols, cnt = bufs[:K], bufs[K]
        n = cnt.data
        has = cnt.valid_mask() & (n > 0)
        den = (n - 1).clamp(min=1)
        qmat = torch.stack([q.data for q in qcols], 1)
        picked = []
        for p in self.percentages:
            r = spark_rank0(p, n)
            k = ((r * (K - 1) + den - 1) // den).clamp(0, K - 1)
            picked.append(qmat.gather(1, k[:, None])[:, 0])
        t = self.children[0].dtype
        if not self.is_list:
            return GpuColumnVector(t, picked[0], has)
        k = len(picked)
        elem = torch.stack(picked, 1).reshape(-1)
        offsets = torch.arange(n.shape[0] + 1, dtype=torch.int32,
                               device=n.device) * k
        return GpuColumnVector(self.dtype, None, has, offsets, children=[
            GpuColumnVector(t, elem, has.repeat_interleave(k))])

    def evaluate(self, bufs):
        return self.evaluate_device(bufs)

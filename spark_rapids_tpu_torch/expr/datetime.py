"""Date and time expressions.

Counterpart of ``spark_rapids_tpu/expr/datetime.py``: the date parts
(``Year``, ``Month``, ``DayOfMonth``, ``Quarter``, ``DayOfWeek``,
``WeekDay``, ``DayOfYear``), ``LastDay``, the time parts (``Hour``,
``Minute``, ``Second``), ``DateAdd``/``DateSub``, ``DateDiff``,
``AddMonths``, ``MonthsBetween``, ``TruncDate``, ``UnixTimestamp``/
``UnixMicros``, ``MicrosToTimestamp`` and ``FromUnixTime``. As there,
the session time zone is UTC, a date is days since 1970-01-01 (int32)
and a timestamp microseconds (int64), and the calendar is Hinnant's
civil-from-days integer arithmetic (``ops/string_parse.civil_from_days``
and ``days_from_civil``): proleptic Gregorian, any year, no tables.

Spark's rules the reference keeps: ``add_months`` clamps the day to the
target month's last day (Jan 31 + 1 month is Feb 28 or 29);
``months_between`` is whole months when both days are their months' last
days or the same day, else months plus the day difference over 31,
rounded to 8 digits; ``dayofweek`` is 1 (Sunday) to 7, ``weekday`` 0
(Monday) to 6. ``trunc`` takes ``YEAR``/``YYYY``/``YY``,
``MONTH``/``MON``/``MM``, ``QUARTER`` and ``WEEK`` (a Monday); any other
format gives null, as in Spark (the reference raises). A date part of a
timestamp reads the timestamp's UTC day (Spark's implicit cast).
"""
from __future__ import annotations

import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, and_validity
from ..ops.numeric_format import timestamp_parts_to_string
from ..ops.string_parse import civil_from_days, days_from_civil
from .base import Expression

__all__ = ["Year", "Month", "DayOfMonth", "Quarter", "DayOfWeek",
           "WeekDay", "DayOfYear", "LastDay", "Hour", "Minute", "Second",
           "DateAdd", "DateSub", "DateDiff", "AddMonths", "MonthsBetween",
           "TruncDate", "UnixTimestamp", "FromUnixTime", "UnixMicros",
           "MicrosToTimestamp"]

_I64 = torch.int64
_US_PER_DAY = 86400 * 1_000_000


def _floordiv(x, d):
    return torch.div(x, d, rounding_mode="floor")


def _days(col: GpuColumnVector, t: dt.DataType) -> torch.Tensor:
    """A date's day number, or a timestamp's UTC day, as int64."""
    if isinstance(t, dt.TimestampType):
        return _floordiv(col.data.to(_I64), _US_PER_DAY)
    return col.data.to(_I64)


def _check(name: str, t: dt.DataType, *allowed) -> None:
    if not isinstance(t, allowed):
        raise TypeError(f"{name} needs a "
                        f"{' or '.join(a.__name__ for a in allowed)}, got "
                        f"{t.simple_string()}")


def _last_day_of_month(y, m):
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    return days_from_civil(ny, nm, torch.ones_like(m)) - 1


class _DatePart(Expression):
    """An int32 field of a date."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check(self.pretty_name(), self.children[0].dtype, dt.DateType,
               dt.TimestampType)

    @property
    def dtype(self):
        return dt.INT32

    def part(self, days, y, m, d):
        raise NotImplementedError

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        days = _days(c, self.children[0].dtype)
        y, m, d = civil_from_days(days)
        return GpuColumnVector(self.dtype, self.part(days, y, m, d)
                               .to(torch.int32), c.validity)


class Year(_DatePart):
    def part(self, days, y, m, d):
        return y


class Month(_DatePart):
    def part(self, days, y, m, d):
        return m


class DayOfMonth(_DatePart):
    def part(self, days, y, m, d):
        return d


class Quarter(_DatePart):
    def part(self, days, y, m, d):
        return _floordiv(m - 1, 3) + 1


class DayOfWeek(_DatePart):
    """1 = Sunday ... 7 = Saturday; day 0 (1970-01-01) was a Thursday."""

    def part(self, days, y, m, d):
        return (days + 4) % 7 + 1


class WeekDay(_DatePart):
    """0 = Monday ... 6 = Sunday."""

    def part(self, days, y, m, d):
        return (days + 3) % 7


class DayOfYear(_DatePart):
    def part(self, days, y, m, d):
        one = torch.ones_like(m)
        return days - days_from_civil(y, one, one) + 1


class LastDay(_DatePart):
    """The last day of the date's month, as a date."""

    @property
    def dtype(self):
        return dt.DATE

    def part(self, days, y, m, d):
        return _last_day_of_month(y, m)


class _TimePart(Expression):
    div = 1
    mod = 24

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check(self.pretty_name(), self.children[0].dtype,
               dt.TimestampType)

    @property
    def dtype(self):
        return dt.INT32

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        secs = _floordiv(c.data.to(_I64), 1_000_000)
        out = _floordiv(secs, self.div) % self.mod
        return GpuColumnVector(dt.INT32, out.to(torch.int32), c.validity)


class Hour(_TimePart):
    div, mod = 3600, 24


class Minute(_TimePart):
    div, mod = 60, 60


class Second(_TimePart):
    div, mod = 1, 60


class DateAdd(Expression):
    sign = 1

    def __init__(self, date: Expression, days: Expression):
        self.children = (date, days)

    def validate(self):
        _check(self.pretty_name(), self.children[0].dtype, dt.DateType)
        if not dt.is_integral(self.children[1].dtype):
            raise TypeError(f"{self.pretty_name()} adds an integer number "
                            "of days")

    @property
    def dtype(self):
        return dt.DATE

    def eval_gpu(self, batch, ctx):
        d = self.children[0].eval_gpu(batch, ctx)
        n = self.children[1].eval_gpu(batch, ctx)
        out = d.data.to(torch.int32) + self.sign * n.data.to(torch.int32)
        return GpuColumnVector(dt.DATE, out,
                               and_validity(d.validity, n.validity))


class DateSub(DateAdd):
    sign = -1


class DateDiff(Expression):
    """datediff(end, start): days from ``start`` to ``end``."""

    def __init__(self, end: Expression, start: Expression):
        self.children = (end, start)

    def validate(self):
        for c in self.children:
            _check("DateDiff", c.dtype, dt.DateType)

    @property
    def dtype(self):
        return dt.INT32

    def eval_gpu(self, batch, ctx):
        e = self.children[0].eval_gpu(batch, ctx)
        s = self.children[1].eval_gpu(batch, ctx)
        return GpuColumnVector(dt.INT32, (e.data.to(torch.int32)
                                          - s.data.to(torch.int32)),
                               and_validity(e.validity, s.validity))


def add_months(days: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Each day ``n`` months on, the day clamped to the target month's
    last day."""
    y, m, d = civil_from_days(days)
    tot = y * 12 + (m - 1) + n.to(_I64)
    ny = _floordiv(tot, 12)
    nm = tot - ny * 12 + 1
    _, _, last = civil_from_days(_last_day_of_month(ny, nm))
    return days_from_civil(ny, nm, torch.minimum(d, last))


class AddMonths(Expression):
    def __init__(self, date: Expression, months: Expression):
        self.children = (date, months)

    def validate(self):
        _check("AddMonths", self.children[0].dtype, dt.DateType)
        if not dt.is_integral(self.children[1].dtype):
            raise TypeError("add_months adds an integer number of months")

    @property
    def dtype(self):
        return dt.DATE

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        n = self.children[1].eval_gpu(batch, ctx)
        out = add_months(c.data.to(_I64), n.data)
        return GpuColumnVector(dt.DATE, out.to(torch.int32),
                               and_validity(c.validity, n.validity))


class MonthsBetween(Expression):
    """months_between(end, start) of two dates (module docstring)."""

    def __init__(self, end: Expression, start: Expression,
                 round_off: bool = True):
        self.children = (end, start)
        self.round_off = round_off

    def validate(self):
        for c in self.children:
            _check("MonthsBetween", c.dtype, dt.DateType)

    @property
    def dtype(self):
        return dt.FLOAT64

    def eval_gpu(self, batch, ctx):
        e = self.children[0].eval_gpu(batch, ctx)
        s = self.children[1].eval_gpu(batch, ctx)
        ed_, sd_ = e.data.to(_I64), s.data.to(_I64)
        ey, em, ed = civil_from_days(ed_)
        sy, sm, sd = civil_from_days(sd_)
        both_last = (ed_ == _last_day_of_month(ey, em)) \
            & (sd_ == _last_day_of_month(sy, sm))
        months = ((ey - sy) * 12 + (em - sm)).to(torch.float64)
        frac = (ed - sd).to(torch.float64) / 31.0
        out = torch.where(both_last, months, months + frac)
        if self.round_off:
            out = torch.round(out * 1e8) / 1e8
        return GpuColumnVector(dt.FLOAT64, out,
                               and_validity(e.validity, s.validity))


class TruncDate(Expression):
    """trunc(date, fmt) (module docstring)."""

    _UNITS = {"YEAR": "year", "YYYY": "year", "YY": "year",
              "MONTH": "month", "MON": "month", "MM": "month",
              "QUARTER": "quarter", "WEEK": "week"}

    def __init__(self, child: Expression, fmt: str):
        self.children = (child,)
        self.fmt = fmt.upper()

    def validate(self):
        _check("TruncDate", self.children[0].dtype, dt.DateType)

    @property
    def dtype(self):
        return dt.DATE

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        unit = self._UNITS.get(self.fmt)
        if unit is None:
            return GpuColumnVector.nulls(dt.DATE, c.capacity, c.device)
        days = c.data.to(_I64)
        y, m, _ = civil_from_days(days)
        one = torch.ones_like(m)
        if unit == "year":
            out = days_from_civil(y, one, one)
        elif unit == "month":
            out = days_from_civil(y, m, one)
        elif unit == "quarter":
            out = days_from_civil(y, _floordiv(m - 1, 3) * 3 + 1, one)
        else:
            out = days - (days + 3) % 7
        return GpuColumnVector(dt.DATE, out.to(torch.int32), c.validity)

    def __repr__(self):
        return f"TruncDate({self.children[0]!r}, {self.fmt!r})"


class UnixTimestamp(Expression):
    """unix_timestamp(ts or date): whole seconds since the epoch."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        _check(self.pretty_name(), self.children[0].dtype,
               dt.TimestampType, dt.DateType)

    @property
    def dtype(self):
        return dt.INT64

    def _micros(self, c):
        us = c.data.to(_I64)
        if isinstance(self.children[0].dtype, dt.DateType):
            us = us * _US_PER_DAY
        return us

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        return GpuColumnVector(dt.INT64,
                               _floordiv(self._micros(c), 1_000_000),
                               c.validity)


class UnixMicros(UnixTimestamp):
    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        return GpuColumnVector(dt.INT64, self._micros(c), c.validity)


class MicrosToTimestamp(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        if not dt.is_integral(self.children[0].dtype):
            raise TypeError("timestamp_micros needs an integer")

    @property
    def dtype(self):
        return dt.TIMESTAMP

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        return GpuColumnVector(dt.TIMESTAMP, c.data.to(_I64), c.validity)


class FromUnixTime(Expression):
    """from_unixtime(seconds): ``yyyy-MM-dd HH:mm:ss`` (UTC)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def validate(self):
        if not dt.is_integral(self.children[0].dtype):
            raise TypeError("from_unixtime needs integer seconds")

    @property
    def dtype(self):
        return dt.STRING

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        secs = c.data.to(_I64)
        days = _floordiv(secs, 86400)
        return timestamp_parts_to_string(days, secs - days * 86400,
                                         torch.zeros_like(secs),
                                         c.validity, with_fraction=False)

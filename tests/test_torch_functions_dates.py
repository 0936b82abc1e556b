"""The port's date and time functions (``spark_rapids_tpu_torch/expr/
datetime.py``) against the JAX package's (``spark_rapids_tpu/expr/
datetime.py``) on the CPU.

Inputs are seeded day numbers around leap days (2000-02-29, 1900-03-01),
month ends, dates before 1970 (to year 1) and past 9999, and
microsecond timestamps of both signs, 15% null. Tolerance: every result
is exact (dates, integers, strings), ``months_between`` too (the same
float64 operations in the same order).

Where the reference departs from Spark the port follows Spark and the
test holds the port to Python's ``datetime``: ``trunc`` with an unknown
format is null (the reference raises), and a date part of a timestamp
reads its UTC day (the reference asserts a date).
"""
import datetime

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.expr.datetime as jd
import spark_rapids_tpu_torch.expr.datetime as td
from spark_rapids_tpu.expr.base import Literal as JLit
from spark_rapids_tpu_torch.expr.base import Literal as TLit
from torch_function_cases import batch, days, eval_both, port_only, same

N = 500
EPOCH = datetime.date(1970, 1, 1)


@pytest.fixture(scope="module")
def rb():
    rng = np.random.default_rng(21)
    us = rng.integers(-(1 << 52), 1 << 52, N)
    us[:6] = [0, -1, 1, 86_399_999_999, -86_400_000_000, 951_782_400_000_001]
    return batch({"d": (pa.date32(), days(N, rng)),
                  "e": (pa.date32(), days(N, rng)),
                  "k": (pa.int32(), rng.integers(-400, 400, N)
                        .astype(np.int32)),
                  "ts": (pa.timestamp("us", tz="UTC"), us),
                  "sec": (pa.int64(), rng.integers(-(1 << 34), 1 << 34, N))},
                 seed=21)


PARTS = ["Year", "Month", "DayOfMonth", "Quarter", "DayOfWeek", "WeekDay",
         "DayOfYear", "LastDay"]


@pytest.mark.parametrize("name", PARTS)
def test_date_parts_equal_the_reference(rb, name):
    got, want = eval_both(rb, lambda c: getattr(td, name)(c("d")),
                          lambda c: getattr(jd, name)(c("d")))
    same(got, want)


@pytest.mark.parametrize("name", ["Hour", "Minute", "Second"])
def test_time_parts_equal_the_reference(rb, name):
    got, want = eval_both(rb, lambda c: getattr(td, name)(c("ts")),
                          lambda c: getattr(jd, name)(c("ts")))
    same(got, want)


def _civil(z):
    """Hinnant's civil_from_days in Python integers (any year)."""
    z += 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    m = mp + 3 if mp < 10 else mp - 9
    return yoe + era * 400 + (m <= 2), m, doy - (153 * mp + 2) // 5 + 1


def _days(y, m, d):
    y -= m <= 2
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m - 3 if m > 2 else m + 9) + 2) // 5 + d - 1
    return era * 146097 + yoe * 365 + yoe // 4 - yoe // 100 + doy - 719468


def _spark_add_months(day, k):
    y, m, d = _civil(day)
    ny, nm0 = divmod(y * 12 + m - 1 + k, 12)
    nxt = _days(ny + (nm0 == 11), (nm0 + 1) % 12 + 1, 1)
    return _days(ny, nm0 + 1, min(d, _civil(nxt - 1)[2]))


@pytest.mark.parametrize("name", ["DateAdd", "DateSub", "AddMonths"])
def test_date_arithmetic_equals_the_reference(rb, name):
    got, want = eval_both(rb, lambda c: getattr(td, name)(c("d"), c("k")),
                          lambda c: getattr(jd, name)(c("d"), c("k")))
    if name != "AddMonths":
        same(got, want)
        return
    # the reference floors a negative month count twice, so it departs
    # from the proleptic calendar before year 0: the port is held to
    # Python's integers on every row, to the reference from year 0 on
    d = rb.column("d").cast(pa.int32()).to_pylist()
    k = rb.column("k").to_pylist()
    spark = [None if a is None or b is None else _spark_add_months(a, b)
             for a, b in zip(d, k)]
    same(got, spark)
    same(got, want, where=[v is None or v >= _days(0, 1, 1) for v in spark])


@pytest.mark.parametrize("name", ["DateDiff", "MonthsBetween"])
def test_date_differences_equal_the_reference(rb, name):
    got, want = eval_both(rb, lambda c: getattr(td, name)(c("d"), c("e")),
                          lambda c: getattr(jd, name)(c("d"), c("e")))
    same(got, want, 0.0)


@pytest.mark.parametrize("fmt", ["YEAR", "yyyy", "YY", "MONTH", "MON", "mm",
                                 "QUARTER", "WEEK"])
def test_trunc_equals_the_reference(rb, fmt):
    got, want = eval_both(rb, lambda c: td.TruncDate(c("d"), fmt),
                          lambda c: jd.TruncDate(c("d"), fmt))
    same(got, want)


def test_trunc_with_an_unknown_format_is_null():
    rb = pa.record_batch({"d": pa.array([0, 100], pa.int32())
                          .view(pa.date32())})
    got = port_only(rb, lambda c: td.TruncDate(c("d"), "DECADE"))
    assert got.to_pylist() == [None, None]
    with pytest.raises(ValueError):
        eval_both(rb, lambda c: td.TruncDate(c("d"), "MM"),
                  lambda c: jd.TruncDate(c("d"), "DECADE"))


@pytest.mark.parametrize("name,col", [("UnixTimestamp", "ts"),
                                      ("UnixTimestamp", "d"),
                                      ("UnixMicros", "ts"),
                                      ("FromUnixTime", "sec"),
                                      ("MicrosToTimestamp", "sec")])
def test_epoch_conversions_equal_the_reference(rb, name, col):
    got, want = eval_both(rb, lambda c: getattr(td, name)(c(col)),
                          lambda c: getattr(jd, name)(c(col)))
    same(got, want)


def test_spark_calendar_corners():
    dates = [datetime.date(2000, 1, 31), datetime.date(2000, 2, 29),
             datetime.date(1900, 2, 28), datetime.date(1969, 12, 31),
             datetime.date(2001, 3, 31), datetime.date(1, 1, 1),
             datetime.date(9999, 12, 31)]
    rb = pa.record_batch({"d": pa.array(dates, pa.date32())})

    def run(build):
        out = port_only(rb, lambda c: build(c("d")))
        if pa.types.is_date32(out.type):
            # Python's dates stop at 9999: day numbers past it stay ints
            n = out.cast(pa.int32()).to_pylist()
            return [EPOCH + datetime.timedelta(days=v) if v <= 2932896
                    else v for v in n]
        return out.to_pylist()
    assert run(lambda d: td.AddMonths(d, TLit(1)))[:5] == [
        datetime.date(2000, 2, 29), datetime.date(2000, 3, 29),
        datetime.date(1900, 3, 28), datetime.date(1970, 1, 31),
        datetime.date(2001, 4, 30)]
    assert run(td.LastDay)[:3] == [datetime.date(2000, 1, 31),
                                   datetime.date(2000, 2, 29),
                                   datetime.date(1900, 2, 28)]
    assert run(td.DayOfWeek) == [d.isoweekday() % 7 + 1 for d in dates]
    assert run(td.Year) == [d.year for d in dates]
    end = pa.record_batch({"a": pa.array([datetime.date(2000, 3, 31),
                                          datetime.date(2000, 3, 30)],
                                         pa.date32()),
                           "b": pa.array([datetime.date(2000, 2, 29),
                                          datetime.date(2000, 2, 29)],
                                         pa.date32())})
    mb = port_only(end, lambda c: td.MonthsBetween(c("a"), c("b")))
    # both month ends: whole months; otherwise the day difference / 31
    assert mb.to_pylist() == [1.0, round(1 + 1 / 31, 8)]


def test_date_parts_of_a_timestamp_read_its_utc_day(rb):
    got = port_only(rb, lambda c: td.Year(c("ts"))).to_pylist()
    for v, g in zip(rb.column("ts").to_pylist(), got):
        assert g == (None if v is None else v.year)


def test_types_are_checked():
    with pytest.raises(TypeError):
        td.DateAdd(TLit(datetime.date(2000, 1, 1)), TLit(1.5)).validate()
    with pytest.raises(TypeError):
        td.Hour(TLit(datetime.date(2000, 1, 1))).validate()
    assert td.LastDay(TLit(None)).dtype.simple_string() == \
        jd.LastDay(JLit(None)).dtype.simple_string()

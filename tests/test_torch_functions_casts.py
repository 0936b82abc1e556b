"""The port's string, date and timestamp casts (``spark_rapids_tpu_torch/
expr/cast.py``, ``ops/string_parse.py``, ``ops/numeric_format.py``)
against the JAX package's on the CPU.

Inputs are seeded strings of numbers in every accepted form and many
rejected ones (spaces around, signs, fractions, exponents, ``nan``/
``inf``, 19- and 20-digit values, the lanes' bounds, ``1e3``, empty and
blank strings), dates (leap days, ``2000-02-30``, pre-1970, a ``T`` or
space tail) and booleans, 15% null; integers with INT64_MIN, dates before
1970 and microsecond timestamps of both signs. Tolerance: every result
is exact except a parsed double, rel 1e-15 (the device path scales two
digit runs by powers of ten, an ulp from strtod past 15 digits, as the
reference documents).

- string -> integral, float, boolean and date on the device against the
  reference's ``eval_tpu``, and on the CPU path (the reference's Python
  parser) against its ``eval_cpu``;
- integral, boolean, date and timestamp -> string on the device, and
  float -> string and string -> timestamp on the CPU path, against the
  reference;
- date <-> timestamp, timestamp -> numbers and seconds -> timestamp;
- placement equals the reference's ``tpu_supported``/
  ``tpu_supported_conf``, ANSI on and off; under ANSI the CPU path
  raises on an unparsable live row, as the reference's does;
- decimal casts raise naming ROADMAP item 2.
"""
import datetime

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.datatypes as jdt
import spark_rapids_tpu_torch.datatypes as tdt
from spark_rapids_tpu.expr.base import ExprError as JExprError
from spark_rapids_tpu.expr.base import Literal as JLit
from spark_rapids_tpu.expr.cast import Cast as JCast
from spark_rapids_tpu_torch.expr.base import ExprError as TExprError
from spark_rapids_tpu_torch.expr.base import Literal as TLit
from spark_rapids_tpu_torch.expr.cast import Cast as TCast
from spark_rapids_tpu_torch.expr.cast import cast_supported
from torch_function_cases import (batch, days, eval_both, ints, port_only,
                                  same)

N = 600
NUMBER_TEXTS = ["0", "1", "-1", "+7", " 12 ", "\t42\n", "1.9", "-1.9",
                "12.", ".5", "1e3", "1E-2", "-2.5e+3", "nan", "NaN", "inf",
                "-Infinity", "+inf", "abc", "", "  ", "1 2", "--1", "+-1",
                "127", "128", "-128", "-129", "32767", "32768",
                "2147483647", "2147483648", "-2147483648", "-2147483649",
                "9223372036854775807", "9223372036854775808",
                "-9223372036854775808", "-9223372036854775809",
                "99999999999999999999", "00000000000000000000123",
                "3.14159265358979", "1e308", "1e309", "-0", "-0.0", "0x10",
                "1_0", "١٢"]
DATE_TEXTS = ["2000-01-01", "2000-02-29", "2001-02-29", "2000-02-30",
              "1969-12-31", "1900-03-01", "0001-01-01", "9999-12-31",
              "2000-1-5", "2000-01-01T10:00:00", "2000-01-01 junk",
              " 2000-01-01 ", "2000/01/01", "20000101", "2000-13-01",
              "2000-00-10", "99-01-01", ""]
BOOL_TEXTS = ["t", "true", "TRUE", "y", "yes", "1", "f", "false", "n", "no",
              "0", " true ", "tru", "2", ""]
TS_TEXTS = ["2000-01-01 10:11:12", "2000-01-01T10:11:12.5",
            "1969-12-31 23:59:59.999999", "2000-01-01", "2000-01-01 25:00:00",
            "junk"]

TARGETS = {"INT8": pa.int8(), "INT16": pa.int16(), "INT32": pa.int32(),
           "INT64": pa.int64(), "FLOAT32": pa.float32(),
           "FLOAT64": pa.float64(), "BOOL": pa.bool_(), "DATE": pa.date32()}


@pytest.fixture(scope="module")
def rb():
    rng = np.random.default_rng(33)
    texts = NUMBER_TEXTS + DATE_TEXTS + BOOL_TEXTS
    us = rng.integers(-(1 << 52), 1 << 52, N)
    us[:4] = [0, -1, 1_500_000, -86_400_000_001]
    return batch({
        "s": (pa.string(), [str(v) for v in rng.choice(
            np.array(texts, dtype=object), N)]),
        "i": (pa.int64(), ints(N, rng)),
        "b": (pa.bool_(), rng.random(N) < 0.5),
        "d": (pa.date32(), days(N, rng)),
        "ts": (pa.timestamp("us", tz="UTC"), us),
        "x": (pa.float64(), rng.normal(size=N) * 10.0 **
              rng.integers(-20, 20, N))}, seed=33)


def _cast(name, col):
    return (lambda c: TCast(c(col), getattr(tdt, name)),
            lambda c: JCast(c(col), getattr(jdt, name)))


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("host", [False, True], ids=["device", "cpu"])
def test_string_parses_equal_the_reference(rb, target, host):
    tp, jp = _cast(target, "s")
    got, want = eval_both(rb, tp, jp, host=host)
    same(got, want, 1e-15 if target.startswith("FLOAT") else 0.0)


@pytest.mark.parametrize("source", ["i", "b", "d", "ts"])
@pytest.mark.parametrize("host", [False, True], ids=["device", "cpu"])
def test_to_string_equals_the_reference(rb, source, host):
    if source == "d" and host:
        # the reference's host path is pyarrow's cast, which prints a
        # year past 9999 with five digits where its device path (and
        # the port's) wraps to four: compare the years it can print
        keep = [v is None or v <= 2932896 for v in
                rb.column("d").cast(pa.int32()).to_pylist()]
        rb = rb.filter(pa.array(keep))
    tp, jp = _cast("STRING", source)
    got, want = eval_both(rb, tp, jp, host=host)
    same(got, want)


def test_float_to_string_and_string_to_timestamp_run_on_the_host(rb):
    tp, jp = _cast("STRING", "x")
    got, want = eval_both(rb, tp, jp, host=True)
    same(got, want)
    tsb = pa.record_batch({"s": pa.array(TS_TEXTS + [None])})
    tp, jp = _cast("TIMESTAMP", "s")
    got, want = eval_both(tsb, tp, jp, host=True)
    same(got, want)
    for f, t in (("FLOAT64", "STRING"), ("FLOAT32", "STRING"),
                 ("STRING", "TIMESTAMP")):
        assert TCast(TLit(None, getattr(tdt, f)), getattr(tdt, t)) \
            .gpu_supported() is not None
        assert JCast(JLit(None, getattr(jdt, f)), getattr(jdt, t)) \
            .tpu_supported() is not None


@pytest.mark.parametrize("pair", [("d", "TIMESTAMP"), ("ts", "DATE"),
                                  ("ts", "INT64"), ("ts", "INT32"),
                                  ("ts", "FLOAT64"), ("i", "TIMESTAMP")])
def test_date_and_timestamp_casts_equal_the_reference(rb, pair):
    col, target = pair
    if col == "i":
        # seconds past the microsecond lane overflow in both packages
        rb = pa.record_batch({"i": pa.array(
            [None if v is None else max(min(v, 1 << 40), -(1 << 40))
             for v in rb.column("i").to_pylist()], pa.int64())})
    tp, jp = _cast(target, col)
    got, want = eval_both(rb, tp, jp)
    same(got, want, 0.0)


@pytest.mark.parametrize("ansi", [False, True])
def test_placement_equals_the_reference_with_ansi_on_and_off(ansi):
    from spark_rapids_tpu.config import RapidsConf as JConf
    from spark_rapids_tpu_torch.config import RapidsConf as TConf
    conf = {"spark.sql.ansi.enabled": str(ansi).lower()}
    tconf, jconf = TConf(conf), JConf(conf)
    sources = ["STRING", "INT64", "INT8", "BOOL", "FLOAT32", "FLOAT64",
               "DATE", "TIMESTAMP"]
    for f in sources:
        for t in sources:
            te = TCast(TLit(None, getattr(tdt, f)), getattr(tdt, t))
            je = JCast(JLit(None, getattr(jdt, f)), getattr(jdt, t))
            if not cast_supported(getattr(tdt, f), getattr(tdt, t)):
                continue
            tr = te.gpu_supported() or te.gpu_supported_conf(tconf)
            jr = je.tpu_supported() or je.tpu_supported_conf(jconf)
            assert (tr is None) == (jr is None), (f, t, ansi, tr, jr)


def test_ansi_string_casts_raise_on_the_host_path():
    rb = pa.record_batch({"s": pa.array(["12", "x", None])})
    for target in ("INT32", "FLOAT64", "DATE", "BOOL"):
        tp, jp = _cast(target, "s")
        with pytest.raises(TExprError):
            port_only(rb, tp, host=True, ansi=True)
        with pytest.raises(JExprError):
            eval_both(rb, lambda c: TCast(c("s"), tdt.STRING), jp,
                      host=True, ansi=True)
    ok = pa.record_batch({"s": pa.array(["12", " 7 ", None])})
    tp, jp = _cast("INT32", "s")
    got, want = eval_both(ok, tp, jp, host=True, ansi=True)
    same(got, want)


def test_spark_corners():
    rb = pa.record_batch({"s": pa.array([" 12 ", "1.9", "1e3", "2000-02-30",
                                         "-9223372036854775808"])})
    assert port_only(rb, _cast("INT32", "s")[0]).to_pylist() == \
        [12, 1, None, None, None]
    assert port_only(rb, _cast("FLOAT64", "s")[0]).to_pylist()[:3] == \
        [12.0, 1.9, 1000.0]
    assert port_only(rb, _cast("DATE", "s")[0]).to_pylist()[3] is None
    assert port_only(rb, _cast("INT64", "s")[0]).to_pylist()[4] == -(1 << 63)
    nums = pa.record_batch({"i": pa.array([-(1 << 63), 0, -5], pa.int64()),
                            "d": pa.array([datetime.date(1969, 7, 20),
                                           datetime.date(2000, 2, 29),
                                           datetime.date(1, 1, 1)],
                                          pa.date32())})
    assert port_only(nums, _cast("STRING", "i")[0]).to_pylist() == \
        ["-9223372036854775808", "0", "-5"]
    assert port_only(nums, _cast("STRING", "d")[0]).to_pylist() == \
        ["1969-07-20", "2000-02-29", "0001-01-01"]


def test_decimal_casts_name_item_2():
    """The decimal casts are ported (tests/test_torch_decimal_expr.py);
    a cast to or from a nested type still raises, naming item 2."""
    for src, dst in ((tdt.DecimalType(9, 2), tdt.INT64),
                     (tdt.INT64, tdt.DecimalType(9, 2)),
                     (tdt.STRING, tdt.DecimalType(9, 2))):
        TCast(TLit(None, src), dst).validate()
    with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
        TCast(TLit(None, tdt.MapType(tdt.STRING, tdt.INT32)),
              tdt.STRING).validate()

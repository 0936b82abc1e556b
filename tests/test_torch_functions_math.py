"""The port's math functions (``spark_rapids_tpu_torch/expr/math.py``)
against the JAX package's (``spark_rapids_tpu/expr/math.py``) on the CPU.

Inputs are seeded numpy values with NaN, +-inf, -0.0, 1e+-300, values on
both sides of every rounding tie (0.5, 2.5, 1.005, 2.675) and the long
lane's bounds, 15% null. Tolerance: integers, nulls and the rounded
doubles exact; the transcendental functions rel 1e-9 (torch's and XLA's
libm agree to an ulp or two, far inside it).

- the device paths against the reference's ``eval_tpu``; a double's
  ``round``/``bround`` on the CPU path (exact through ``decimal``, as
  Spark's BigDecimal) against the reference's ``eval_cpu``, and its
  device form (float scaling) against ``eval_tpu``;
- placement: a double's round refuses the device exactly as the
  reference's ``tpu_supported`` does, an integer's does not;
- Spark's corners held to Python's rules: ``round(2.5)`` is 3,
  ``bround(2.5)`` is 2, ``floor`` of +-inf and NaN saturates and zeroes,
  ``ln`` of 0 and of a negative is null;
- where the reference departs from Spark (it asserts a double input, so
  ``sqrt``/``pow``/``sign`` of an integer fail there), the port casts to
  double as Spark does: held to Python's ``math``.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.expr.math as jm
import spark_rapids_tpu_torch.expr.math as tm
from torch_function_cases import (FLOAT_RTOL, batch, eval_both, floats,
                                  ints, port_only, same)

N = 500
UNARY = ["Sqrt", "Cbrt", "Exp", "Expm1", "Log", "Log10", "Log2", "Log1p",
         "Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
         "Tanh", "Signum", "ToDegrees", "ToRadians", "Rint"]


@pytest.fixture(scope="module")
def rb():
    rng = np.random.default_rng(16)
    return batch({"x": (pa.float64(), floats(N, rng)),
                  "y": (pa.float64(), floats(N, rng)),
                  "i": (pa.int64(), ints(N, rng)),
                  "q": (pa.int32(), ints(N, rng, -(1 << 31), (1 << 31) - 1)
                        .astype(np.int32)),
                  "f": (pa.float32(), floats(N, rng).astype(np.float32))},
                 seed=16)


_TINY = 2.2250738585072014e-308  # the least normal double


def _subnormal(values) -> list:
    return [v is not None and v != 0 and abs(v) < _TINY for v in values]


def _flushed(*arrays) -> list:
    """Rows where any array holds a subnormal (XLA's CPU backend flushes
    it to zero; Java and the port keep it)."""
    out = [False] * len(arrays[0])
    for a in arrays:
        out = [o or s for o, s in zip(out, _subnormal(a.to_pylist()))]
    return out


def _near(got: pa.Array, want: pa.Array, where) -> None:
    """Rows of ``where`` equal, or both below the normal range."""
    for i, (a, b) in enumerate(zip(got.to_pylist(), want.to_pylist())):
        if not where[i] or (a is None and b is None):
            continue
        if isinstance(a, float) and (math.isnan(a) or math.isnan(b)):
            assert math.isnan(a) and math.isnan(b), (i, a, b)
            continue
        assert a == b or abs(a - b) < _TINY or math.isclose(
            a, b, rel_tol=FLOAT_RTOL), (i, a, b)


@pytest.mark.parametrize("name", UNARY)
def test_unary_math_equals_the_reference(rb, name):
    for c in ("x", "f"):
        got, want = eval_both(rb, lambda col: getattr(tm, name)(col(c)),
                              lambda col: getattr(jm, name)(col(c)))
        # XLA's CPU backend flushes a subnormal input to zero; Java and
        # the port do not: those rows are held to the reference's numpy
        # host path instead
        sub = _flushed(rb.column(c), got)
        same(got, want, FLOAT_RTOL, where=[not s for s in sub])
        _, host = eval_both(rb, lambda col: getattr(tm, name)(col(c)),
                            lambda col: getattr(jm, name)(col(c)),
                            host=True)
        _near(got, host, sub)


@pytest.mark.parametrize("name", ["Floor", "Ceil"])
def test_floor_and_ceil_equal_the_reference(rb, name):
    for c in ("x", "i", "q"):
        got, want = eval_both(rb, lambda col: getattr(tm, name)(col(c)),
                              lambda col: getattr(jm, name)(col(c)))
        sub = _flushed(rb.column(c))
        same(got, want, 0.0, where=[not s for s in sub])
        f = math.ceil if name == "Ceil" else math.floor
        for v, g, s in zip(rb.column(c).to_pylist(), got.to_pylist(), sub):
            if s:
                assert g == f(v), (v, g)


@pytest.mark.parametrize("name", ["Pow", "Atan2", "Hypot"])
def test_binary_math_equals_the_reference(rb, name):
    got, want = eval_both(rb, lambda col: getattr(tm, name)(col("x"),
                                                           col("y")),
                          lambda col: getattr(jm, name)(col("x"), col("y")))
    sub = _flushed(rb.column("x"), rb.column("y"), got)
    same(got, want, FLOAT_RTOL, where=[not s for s in sub])


@pytest.mark.parametrize("name,digits", [
    (n, d) for n in ("Round", "BRound") for d in (0, -1, -2, -5, -18,
                                                   -19, 2)])
def test_integer_round_equals_the_reference(rb, name, digits):
    """Held to Spark's rule (BigDecimal rounding, then Java's wrap to
    the lane) on every row, and to the reference where the rounded value
    stays inside the lane and the input is not INT64_MIN: the
    reference's int64 arithmetic wraps otherwise, and its 10^19 (scale
    -19) does not fit int64 at all."""
    import decimal
    for c, bits in (("i", 64), ("q", 32)):
        vals = rb.column(c).to_pylist()
        got = port_only(rb, lambda col: getattr(tm, name)(col(c), digits))
        mode = decimal.ROUND_HALF_EVEN if name == "BRound" \
            else decimal.ROUND_HALF_UP
        half = 1 << (bits - 1)
        spark, inside = [], []
        for v in vals:
            if v is None:
                spark.append(None)
                inside.append(True)
                continue
            r = int(decimal.Decimal(v).quantize(
                decimal.Decimal(1).scaleb(-digits), rounding=mode)) \
                if digits < 0 else v
            # the reference takes |INT64_MIN|, which wraps
            inside.append(-half <= r < half and v != -(1 << 63))
            spark.append((r + half) % (1 << bits) - half)
        same(got, spark, 0.0)
        if digits > -19:
            _, want = eval_both(
                rb, lambda col: getattr(tm, name)(col(c), digits),
                lambda col: getattr(jm, name)(col(c), digits))
            same(got, want, 0.0, where=inside)


@pytest.mark.parametrize("name,digits", [
    (n, d) for n in ("Round", "BRound") for d in (0, 1, 2, 3, -1, -2)])
def test_double_round_on_each_path_equals_the_reference(rb, name,
                                                        digits):
    # the CPU path: decimal-exact, as the reference's eval_cpu, on the
    # values its 28-digit decimal context takes (it raises on 1e300);
    # every value, huge ones too, against Python's exact decimal
    import decimal
    x = rb.column("x").to_pylist()
    xs = [None if v is None or (math.isfinite(v) and abs(v) >= 1e15)
          else v for v in x]
    small = pa.record_batch({"x": pa.array(xs, pa.float64())})
    got, want = eval_both(small, lambda col: getattr(tm, name)(col("x"),
                                                              digits),
                          lambda col: getattr(jm, name)(col("x"), digits),
                          host=True)
    same(got, want, 0.0)
    got = port_only(rb, lambda col: getattr(tm, name)(col("x"), digits),
                    host=True)
    mode = decimal.ROUND_HALF_EVEN if name == "BRound" \
        else decimal.ROUND_HALF_UP
    with decimal.localcontext() as dctx:
        dctx.prec = 800
        exact = [v if v is None or not math.isfinite(v) else float(
            decimal.Decimal(v).quantize(decimal.Decimal(1).scaleb(-digits),
                                        rounding=mode)) for v in x]
    same(got, exact, 0.0)
    # the device form: float scaling, as the reference's eval_tpu
    got, want = eval_both(rb, lambda col: getattr(tm, name)(col("x"),
                                                           digits),
                          lambda col: getattr(jm, name)(col("x"), digits))
    same(got, want, 0.0)


def test_round_placement_equals_the_reference():
    from spark_rapids_tpu.expr.base import Literal as JLit
    from spark_rapids_tpu_torch.expr.base import Literal as TLit
    for value in (2.5, 7):
        for name in ("Round", "BRound"):
            t = getattr(tm, name)(TLit(value), 0).gpu_supported()
            j = getattr(jm, name)(JLit(value), 0).tpu_supported()
            assert (t is None) == (j is None), (value, name, t, j)
            assert (t is None) == isinstance(value, int)


def test_spark_corners_follow_pythons_rules():
    rb = pa.record_batch({
        "x": pa.array([2.5, -2.5, 0.5, 1.5, math.inf, -math.inf, math.nan,
                       0.0, -1.0, 1e20, -1e20, 3.7], pa.float64())})
    col = "x"

    def run(build, host=False):
        return port_only(rb, lambda c: build(c(col)), host=host) \
            .to_pylist()
    assert run(lambda c: tm.Round(c, 0), host=True)[:4] == \
        [3.0, -3.0, 1.0, 2.0]
    assert run(lambda c: tm.BRound(c, 0), host=True)[:4] == \
        [2.0, -2.0, 0.0, 2.0]
    big, small = (1 << 63) - 1, -(1 << 63)
    assert run(tm.Floor)[4:7] == [big, small, 0]
    assert run(tm.Ceil)[9:12] == [big, small, 4]
    assert run(tm.Log)[7:9] == [None, None]
    assert run(tm.Log10)[7:9] == [None, None]
    assert run(tm.Sqrt)[8] != run(tm.Sqrt)[8]  # sqrt(-1) is NaN


def test_integer_inputs_cast_to_double_as_spark_does(rb):
    """The reference asserts a double input; Spark and the port cast."""
    vals = rb.column("q").to_pylist()
    got = port_only(rb, lambda c: tm.Sqrt(c("q"))).to_pylist()
    for v, g in zip(vals, got):
        if v is None:
            assert g is None
        elif v < 0:
            assert math.isnan(g)
        else:
            assert math.isclose(g, math.sqrt(v), rel_tol=FLOAT_RTOL)
    got = port_only(rb, lambda c: tm.Pow(c("q"), c("q"))).to_pylist()
    small = [v for v in vals if v is not None and abs(v) <= 3]
    assert small, "the seed gives small integers"
    for v, g in zip(vals, got):
        if v is not None and abs(v) <= 3 and v != 0:
            assert math.isclose(g, float(v) ** v, rel_tol=FLOAT_RTOL)
    got = port_only(rb, lambda c: tm.Signum(c("i"))).to_pylist()
    for v, g in zip(rb.column("i").to_pylist(), got):
        assert g == (None if v is None else float((v > 0) - (v < 0)))


def test_decimal_input_names_item_2():
    """A decimal input is ported (its value as a double, as Spark's
    implicit cast; tests/test_torch_decimal_expr.py); a nested input
    still raises, naming item 2."""
    import spark_rapids_tpu_torch.datatypes as tdt
    from spark_rapids_tpu_torch.expr.base import Literal as TLit
    e = tm.Sqrt(TLit(None, tdt.DecimalType(9, 2)))
    e.validate()
    assert e.dtype == tdt.FLOAT64
    with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
        tm.Sqrt(TLit(None, tdt.ArrayType(tdt.FLOAT64))).validate()

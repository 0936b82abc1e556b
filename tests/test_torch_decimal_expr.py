"""Decimal expressions of the port against Python's ``decimal`` under
Spark's rules, and against the JAX package where it agrees with Spark:
arithmetic (``+ - * / div % pmod``, unary minus, ``abs``) with Spark's
``DecimalPrecision`` result types, every decimal cast (overflow to null,
and under ANSI a raise), comparisons, ``IN``, ``floor``, ``ceil``,
``round``, ``bround``, ``sign`` and the double functions, and the
analyzer's coercions. Each runs on the port's device path (``eval_gpu``
on CPU tensors) and its host path (``eval_cpu``).

Where the reference departs from Spark the port is held to Python's
``decimal`` alone (ROADMAP "Things to know"): ``+`` and ``-`` keep the
left operand's type there and never null an overflow; ``ROUND`` of a
``decimal(7,2)`` to 1 digit is a ``decimal(6,1)``; a decimal cast to a
narrower integer is null past its range (Spark wraps); an ``IN`` list of
floats over a decimal fails. Decimals compare exactly.
"""
import decimal

import numpy as np
import pyarrow as pa
import pytest

from torch_function_cases import eval_both, port_only, same

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.expr import arithmetic as JA
from spark_rapids_tpu.expr import cast as JC
from spark_rapids_tpu.expr import math as JM
from spark_rapids_tpu.expr import predicates as JP
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expr import arithmetic as TA
from spark_rapids_tpu_torch.expr import cast as TC
from spark_rapids_tpu_torch.expr import math as TM
from spark_rapids_tpu_torch.expr import predicates as TP
from spark_rapids_tpu_torch.expr.base import ExprError, Literal
from spark_rapids_tpu_torch.session import _analyze

N = 1 << 11
CTX = decimal.Context(prec=100)
D = decimal.Decimal


def _decimals(rng, p, s, n, zeros=False):
    lim = 10 ** p - 1
    v = [int(x) for x in rng.integers(-min(lim, 1 << 62),
                                      min(lim, 1 << 62) + 1, n)]
    v[:4] = [lim, -lim, 1, -1]
    small = rng.random(n) < 0.3
    for i in np.flatnonzero(small):
        v[i] = int(rng.integers(-999, 1000))
    if zeros:
        for i in np.flatnonzero(rng.random(n) < 0.05):
            v[i] = 0
    return [D(x).scaleb(-s, CTX) for x in v]


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    cols = {
        "p": (pa.decimal128(7, 2), _decimals(rng, 7, 2, N, zeros=True)),
        "q": (pa.decimal128(7, 2), _decimals(rng, 7, 2, N, zeros=True)),
        "m": (pa.decimal128(12, 3), _decimals(rng, 12, 3, N, zeros=True)),
        "big": (pa.decimal128(18, 4), _decimals(rng, 18, 4, N, zeros=True)),
        "w": (pa.decimal128(30, 5), _decimals(rng, 30, 5, N)),
    }
    mask_rng = np.random.default_rng(seed + 1)
    arrays = [pa.array([None if m else v for v, m in
                        zip(vals, mask_rng.random(N) < 0.12)], t)
              for t, vals in cols.values()]
    return pa.record_batch(arrays, names=list(cols))


RB = _batch()
#: the columns the reference can hold (it has no layout past 18 digits)
NARROW = RB.select(["p", "q", "m", "big"])


def vals(name):
    return RB.column(name).to_pylist()


def _fits(v: D, t) -> bool:
    return abs(int(v.scaleb(t.scale, CTX))) < 10 ** t.precision


def _at(v: D, t, rounding=decimal.ROUND_HALF_UP):
    """``v`` at ``t``'s scale, None past its precision (Spark's
    changePrecision, non-ANSI)."""
    q = v.quantize(D(1).scaleb(-t.scale, CTX), rounding=rounding,
                   context=CTX)
    return q if _fits(q, t) else None


OPS = {
    "add": (TA.Add, lambda a, b: CTX.add(a, b)),
    "sub": (TA.Subtract, lambda a, b: CTX.subtract(a, b)),
    "mul": (TA.Multiply, lambda a, b: CTX.multiply(a, b)),
    "div": (TA.Divide, lambda a, b: None if b == 0 else CTX.divide(a, b)),
    "mod": (TA.Remainder, lambda a, b: None if b == 0 else
            CTX.remainder(a, b)),
    "pmod": (TA.Pmod, lambda a, b: None if b == 0 else (
        CTX.remainder(a, b) if CTX.remainder(a, b) >= 0 else
        CTX.remainder(CTX.add(CTX.remainder(a, b), b), b))),
}
RULE = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
        "mod": "mod", "pmod": "mod"}
PAIRS = [("p", "q"), ("p", "m"), ("m", "p"), ("m", "big"), ("big", "p"),
         ("big", "big"), ("w", "p"), ("p", "w")]


def _type(name):
    return tdt.from_arrow(RB.schema.field(name).type)


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("left,right", PAIRS,
                         ids=[f"{a}_{b}" for a, b in PAIRS])
@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_arithmetic_matches_python_decimal(op, left, right, host):
    cls, fn = OPS[op]
    t = tdt.decimal_result_type(RULE[op], _type(left), _type(right))
    got = port_only(RB, lambda c: cls(c(left), c(right)), host=host)
    assert got.type == pa.decimal128(t.precision, t.scale)
    want = []
    for a, b in zip(vals(left), vals(right)):
        v = None if a is None or b is None else fn(a, b)
        want.append(None if v is None else _at(v, t))
    same(got, want)


@pytest.mark.parametrize("left,right", [("p", "q"), ("q", "p")])
@pytest.mark.parametrize("cls,jcls", [(TA.Multiply, JA.Multiply),
                                      (TA.Divide, JA.Divide)],
                         ids=["mul", "div"])
def test_multiply_and_divide_match_reference(left, right, cls, jcls):
    """``*`` and ``/`` take the reference's result types and its
    ``HALF_UP`` division (``_div_half_up_j``), row for row, where the
    result fits its 18 digits."""
    got, want = eval_both(NARROW, lambda c: cls(c(left), c(right)),
                          lambda c: jcls(c(left), c(right)))
    same(got, want)


@pytest.mark.parametrize("left,right", [("p", "q"), ("m", "p")])
@pytest.mark.parametrize("cls,jcls", [(TA.IntegralDivide, JA.IntegralDivide)],
                         ids=["div"])
def test_integral_divide_of_decimals(left, right, cls, jcls):
    """``div`` truncates the quotient to a long, as Spark does."""
    got = port_only(RB, lambda c: cls(c(left), c(right)))
    assert got.type == pa.int64()
    want = []
    for a, b in zip(vals(left), vals(right)):
        if a is None or b is None or b == 0:
            want.append(None)
        else:
            q = CTX.divide(a, b)
            want.append(int(q.to_integral_value(decimal.ROUND_DOWN)))
    same(got, want)


@pytest.mark.parametrize("name", ["p", "big", "w"])
def test_unary_minus_and_abs(name):
    t = _type(name)
    for cls, fn in ((TA.UnaryMinus, CTX.minus), (TA.Abs, CTX.abs)):
        for host in (False, True):
            got = port_only(RB, lambda c: cls(c(name)), host=host)
            assert got.type == pa.decimal128(t.precision, t.scale)
            same(got, [None if v is None else fn(v) for v in vals(name)])


def test_gpu_gate_of_decimal_arithmetic():
    """What needs more than 18 digits is refused on the device: a wide
    result, or ``%`` rescaling an operand past them."""
    from spark_rapids_tpu_torch.expr.base import BoundReference
    col = {f.name: BoundReference(i, tdt.from_arrow(f.type), True, f.name)
           for i, f in enumerate(RB.schema)}
    assert TA.Add(col["p"], col["q"]).gpu_supported() is None
    assert TA.Multiply(col["p"], col["q"]).gpu_supported() is None
    assert TA.Divide(col["p"], col["q"]).gpu_supported() is None
    assert "18 digits" in TA.Multiply(col["m"], col["p"]).gpu_supported()
    a = BoundReference(0, tdt.DecimalType(18, 0))
    b = BoundReference(1, tdt.DecimalType(10, 8))
    rem = TA.Remainder(a, b)
    assert rem.dtype == tdt.DecimalType(10, 8)
    assert "18 digits" in rem.gpu_supported()


# --- casts -------------------------------------------------------------------

def _int_batch(seed=2):
    rng = np.random.default_rng(seed)
    i = rng.integers(-(1 << 31), 1 << 31, N).astype(np.int64)
    i[:6] = [0, 1, -1, 99999, 100000, -(1 << 31)]
    small = rng.random(N) < 0.5
    i[small] = rng.integers(-2000, 2000, int(small.sum()))
    f = rng.normal(0, 1e4, N)
    f[:8] = [1.005, 2.675, -0.125, np.nan, np.inf, -np.inf, 1e30, 0.5]
    strs = ["1.005", " 12.345 ", "-7", "abc", "1e3", "", "99999.995",
            "NaN", "+0.5", "-0.005"]
    s = [strs[k] for k in rng.integers(0, len(strs), N)]
    mask = rng.random(N) < 0.1
    return pa.record_batch({
        "i": pa.array(i.astype(np.int32), mask=mask),
        "l": pa.array(i * 1000, mask=mask),
        "f": pa.array(f, mask=mask),
        "s": pa.array(s, mask=mask),
        "b": pa.array(rng.random(N) < 0.5, mask=mask),
        "p": RB.column("p"), "big": RB.column("big"), "w": RB.column("w"),
    })


IB = _int_batch()


def _cast_oracle(v, f, t):
    """Spark's non-ANSI cast of one value (None for null)."""
    if v is None:
        return None
    if isinstance(t, tdt.DecimalType):
        if isinstance(v, float):
            if v != v or v in (float("inf"), float("-inf")):
                return None
            v = D(repr(v))
        elif isinstance(v, str):
            try:
                v = D(v.strip())
            except decimal.InvalidOperation:
                return None
            if not v.is_finite():
                return None
        elif isinstance(v, bool):
            v = D(int(v))
        else:
            v = D(v)
        return _at(v, t)
    if isinstance(t, tdt.StringType):
        return format(v, "f")
    if isinstance(t, tdt.BooleanType):
        return v != 0
    if isinstance(t, tdt.DoubleType):
        return float(v)
    if isinstance(t, tdt.FloatType):
        return float(np.float32(float(v)))
    bits = {tdt.ByteType: 8, tdt.ShortType: 16, tdt.IntegerType: 32,
            tdt.LongType: 64}[type(t)]
    w = int(v) & ((1 << bits) - 1)  # truncate, then Java's wrap
    return w - (1 << bits) if w >= 1 << (bits - 1) else w


CASTS = [
    ("p", tdt.DecimalType(9, 4)), ("p", tdt.DecimalType(5, 2)),
    ("p", tdt.DecimalType(7, 1)), ("p", tdt.DecimalType(6, 0)),
    ("big", tdt.DecimalType(10, 1)), ("big", tdt.DecimalType(18, 2)),
    ("p", tdt.INT32), ("p", tdt.INT16), ("p", tdt.INT8), ("big", tdt.INT64),
    ("big", tdt.INT32), ("p", tdt.FLOAT64), ("big", tdt.FLOAT32),
    ("p", tdt.STRING), ("big", tdt.STRING), ("p", tdt.BOOL),
    ("i", tdt.DecimalType(7, 2)), ("i", tdt.DecimalType(12, 2)),
    ("l", tdt.DecimalType(20, 0)), ("l", tdt.DecimalType(15, 3)),
    ("b", tdt.DecimalType(3, 2)), ("b", tdt.DecimalType(1, 1)),
    ("f", tdt.DecimalType(9, 2)), ("f", tdt.DecimalType(4, 3)),
    ("s", tdt.DecimalType(7, 2)), ("s", tdt.DecimalType(4, 0)),
    ("w", tdt.STRING), ("w", tdt.DecimalType(12, 1)),
    ("w", tdt.FLOAT64), ("p", tdt.DecimalType(25, 5)),
]


@pytest.mark.parametrize("src,to", CASTS,
                         ids=[f"{a}_{b.simple_string()}" for a, b in CASTS])
def test_decimal_casts_match_spark(src, to):
    f = tdt.from_arrow(IB.schema.field(src).type)
    want = [_cast_oracle(v, f, to) for v in IB.column(src).to_pylist()]
    for host in (False, True):
        if not host and (tdt.is_floating(f) or isinstance(f, tdt.StringType)):
            # the device refuses these: the planner puts them on the CPU
            # (test_float_and_string_to_decimal_are_host_only)
            continue
        got = port_only(IB, lambda c: TC.Cast(c(src), to), host=host)
        rtol = 1e-7 if isinstance(to, tdt.FloatType) else 0.0
        same(got, want, rtol=rtol)


def test_float_and_string_to_decimal_are_host_only():
    from spark_rapids_tpu_torch.expr.base import BoundReference
    f = BoundReference(0, tdt.FLOAT64)
    s = BoundReference(0, tdt.STRING)
    d = BoundReference(0, tdt.DecimalType(7, 2))
    assert "host" in TC.Cast(f, tdt.DecimalType(7, 2)).gpu_supported()
    assert "host" in TC.Cast(s, tdt.DecimalType(7, 2)).gpu_supported()
    assert TC.Cast(d, tdt.STRING).gpu_supported() is None
    assert TC.Cast(d, tdt.DecimalType(9, 2)).gpu_supported() is None
    ansi = RapidsConf({"spark.sql.ansi.enabled": "true"})
    assert "overflow" in TC.Cast(d, tdt.DecimalType(5, 2)) \
        .gpu_supported_conf(ansi)
    assert TC.Cast(d, tdt.DecimalType(9, 3)).gpu_supported_conf(ansi) \
        is None
    assert "overflow" in TC.Cast(d, tdt.INT8).gpu_supported_conf(ansi)


@pytest.mark.parametrize("src,to", [
    ("p", tdt.DecimalType(5, 2)), ("p", tdt.INT8), ("i", tdt.DecimalType(5, 2)),
    ("f", tdt.DecimalType(4, 3)), ("s", tdt.DecimalType(4, 0))],
    ids=["narrowing", "to_tinyint", "from_int", "from_double",
         "from_string"])
def test_ansi_cast_overflow_raises_on_the_host(src, to):
    with pytest.raises(ExprError):
        port_only(IB, lambda c: TC.Cast(c(src), to), host=True, ansi=True)


@pytest.mark.parametrize("src,to", [
    ("p", tdt.STRING), ("p", tdt.FLOAT64), ("p", tdt.DecimalType(12, 4)),
    ("big", tdt.STRING), ("i", tdt.DecimalType(12, 2)),
    ("p", tdt.DecimalType(7, 1))],
    ids=["p_string", "p_double", "p_widen", "big_string", "int_dec",
         "p_round_down"])
def test_casts_match_reference(src, to):
    jto = jdt.DecimalType(to.precision, to.scale) \
        if isinstance(to, tdt.DecimalType) else \
        {tdt.STRING: jdt.STRING, tdt.FLOAT64: jdt.FLOAT64}[to]
    rb = IB.select(["i", "p", "big"])
    got, want = eval_both(rb, lambda c: TC.Cast(c(src), to),
                          lambda c: JC.Cast(c(src), jto))
    same(got, want)


def test_string_to_decimal_matches_reference_host_path():
    """The reference's host parser, where it runs: it raises on 'NaN'
    (its Arrow conversion), which the port nulls as Spark does."""
    s = IB.column("s").to_pylist()
    rb = pa.record_batch({"s": pa.array([None if v == "NaN" else v
                                         for v in s])})
    got = port_only(IB.select(["s"]), lambda c: TC.Cast(
        c("s"), tdt.DecimalType(7, 2)), host=True).to_pylist()
    assert all(g is None for g, v in zip(got, s) if v == "NaN")
    got, want = eval_both(rb, lambda c: TC.Cast(c("s"),
                                                tdt.DecimalType(7, 2)),
                          lambda c: JC.Cast(c("s"), jdt.DecimalType(7, 2)),
                          host=True)
    same(got, want)


# --- comparisons, IN -----------------------------------------------------------

CMPS = {"=": (TP.EqualTo, JP.EqualTo, lambda a, b: a == b),
        "<": (TP.LessThan, JP.LessThan, lambda a, b: a < b),
        "<=": (TP.LessThanOrEqual, JP.LessThanOrEqual, lambda a, b: a <= b),
        ">": (TP.GreaterThan, JP.GreaterThan, lambda a, b: a > b),
        ">=": (TP.GreaterThanOrEqual, JP.GreaterThanOrEqual,
               lambda a, b: a >= b)}


@pytest.mark.parametrize("sym", sorted(CMPS))
@pytest.mark.parametrize("left,right", [("p", "q"), ("p", "big"),
                                        ("big", "w"), ("w", "w")],
                         ids=["same", "widened", "wide", "wide_same"])
def test_comparisons(sym, left, right):
    cls, jcls, fn = CMPS[sym]
    want = [None if a is None or b is None else fn(a, b)
            for a, b in zip(vals(left), vals(right))]
    for host in (False, True):
        got = port_only(RB, lambda c: _analyze(cls(c(left), c(right))),
                        host=host)
        same(got, want)
    if left == "p" and right == "q":
        got, ref = eval_both(NARROW, lambda c: cls(c(left), c(right)),
                             lambda c: jcls(c(left), c(right)))
        same(got, ref)


def test_analyzer_coerces_as_spark():
    from spark_rapids_tpu_torch.expr.base import BoundReference
    p = BoundReference(0, tdt.DecimalType(7, 2), True, "p")
    i = BoundReference(1, tdt.INT32, True, "i")
    l = BoundReference(2, tdt.INT64, True, "l")
    f = BoundReference(3, tdt.FLOAT64, True, "f")
    assert _analyze(TA.Multiply(i, p)).dtype == tdt.DecimalType(18, 2)
    assert _analyze(TA.Multiply(l, p)).dtype == tdt.DecimalType(28, 2)
    assert _analyze(TA.Subtract(p, Literal(1))).dtype \
        == tdt.DecimalType(8, 2)
    assert _analyze(TA.Multiply(p, Literal(2))).dtype \
        == tdt.DecimalType(9, 2)
    assert _analyze(TA.Add(p, f)).dtype == tdt.FLOAT64
    assert _analyze(TA.Divide(p, p)).dtype == tdt.DecimalType(17, 10)
    cmp = _analyze(TP.LessThan(p, Literal(100)))
    assert cmp.children[1].dtype == tdt.DecimalType(7, 2)
    assert tdt.common_type(tdt.INT64, tdt.DecimalType(7, 2)) \
        == tdt.DecimalType(22, 2)


@pytest.mark.parametrize("name", ["p", "w"])
def test_in_over_decimals(name):
    col = vals(name)
    present = [v for v in col[10:20] if v is not None][:3]
    items = (int(present[0]) if present[0] == int(present[0]) else 5,
             D("0.01"), present[1], float(present[2]), D("1.001"), 7)
    lits = set()
    for it in items:
        d = D(repr(it)) if isinstance(it, float) else D(it)
        lits.add(d)

    def want(with_null):
        out = []
        for v in col:
            if v is None:
                out.append(None)
            elif v in lits:
                out.append(True)
            else:
                out.append(None if with_null else False)
        return out
    for host in (False, True):
        got = port_only(RB, lambda c: TP.In(c(name), items), host=host)
        same(got, want(False))
        got = port_only(RB, lambda c: TP.In(c(name), items + (None,)),
                        host=host)
        same(got, want(True))


def test_in_with_integer_items_matches_reference():
    items = (0, 1, -1, 5)
    got, want = eval_both(NARROW, lambda c: TP.In(c("p"), items),
                          lambda c: JP.In(c("p"), items))
    same(got, want)


# --- math ------------------------------------------------------------------------

def _round_type(t, d):
    if d < 0:
        return tdt.DecimalType(max(t.precision - t.scale + 1, 1 - d), 0)
    ns = min(t.scale, d)
    return tdt.DecimalType(t.precision - t.scale + 1 + ns, ns)


@pytest.mark.parametrize("name", ["p", "big", "w"])
@pytest.mark.parametrize("digits", [-3, -1, 0, 1, 2, 5])
@pytest.mark.parametrize("half_even", [False, True], ids=["round", "bround"])
def test_round_follows_spark(name, digits, half_even):
    t = _type(name)
    rt = _round_type(t, digits)
    mode = decimal.ROUND_HALF_EVEN if half_even else decimal.ROUND_HALF_UP
    cls = TM.BRound if half_even else TM.Round
    want = []
    for v in vals(name):
        if v is None:
            want.append(None)
            continue
        q = v.quantize(D(1).scaleb(-max(digits, 0), CTX), rounding=mode,
                       context=CTX) if digits >= 0 else \
            CTX.multiply(CTX.divide(v, D(10) ** -digits).quantize(
                D(1), rounding=mode, context=CTX), D(10) ** -digits)
        want.append(_at(q, rt))
    for host in (False, True):
        got = port_only(RB, lambda c: cls(c(name), digits), host=host)
        assert got.type == pa.decimal128(rt.precision, rt.scale)
        same(got, want)


@pytest.mark.parametrize("name", ["p", "m", "big", "w"])
def test_floor_and_ceil_follow_spark(name):
    t = _type(name)
    rt = tdt.DecimalType(t.precision - t.scale + 1, 0)
    for cls, mode in ((TM.Floor, decimal.ROUND_FLOOR),
                      (TM.Ceil, decimal.ROUND_CEILING)):
        want = [None if v is None else
                v.quantize(D(1), rounding=mode, context=CTX)
                for v in vals(name)]
        for host in (False, True):
            got = port_only(RB, lambda c: cls(c(name)), host=host)
            assert got.type == pa.decimal128(rt.precision, 0)
            same(got, want)


@pytest.mark.parametrize("cls,jcls", [(TM.Floor, JM.Floor),
                                      (TM.Ceil, JM.Ceil)],
                         ids=["floor", "ceil"])
def test_floor_and_ceil_match_reference(cls, jcls):
    got, want = eval_both(RB.select(["p", "big"]),
                          lambda c: cls(c("big")), lambda c: jcls(c("big")))
    same(got, want)


def test_double_functions_of_decimals():
    """``sign``, ``sqrt`` and ``pow`` take a decimal's value as a double,
    as Spark's implicit cast does."""
    p = [None if v is None else float(v) for v in vals("p")]
    got = port_only(RB, lambda c: TM.Signum(c("p")))
    same(got, [None if v is None else float(np.sign(v)) for v in p])
    got = port_only(RB, lambda c: TM.Sqrt(c("p")))
    same(got, [None if v is None else float(np.sqrt(v)) if v >= 0
               else float("nan") for v in p], rtol=1e-15)
    got = port_only(RB, lambda c: TM.Pow(c("p"), c("q")))
    q = [None if v is None else float(v) for v in vals("q")]
    with np.errstate(all="ignore"):
        same(got, [None if a is None or b is None else
                   float(np.power(a, b)) for a, b in zip(p, q)],
             rtol=1e-12)


def test_decimal_literals():
    lit = Literal(D("12.345"))
    assert lit.dtype == tdt.DecimalType(5, 3)
    assert lit.lane_value == 12345
    assert Literal(D("1E+2")).dtype == tdt.DecimalType(3, 0)
    wide = Literal(D("1234567890123456789012.5"))
    assert wide.dtype == tdt.DecimalType(23, 1)
    got = port_only(RB, lambda c: TA.Add(c("w"), wide), host=True)
    rt = tdt.decimal_result_type("add", _type("w"), wide.dtype)
    same(got, [None if v is None else
               _at(CTX.add(v, D("1234567890123456789012.5")), rt)
               for v in vals("w")])

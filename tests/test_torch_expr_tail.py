"""The expressions of the port's eighth slice against the JAX package's,
on the CPU: ``Cast``, ``Add``/``Divide``/``IntegralDivide``/
``Remainder``/``Pmod``/``UnaryMinus``/``Abs``, ``Or``/``Not``/``In``/
``EqualNullSafe``/the null tests and string comparisons,
``If``/``CaseWhen``/``Coalesce``/``Least``/``Greatest``/``NullIf``, and
the ``Average``/``Min``/``Max`` aggregates, grouped and global.

Every input is one Arrow batch made with numpy from a seed, uploaded by
each package; the reference evaluates with ``eval_tpu`` on JAX's CPU
backend, the port with ``eval_gpu`` on CPU tensors. Tolerance: every
result is exact (the same IEEE operations in the same order: integers,
booleans, strings, nulls and floats alike, NaN equal to NaN) except the
averages, whose float64 sums add in another order: rel 1e-12.

Where the reference departs from Spark the port follows Spark, and the
test says so: a float cast to an integer is Java's narrowing (NaN is 0
where the reference makes it null; to tinyint and smallint through int,
then wrapped, where the reference saturates at the target's bounds);
``pmod`` by a negative divisor is Spark's ``(r + n) % n`` (the
reference adds ``|n|``); ``NaN IN (NaN)`` is true; and ``DIV``/``%``
with ``INT64_MIN`` as the dividend of a divisor other than +-1, or as
the divisor (the reference's ``|INT64_MIN|`` wraps), are held to
Python's integers. Each is held to Python's rule on every row, and to
the reference on the rows where the two agree."""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.datatypes as jdt
import spark_rapids_tpu.expr as jexpr
import spark_rapids_tpu_torch.datatypes as tdt
from spark_rapids_tpu.columnar import TpuBatch
from spark_rapids_tpu.columnar import arrow_to_device as j_upload
from spark_rapids_tpu.columnar import device_to_arrow as j_download
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import HostBatchSourceExec as JSource
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu.expr import aggregates as jagg
from spark_rapids_tpu.expr import arithmetic as jarith
from spark_rapids_tpu.expr import conditional as jcond
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.expr.base import EvalCtx as JEval
from spark_rapids_tpu.expr.base import bind_expr as jbind
from spark_rapids_tpu.expr.cast import Cast as JCast
from spark_rapids_tpu_torch.columnar import GpuBatch
from spark_rapids_tpu_torch.columnar import arrow_to_device as t_upload
from spark_rapids_tpu_torch.columnar import device_to_arrow as t_download
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec as TSource
from spark_rapids_tpu_torch.exec.base import collect_arrow as tcollect
from spark_rapids_tpu_torch.expr import aggregates as tagg
from spark_rapids_tpu_torch.expr import arithmetic as tarith
from spark_rapids_tpu_torch.expr import conditional as tcond
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.expr.base import EvalCtx as TEval
from spark_rapids_tpu_torch.expr.base import Literal as TLit
from spark_rapids_tpu_torch.expr.base import UnresolvedColumn as TCol
from spark_rapids_tpu_torch.expr.base import bind_expr as tbind
from spark_rapids_tpu_torch.expr.cast import Cast as TCast

AVG_RTOL = 1e-12
N = 600
NUMERIC = ["BOOL", "INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64"]
ARROW = {"BOOL": pa.bool_(), "INT8": pa.int8(), "INT16": pa.int16(),
         "INT32": pa.int32(), "INT64": pa.int64(), "FLOAT32": pa.float32(),
         "FLOAT64": pa.float64()}
J = dict(E=jexpr, dt=jdt, Cast=JCast, arith=jarith, pred=jpred,
         cond=jcond, agg=jagg, Col=jexpr.UnresolvedColumn,
         Lit=jexpr.Literal)
T = dict(E=None, dt=tdt, Cast=TCast, arith=tarith, pred=tpred,
         cond=tcond, agg=tagg, Col=TCol, Lit=TLit)


def _values(t: str, n: int, rng) -> np.ndarray:
    """Values of type ``t`` with its edge cases: zeros, +-1, the lane's
    bounds, and for floats NaN, +-inf, -0.0, values past every integer
    range and fractions on both sides of zero."""
    if t == "BOOL":
        return rng.random(n) < 0.5
    if t.startswith("FLOAT"):
        special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0,
                            0.5, -0.5, 2.7, -2.7, 127.9, 128.0, -129.5,
                            3e4, -4e4, 2.2e9, -2.2e9, 1e19, -1e19, 9.3e18,
                            -9.3e18, 1e300, -1e300])
        v = rng.choice(special, n)
        some = rng.random(n) < 0.4
        v[some] = rng.normal(size=int(some.sum())) * 10 ** rng.integers(
            0, 12, int(some.sum()))
        with np.errstate(over="ignore"):
            return v.astype(np.float32 if t == "FLOAT32" else np.float64)
    info = np.iinfo(getattr(jdt, t).np_dtype)
    v = rng.integers(info.min, info.max, n, endpoint=True, dtype=np.int64)
    edge = np.array([0, 1, -1, 2, -2, 3, -7, 7, info.min, info.max,
                     info.min + 1, info.max - 1], dtype=np.int64)
    pick = rng.random(n) < 0.4
    v[pick] = rng.choice(edge, int(pick.sum()))
    small = rng.random(n) < 0.2
    v[small] = rng.integers(-20, 21, int(small.sum()))
    return v.astype(info.dtype)


def _batch(columns: dict, seed: int = 0, null_share: float = 0.15):
    """An Arrow batch of ``{name: (type name, values)}``, nulls at
    random."""
    rng = np.random.default_rng(seed)
    arrays, names = [], []
    for name, (t, v) in columns.items():
        mask = rng.random(len(v)) < null_share
        at = ARROW.get(t, pa.string())
        arrays.append(pa.array(v, at, mask=mask) if t != "STRING"
                      else pa.array(list(v), pa.string(), mask=mask))
        names.append(name)
    return pa.record_batch(arrays, names=names)


def _eval_both(rb: pa.RecordBatch, build):
    """``build(pkg)`` evaluated over ``rb`` by both packages: (the port's
    Arrow array, the reference's)."""
    jb = j_upload(rb)
    tb = t_upload(rb, None, torch.device("cpu"))
    # columns come bound, as the reference's constructors check types
    jp = dict(J, Col=lambda name: jbind(jexpr.UnresolvedColumn(name),
                                        jb.schema))
    tp = dict(T, Col=lambda name: tbind(TCol(name), tb.schema))
    je = jbind(build(jp), jb.schema)
    te = tbind(build(tp), tb.schema)
    assert te.dtype == je.dtype or te.dtype.simple_string() \
        == je.dtype.simple_string()
    jc = je.eval_tpu(jb, JEval())
    tc = te.eval_gpu(tb, TEval())
    n = rb.num_rows
    want = j_download(TpuBatch([jc], jdt.Schema(
        [jdt.StructField("r", je.dtype, True)]), n)).column(0)
    got = t_download(GpuBatch([tc], tdt.Schema(
        [tdt.StructField("r", te.dtype, True)]), n)).column(0)
    return got, want


def _same(got: pa.Array, want: pa.Array, rtol: float = 0.0):
    assert got.type == want.type, (got.type, want.type)
    g, w = got.to_pylist(), want.to_pylist()
    for i, (a, b) in enumerate(zip(g, w)):
        if a is None or b is None:
            assert a is None and b is None, (i, a, b)
        elif isinstance(a, float):
            if math.isnan(a) or math.isnan(b):
                assert math.isnan(a) and math.isnan(b), (i, a, b)
            elif rtol:
                assert math.isclose(a, b, rel_tol=rtol), (i, a, b)
            else:
                assert a == b, (i, a, b)
        else:
            assert a == b, (i, a, b)


def _trunc(a: int, b: int) -> int:
    """Java's integer quotient: truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _wrap(v: int, bits: int) -> int:
    """Two's-complement wrap of a Python integer to ``bits``."""
    half = 1 << (bits - 1)
    return (v + half) % (1 << bits) - half


def _java_narrow(v, dst: str):
    """Java's ``(long)``/``(int)``/``(short)``/``(byte)`` of a float:
    truncate, NaN to 0, saturate at long's bounds for a long and int's
    otherwise, then wrap to a narrower type."""
    if v is None:
        return None
    if math.isnan(v):
        return 0
    bits = 64 if dst == "INT64" else 32
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    x = lo if v <= lo else hi if v >= hi else int(v)
    return _wrap(x, int(dst[3:]))


def _spark_pmod(a, b, t: str):
    """Spark's ``pmod`` in lane ``t``: ``r = a % b`` (the dividend's
    sign), and ``(r + b) % b`` where ``r < 0``, in int arithmetic for
    tinyint, smallint and int (int wraps) and long for long."""
    if a is None or b is None or b == 0:
        return None
    if t.startswith("FLOAT"):
        f = np.float32 if t == "FLOAT32" else np.float64
        with np.errstate(invalid="ignore"):
            r = np.fmod(f(a), f(b))
            return float(np.fmod(r + f(b), f(b)) if r < 0 else r)
    r = a - b * _trunc(a, b)
    if r >= 0:
        return r
    s = _wrap(r + b, 64 if t == "INT64" else 32)
    return s - b * _trunc(s, b)


def _hold_pmod(rb: pa.RecordBatch, got: pa.Array, want: pa.Array,
               t: str) -> None:
    """``pmod``: Spark's rule on every row, and the reference where the
    two agree: a positive divisor, and for floats a remainder that is not
    negative (the reference's ``r + |b|`` can round to ``b`` where
    Spark's ``(r + b) % b`` gives 0)."""
    a, b = rb.column(0).to_pylist(), rb.column(1).to_pylist()
    spark = [_spark_pmod(x, y, t) for x, y in zip(a, b)]
    assert any(y is not None and y < 0 for y in b)
    _same(got, pa.array(spark, got.type))
    with np.errstate(invalid="ignore"):
        agree = [i for i, (x, y) in enumerate(zip(a, b))
                 if y is not None and y > 0 and (
                     not t.startswith("FLOAT") or x is None
                     or not np.fmod(x, y) < 0)]
    _same(got.take(agree), want.take(agree))


def _col(pkg, name):
    return pkg["Col"](name)


def _alias(pkg, e, name):
    from spark_rapids_tpu_torch.expr import Alias
    return (jexpr.Alias if pkg["E"] is jexpr else Alias)(e, name)


# --- Cast ---------------------------------------------------------------

@pytest.mark.parametrize("src", NUMERIC)
def test_cast_every_numeric_pair_matches_reference(src):
    """One source type to all seven targets: integer narrowing wraps,
    float -> integer truncates and saturates, NaN and +-inf and values
    past every range included. A float cast to an integer is Java's
    narrowing (``_java_narrow``): NaN is 0, where the reference gives
    null, and a value past tinyint's or smallint's range goes through
    int and wraps, where the reference saturates; every other row is
    the reference's."""
    rng = np.random.default_rng(NUMERIC.index(src))
    rb = _batch({"x": (src, _values(src, N, rng))}, seed=1)
    x = rb.column(0).to_pylist()
    for dst in NUMERIC:
        got, want = _eval_both(rb, lambda p: p["Cast"](
            _col(p, "x"), getattr(p["dt"], dst)))
        if src.startswith("FLOAT") and dst.startswith("INT"):
            _same(got, pa.array([_java_narrow(v, dst) for v in x],
                                want.type))
            w = int(dst[3:])
            lo, hi = -(1 << (w - 1)), (1 << (w - 1)) - 1
            inside = [i for i, v in enumerate(x) if v is None
                      or (math.isfinite(v) and lo <= math.trunc(v) <= hi)]
            assert len(inside) < len(x)
            got, want = got.take(inside), want.take(inside)
        _same(got, want)


def test_unported_casts_raise_naming_their_item():
    # the string, date and timestamp casts are ported
    # (tests/test_torch_functions_casts.py), the decimal ones too
    # (tests/test_torch_decimal_expr.py); nested types wait for item 2
    for src, dst in ((tdt.DecimalType(9, 2), tdt.INT64),
                     (tdt.INT64, tdt.DecimalType(9, 2)),
                     (tdt.STRING, tdt.DecimalType(9, 2)),
                     (tdt.DecimalType(9, 2), tdt.STRING)):
        TCast(TLit(None, src), dst).validate()
    for src, dst in ((tdt.ArrayType(tdt.INT32), tdt.STRING),
                     (tdt.STRING, tdt.ArrayType(tdt.INT32))):
        e = TCast(TLit(None, src), dst)
        with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
            e.validate()


# --- arithmetic -----------------------------------------------------------

INT_TYPES = ["INT8", "INT16", "INT32", "INT64"]
ARITH = ["Add", "Subtract", "Multiply", "IntegralDivide", "Remainder",
         "Pmod"]


def _divisor(t: str, n: int, rng) -> np.ndarray:
    """Divisors: zeros, +-1, small values of both signs, the bounds."""
    v = _values(t, n, rng)
    zero = rng.random(n) < 0.2
    v[zero] = 0
    pm = rng.random(n) < 0.2
    v[pm] = rng.choice(np.array([1, -1], v.dtype), int(pm.sum()))
    return v


def _int_operands(t: str, seed: int):
    """Dividend and divisor columns; for int64, INT64_MIN is never a
    divisor and meets only the divisors 0 and +-1 here (the reference
    wraps otherwise: ``test_int64_min_division_follows_spark``)."""
    rng = np.random.default_rng(seed)
    a, b = _values(t, N, rng), _divisor(t, N, rng)
    if t == "INT64":
        lo = np.iinfo(np.int64).min
        b = np.where(b == lo, np.int64(-1), b)
        b = np.where((a == lo) & (np.abs(b.astype(np.float64)) > 1),
                     np.int64(-1), b)
    return _batch({"a": (t, a), "b": (t, b)}, seed=seed)


@pytest.mark.parametrize("t", INT_TYPES)
def test_integer_arithmetic_matches_reference(t):
    """+, -, *, DIV, % and pmod over integers: overflow wraps, a zero
    divisor gives null, DIV truncates toward zero, % takes the
    dividend's sign, pmod is Spark's (``_hold_pmod``); INT64_MIN DIV -1
    wraps."""
    rb = _int_operands(t, INT_TYPES.index(t) + 10)
    for op in ARITH:
        got, want = _eval_both(rb, lambda p: getattr(p["arith"], op)(
            _col(p, "a"), _col(p, "b")))
        if op == "Pmod":
            _hold_pmod(rb, got, want, t)
        else:
            _same(got, want)
    for op in ("UnaryMinus", "Abs"):
        got, want = _eval_both(
            rb, lambda p: getattr(p["arith"], op)(_col(p, "a")))
        _same(got, want)


@pytest.mark.parametrize("t", ["FLOAT32", "FLOAT64"])
def test_float_arithmetic_matches_reference(t):
    """+, -, *, /, % and pmod over floats: a zero divisor gives null,
    NaN and +-inf propagate; pmod is Spark's (``_hold_pmod``)."""
    rng = np.random.default_rng(20)
    a, b = _values(t, N, rng), _values(t, N, rng)
    b[rng.random(N) < 0.2] = 0.0
    rb = _batch({"a": (t, a), "b": (t, b)}, seed=21)
    for op in ("Add", "Subtract", "Multiply", "Divide", "Remainder",
               "Pmod"):
        got, want = _eval_both(rb, lambda p: getattr(p["arith"], op)(
            _col(p, "a"), _col(p, "b")))
        if op == "Pmod":
            _hold_pmod(rb, got, want, t)
        else:
            _same(got, want)


def test_int64_min_division_follows_spark():
    """DIV, % and pmod with INT64_MIN as dividend or divisor against
    Python's integers (Java's truncation), where the reference's device
    path wraps ``|INT64_MIN|``; and ``INT64_MIN DIV -1`` wraps."""
    lo = -(1 << 63)
    pairs = [(lo, 3), (lo, -3), (lo, 7), (lo, -2), (lo, 1), (lo, -1),
             (lo, 1 << 40), (lo, lo), (10, lo), (-7, lo), (lo + 1, lo),
             ((1 << 63) - 1, lo)]
    nums = [a for a, _ in pairs]
    divs = [b for _, b in pairs]
    rb = pa.record_batch([pa.array(nums, pa.int64()),
                          pa.array(divs, pa.int64())], names=["a", "b"])
    tb = t_upload(rb, None, torch.device("cpu"))

    def run(cls):
        e = tbind(cls(TCol("a"), TCol("b")), tb.schema)
        c = e.eval_gpu(tb, TEval())
        return c.data[:len(divs)].tolist()

    assert run(tarith.IntegralDivide) == [_wrap(_trunc(a, b), 64)
                                          for a, b in pairs]
    rem = [a - b * _trunc(a, b) for a, b in pairs]
    assert run(tarith.Remainder) == [_wrap(r, 64) for r in rem]
    assert run(tarith.Pmod) == [_spark_pmod(a, b, "INT64")
                                for a, b in pairs]


def test_decimal_arithmetic_raises_naming_item_2():
    """Decimal arithmetic is ported (tests/test_torch_decimal_expr.py,
    Spark's result types); arithmetic over a nested type still raises,
    naming item 2."""
    e = tarith.Add(TLit(None, tdt.DecimalType(9, 2)),
                   TLit(None, tdt.DecimalType(9, 2)))
    e.validate()
    assert e.dtype == tdt.DecimalType(10, 2)
    arr = tdt.ArrayType(tdt.INT32)
    with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
        tarith.Add(TLit(None, arr), TLit(None, arr)).validate()


# --- predicates -----------------------------------------------------------

def _bools(seed):
    rng = np.random.default_rng(seed)
    return _batch({"p": ("BOOL", rng.random(N) < 0.5),
                   "q": ("BOOL", rng.random(N) < 0.5)}, seed=seed,
                  null_share=0.3)


@pytest.mark.parametrize("op", ["And", "Or", "Not", "IsNull", "IsNotNull"])
def test_kleene_logic_and_null_tests_match_reference(op):
    rb = _bools(30)
    if op in ("And", "Or"):
        def build(p):
            return getattr(p["pred"], op)(_col(p, "p"), _col(p, "q"))
    else:
        def build(p):
            return getattr(p["pred"], op)(_col(p, "p"))
    got, want = _eval_both(rb, build)
    _same(got, want)


WORDS = ["", "a", "b", "ab", "abc", "abcdefg", "abcdefgh", "abcdefgX",
         "abcdefghijklmn", "abcdefghijklmo", "été", "ÿ",
         "Books", "Music", "Sports", "Electronics", "zz", "Z"]


def _strings(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array(WORDS, dtype=object), n)


@pytest.mark.parametrize("op", ["EqualTo", "EqualNullSafe", "LessThan",
                                "LessThanOrEqual", "GreaterThan",
                                "GreaterThanOrEqual"])
def test_string_comparisons_match_reference(op):
    """Unsigned byte order, a shorter prefix first: column against
    column, and against literals (empty, a prefix, past-ASCII bytes)."""
    rb = _batch({"s": ("STRING", _strings(40)),
                 "t": ("STRING", _strings(41))}, seed=42)
    got, want = _eval_both(rb, lambda p: getattr(p["pred"], op)(
        _col(p, "s"), _col(p, "t")))
    _same(got, want)
    for lit in ("", "abcdefg", "abcdefgh", "é", "Music"):
        got, want = _eval_both(rb, lambda p: getattr(p["pred"], op)(
            _col(p, "s"), p["Lit"](lit, p["dt"].STRING)))
        _same(got, want)
        got, want = _eval_both(rb, lambda p: getattr(p["pred"], op)(
            p["Lit"](lit, p["dt"].STRING), _col(p, "s")))
        _same(got, want)


@pytest.mark.parametrize("t", ["INT32", "INT64", "FLOAT64", "STRING"])
@pytest.mark.parametrize("with_null", [False, True])
def test_in_matches_reference(t, with_null):
    """``x IN (...)``: null for a null x; with a null in the list, null
    rather than false where nothing matches."""
    rng = np.random.default_rng(50)
    if t == "STRING":
        vals, items = _strings(51), ["Books", "", "abcdefgh", "ÿ"]
    elif t == "FLOAT64":
        vals = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, 2.0, 7.0]), N)
        items = [0.0, 1.5, 7.0]
    else:
        vals = rng.integers(-5, 6, N).astype(ARROW[t].to_pandas_dtype())
        items = [-5, 0, 3]
    if with_null:
        items = items + [None]
    rb = _batch({"x": (t, vals)}, seed=52)
    got, want = _eval_both(
        rb, lambda p: p["pred"].In(_col(p, "x"), tuple(items)))
    _same(got, want)


def test_spark_rules_where_the_reference_departs():
    """Spark's own answers: ``cast(300.0 as tinyint)`` is 44 and
    ``cast(1e10 as smallint)`` is -1 (through int, then wrapped);
    ``pmod(-7, -3)`` is -1 and ``pmod(-7.5, -2.0)`` is -1.5; ``NaN IN
    (NaN)`` is true and ``NaN IN (1.0)`` false."""
    rb = pa.record_batch([pa.array([300.0, 1e10, -7.5, float("nan")]),
                          pa.array([-7, 7, -7, 7], pa.int32())],
                         names=["f", "i"])
    tb = t_upload(rb, None, torch.device("cpu"))

    def run(e):
        e = tbind(e, tb.schema)
        return e.eval_gpu(tb, TEval()).data[:4].tolist()

    assert run(TCast(TCol("f"), tdt.INT8))[:2] == [44, -1]
    assert run(TCast(TCol("f"), tdt.INT16))[:2] == [300, -1]
    assert run(tarith.Pmod(TCol("i"), TLit(-3, tdt.INT32))) == [-1, 1, -1, 1]
    assert run(tarith.Pmod(TCol("i"), TLit(3, tdt.INT32))) == [2, 1, 2, 1]
    assert run(tarith.Pmod(TCol("f"), TLit(-2.0, tdt.FLOAT64)))[2] == -1.5
    assert run(tpred.In(TCol("f"), (float("nan"),))) \
        == [False, False, False, True]
    assert run(tpred.In(TCol("f"), (1.0, 300.0))) \
        == [True, False, False, False]


def test_isnan_and_equal_null_safe_over_floats_match_reference():
    rng = np.random.default_rng(60)
    rb = _batch({"a": ("FLOAT64", _values("FLOAT64", N, rng)),
                 "b": ("FLOAT64", _values("FLOAT64", N, rng))}, seed=61)
    for build in (lambda p: p["pred"].IsNaN(_col(p, "a")),
                  lambda p: p["pred"].EqualNullSafe(_col(p, "a"),
                                                    _col(p, "b"))):
        got, want = _eval_both(rb, build)
        _same(got, want)


# --- conditionals ---------------------------------------------------------

def _cond_batch(seed):
    rng = np.random.default_rng(seed)
    return _batch({"c1": ("BOOL", rng.random(N) < 0.3),
                   "c2": ("BOOL", rng.random(N) < 0.5),
                   "x": ("FLOAT64", _values("FLOAT64", N, rng)),
                   "y": ("FLOAT64", _values("FLOAT64", N, rng)),
                   "i": ("INT32", _values("INT32", N, rng)),
                   "s": ("STRING", _strings(seed + 1)),
                   "t": ("STRING", _strings(seed + 2))}, seed=seed,
                  null_share=0.25)


@pytest.mark.parametrize("kind", ["float", "int", "string",
                                  "string_literals"])
@pytest.mark.parametrize("with_else", [False, True])
def test_case_when_matches_reference(kind, with_else):
    """Null conditions fall through; no ELSE gives null; string branches
    from columns and from literals."""
    rb = _cond_batch(70)

    def build(p):
        if kind == "float":
            v1, v2, e = _col(p, "x"), _col(p, "y"), \
                p["Lit"](0.0, p["dt"].FLOAT64)
        elif kind == "int":
            v1, v2, e = _col(p, "i"), p["Lit"](7, p["dt"].INT32), \
                p["Lit"](None, p["dt"].INT32)
        elif kind == "string":
            v1, v2, e = _col(p, "s"), _col(p, "t"), \
                p["Lit"]("else", p["dt"].STRING)
        else:
            v1, v2, e = (p["Lit"](w, p["dt"].STRING)
                         for w in ("low", "mid", "high"))
        return p["cond"].CaseWhen([(_col(p, "c1"), v1),
                                   (_col(p, "c2"), v2)],
                                  e if with_else else None)

    got, want = _eval_both(rb, build)
    _same(got, want)


@pytest.mark.parametrize("kind", ["float", "string"])
def test_if_coalesce_nullif_match_reference(kind):
    rb = _cond_batch(80)
    a, b = ("x", "y") if kind == "float" else ("s", "t")
    for build in (
            lambda p: p["cond"].If(_col(p, "c1"), _col(p, a), _col(p, b)),
            lambda p: p["cond"].Coalesce(_col(p, a), _col(p, b)),
            lambda p: p["cond"].NullIf(_col(p, a), _col(p, b))):
        got, want = _eval_both(rb, build)
        _same(got, want)


def test_least_greatest_match_reference():
    """Nulls skipped, NaN greatest."""
    rb = _cond_batch(90)
    for name in ("Least", "Greatest"):
        got, want = _eval_both(rb, lambda p: getattr(p["cond"], name)(
            _col(p, "x"), _col(p, "y")))
        _same(got, want)


# --- Average, Min, Max ----------------------------------------------------

def _agg_table(seed, t):
    """Rows in 3 batches: group keys 0-9 (key 7 all null values, key 9
    a null key), values with NaN, +-inf and nulls."""
    rng = np.random.default_rng(seed)
    n = 900
    k = rng.integers(0, 10, n).astype(np.int32)
    v = _values(t, n, rng)
    null_v = rng.random(n) < 0.2
    null_v[k == 7] = True
    if t.startswith("FLOAT"):
        v[k == 3] = np.where(rng.random(int((k == 3).sum())) < 0.5, np.nan,
                             v[k == 3])
    elif t != "BOOL":
        v = (v // 4).astype(v.dtype)  # keep sums inside float64's grid
    table = pa.table({"k": pa.array(k, mask=k == 9),
                      "v": pa.array(v, ARROW[t], mask=null_v)})
    return table.to_batches(max_chunksize=300)


AGG_TYPES = {"avg": ["INT32", "INT64", "FLOAT32", "FLOAT64"],
             "min": ["BOOL", "INT8", "INT32", "INT64", "FLOAT32",
                     "FLOAT64"],
             "max": ["BOOL", "INT16", "INT32", "INT64", "FLOAT32",
                     "FLOAT64"]}
AGG_CASES = [(f, t) for f, ts in AGG_TYPES.items() for t in ts]
AGG_CLASSES = {"avg": "Average", "min": "Min", "max": "Max"}


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("fn,t", AGG_CASES,
                         ids=[f"{f}-{t}" for f, t in AGG_CASES])
def test_average_min_max_match_reference(fn, t, grouped):
    """Grouped (a null key, an all-null group, NaN) and global; NaN is
    the largest value for min and max, an all-null group is null."""
    batches = _agg_table(100 + AGG_CASES.index((fn, t)), t)
    cls = AGG_CLASSES[fn]

    def plan(p, src):
        agg = getattr(p["agg"], cls)(_col(p, "v"))
        keys = [_col(p, "k")] if grouped else []
        if p is J:
            return TpuHashAggregateExec(keys, [_alias(p, agg, "r")], src)
        return GpuHashAggregateExec(keys, [_alias(p, agg, "r")], src)

    want = jcollect(plan(J, JSource(batches)), JCtx())
    got = tcollect(plan(T, TSource(batches)), TCtx(device="cpu"))
    if grouped:
        want = want.sort_by([("k", "ascending")])
        got = got.sort_by([("k", "ascending")])
    assert got.column_names == want.column_names
    for c in got.column_names:
        _same(got.column(c), want.column(c),
              AVG_RTOL if fn == "avg" else 0.0)

"""The window operator on the CPU: the port's ``GpuWindowExec`` held to
the JAX package's ``TpuWindowExec`` (its device path, jitted on the CPU
backend) over the same input batches, made from a seed with numpy.

The cases are ``tests/test_window.py``'s matrix: the ranking functions,
Sum, Count, Min, Max and Average over every frame of ``AGG_FRAMES``,
COUNT(*), lag and lead (strings too), several expressions on one spec,
multi-batch input, a filtered input (dead rows between live ones) and
spare capacity, float order keys with NaN and -0.0, string partition
keys, RANGE literal offsets with null order values and offsets at the
int32 bounds, bounded min/max frames on either side of the reference's
``MAX_GATHER_FRAME`` (its windowed gather and its sparse table; the port
takes the sparse table for both) and int64 extremes. Tolerance: ints, strings and nulls
exact, floats rel 1e-9 (``torch_dual_run.assert_same_rows``), the row
order exact (both packages sort stably by partition and order keys).

The windows the device gate refuses (RANGE offsets over a 64-bit,
float or descending order key or over two order keys) run on the CPU,
held to the reference's CPU path; First and Last raise and name their
ROADMAP item."""
import types

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.exec.base as jbase
import spark_rapids_tpu.exec.basic as jbasic
import spark_rapids_tpu.exec.sort as jsort
import spark_rapids_tpu.exec.window as jwin
import spark_rapids_tpu.expr as jexpr
import spark_rapids_tpu.expr.aggregates as jagg
import spark_rapids_tpu.expr.predicates as jpred
import spark_rapids_tpu.expr.window as jwexpr
from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import sort as tsort
from spark_rapids_tpu_torch.exec import window as twin
from spark_rapids_tpu_torch import expr as texpr
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.expr import window as twexpr
from spark_rapids_tpu_torch.planner import GpuOverrides
from torch_dual_run import assert_same_rows

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _ns(expr, wexpr, agg, dtm, sort, window_cls, base, filter_cls, pred,
        collect):
    """One package's constructors under common names."""
    return types.SimpleNamespace(
        col=expr.UnresolvedColumn, Alias=expr.Alias, Literal=expr.Literal,
        Sum=agg.Sum, Count=agg.Count, Min=agg.Min, Max=agg.Max,
        Average=agg.Average, RowNumber=wexpr.RowNumber, Rank=wexpr.Rank,
        DenseRank=wexpr.DenseRank, PercentRank=wexpr.PercentRank,
        NTile=wexpr.NTile, Lag=wexpr.Lag, Lead=wexpr.Lead,
        WE=wexpr.WindowExpression, WF=wexpr.WindowFrame,
        SortOrder=sort.SortOrder, Window=window_cls,
        Source=base.HostBatchSourceExec, Filter=filter_cls,
        GreaterThan=pred.GreaterThan, dt=dtm, collect=collect)


REF = _ns(jexpr, jwexpr, jagg, jdt, jsort, jwin.TpuWindowExec, jbase,
          jbasic.TpuFilterExec, jpred,
          lambda p: jbase.collect_arrow(p, jbase.ExecCtx()))
PORT = _ns(texpr, twexpr, texpr, tdt, tsort, twin.GpuWindowExec, tbase,
           tbasic.GpuFilterExec, tpred,
           lambda p: tbase.collect_arrow(p, tbase.ExecCtx(device="cpu")))


# --- inputs, from a seed -----------------------------------------------------

def _arr(values, null_frac, rng, typ):
    mask = rng.random(len(values)) < null_frac if null_frac else None
    return pa.array(values, type=typ, mask=mask)


def part_order_batches(n=200, seed=1234, n_batches=1):
    """c0 partition key (0..4, 10% null), c1 order key (0..20, ties, 15%
    null), c2 int64 values (20% null), c3 doubles (20% null), c4 short
    strings (10% null)."""
    out = []
    for b in range(n_batches):
        rng = np.random.default_rng(seed + b)
        out.append(pa.record_batch({
            "c0": _arr(rng.integers(0, 5, n), 0.1, rng, pa.int32()),
            "c1": _arr(rng.integers(0, 21, n), 0.15, rng, pa.int32()),
            "c2": _arr(rng.integers(-1000, 1001, n), 0.2, rng, pa.int64()),
            "c3": _arr(rng.normal(0, 100, n), 0.2, rng, pa.float64()),
            "c4": _arr(["".join(rng.choice(list("abcxyz"),
                                           rng.integers(0, 6)))
                        for _ in range(n)], 0.1, rng, pa.string())}))
    return out


def run_both(rbs, specs, filt=None):
    """``specs``: ``(name, func builder, partition cols, [(order col,
    ascending, nulls_first)], frame tuple or None)``. Returns (port,
    reference) tables."""
    out = []
    for ns in (PORT, REF):
        src = ns.Source(rbs)
        if filt is not None:
            src = ns.Filter(filt(ns), src)
        exprs = []
        for name, fn, part, order, frame in specs:
            exprs.append(ns.Alias(ns.WE(
                fn(ns), [ns.col(c) for c in part],
                [ns.SortOrder(ns.col(c), asc, nf) for c, asc, nf in order],
                None if frame is None else ns.WF(*frame)), name))
        out.append(ns.collect(ns.Window(exprs, src)))
    return out


def check(rbs, specs, filt=None):
    got, want = run_both(rbs, specs, filt)
    assert got.num_rows == want.num_rows > 0
    assert_same_rows(got, want, ordered=True)
    return got


def win(fn, frame=None, part=("c0",), order=(("c1", True, None),),
        name="w"):
    return (name, fn, list(part), list(order), frame)


# --- ranking -----------------------------------------------------------------

RANKING = {"row_number": lambda ns: ns.RowNumber(),
           "rank": lambda ns: ns.Rank(),
           "dense_rank": lambda ns: ns.DenseRank(),
           "percent_rank": lambda ns: ns.PercentRank(),
           "ntile3": lambda ns: ns.NTile(3),
           "ntile7": lambda ns: ns.NTile(7)}


@pytest.mark.parametrize("name", sorted(RANKING))
def test_ranking(name):
    check(part_order_batches(), [win(RANKING[name])])


def test_ranking_without_partition_and_descending_nulls_last():
    check(part_order_batches(),
          [win(RANKING["row_number"], part=())])
    check(part_order_batches(),
          [win(RANKING["rank"], order=(("c1", False, False),))])


# --- aggregates over frames --------------------------------------------------

AGG_FRAMES = [
    None,                      # the default RANGE UNBOUNDED..CURRENT ROW
    ("rows", None, 0),         # running
    ("rows", None, None),      # the whole partition
    ("rows", -2, 0),
    ("rows", -1, 1),
    ("rows", 0, None),
    ("rows", 2, 4),            # empty near the partition's end
    ("range", None, None),
    ("range", 0, None),
    ("range", 0, 0),           # the peer group
]
AGGS = {"sum": lambda ns, c: ns.Sum(ns.col(c)),
        "count": lambda ns, c: ns.Count(ns.col(c)),
        "min": lambda ns, c: ns.Min(ns.col(c)),
        "max": lambda ns, c: ns.Max(ns.col(c)),
        "avg": lambda ns, c: ns.Average(ns.col(c))}


def _frame_id(f):
    return "default" if f is None else "_".join(map(str, f))


@pytest.mark.parametrize("frame", AGG_FRAMES, ids=_frame_id)
@pytest.mark.parametrize("agg", sorted(AGGS))
def test_agg_window_frames(agg, frame):
    """Each aggregate over an int64 and a double column in one exec."""
    check(part_order_batches(),
          [win(lambda ns: AGGS[agg](ns, "c2"), frame, name="i"),
           win(lambda ns: AGGS[agg](ns, "c3"), frame, name="d")])


def test_count_star():
    check(part_order_batches(),
          [win(lambda ns: ns.Count(), ("rows", -3, 3))])


# --- lag / lead --------------------------------------------------------------

@pytest.mark.parametrize("fn", ["lag", "lead"])
def test_lag_lead(fn):
    def cls(ns):
        return ns.Lag if fn == "lag" else ns.Lead
    check(part_order_batches(), [
        win(lambda ns: cls(ns)(ns.col("c2"), 1), name="a"),
        win(lambda ns: cls(ns)(ns.col("c2"), 3), name="b"),
        win(lambda ns: cls(ns)(ns.col("c2"), 2,
                               ns.Literal(-99, ns.dt.INT64)), name="c"),
        win(lambda ns: cls(ns)(ns.col("c4"), 1), name="s"),
        win(lambda ns: cls(ns)(ns.col("c4"), 0), name="s0")])


# --- specs, batches and keys -------------------------------------------------

def test_several_expressions_on_one_spec():
    check(part_order_batches(), [
        win(RANKING["row_number"], name="rn"),
        win(lambda ns: ns.Sum(ns.col("c2")), name="s"),
        win(lambda ns: ns.Min(ns.col("c2")), ("rows", -3, 0), name="m"),
        win(lambda ns: ns.Lead(ns.col("c4"), 2), name="ld")])


def test_mixed_specs_rejected():
    for ns in (PORT, REF):
        with pytest.raises(ValueError):
            ns.Window([
                ns.Alias(ns.WE(ns.RowNumber(), [ns.col("c0")],
                               [ns.SortOrder(ns.col("c1"))]), "a"),
                ns.Alias(ns.WE(ns.RowNumber(), [ns.col("c1")],
                               [ns.SortOrder(ns.col("c0"))]), "b")],
                ns.Source(part_order_batches()))


def test_multi_batch_input():
    check(part_order_batches(n=100, n_batches=3), [
        win(lambda ns: ns.Sum(ns.col("c2")), name="s"),
        win(RANKING["dense_rank"], name="dr"),
        win(lambda ns: ns.Max(ns.col("c3")), ("rows", -1, 2), name="mx")])


def test_dead_rows_between_live_ones():
    """A filter leaves a lazy selection: the dead rows must neither open a
    partition nor feed a prefix sum."""
    check(part_order_batches(n=300), [
        win(lambda ns: ns.Sum(ns.col("c2")), name="s"),
        win(lambda ns: ns.Count(), ("rows", None, None), name="n"),
        win(RANKING["rank"], name="rk")],
        filt=lambda ns: ns.GreaterThan(ns.col("c2"),
                                       ns.Literal(0, ns.dt.INT64)))
    check(part_order_batches(n=100, n_batches=3),
          [win(lambda ns: ns.Average(ns.col("c3")), ("range", 0, None))],
          filt=lambda ns: ns.GreaterThan(ns.col("c1"), ns.Literal(5)))


def test_float_order_keys_nan_and_negative_zero():
    rng = np.random.default_rng(7)
    vals = rng.choice([float("nan"), -0.0, 0.0, 1.5, -2.25, float("inf"),
                       float("-inf"), 3.0], 150)
    rb = pa.record_batch({
        "c0": pa.array(rng.integers(0, 3, 150), pa.int32()),
        "c1": _arr(vals, 0.2, rng, pa.float64()),
        "c2": _arr(rng.integers(0, 101, 150), 0.1, rng, pa.int64())})
    for asc in (True, False):
        check([rb], [win(RANKING["rank"], order=(("c1", asc, None),),
                         name="rk"),
                     win(lambda ns: ns.Sum(ns.col("c2")),
                         order=(("c1", asc, None),), name="s")])
    # a float partition key: -0.0 and 0.0, and every NaN, are one partition
    check([rb], [win(RANKING["row_number"], part=("c1",),
                     order=(("c2", True, None),))])


def test_string_partition_keys():
    rbs = part_order_batches()
    check(rbs, [win(RANKING["row_number"], part=("c4",), name="rn"),
                win(lambda ns: ns.Average(ns.col("c2")), part=("c4",),
                    name="a")])
    check(rbs, [win(RANKING["rank"], part=("c4", "c0"),
                    order=(("c3", False, None),))])


# --- RANGE literal offsets ---------------------------------------------------

def _range_batch():
    rng = np.random.default_rng(31)
    n = 1200
    o = rng.integers(0, 501, n)
    o[:40] = rng.choice([I32_MIN, I32_MIN + 1, I32_MAX - 1, I32_MAX], 40)
    rng.shuffle(o)
    return pa.record_batch({
        "p": pa.array(rng.integers(0, 4, n), pa.int32()),
        "o": _arr(o, 0.08, rng, pa.int32()),
        "v": _arr(rng.integers(-(1 << 40), 1 << 40, n), 0.1, rng,
                  pa.int64()),
        "d": _arr(rng.normal(0, 10, n), 0.1, rng, pa.float64())})


RANGE_FRAMES = [(-25, 25), (-100, 0), (0, 40), (-7, -2), (3, 9),
                (None, 30), (-30, None), (-(1 << 31), -1),
                (1, (1 << 31) - 1), (-(1 << 40), 1 << 40)]


@pytest.mark.parametrize("lo,hi", RANGE_FRAMES,
                         ids=[f"{a}_{b}" for a, b in RANGE_FRAMES])
def test_range_literal_offsets(lo, hi):
    frame = ("range", lo, hi)
    order = (("o", True, None),)
    specs = [win(lambda ns, f=f, c=c: AGGS[f](ns, c), frame, ("p",), order,
                 f"{f}_{c}")
             for f in ("sum", "count", "min", "max", "avg")
             for c in ("v", "d")]
    check([_range_batch()], specs)
    # nulls ordered last
    check([_range_batch()],
          [win(lambda ns: ns.Sum(ns.col("v")), frame, ("p",),
               (("o", True, False),))])


# --- min/max edges -----------------------------------------------------------

def _min_max_frame_case(frame, parts: int):
    rng = np.random.default_rng(21)
    rb = pa.record_batch({
        "p": pa.array(rng.integers(0, parts, 4000), pa.int32()),
        "v": _arr(rng.integers(-(1 << 62), 1 << 62, 4000), 0.1, rng,
                  pa.int64()),
        "o": pa.array(rng.integers(-(1 << 31), 1 << 31, 4000), pa.int32())})
    order = (("o", True, None), ("v", True, None))
    check([rb], [win(lambda ns: ns.Min(ns.col("v")), frame, ("p",), order,
                     "mn"),
                 win(lambda ns: ns.Max(ns.col("v")), frame, ("p",), order,
                     "mx")])


def test_wide_bounded_min_max_frame_takes_the_sparse_table():
    w = jwexpr.MAX_GATHER_FRAME * 2 + 7
    _min_max_frame_case(("rows", -(w // 2), w // 2), 4)


# the reference's widest windowed-gather frame, and one row wider: the
# port's sparse table against both of the reference's routes
GATHER_EDGE_FRAMES = [("rows", -(jwexpr.MAX_GATHER_FRAME // 2),
                       jwexpr.MAX_GATHER_FRAME // 2 - 1),
                      ("rows", -(jwexpr.MAX_GATHER_FRAME // 2),
                       jwexpr.MAX_GATHER_FRAME // 2),
                      ("rows", -37, -5)]


@pytest.mark.parametrize("frame", GATHER_EDGE_FRAMES, ids=_frame_id)
def test_bounded_min_max_frames_around_the_reference_gather_width(frame):
    _min_max_frame_case(frame, 2)


def test_int64_extremes():
    """Min over all-INT64_MAX frames and Max over all-INT64_MIN frames
    must not meet the argmin's sentinel; Sum wraps like a Java long."""
    rb = pa.record_batch({
        "c0": pa.array([0, 0, 1, 1, 2, 2, 2], pa.int32()),
        "c1": pa.array([1, 2, 1, 2, 1, 2, 3], pa.int32()),
        "c2": pa.array([I64_MAX, I64_MAX, I64_MIN, I64_MIN, I64_MAX, 1,
                        I64_MIN], pa.int64())})
    check([rb], [win(lambda ns: ns.Min(ns.col("c2")), name="mn"),
                 win(lambda ns: ns.Max(ns.col("c2")), name="mx"),
                 win(lambda ns: ns.Sum(ns.col("c2")), ("rows", None, None),
                     name="s")])


# --- the gate ----------------------------------------------------------------

def _plan(frame, order, rbs=None):
    ns = PORT
    return ns.Window([ns.Alias(ns.WE(
        ns.Sum(ns.col("v")), [ns.col("p")],
        [ns.SortOrder(ns.col(c), asc) for c, asc in order],
        ns.WF(*frame)), "s")], ns.Source(rbs or [_gate_batch()]))


def _gate_batch():
    rng = np.random.default_rng(5)
    return pa.record_batch({
        "p": pa.array(rng.integers(0, 3, 300), pa.int32()),
        "o": pa.array(rng.integers(0, 50, 300), pa.int32()),
        "o64": pa.array(rng.integers(0, 50, 300), pa.int64()),
        "f": pa.array(rng.normal(0, 5, 300), pa.float64()),
        "v": pa.array(rng.integers(-9, 9, 300), pa.int64())})


GATED = {"int64": [("o64", True)], "float": [("f", True)],
         "descending": [("o", False)], "two_keys": [("o", True),
                                                    ("o64", True)]}


@pytest.mark.parametrize("case", sorted(GATED))
def test_range_offsets_the_device_cannot_compute_raise(case):
    """They raised at planning until the CPU fallback was ported: the
    planner now places the window on the CPU, where it equals the
    reference's CPU path (its ``execute_cpu``), and the device path
    still refuses the offsets."""
    pp = GpuOverrides(device="cpu").apply(_plan(("range", -5, 5),
                                                GATED[case]))
    assert pp.fallback_nodes() == ["WindowExec"]
    assert "RANGE literal offsets" in pp.explain("NOT_ON_GPU")
    ref = REF.Window([REF.Alias(REF.WE(
        REF.Sum(REF.col("v")), [REF.col("p")],
        [REF.SortOrder(REF.col(c), asc) for c, asc in GATED[case]],
        REF.WF("range", -5, 5)), "s")], REF.Source([_gate_batch()]))
    want = jbase.collect_arrow_cpu(ref, jbase.ExecCtx())
    assert_same_rows(pp.collect(), want, ordered=False)
    with pytest.raises(NotImplementedError, match="RANGE literal offsets"):
        PORT.collect(_plan(("range", -5, 5), GATED[case]))
    # the same spec with unbounded or current-row bounds runs
    ok = _plan(("range", None, 0), GATED[case])
    GpuOverrides(device="cpu").apply(ok).collect()


@pytest.mark.parametrize("fn", ["first", "last"])
def test_first_and_last_over_a_window_name_item_8(fn):
    """Item 8's window aggregates run now (the gate took First, Last
    and the moments, ``tests/test_torch_moments.py``); the collects build
    as aggregates now, but over a window they still raise, naming item
    8."""
    from spark_rapids_tpu_torch.session import GpuSession
    from spark_rapids_tpu_torch.sql import SqlAnalysisError
    s = GpuSession(device="cpu")
    s.register_table("t", _gate_batch())
    out = s.sql(f"SELECT p, o, {fn}(v) OVER (PARTITION BY p ORDER BY o "
                "ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS w FROM t") \
        .collect()
    assert out.num_rows == _gate_batch().num_rows
    with pytest.raises(SqlAnalysisError, match="ROADMAP item 8") as e:
        s.sql("SELECT collect_list(v) OVER (PARTITION BY p ORDER BY o) "
              "FROM t")
    assert e.value.detail == "unsupported_feature"


def test_the_window_runs_where_the_caller_asks():
    """The plan runs on ``cuda:0`` unless the caller names the CPU."""
    import torch
    plan = _plan(("rows", -1, 1), [("o", True)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbase.collect_arrow(plan)
    assert tbase.collect_arrow(plan, tbase.ExecCtx(device="cpu")) \
        .num_rows == 300

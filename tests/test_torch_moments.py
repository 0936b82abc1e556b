"""ROADMAP item 8's rest on the CPU: string ``MIN``/``MAX``, ``FIRST``/
``LAST`` (with ``ignoreNulls``) and the central moments
(``VarianceSamp``, ``VariancePop``, ``StddevSamp``, ``StddevPop``),
grouped, global and over window frames, against the JAX package.

- Grouped and global aggregates: the port's ``GpuHashAggregateExec``
  against the reference's ``TpuHashAggregateExec`` on its CPU path
  (``collect_arrow_cpu``, Spark's semantics a group at a time), over one
  batch and over three (partials merged in batch order), with NaN, inf,
  nulls, all-null groups, one-row groups and empty and non-ASCII strings.
  First/Last depend on the order of the rows: here it is fixed (the
  batches in order, the rows in order within them).
- Windows: the port's ``GpuWindowExec`` against the reference's
  ``TpuWindowExec`` on its CPU path (its device window has no string
  MIN/MAX) over every frame kind the port takes for Sum/Min/Max
  (rows bounded on both sides, running, whole partition, reverse running,
  RANGE peers and a RANGE literal offset), ordered with ties (both break
  them by input position) and without.

Tolerance: strings, integers and nulls exact; the moments rel 1e-9 (a
merge or a frame sum adds in another order than the reference). The
port's frame moments are centered by the partition's mean and take the
two-pass sum over a bounded rows frame, or segmented running sums
elsewhere (``exec/window._frame_moment``, whose error bound its
docstring states); the reference's CPU path takes each frame's
two-pass sum.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.exec.base as jbase
import spark_rapids_tpu.expr as jexpr
import spark_rapids_tpu.expr.aggregates as jagg
import spark_rapids_tpu_torch.expr.aggregates as tagg
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.expr.base import Alias as TAlias
from spark_rapids_tpu_torch.expr.base import UnresolvedColumn as TCol
from test_torch_window import PORT, REF, part_order_batches
from torch_dual_run import assert_same_rows

RTOL = 1e-9
MOMENTS = ["VarianceSamp", "VariancePop", "StddevSamp", "StddevPop"]


def _batches(n_batches, seed=8, n=300):
    """k group key (0..9 and null; group 7 all-null values, group 8 one
    row), x doubles with NaN/inf/nulls, q int32, s strings with the empty
    and non-ASCII ones."""
    out = []
    for b in range(n_batches):
        rng = np.random.default_rng(seed + b)
        k = rng.integers(0, 7, n).astype(object)
        k[rng.random(n) < 0.05] = None
        k[:4] = 7
        k[4] = 8 if b == 0 else 9
        x = rng.normal(50, 30, n)
        x[rng.random(n) < 0.01] = math.nan
        x[rng.random(n) < 0.01] = math.inf
        xm = rng.random(n) < 0.15
        xm[:4] = True
        s = rng.choice(np.array(["", "a", "b", "Books", "é", "ée", "zz",
                                 "日本", "ab"], dtype=object), n)
        out.append(pa.record_batch({
            "k": pa.array(list(k), pa.int32()),
            "x": pa.array(x, pa.float64(), mask=xm),
            "q": pa.array(rng.integers(-50, 50, n), pa.int32(),
                          mask=rng.random(n) < 0.1),
            "s": pa.array(list(s), pa.string(),
                          mask=rng.random(n) < 0.1)}))
    return out


def _aggs(pkg, col, alias):
    out = []
    for name in MOMENTS:
        for c in ("x", "q"):
            out.append(alias(getattr(pkg, name)(col(c)), f"{name}_{c}"))
    out += [alias(pkg.Min(col("s")), "mn_s"), alias(pkg.Max(col("s")), "mx_s"),
            alias(pkg.First(col("x")), "f_x"),
            alias(pkg.First(col("x"), True), "fi_x"),
            alias(pkg.Last(col("q")), "l_q"),
            alias(pkg.Last(col("q"), True), "li_q")]
    return out


def _run_aggregates(rbs, keys):
    port = GpuHashAggregateExec(
        [TCol(k) for k in keys], _aggs(tagg, TCol, TAlias),
        tbase.HostBatchSourceExec(rbs))
    got = tbase.collect_arrow(port, tbase.ExecCtx(device="cpu"))
    ref = TpuHashAggregateExec(
        [jexpr.UnresolvedColumn(k) for k in keys],
        _aggs(jagg, jexpr.UnresolvedColumn, jexpr.Alias),
        jbase.HostBatchSourceExec(rbs))
    want = jbase.collect_arrow_cpu(ref, jbase.ExecCtx())
    return got, want


def _hold(got, want):
    """Exact, except the moment columns at RTOL."""
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows

    def key(i, t):
        v = t.column(0).to_pylist()[i] if t.num_columns else None
        return (v is None, v if v is not None else 0)
    gi = sorted(range(got.num_rows), key=lambda i: key(i, got))
    wi = sorted(range(want.num_rows), key=lambda i: key(i, want))
    for name in got.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        for a, b in zip([g[i] for i in gi], [w[i] for i in wi]):
            if isinstance(a, float) and b is not None:
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=RTOL), (name, a, b)
            else:
                assert a == b, (name, a, b)


@pytest.mark.parametrize("n_batches", [1, 3])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_aggregates_equal_the_reference(n_batches, grouped):
    got, want = _run_aggregates(_batches(n_batches), ["k"] if grouped else [])
    _hold(got, want)


def test_global_string_min_max_over_null_and_empty_partials():
    """The global MIN/MAX of a string stacks each partial's lane 0
    (``exec/aggregate._lane0_column``): a batch whose strings are all
    null, one of only empty strings and one of non-ASCII strings still
    equal the reference."""
    rbs = _batches(3)
    for i, vals in ((0, [None]), (1, [""]), (2, ["é", "日本", "ab"])):
        n = rbs[i].num_rows
        s = pa.array([vals[j % len(vals)] for j in range(n)], pa.string())
        rbs[i] = rbs[i].set_column(3, "s", s)
    got, want = _run_aggregates(rbs, [])
    _hold(got, want)
    assert got.column("mn_s").to_pylist() == [""]


def test_moment_corners_follow_spark():
    rb = pa.record_batch({"k": pa.array([1, 2, 2, 3, 3], pa.int32()),
                          "x": pa.array([4.0, 1.0, 1.0, None, None],
                                        pa.float64())})
    port = GpuHashAggregateExec(
        [TCol("k")], [TAlias(tagg.StddevSamp(TCol("x")), "s"),
                      TAlias(tagg.VariancePop(TCol("x")), "p")],
        tbase.HostBatchSourceExec([rb]))
    got = tbase.collect_arrow(port, tbase.ExecCtx(device="cpu")) \
        .sort_by("k")
    # one row: the sample moment is null, the population one 0; equal
    # values: exactly 0; no value: null
    assert got.column("s").to_pylist() == [None, 0.0, None]
    assert got.column("p").to_pylist() == [0.0, 0.0, None]


def run_both(rbs, specs):
    """The port's window against the reference's CPU path (Spark's
    semantics a partition at a time; the reference's device window has no
    string MIN/MAX): ``specs`` as in ``test_torch_window.run_both``."""
    out = []
    for ns in (PORT, REF):
        exprs = [ns.Alias(ns.WE(
            fn(ns), [ns.col(c) for c in part],
            [ns.SortOrder(ns.col(c), asc, nf) for c, asc, nf in order],
            ns.WF(*frame)), name) for name, fn, part, order, frame in specs]
        plan = ns.Window(exprs, ns.Source(rbs))
        out.append(ns.collect(plan) if ns is PORT else
                   jbase.collect_arrow_cpu(plan, jbase.ExecCtx()))
    return out


FRAMES = [("rows", -2, 0), ("rows", -1, 3), ("rows", None, 0),
          ("rows", 0, None), ("rows", None, None), ("range", None, 0),
          ("range", 0, 0), ("range", -3, 2)]
ORDERS = {"ties": [("c1", True, None)],
          "no_ties": [("c1", True, None), ("c2", True, None),
                      ("c3", True, None), ("c4", True, None)]}


def _window_specs(ns_frame, order):
    specs = []
    for i, name in enumerate(MOMENTS):
        specs.append((f"m{i}", lambda ns, n=name: getattr(
            tagg if ns is PORT else jagg, n)(ns.col("c3")), ["c0"], order,
            ns_frame))
    specs += [("mn", lambda ns: ns.Min(ns.col("c4")), ["c0"], order,
               ns_frame),
              ("mx", lambda ns: ns.Max(ns.col("c4")), ["c0"], order,
               ns_frame)]
    for name, ign in (("First", False), ("First", True), ("Last", False),
                      ("Last", True)):
        specs.append((f"{name}{int(ign)}", lambda ns, n=name, g=ign: (
            getattr(tagg, n) if ns is PORT else getattr(jagg, n))(
                ns.col("c2"), g), ["c0"], order, ns_frame))
    return specs


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("frame", FRAMES, ids=[str(f) for f in FRAMES])
def test_window_moments_first_last_and_string_min_max(frame, order):
    rbs = part_order_batches(240, seed=77)
    if frame[0] == "range" and frame[1] not in (None, 0):
        spec_order = ORDERS["ties"]
    else:
        spec_order = ORDERS[order]
    got, want = run_both(rbs, _window_specs(frame, spec_order))
    assert got.num_rows == want.num_rows > 0
    floats = {f"m{i}" for i in range(len(MOMENTS))}
    g = list(zip(*[got.column(c).to_pylist() for c in got.column_names]))
    w = list(zip(*[want.column(c).to_pylist() for c in want.column_names]))
    for gr, wr in zip(g, w):
        for name, a, b in zip(got.column_names, gr, wr):
            if name in floats and a is not None and b is not None:
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=RTOL, abs_tol=1e-9 * (1 + abs(b))), \
                    (name, a, b)
            else:
                assert a == b, (name, a, b)


def test_window_moments_of_equal_values_are_exactly_zero():
    rb = pa.record_batch({"c0": pa.array([1] * 6, pa.int32()),
                          "c1": pa.array(range(6), pa.int32()),
                          "c3": pa.array([0.1] * 6, pa.float64())})
    for frame in (("rows", -2, 0), ("rows", None, 0)):
        got, _ = run_both([rb], [(
            "v", lambda ns: (tagg.VariancePop if ns is PORT
                             else jagg.VariancePop)(ns.col("c3")),
            ["c0"], [("c1", True, None)], frame)])
        assert got.column("v").to_pylist() == [0.0] * 6


def test_window_first_last_sql_matches_the_reference(tmp_path):
    """FIRST/LAST and the moments over a window from SQL text (the gate
    no longer refuses them)."""
    from spark_rapids_tpu_torch import nds
    from torch_dual_run import dual_run
    paths = nds.write_tables(nds.gen_tables(1 << 10), str(tmp_path))
    sql = ("SELECT ss_store_sk, ss_item_sk, ss_customer_sk, "
           "STDDEV_POP(ss_net_profit) OVER (PARTITION BY ss_store_sk "
           "ORDER BY ss_item_sk, ss_customer_sk, ss_sold_date_sk ROWS "
           "BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS sd, "
           "FIRST(ss_quantity) OVER (PARTITION BY ss_store_sk ORDER BY "
           "ss_item_sk, ss_customer_sk, ss_sold_date_sk ROWS BETWEEN 3 "
           "PRECEDING AND 1 FOLLOWING) AS f FROM store_sales")
    got, want = dual_run(sql, paths, {"spark.sql.shuffle.partitions": "1"})
    assert got.num_rows == 1 << 10
    assert_same_rows(got, want, ordered=False)


@pytest.mark.parametrize("frame", FRAMES, ids=[str(f) for f in FRAMES])
def test_window_moments_equal_the_reference_device_formulation(frame):
    """The moments and FIRST/LAST against the reference's device window
    (its prefix differences of partition-centered sums), rel 1e-9."""
    rbs = part_order_batches(240, seed=78)
    specs = [s for s in _window_specs(frame, ORDERS["ties"])
             if s[0] not in ("mn", "mx")]
    got = PORT.collect(PORT.Window([PORT.Alias(PORT.WE(
        fn(PORT), [PORT.col(c) for c in part],
        [PORT.SortOrder(PORT.col(c), asc, nf) for c, asc, nf in order],
        PORT.WF(*fr)), name) for name, fn, part, order, fr in specs],
        PORT.Source(rbs)))
    want = REF.collect(REF.Window([REF.Alias(REF.WE(
        fn(REF), [REF.col(c) for c in part],
        [REF.SortOrder(REF.col(c), asc, nf) for c, asc, nf in order],
        REF.WF(*fr)), name) for name, fn, part, order, fr in specs],
        REF.Source(rbs)))
    for name in got.column_names:
        for a, b in zip(got.column(name).to_pylist(),
                        want.column(name).to_pylist()):
            if isinstance(a, float) and b is not None:
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=RTOL, abs_tol=1e-9 * (1 + abs(b))), \
                    (name, a, b)
            else:
                assert a == b, (name, a, b)

"""Decimal aggregates and window frames of the port: ``SUM`` (a
``decimal(p+10,s)``, null past its precision), ``AVG`` (a
``decimal(p+4,s+4)``, ``HALF_UP``), ``MIN``, ``MAX``, ``FIRST``,
``LAST``, ``COUNT`` and the moments, grouped and global, through SQL
over Parquet files against the JAX package (``torch_dual_run``) and
Python's ``decimal``; ``Sum``'s overflow on hand-made int64 lanes; the
placement of the reference's gates (a sum past 18 digits and an
average whose scaled sum could pass them run on the CPU, and there the
sum is exact at any width); and a decimal ``SUM`` and ``AVG`` over a
window frame.

Where the reference departs the port is held to Python's ``decimal``:
the moments of a decimal (the reference reads the unscaled lane, Spark
the value), and every result past 18 digits (the reference has no
layout for it). Decimals compare exactly.
"""
import decimal
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_dual_run import dual_run, run_port

from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.columnar.column import GpuColumnVector
from spark_rapids_tpu_torch.expr.aggregates import Average, Sum
from spark_rapids_tpu_torch.expr.base import BoundReference

N = 1 << 11
CTX = decimal.Context(prec=100)
D = decimal.Decimal


def _table(seed=0):
    rng = np.random.default_rng(seed)

    def dec(p, s, null_share=0.1):
        lim = 10 ** p - 1
        v = rng.integers(-lim, lim + 1, N)
        small = rng.random(N) < 0.5
        v[small] = rng.integers(-5000, 5000, int(small.sum()))
        v[:2] = [lim, -lim]
        mask = rng.random(N) < null_share
        mask[:2] = False
        return pa.array([None if m else D(int(x)).scaleb(-s, CTX)
                         for x, m in zip(v, mask)], pa.decimal128(p, s))

    g = rng.integers(0, 7, N)
    d = dec(7, 2)
    # group 6 only ever sees nulls of d
    dl = d.to_pylist()
    for i in np.flatnonzero(g == 6):
        dl[i] = None
    return pa.table({
        "g": pa.array(g.astype(np.int32)),
        "o": pa.array(rng.permutation(N).astype(np.int64)),
        "d": pa.array(dl, pa.decimal128(7, 2)),
        "e": dec(8, 4),
        "c": dec(4, 2),
        "t": dec(9, 1),
        "h": dec(15, 3),
    })


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.fixture(scope="module")
def paths(table, tmp_path_factory):
    d = tmp_path_factory.mktemp("dec_agg")
    p = str(d / "t.parquet")
    pq.write_table(table, p, row_group_size=N // 2,
                   store_decimal_as_integer=True)
    return {"t": p}


GROUPED = {
    "sum_min_max_count": "SELECT g, SUM(d) AS s, MIN(d) AS lo, MAX(d) AS hi, "
                         "COUNT(d) AS n, COUNT(*) AS c, SUM(e) AS se, "
                         "MIN(e) AS le FROM t GROUP BY g ORDER BY g",
    "avg_narrow": "SELECT g, AVG(c) AS a, SUM(c) AS s FROM t GROUP BY g "
                  "ORDER BY g",
    "avg_cpu": "SELECT g, AVG(d) AS a, AVG(e) AS ae FROM t GROUP BY g "
               "ORDER BY g",
    "first_last": "SELECT g, FIRST(d) AS f, LAST(e) AS l FROM "
                  "(SELECT g, d, e FROM t ORDER BY o) x GROUP BY g "
                  "ORDER BY g",
    "group_by_decimal": "SELECT e, COUNT(*) AS n, SUM(d) AS s FROM t "
                        "GROUP BY e ORDER BY n DESC, e LIMIT 50",
    "global": "SELECT SUM(d) AS s, AVG(d) AS a, MIN(e) AS lo, MAX(e) AS hi, "
              "COUNT(d) AS n FROM t",
}


@pytest.mark.parametrize("parts", [1, 16])
@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_and_global_match_reference(paths, name, parts):
    if name == "first_last" and parts == 16:
        pytest.skip("FIRST/LAST after a 16-way exchange depend on the "
                    "order partitions arrive in; 1 partition fixes it")
    dual_run(GROUPED[name], paths, {"spark.sql.shuffle.partitions":
                                    str(parts)})


def _by_group(table, col, fn):
    groups = defaultdict(list)
    for g, v in zip(table.column("g").to_pylist(),
                    table.column(col).to_pylist()):
        groups[g].append(v)
    return [fn([v for v in groups[g] if v is not None])
            for g in sorted(groups)]


def _at(v, p, s):
    if v is None:
        return None
    q = v.quantize(D(1).scaleb(-s, CTX), rounding=decimal.ROUND_HALF_UP,
                   context=CTX)
    return q if abs(int(q.scaleb(s, CTX))) < 10 ** p else None


@pytest.mark.parametrize("parts", [1, 16])
def test_sums_past_18_digits_run_exactly_on_the_cpu(paths, table, parts):
    """The reference cannot run these (its upload has no layout past 18
    digits): ``SUM`` of a ``decimal(9,1)`` is a ``decimal(19,1)``, of a
    ``decimal(15,3)`` a ``decimal(25,3)``, ``AVG`` of it a
    ``decimal(19,7)``; held to Python's ``decimal``, placed on the
    CPU."""
    sql = ("SELECT g, SUM(t) AS st, SUM(h) AS sh, AVG(h) AS ah FROM t "
           "GROUP BY g ORDER BY g")
    conf = {"spark.sql.shuffle.partitions": str(parts)}
    got, _ = run_port(sql, paths, conf)
    assert got.schema.types == [pa.int32(), pa.decimal128(19, 1),
                                pa.decimal128(25, 3), pa.decimal128(19, 7)]
    sums = lambda vs: sum(vs, D(0)) if vs else None  # noqa: E731
    assert got.column("st").to_pylist() == _by_group(table, "t", sums)
    assert got.column("sh").to_pylist() == _by_group(table, "h", sums)
    avg = [None if not vs else _at(CTX.divide(sum(vs, D(0)), len(vs)), 19, 7)
           for vs in _by_group(table, "h", list)]
    assert got.column("ah").to_pylist() == avg
    from spark_rapids_tpu_torch import nds
    from spark_rapids_tpu_torch.planner import GpuOverrides
    s = nds.session_over_files(paths, conf, device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)
    assert "HashAggregateExec" in pp.fallback_nodes()
    assert "18 decimal digits" in pp.explain("NOT_ON_GPU")


def test_moments_of_decimals_take_the_value(paths, table):
    """Spark casts a decimal to double for the moments; the reference
    reads the unscaled lane, so the port is held to numpy here."""
    sql = ("SELECT g, VAR_POP(d) AS v, STDDEV_SAMP(e) AS sd FROM t "
           "GROUP BY g ORDER BY g")
    got, _ = run_port(sql, paths, {"spark.sql.shuffle.partitions": "4"})
    v = _by_group(table, "d", lambda vs: float(np.var(np.array(
        [float(x) for x in vs]))) if vs else None)
    sd = _by_group(table, "e", lambda vs: float(np.std(np.array(
        [float(x) for x in vs]), ddof=1)) if len(vs) > 1 else None)
    for a, b in zip(got.column("v").to_pylist(), v):
        assert (a is None and b is None) or abs(a - b) <= 1e-9 * abs(b)
    for a, b in zip(got.column("sd").to_pylist(), sd):
        assert (a is None and b is None) or abs(a - b) <= 1e-9 * abs(b)


def _lanes(t, values):
    data = torch.tensor(values, dtype=torch.int64)
    return GpuColumnVector(t, data, None)


def test_sum_overflow_on_hand_made_lanes():
    """A Decimal64 sum is null past its precision, as far as the int64
    accumulator can tell (``|sum| < 2^63``, the reference's bound); past
    18 digits, on the host, the limbs make it exact."""
    t8 = tdt.DecimalType(8, 0)  # its sum is a decimal(18,0)
    s = Sum(BoundReference(0, t8))
    live = torch.ones(3, dtype=torch.bool)
    seg = torch.zeros(3, dtype=torch.int32)
    out_live = torch.tensor([True, False, False])
    near = 10 ** 18 // 3
    fits = s.update_device([_lanes(t8, [near, near, 0])], seg, live,
                           out_live)[0]
    assert fits.validity[0] and int(fits.data[0]) == 2 * near
    over = s.update_device([_lanes(t8, [near, near, near + 1])], seg, live,
                           out_live)[0]
    assert not over.validity[0]
    neg = s.update([_lanes(t8, [-near, -near, -near - 1])], live)[0]
    assert not neg.validity[0]
    t9 = tdt.DecimalType(9, 0)  # its sum is a decimal(19,0): the host's
    w = Sum(BoundReference(0, t9))
    assert "exceeds device decimal" in w.gpu_supported()
    big = 3 * 10 ** 18  # three of them pass 2^63 but not 10^19
    exact = w.update_device([_lanes(t9, [big, big, big])], seg, live,
                            out_live)[0]
    assert exact.validity[0]
    lo, hi = exact.data[0].tolist()
    assert hi * (1 << 64) + (lo & ((1 << 64) - 1)) == 3 * big
    past = w.update_device([_lanes(t9, [big, big, big + 10 ** 18 + 1])],
                           seg, live, out_live)[0]
    assert not past.validity[0]


def test_average_gate_and_half_up_ties():
    """``AVG`` of a ``decimal(p,s)`` runs on the device only while
    ``p + 14 <= 18``; its ``HALF_UP`` rounds a tie away from zero."""
    assert Average(BoundReference(0, tdt.DecimalType(4, 2))) \
        .gpu_supported() is None
    assert "exceeds" in Average(BoundReference(0, tdt.DecimalType(5, 2))) \
        .gpu_supported()
    t = tdt.DecimalType(4, 2)
    a = Average(BoundReference(0, t))
    assert a.dtype == tdt.DecimalType(8, 6)
    live = torch.ones(32, dtype=torch.bool)
    for total in (1, -1, 31, -33):  # cents over 32 rows: a tie at 6 places
        vals = [total] + [0] * 31
        bufs = a.update([_lanes(t, vals)], live)
        got = a.evaluate(bufs)
        want = CTX.divide(D(total).scaleb(-2), 32).quantize(
            D("0.000001"), rounding=decimal.ROUND_HALF_UP)
        assert int(got.data[0]) == int(want.scaleb(6)), (total, want)


WINDOW = ("SELECT g, o, d, SUM(d) OVER (PARTITION BY g ORDER BY o ROWS "
          "BETWEEN 2 PRECEDING AND CURRENT ROW) AS s3, "
          "SUM(e) OVER (PARTITION BY g ORDER BY o) AS run "
          "FROM t ORDER BY g, o")


@pytest.mark.parametrize("parts", [1, 16])
def test_window_decimal_sum_matches_reference(paths, parts):
    dual_run(WINDOW, paths, {"spark.sql.shuffle.partitions": str(parts)})


def test_window_decimal_avg_and_wide_sum_run_on_the_cpu(paths, table):
    """A decimal ``AVG`` over a frame runs on the CPU, as the reference
    places it; so does a frame ``SUM`` past 18 digits. Both held to
    Python's ``decimal``."""
    sql = ("SELECT g, o, AVG(d) OVER (PARTITION BY g ORDER BY o ROWS "
           "BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS a3, "
           "SUM(t) OVER (PARTITION BY g ORDER BY o ROWS BETWEEN 2 "
           "PRECEDING AND CURRENT ROW) AS w3 FROM t ORDER BY g, o")
    got, _ = run_port(sql, paths, {"spark.sql.shuffle.partitions": "1"})
    assert got.schema.types[2:] == [pa.decimal128(11, 6),
                                    pa.decimal128(19, 1)]
    rows = sorted(zip(table.column("g").to_pylist(),
                      table.column("o").to_pylist(),
                      table.column("d").to_pylist(),
                      table.column("t").to_pylist()))
    a3, w3 = [], []
    for i, (g, o, _, _) in enumerate(rows):
        part = [r for r in rows if r[0] == g] if i == 0 or \
            rows[i - 1][0] != g else part
        k = [r[1] for r in part].index(o)
        frame = [r[2] for r in part[max(k - 1, 0):k + 2] if r[2] is not None]
        a3.append(_at(CTX.divide(sum(frame, D(0)), len(frame)), 11, 6)
                  if frame else None)
        back = [r[3] for r in part[max(k - 2, 0):k + 1] if r[3] is not None]
        w3.append(sum(back, D(0)) if back else None)
    assert got.column("a3").to_pylist() == a3
    assert got.column("w3").to_pylist() == w3


@pytest.mark.parametrize("parts", [1, 16])
def test_an_overflowed_partial_nulls_the_merged_sum(tmp_path, parts):
    """A ``decimal(38,0)`` sums to a ``decimal(38,0)``: two rows of
    ``6 x 10^37`` overflow their row group's partial, which is null but
    not empty, and so the merged ``SUM`` and ``AVG`` are null (Spark's
    ``isEmpty`` buffer), not the other partial's total. Held to Python's
    ``decimal``."""
    big = D(6) * D(10) ** 37
    g = [0, 0, 1, 1, 0, 1, 0, 1]
    x = [big, big, D(5), D(7), D(3), D(4), None, D(2)]
    p = str(tmp_path / "wide.parquet")
    pq.write_table(pa.table({"g": pa.array(g, pa.int32()),
                             "x": pa.array(x, pa.decimal128(38, 0))}),
                   p, row_group_size=4)
    # a batch a row group: one partial each
    conf = {"spark.sql.shuffle.partitions": str(parts),
            "spark.rapids.sql.batchSizeRows": "4"}
    got, _ = run_port("SELECT g, SUM(x) AS s, AVG(x) AS a FROM t "
                      "GROUP BY g ORDER BY g", {"t": p}, conf)
    assert got.column("s").to_pylist() == [None, D(18)]
    assert got.column("a").to_pylist() == [None, D("4.5000")]
    got, _ = run_port("SELECT SUM(x) AS s, AVG(x) AS a, "
                      "SUM(CASE WHEN g = 1 THEN x END) AS s1 FROM t",
                      {"t": p}, conf)
    assert got.to_pylist() == [{"s": None, "a": None, "s1": D(18)}]

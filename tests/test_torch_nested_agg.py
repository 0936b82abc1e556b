"""The collects and a list of percentiles on the CPU: the port's
``GpuHashAggregateExec`` held to the JAX package's ``TpuHashAggregateExec``
over the same seeded batches (``tests/test_aggregate.py:279-330``'s
cases), and from SQL through both sessions.

- ``collect_list`` and ``collect_set`` grouped, over long, string and
  double values with nulls (each group's elements in the reference's
  value order: strings by UTF-8 bytes, NaN last; a set keeps one NaN and
  ``-0.0`` equal to ``0.0``), global, and beside ``SUM`` and ``COUNT``;
- the collects from SQL, at 1 and 4 partitions;
- the over-budget reroute: the single pass's input past half the device
  budget goes to the CPU grouping (``cpuAggregate`` = 1), rows
  unchanged;
- ``approx_percentile`` with a list of percentages, grouped and global,
  in both strategies (``tests/test_torch_percentile.py`` holds the
  values): an ``array<double>`` whose elements are the reference's.
"""
import math

import pyarrow as pa
import pytest

from data_gen import (DoubleGen, IntegerGen, LongGen, StringGen, gen_table)

from spark_rapids_tpu.exec import HostBatchSourceExec as JS
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec as JA
from spark_rapids_tpu.expr import Alias as JAlias
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.expr.aggregates import ApproxPercentile as JPct
from spark_rapids_tpu.expr.aggregates import CollectList as JCL
from spark_rapids_tpu.expr.aggregates import CollectSet as JCS
from spark_rapids_tpu.expr.aggregates import Count as JCount
from spark_rapids_tpu.expr.aggregates import Sum as JSum
from spark_rapids_tpu.planner import overrides

from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec as TA
from spark_rapids_tpu_torch.exec.base import ExecCtx
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec as TS
from spark_rapids_tpu_torch.expr import Alias as TAlias
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.expr.aggregates import ApproxPercentile as TPct
from spark_rapids_tpu_torch.expr.aggregates import CollectList as TCL
from spark_rapids_tpu_torch.expr.aggregates import CollectSet as TCS
from spark_rapids_tpu_torch.expr.aggregates import Count as TCount
from spark_rapids_tpu_torch.expr.aggregates import Sum as TSum
from spark_rapids_tpu_torch.planner import GpuOverrides

REF = {"Agg": JA, "Src": JS, "Alias": JAlias, "col": jcol, "CL": JCL,
       "CS": JCS, "Sum": JSum, "Count": JCount, "Pct": JPct}
PORT = {"Agg": TA, "Src": TS, "Alias": TAlias, "col": tcol, "CL": TCL,
        "CS": TCS, "Sum": TSum, "Count": TCount, "Pct": TPct}


def _same(a, b):
    """Equal Python values, NaN equal to NaN, a float's sign kept out of
    it (``-0.0 == 0.0``), lists element by element."""
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return type(a) is type(b) and a == b


def _rows(t: pa.Table):
    rows = list(zip(*[t.column(c).to_pylist() for c in t.column_names]))
    return sorted(rows, key=repr)


def _both(build, rbs, conf=None, ordered=False):
    """``build(pkg, rbs)`` planned and run in both packages: names,
    Arrow types and rows equal (sorted unless ``ordered``)."""
    from spark_rapids_tpu.config import RapidsConf as JConf
    want = overrides(build(REF, rbs), JConf(conf or {})).collect()
    pp = GpuOverrides(RapidsConf(conf or {}), "cpu").apply(
        build(PORT, rbs))
    ctx = ExecCtx(RapidsConf(conf or {}), "cpu")
    got = pp.collect(ctx)
    assert got.column_names == want.column_names
    assert got.schema.types == want.schema.types
    g = list(zip(*[got.column(c).to_pylist() for c in got.column_names]))
    w = list(zip(*[want.column(c).to_pylist() for c in want.column_names]))
    if not ordered:
        g, w = _rows(got), _rows(want)
    assert len(g) == len(w)
    for gr, wr in zip(g, w):
        assert all(_same(a, b) for a, b in zip(gr, wr)), (gr, wr)
    return got, ctx


def _collect_batches(val_gen, n=200):
    return [gen_table([IntegerGen(min_val=0, max_val=6, null_frac=0.1),
                       val_gen], n, seed=31 + i) for i in range(2)]


VALUES = {"long": LongGen(null_frac=0.2),
          "string": StringGen(max_len=5, null_frac=0.2),
          "double": DoubleGen(null_frac=0.2)}


@pytest.mark.parametrize("kind", ["CL", "CS"],
                         ids=["collect_list", "collect_set"])
@pytest.mark.parametrize("name", sorted(VALUES))
def test_grouped_collects_match_reference(kind, name):
    gen = VALUES[name] if not (kind == "CS" and name == "string") \
        else StringGen(max_len=4, null_frac=0.2)
    _both(lambda p, rbs: p["Agg"]([p["col"]("c0")], [p["Alias"](
        p[kind](p["col"]("c1")), "vals")], p["Src"](rbs)),
        _collect_batches(gen))


def test_set_keeps_one_nan_and_zero():
    rb = pa.record_batch({
        "k": pa.array([1, 1, 1, 1, 1, 2, 2, 2], pa.int32()),
        "v": pa.array([float("nan"), -0.0, 0.0, float("nan"), 1.5, None,
                       -0.0, float("inf")], pa.float64())})
    got, _ = _both(lambda p, rbs: p["Agg"]([p["col"]("k")], [
        p["Alias"](p["CS"](p["col"]("v")), "s"),
        p["Alias"](p["CL"](p["col"]("v")), "l")], p["Src"](rbs)), [rb])
    sets = dict(zip(got.column("k").to_pylist(), got.column("s").to_pylist()))
    assert len(sets[1]) == 3 and math.isnan(sets[1][-1])
    assert sets[2] == [0.0, float("inf")]


def test_collect_mixed_with_other_aggs():
    rbs = [gen_table([IntegerGen(min_val=0, max_val=4, null_frac=0.0),
                      LongGen(null_frac=0.1)], 150, seed=3)]
    _both(lambda p, rbs: p["Agg"]([p["col"]("c0")], [
        p["Alias"](p["CL"](p["col"]("c1")), "vals"),
        p["Alias"](p["Sum"](p["col"]("c1")), "s"),
        p["Alias"](p["Count"](), "n")], p["Src"](rbs)), rbs)


@pytest.mark.parametrize("kind", ["CL", "CS"],
                         ids=["collect_list", "collect_set"])
def test_global_collects(kind):
    rbs = [gen_table([IntegerGen(min_val=0, max_val=9, null_frac=0.3)], 80,
                     seed=8)]
    got, _ = _both(lambda p, rbs: p["Agg"]([], [p["Alias"](
        p[kind](p["col"]("c0")), "vals")], p["Src"](rbs)), rbs,
        ordered=True)
    assert got.num_rows == 1


@pytest.mark.parametrize("parts", [1, 4])
def test_collects_from_sql(parts):
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import GpuSession
    rb = gen_table([IntegerGen(min_val=0, max_val=5, null_frac=0.1),
                    StringGen(max_len=4, null_frac=0.2),
                    DoubleGen(null_frac=0.1)], 300, seed=12,
                   names=["k", "s", "d"])
    sql = ("SELECT k, collect_list(s) AS ls, collect_set(s) AS ss, "
           "collect_set(d) AS ds, COUNT(*) AS n FROM t GROUP BY k")
    conf = {"spark.sql.shuffle.partitions": str(parts)}
    s = GpuSession(conf, device="cpu")
    s.register_table("t", s.create_dataframe(pa.Table.from_batches([rb])))
    js = TpuSession(conf)
    js.register_table("t", js.create_dataframe(pa.Table.from_batches([rb])))
    got, want = s.sql(sql).collect(), js.sql(sql).collect()
    assert got.schema.types == want.schema.types
    for gr, wr in zip(_rows(got), _rows(want)):
        assert all(_same(a, b) for a, b in zip(gr, wr)), (gr, wr)


def test_over_budget_collect_reroutes_to_the_cpu():
    """The single pass's input past half a 4 KiB budget: the batches so
    far are downloaded and the grouping runs on the CPU, as the
    reference's ``_execute_single_pass`` reroutes."""
    rbs = [gen_table([IntegerGen(min_val=0, max_val=6, null_frac=0.1),
                      LongGen(null_frac=0.2)], 300, seed=40 + i)
           for i in range(4)]
    conf = {"spark.rapids.memory.device.budgetBytes": "4096",
            "spark.rapids.sql.verifyPlan": "false"}
    _, ctx = _both(lambda p, rbs: p["Agg"]([p["col"]("c0")], [
        p["Alias"](p["CL"](p["col"]("c1")), "vals"),
        p["Alias"](p["CS"](p["col"]("c1")), "set")], p["Src"](rbs)),
        rbs, conf=conf)
    agg = [m for k, m in ctx.metrics.items()
           if k.startswith("HashAggregateExec")][0]
    assert agg["cpuAggregate"].value == 1


@pytest.mark.parametrize("exact", ["true", "false"])
@pytest.mark.parametrize("keys", [True, False], ids=["grouped", "global"])
def test_list_of_percentiles(exact, keys):
    rbs = [gen_table([IntegerGen(min_val=0, max_val=5, nullable=False),
                      DoubleGen(null_frac=0.1)], 300, seed=17,
                     names=["k", "v"])]
    conf = {"spark.rapids.sql.approxPercentile.exact": exact}
    got, _ = _both(lambda p, rbs: p["Agg"](
        [p["col"]("k")] if keys else [],
        [p["Alias"](p["Pct"](p["col"]("v"), [0.0, 0.25, 0.5, 1.0]), "p")],
        p["Src"](rbs)), rbs, conf=conf)
    assert str(got.schema.field("p").type) == "list<item: double>"
    assert all(v is None or len(v) == 4
               for v in got.column("p").to_pylist())

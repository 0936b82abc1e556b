"""The per-operator CPU fallback on the CPU: placement, transitions and
the eight texts of ``spark_rapids_tpu_torch/tools/nds_fallback.py``.

- The eight texts at 2^12 store_sales rows and ``spark.sql.shuffle
  .partitions`` 1 and 4, each under its conf: the port's rows against
  the reference's all-CPU rows and against the text's numpy/pyarrow
  oracle, its ``fallback_nodes()`` against the reference's placement
  and ``FALLBACK`` (``tests/torch_fallback_cases.py``).
- ``variableFloatAgg=false`` places q3's aggregate on the CPU, as in
  the reference (the port ignored the switch before the operator gates
  were read).
- ``explain("NOT_ON_GPU")`` names the reference's nodes.
- Every type the Arrow bridge carries survives both transitions: nulls,
  a lazy selection applied before the download, string columns of a
  sliced input (their chars buffer inherited) and a ``NullType`` column.
- ``DeviceToHostExec.execute`` raises, and a kernel wrapper that raises
  inside a device node makes the query raise: nothing reroutes to the
  CPU at run time.
- ``Expression.eval_cpu`` against the reference's ``eval_cpu`` on one
  Arrow batch, an expression or two from each ``expr/`` module (nulls,
  NaN, Kleene logic, a non-ASCII LIKE).

Tolerance: ints, strings and nulls exact, floats rel 1e-9
(``torch_dual_run.FLOAT_RTOL``)."""
import datetime

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import spark_rapids_tpu.expr as jexpr
from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.columnar.arrow_bridge import \
    engine_schema as j_engine_schema
from spark_rapids_tpu.expr.base import EvalCtx as JEvalCtx
from spark_rapids_tpu.expr.strings import Like as JLike
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch import expr as texpr
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.columnar.arrow_bridge import \
    engine_schema as t_engine_schema
from spark_rapids_tpu_torch.expr.base import EvalCtx
from spark_rapids_tpu_torch.expr.strings import Like
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.exec.basic import GpuFilterExec
from spark_rapids_tpu_torch.exec.transitions import (DeviceToHostExec,
                                                     HostToDeviceExec)
from spark_rapids_tpu_torch.expr import IsNotNull, UnresolvedColumn
from spark_rapids_tpu_torch.ops import cuda_kernels as ck
from spark_rapids_tpu_torch.tools import nds_fallback as fb
from torch_dual_run import assert_same_rows
from torch_fallback_cases import (N_SALES, check_text, port_plan,
                                  reference_fallback)


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


RUNS = [(q, p) for q in fb.QUERIES for p in (1, 4)]


@pytest.mark.parametrize("q,parts", RUNS, ids=[f"{q}-p{p}" for q, p in RUNS])
def test_text_matches_reference_cpu_rows_and_oracle(paths, tables, q,
                                                    parts):
    conf = dict(fb.CONF[q], **{"spark.sql.shuffle.partitions": str(parts)})
    pp = check_text(fb.SQL_QUERIES[q], paths, conf, label=q)
    assert pp.fallback_nodes() == fb.FALLBACK[q]
    want = fb.oracle(q, tables)
    assert_same_rows(pp.collect().cast(want.schema), want, ordered=True,
                     label=q)


def test_variable_float_agg_places_the_aggregate_on_the_cpu(paths):
    """The operator gates' fault: ``gpu_supported_conf`` was not read,
    so q3 ran its float sum on the device under
    ``variableFloatAgg=false``."""
    conf = fb.CONF["q3_float_exact"]
    pp = port_plan(fb.SQL_QUERIES["q3_float_exact"], paths, conf)
    assert pp.fallback_nodes() == ["HashAggregateExec"]
    assert "variableFloatAgg" in pp.explain("NOT_ON_GPU")
    # the same input gives the same bits on every run
    a, b = pp.collect(), pp.collect()
    assert a.equals(b)


def _explained_nodes(text: str):
    return [line.split("!Exec! ")[1].split()[0]
            for line in text.splitlines() if "!Exec! " in line]


@pytest.mark.parametrize("q", fb.QUERIES)
def test_explain_not_on_gpu_names_the_reference_nodes(paths, q):
    sql, conf = fb.SQL_QUERIES[q], fb.CONF[q]
    _, ref_text = reference_fallback(sql, paths, conf)
    text = port_plan(sql, paths, conf).explain("NOT_ON_GPU")
    assert _explained_nodes(text) == _explained_nodes(ref_text) \
        == fb.FALLBACK[q]
    assert "will run on GPU" not in text


def _every_type_batch() -> pa.RecordBatch:
    rng = np.random.default_rng(13)
    n = 40
    mask = rng.random(n) < 0.2
    ints = rng.integers(-100, 100, n)
    strs = ["".join(rng.choice(list("abé日"), rng.integers(0, 5)))
            for _ in range(n)]
    full = pa.record_batch({
        "b": pa.array(ints % 2 == 0, mask=mask),
        "i8": pa.array(ints.astype(np.int8), mask=mask),
        "i16": pa.array(ints.astype(np.int16), mask=mask),
        "i32": pa.array(ints.astype(np.int32), mask=rng.random(n) < 0.3),
        "i64": pa.array(ints.astype(np.int64) << 40, mask=mask),
        "f32": pa.array(rng.normal(0, 9, n).astype(np.float32), mask=mask),
        "f64": pa.array(np.where(ints == 0, np.nan, rng.normal(0, 9, n)),
                        mask=mask),
        "d": pa.array([datetime.date(2000, 1, 1)
                       + datetime.timedelta(days=int(v)) for v in ints],
                      pa.date32(), mask=mask),
        "ts": pa.array(ints.astype(np.int64) * 10 ** 9,
                       pa.timestamp("us", tz="UTC"), mask=mask),
        "s": pa.array(strs, pa.string(), mask=mask),
        "bin": pa.array([x.encode() for x in strs], pa.binary(), mask=mask),
        "nul": pa.nulls(n),
    })
    # a slice: the string columns' offsets start inside their buffers
    return full.slice(5, 30)


def test_transitions_round_trip_every_type():
    rb = _every_type_batch()
    keep = pc.is_valid(rb.column("i32"))
    ctx = tbase.ExecCtx(device="cpu")
    # a device filter marks its rows with a lazy selection; the download
    # applies it
    filt = GpuFilterExec(IsNotNull(UnresolvedColumn("i32")),
                         tbase.HostBatchSourceExec([rb]))
    d2h = DeviceToHostExec(filt)
    down = pa.Table.from_batches(list(d2h.execute_cpu(ctx)))
    want = pa.Table.from_batches([rb.filter(keep)])
    assert down.equals(want)
    assert ctx.metrics[d2h.node_label()]["numOutputBatches"].value == 1
    # and up again, through a CPU island's batches
    up = HostToDeviceExec(DeviceToHostExec(filt))
    assert tbase.collect_arrow(up, ctx).equals(want)
    # the host source's own CPU path keeps every row and type
    src = tbase.HostBatchSourceExec([rb])
    assert tbase.collect_arrow_cpu(src, ctx).equals(
        pa.Table.from_batches([rb]))


def test_device_to_host_execute_raises():
    src = tbase.HostBatchSourceExec([_every_type_batch()])
    with pytest.raises(AssertionError, match="execute_cpu"):
        list(DeviceToHostExec(src).execute(tbase.ExecCtx(device="cpu")))


def test_a_failing_kernel_makes_the_query_raise(paths, monkeypatch):
    """Placement is decided at planning only: K3's wrapper raising
    inside q3's device aggregate fails the query, with no CPU rerun."""
    pp = port_plan(nds.SQL_QUERIES["q3"], paths)
    assert pp.fallback_nodes() == []
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ck, "sort_pairs", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        pp.collect()
    assert len(calls) == 1


# one expression or two from each expr/ module, built in either package
# from its namespace: (expressions, the Like class, datatypes)
EXPRESSIONS = {
    "base": lambda e, like, d: e.Alias(e.UnresolvedColumn("i"), "j"),
    "literal": lambda e, like, d: e.Literal("é"),
    "predicates": lambda e, like, d: e.Or(
        e.And(e.GreaterThan(e.UnresolvedColumn("f"), e.Literal(0.5)),
              e.Not(e.IsNull(e.UnresolvedColumn("s")))),
        e.EqualTo(e.UnresolvedColumn("i"), e.Literal(3))),
    "in": lambda e, like, d: e.In(e.UnresolvedColumn("i"), [1, 3, None]),
    "arithmetic": lambda e, like, d: e.Multiply(
        e.Add(e.UnresolvedColumn("i"), e.Literal(7)), e.Literal(3)),
    "cast": lambda e, like, d: e.Cast(e.UnresolvedColumn("i"), d.FLOAT64),
    "conditional": lambda e, like, d: e.CaseWhen(
        [(e.GreaterThan(e.UnresolvedColumn("i"), e.Literal(5)),
          e.UnresolvedColumn("s"))], e.Literal("low")),
    "strings": lambda e, like, d: like(e.UnresolvedColumn("s"), "%é_%"),
}


@pytest.mark.parametrize("module", sorted(EXPRESSIONS))
def test_eval_cpu_matches_the_reference(module):
    rng = np.random.default_rng(21)
    n = 64
    rb = pa.record_batch({
        "i": pa.array(rng.integers(0, 10, n).astype(np.int32),
                      mask=rng.random(n) < 0.2),
        "f": pa.array(np.where(rng.random(n) < 0.1, np.nan,
                               rng.random(n)), mask=rng.random(n) < 0.2),
        "s": pa.array([rng.choice(["aé", "éb", "é", "abc", ""])
                       for _ in range(n)], mask=rng.random(n) < 0.2)})
    port = texpr.bind_expr(EXPRESSIONS[module](texpr, Like, tdt),
                           t_engine_schema(rb.schema))
    ref = jexpr.bind_expr(EXPRESSIONS[module](jexpr, JLike, jdt),
                          j_engine_schema(rb.schema))
    got = port.eval_cpu(rb, EvalCtx())
    want = ref.eval_cpu(rb, JEvalCtx())
    if isinstance(want, pa.ChunkedArray):
        want = want.combine_chunks()
    assert got.type == want.type, (got.type, want.type)
    assert got.to_pylist() == want.to_pylist()

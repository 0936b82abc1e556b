"""Shared parts of the outer, cross and nested-loop join tests
(``tests/test_torch_outer_cross_join.py``,
``tests/test_torch_nested_loop_join.py``): one plan built in both
packages over the same Arrow batches and the rows compared, and the
check a SQL text of ``spark_rapids_tpu_torch/tools/nds_joins.py`` makes
through the dual-run assert and against its oracle.

Tolerance: ``torch_dual_run.assert_same_rows`` (ints, strings and nulls
exact, floats rel ``FLOAT_RTOL``). Against the reference's device path
the row order is exact: both packages emit each stream batch's rows in
the build's order, then a right or full outer join's unmatched build
rows in build order. The reference's CPU oracle (``execute_cpu``, a
row-at-a-time Python join) orders rows its own way and costs no
compiles; it holds the cheaper cases, as multisets."""
from typing import Callable

import pyarrow as pa

import spark_rapids_tpu.exec.base as jbase
from spark_rapids_tpu.columnar.arrow_bridge import \
    engine_schema as j_engine_schema
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu_torch.columnar.arrow_bridge import \
    engine_schema as t_engine_schema
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.tools import nds_joins
from torch_dual_run import assert_same_rows, dual_run

N_SALES = 1 << 14


def sources(side):
    """``(port source, reference source)`` over the same Arrow batches,
    or empty sources of a ``pa.Schema``."""
    if isinstance(side, pa.Schema):
        return (tbase.HostBatchSourceExec([], t_engine_schema(side)),
                jbase.HostBatchSourceExec([], schema=j_engine_schema(side)))
    return tbase.HostBatchSourceExec(side), jbase.HostBatchSourceExec(side)


def run_both(build: Callable, left, right, conf=None, label="",
             oracle="device"):
    """``build(side, left source, right source, col)`` makes the plan in
    one package (``side`` is "port" or "ref", ``col`` its column
    reference); both plans run over ``left`` and ``right`` (lists of
    Arrow batches, or a schema for an empty side) and the port's rows
    are held to the reference's: its device path (``oracle="device"``,
    the row order exact) or its CPU oracle (``"cpu"``, the reference's
    ``execute_cpu``, which orders rows its own way: compared as
    multisets). Returns ``(port table, port ctx, port plan)``."""
    (lp, lr), (rp, rr) = sources(left), sources(right)
    port = build("port", lp, rp, tcol)
    ref = build("ref", lr, rr, jcol)
    ctx = tbase.ExecCtx(RapidsConf(conf or {}), device="cpu")
    got = tbase.collect_arrow(port, ctx)
    jctx = jbase.ExecCtx(JConf(conf or {}))
    if oracle == "device":
        want = jbase.collect_arrow(ref, jctx)
    else:
        want = jbase.collect_arrow_cpu(ref, jctx)
    assert_same_rows(got, want, ordered=oracle == "device", label=label)
    return got, ctx, port


def check_sql(paths, tables, q: str, parts: int) -> None:
    """``q`` of ``nds_joins`` at ``parts`` partitions through the
    dual-run assert, and held to its oracle."""
    got, _ = dual_run(nds_joins.SQL_QUERIES[q], paths,
                      {"spark.sql.shuffle.partitions": str(parts)})
    assert got.num_rows > 0
    assert_same_rows(got, nds_joins.oracle(q, tables), ordered=True,
                     label=q)

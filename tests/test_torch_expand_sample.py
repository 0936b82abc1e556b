"""``GpuExpandExec`` and ``GpuSampleExec`` on the CPU against the JAX
package's ``TpuExpandExec`` and ``TpuSampleExec``: the same plans over
the same seeded Arrow batches (``tests/data_gen.gen_table``), collected
through each package's device path and the port's CPU path, the rows
compared exactly (as multisets where the operator's order is not
Spark's contract). The counterparts of the reference's
``tests/test_exec.py:126-183``, plus Expand fused under a partial
aggregate and run on its own, a sample over a lazy filter (positions
over live rows only) and across batches, and the sample's rows held to
its numpy oracle (``_keep_mask_np``)."""
import numpy as np
import pyarrow as pa
import pytest

from data_gen import IntegerGen, LongGen, StringGen, gen_table

import spark_rapids_tpu.datatypes as jdt
import spark_rapids_tpu_torch.datatypes as tdt
from spark_rapids_tpu.exec import HostBatchSourceExec as JSource
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec as TSource
from spark_rapids_tpu_torch.exec.base import collect_arrow as tcollect
from spark_rapids_tpu_torch.exec.base import collect_arrow_cpu
from torch_dual_run import assert_same_rows


def _sources(tables):
    """The same batches as each package's host source."""
    from spark_rapids_tpu.columnar.arrow_bridge import engine_schema as jes
    from spark_rapids_tpu_torch.columnar.arrow_bridge import \
        engine_schema as tes
    rbs = list(tables)  # gen_table gives RecordBatches
    return (TSource(rbs, schema=tes(tables[0].schema)),
            JSource(rbs, schema=jes(tables[0].schema)))


def _run_both(build_port, build_ref, tables, ordered=True):
    """The port's rows on its device path and its CPU path, each held to
    the reference's."""
    tsrc, jsrc = _sources(tables)
    want = jcollect(build_ref(jsrc), JCtx())
    got = tcollect(build_port(tsrc), TCtx(device="cpu"))
    assert_same_rows(got, want, ordered, rtol=0)
    cpu = collect_arrow_cpu(build_port(tsrc), TCtx(device="cpu"))
    assert_same_rows(cpu, want, ordered, rtol=0)
    return got


def _projections(E, dt, col, Lit):
    return [[col("c0"), col("c1"), col("c2"), Lit(0, dt.INT32)],
            [col("c0"), Lit(None, dt.INT32), col("c2"), Lit(1, dt.INT32)],
            [Lit(None, dt.INT32), Lit(None, dt.INT32), col("c2"),
             Lit(3, dt.INT32)]]


def _expand(pkg):
    """(Expand class, expr module, datatypes, col, Literal) of a
    package."""
    if pkg == "port":
        from spark_rapids_tpu_torch import expr
        from spark_rapids_tpu_torch.exec.misc import GpuExpandExec as X
        return X, expr, tdt
    from spark_rapids_tpu import expr
    from spark_rapids_tpu.exec import TpuExpandExec as X
    return X, expr, jdt


def _expand_plan(pkg, src):
    X, E, dt = _expand(pkg)
    return X(_projections(E, dt, E.UnresolvedColumn, E.Literal),
             ["c0", "c1", "c2", "gid"], src)


def test_expand_grouping_sets_shape():
    tables = [gen_table([IntegerGen(min_val=0, max_val=5),
                         IntegerGen(min_val=0, max_val=3), LongGen()],
                        150, seed=4)]
    got = _run_both(lambda s: _expand_plan("port", s),
                    lambda s: _expand_plan("ref", s), tables)
    assert got.num_rows == 450


def _rollup(pkg, src):
    X, E, dt = _expand(pkg)
    if pkg == "port":
        from spark_rapids_tpu_torch.exec.aggregate import \
            GpuHashAggregateExec as Agg
        from spark_rapids_tpu_torch.expr.aggregates import Sum
    else:
        from spark_rapids_tpu.exec.aggregate import \
            TpuHashAggregateExec as Agg
        from spark_rapids_tpu.expr.aggregates import Sum
    col, Lit = E.UnresolvedColumn, E.Literal
    exp = X([[col("c0"), col("c1"), Lit(0, dt.INT32)],
             [Lit(None, dt.INT32), col("c1"), Lit(1, dt.INT32)]],
            ["c0", "c1", "gid"], src)
    return Agg([col("c0"), col("gid")], [E.Alias(Sum(col("c1")), "s")],
               exp)


@pytest.mark.parametrize("fusion", ["true", "false"])
def test_expand_feeds_rollup_aggregate(fusion):
    """Expand under the aggregate: in its fused stage (``_run_all``, one
    batch an input batch) and on its own (a batch a projection)."""
    tables = [gen_table([IntegerGen(min_val=0, max_val=4), LongGen()], 200,
                        seed=6) for _ in range(2)]
    tsrc, jsrc = _sources(tables)
    from spark_rapids_tpu_torch.config import RapidsConf
    conf = RapidsConf({"spark.rapids.sql.stageFusion.enabled": fusion})
    ctx = TCtx(conf, device="cpu")
    plan = _rollup("port", tsrc)
    got = tcollect(plan, ctx)
    want = jcollect(_rollup("ref", jsrc), JCtx())
    assert_same_rows(got, want, ordered=False, rtol=0)
    expand = plan.child
    fused = "fusedInto" in ctx.metrics.get(expand.node_label(), {})
    assert fused == (fusion == "true")


def _sample(pkg, fraction, seed, src):
    if pkg == "port":
        from spark_rapids_tpu_torch.exec.misc import GpuSampleExec as S
    else:
        from spark_rapids_tpu.exec import TpuSampleExec as S
    return S(fraction, seed=seed, child=src)


@pytest.mark.parametrize("fraction", [0.0, 0.3, 1.0])
def test_sample(fraction):
    tables = [gen_table([IntegerGen(), StringGen()], 150, seed=s)
              for s in (1, 2)]
    got = _run_both(lambda s: _sample("port", fraction, 42, s),
                    lambda s: _sample("ref", fraction, 42, s), tables)
    if fraction == 0.0:
        assert got.num_rows == 0
    if fraction == 1.0:
        assert got.num_rows == 300
    keep = _sample("port", fraction, 42, None)._keep_mask_np(0, 300)
    src = pa.Table.from_batches(tables)
    assert got.equals(src.filter(pa.array(keep)).cast(got.schema))


def test_sample_deterministic():
    tables = [gen_table([IntegerGen()], 200, seed=9)]
    tsrc, _ = _sources(tables)
    a = tcollect(_sample("port", 0.5, 7, tsrc), TCtx(device="cpu"))
    b = tcollect(_sample("port", 0.5, 7, tsrc), TCtx(device="cpu"))
    assert a.to_pylist() == b.to_pylist()


def test_sample_over_a_lazy_filter():
    """Positions run over the live rows only: a sample over a filter's
    selection keeps the reference's rows (which compacts first), across
    three batches."""
    tables = [gen_table([IntegerGen(min_val=-50, max_val=50), LongGen()],
                        n, seed=s) for n, s in ((90, 3), (40, 4), (130, 5))]

    def build(pkg, src):
        if pkg == "port":
            from spark_rapids_tpu_torch import expr as E
            from spark_rapids_tpu_torch.exec.basic import GpuFilterExec as F
        else:
            from spark_rapids_tpu import expr as E
            from spark_rapids_tpu.exec import TpuFilterExec as F
        dt = tdt if pkg == "port" else jdt
        f = F(E.GreaterThan(E.UnresolvedColumn("c0"),
                            E.Literal(0, dt.INT32)), src)
        return _sample(pkg, 0.5, 11, f)
    got = _run_both(lambda s: build("port", s), lambda s: build("ref", s),
                    tables)
    assert 0 < got.num_rows


def test_sample_rejects_a_fraction_outside_0_1():
    with pytest.raises(ValueError):
        _sample("port", 1.5, 1, None)


def test_keep_mask_oracle_matches_the_references():
    from spark_rapids_tpu.exec import TpuSampleExec
    for fraction, seed in ((0.1, 7), (0.5, -3), (0.9, 1 << 40)):
        port = _sample("port", fraction, seed, None)
        ref = TpuSampleExec(fraction, seed, None)
        for start in (0, 12345, (1 << 33) + 5):
            assert (port._keep_mask_np(start, 500)
                    == ref._keep_mask_np(start, 500)).all()
    assert np.asarray(port._keep_mask_np(0, 10)).dtype == bool

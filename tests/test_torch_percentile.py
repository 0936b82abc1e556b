"""APPROX_PERCENTILE on the CPU: the port's ``GpuHashAggregateExec`` with
``ApproxPercentile`` held to the JAX package's ``TpuHashAggregateExec``
on the same batches, made from a seed (``tests/data_gen.py``), in both
strategies: the exact rank over the single pass (the default) and the
mergeable sketch (``spark.rapids.sql.approxPercentile.exact=false``).

The cases are ``tests/test_aggregate.py:349-470``'s for a scalar
percentage: int, long, float and double values at p = 0, 0.5 and 1,
grouped and global, an all-null group and an all-null input, strings
refused, the sketch over several batches (grouped and global), a large
n where a float32 ``p * n`` picks another row than Spark's float64
rank, and ``rank0`` at its edges. A list of percentages returns an
array of the value's type, held to the reference in both strategies.
Every value is compared exactly (a percentile is one of the data's own
values, ``-0.0`` keeping its sign), and the row order too (both
packages emit groups in key order)."""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.exec.base as jbase
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu.expr import Alias as JAlias
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.expr.aggregates import \
    ApproxPercentile as JApproxPercentile
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.expr import Alias as TAlias
from spark_rapids_tpu_torch.expr import Sum as TSum
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.expr.aggregates import (ApproxPercentile,
                                                    spark_rank0)

from data_gen import (DoubleGen, FloatGen, IntegerGen, LongGen, StringGen,
                      gen_table)
from spark_rapids_tpu import datatypes as jdt

SKETCH = {"spark.rapids.sql.approxPercentile.exact": "false"}
# the sketch's narrowest width, K = 16 (sqrt(256)): the same merge at a
# quarter of the default's points
SKETCH_ACCURACY = 256
GENS = {"int": IntegerGen(null_frac=0.2), "long": LongGen(),
        "double": DoubleGen(null_frac=0.1), "float": FloatGen(jdt.FLOAT32)}


def _exact(got: pa.Table, want: pa.Table):
    assert got.column_names == want.column_names
    assert got.schema.types == want.schema.types
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        for a, b in zip(got.column(name).to_pylist(),
                        want.column(name).to_pylist()):
            if isinstance(a, float) and isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) or (
                    a == b and math.copysign(1, a) == math.copysign(1, b)), \
                    (name, a, b)
            else:
                assert a == b and type(a) is type(b), (name, a, b)


def run_both(rbs, pct, keys=True, conf=None, extra_sum=False,
             accuracy=10000):
    """The port's and the reference's percentile of ``v`` (by ``k``)."""
    def plan(Agg, Alias, col, Pct, Src, extra):
        aggs = [Alias(Pct(col("v"), pct, accuracy), "p")] + extra
        return Agg([col("k")] if keys else [], aggs, Src(rbs))
    port = plan(GpuHashAggregateExec, TAlias, tcol, ApproxPercentile,
                tbase.HostBatchSourceExec,
                [TAlias(TSum(tcol("k")), "s")] if extra_sum else [])
    from spark_rapids_tpu.expr.aggregates import Sum as JSum
    ref = plan(TpuHashAggregateExec, JAlias, jcol, JApproxPercentile,
               jbase.HostBatchSourceExec,
               [JAlias(JSum(jcol("k")), "s")] if extra_sum else [])
    got = tbase.collect_arrow(port, tbase.ExecCtx(RapidsConf(conf or {}),
                                                  device="cpu"))
    want = jbase.collect_arrow(ref, jbase.ExecCtx(JConf(conf or {})))
    return got, want


def _batches(gen, n=300, seed=17, parts=1, groups=6):
    rb = gen_table([IntegerGen(min_val=0, max_val=groups, nullable=False),
                    gen], n, seed=seed, names=["k", "v"])
    step = -(-n // parts)
    return [rb.slice(i, step) for i in range(0, n, step)]


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("gen", sorted(GENS))
def test_grouped_percentile_matches_reference(gen, p):
    got, want = run_both(_batches(GENS[gen]), p)
    _exact(got, want)
    assert got.num_rows == 7


@pytest.mark.parametrize("gen", sorted(GENS))
def test_global_percentile_matches_reference(gen):
    got, want = run_both(_batches(GENS[gen], parts=3), 0.25, keys=False)
    _exact(got, want)


def test_percentile_beside_another_aggregate():
    got, want = run_both(_batches(GENS["double"], parts=2), 0.9,
                         extra_sum=True)
    _exact(got, want)


def test_all_null_group_and_all_null_input():
    k = pa.array([0, 0, 1, 1, 2, 2], pa.int32())
    v = pa.array([1.5, -0.0, None, None, 0.0, float("nan")])
    rbs = [pa.record_batch({"k": k, "v": v})]
    got, want = run_both(rbs, 0.5)
    _exact(got, want)
    assert got.column("p").to_pylist()[1] is None
    nulls = [pa.record_batch({"k": pa.array([0] * 8, pa.int32()),
                              "v": pa.array([None] * 8, pa.float64())})]
    for keys in (True, False):
        got, want = run_both(nulls, 0.5, keys=keys)
        _exact(got, want)
        assert got.column("p").to_pylist() == [None]


def test_empty_input_global_is_null():
    empty = [pa.record_batch({"k": pa.array([], pa.int32()),
                              "v": pa.array([], pa.float64())})]
    got, want = run_both(empty, 0.5, keys=False)
    _exact(got, want)
    assert got.column("p").to_pylist() == [None]


def test_strings_and_lists_refused():
    src = tbase.HostBatchSourceExec([gen_table([StringGen()], 10, 1,
                                               names=["s"])])
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        GpuHashAggregateExec([], [TAlias(ApproxPercentile(tcol("s"), 0.5),
                                         "p")], src)
    # a list of percentages is no longer refused: an array a group, in
    # both strategies
    for exact in ("true", "false"):
        for keys in (True, False):
            got, want = run_both(_batches(GENS["double"]), [0.25, 0.5, 1.0],
                                 keys=keys, conf={
                                     "spark.rapids.sql.approxPercentile"
                                     ".exact": exact})
            assert got.schema.types == want.schema.types
            flat = [pa.table({"p": t.column("p").combine_chunks()
                              .flatten()}) for t in (got, want)]
            _exact(*flat)
            assert got.column("p").combine_chunks().value_lengths() \
                .equals(want.column("p").combine_chunks().value_lengths())


@pytest.mark.parametrize("keys", [True, False], ids=["grouped", "global"])
def test_sketch_over_several_batches_matches_reference(keys):
    """The sketch's partials and merge: K points a group, each a data
    value; bit for bit the reference's, and within its rank bound."""
    rng = np.random.default_rng(11)
    rbs = []
    for _ in range(4):
        k = rng.integers(0, 3, 300).astype(np.int32)
        v = (rng.lognormal(0, 2, 300) * 100).astype(np.int64)
        rbs.append(pa.record_batch({"k": pa.array(k), "v": pa.array(v)}))
    got, want = run_both(rbs, 0.9, keys=keys, conf=SKETCH,
                         accuracy=SKETCH_ACCURACY)
    _exact(got, want)
    everything = np.concatenate([rb.column("v").to_numpy() for rb in rbs])
    assert set(got.column("p").to_pylist()) <= set(everything.tolist())


def test_sketch_with_an_all_null_group():
    """A group whose values are all null between two that have values.
    The reference's merge sums each group's mass over the sorted points
    with a search that assumes sorted group ids, but the null group's
    dropped points sort last, so its groups after it shift (it gives
    group 1 group 2's median and group 2 null; ROADMAP section C). The
    port sums the mass by group id: it is held to the reference's run
    over the same rows without the null group, and group 1 is null."""
    k = np.repeat(np.arange(3, dtype=np.int32), 40)
    v = np.arange(120, dtype=np.float64)
    mask = k == 1

    def batches(keep):
        return [pa.record_batch({
            "k": pa.array(k[i::2][keep[i::2]]),
            "v": pa.array(v[i::2][keep[i::2]],
                          mask=mask[i::2][keep[i::2]])}) for i in range(2)]
    got, want = run_both(batches(np.ones(120, bool)), 0.5, conf=SKETCH,
                         accuracy=SKETCH_ACCURACY)
    assert want.column("p").to_pylist()[2] is None  # the reference's fault
    _, without = run_both(batches(~mask), 0.5, conf=SKETCH,
                          accuracy=SKETCH_ACCURACY)
    p = got.column("p").to_pylist()
    assert p[1] is None
    assert [p[0], p[2]] == without.column("p").to_pylist()


def test_large_n_takes_sparks_float64_rank():
    """Spark's rank is ceil(p * n) in float64; at this n and p a float32
    product picks the row before."""
    n, p = 100_000, 0.55
    f32 = math.ceil(float(np.float32(p) * np.float32(n)))
    assert f32 != math.ceil(p * n)
    rng = np.random.default_rng(5)
    v = rng.permutation(n).astype(np.int64)
    rbs = [pa.record_batch({"k": pa.array(np.zeros(n, np.int32)),
                            "v": pa.array(v)})]
    got, want = run_both(rbs, p, keys=False)
    _exact(got, want)
    assert got.column("p").to_pylist() == [ApproxPercentile.rank0(p, n)]


def test_rank0_at_the_edges():
    ps = [0.0, 1e-12, 0.001, 0.1, 0.25, 0.5, 0.7, 0.999, 1.0 - 1e-12, 1.0]
    ns = [1, 2, 3, 7, 10, 100, 1001, (1 << 31) - 1, 10**12 + 7]
    for p in ps:
        got = spark_rank0(p, torch.tensor(ns, dtype=torch.int64)).tolist()
        want = [ApproxPercentile.rank0(p, n) for n in ns]
        assert got == want, p
        assert want == [JApproxPercentile.rank0(p, n) for n in ns]
    assert ApproxPercentile.rank0(0.5, 1) == 0
    assert ApproxPercentile.rank0(1.0, 10) == 9
    assert ApproxPercentile.rank0(0.0, 10) == 0
    agg = ApproxPercentile(tcol("v"), 0.5)
    assert agg.cpu_agg([3.0, None, -0.0, float("nan"), 1.0]) == 1.0
    assert agg.cpu_agg([None]) is None

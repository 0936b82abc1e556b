"""The join + group-by slice end to end on the CPU: the port's plan
(``join_groupby.py``) against the same plan in the JAX package
(``bench.py:142-235``'s shape), both on the CPU over the same numpy
inputs. Months must be bit-exact and revenues agree to rel 1e-12 (both
sum float32 products in float64, in other orders). The other fast-path
join types, Spark's key equality (null, NaN, ``-0.0``), the
build_unique hint's check and the launch counts the plan implies are
checked here too."""
import math

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.datatypes as jdt
from spark_rapids_tpu.columnar.batch import TpuBatch, bucket_rows
from spark_rapids_tpu.columnar.column import TpuColumnVector
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu.exec.base import DeviceBatchSourceExec as JSource
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu.exec.joins import TpuShuffledHashJoinExec
from spark_rapids_tpu.expr import Alias as JAlias
from spark_rapids_tpu.expr import Literal as JLit
from spark_rapids_tpu.expr import Multiply as JMul
from spark_rapids_tpu.expr import Subtract as JSub
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.expr.aggregates import Count as JCount
from spark_rapids_tpu.expr.aggregates import Sum as JSum
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch import join_groupby as jg
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import collect_arrow as tcollect
from spark_rapids_tpu_torch.exec.joins import GpuShuffledHashJoinExec
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.expr.aggregates import Count as TCount
from spark_rapids_tpu_torch.expr.aggregates import Sum as TSum
from spark_rapids_tpu_torch.ops import cuda_kernels as ck

N_LI, N_ORD, BATCH = 4096, 256, 1024


def _jax_source(cols, fields, batch_rows, validity=None):
    """The JAX package's DeviceBatchSourceExec over the same columns
    (``bench.py:186``'s ``dev_source``)."""
    schema = jdt.Schema([jdt.StructField(n, getattr(jdt, t), nl)
                         for n, t, nl in fields])
    validity = validity or {}
    n = len(cols[fields[0][0]])
    batches = []
    for off in range(0, n, batch_rows):
        m = min(batch_rows, n - off)
        cap = bucket_rows(m)
        cs = [TpuColumnVector.from_numpy(
            f.dtype, cols[f.name][off:off + m],
            None if f.name not in validity else
            validity[f.name][off:off + m], cap) for f in schema.fields]
        batches.append(TpuBatch(cs, schema, m))
    return JSource(batches, schema)


def _torch_source(cols, fields, batch_rows, validity=None):
    schema = tdt.Schema([tdt.StructField(n, getattr(tdt, t), nl)
                         for n, t, nl in fields])
    return jg.device_source(cols, schema, batch_rows, "cpu", validity)


LI_FIELDS = [("l_orderkey", "INT32", False),
             ("l_extendedprice", "FLOAT32", False),
             ("l_discount", "FLOAT32", False)]
ORD_FIELDS = [("o_orderkey", "INT32", False), ("o_month", "INT32", False)]


def _jax_plan(li, orders):
    join = TpuShuffledHashJoinExec(
        [jcol("l_orderkey")], [jcol("o_orderkey")], "inner",
        _jax_source(li, LI_FIELDS, BATCH),
        _jax_source(orders, ORD_FIELDS, BATCH), build_unique_hint=True)
    rev = JMul(jcol("l_extendedprice"),
               JSub(JLit(np.float32(1.0), jdt.FLOAT32),
                    jcol("l_discount")))
    return TpuHashAggregateExec([jcol("o_month")],
                                [JAlias(JSum(rev), "revenue")], join)


def test_join_groupby_matches_reference_and_oracle():
    plan, li, orders = jg.build_plan(N_LI, N_ORD, BATCH, device="cpu")
    got = tcollect(plan, TCtx(device="cpu")).to_pydict()
    want = jcollect(_jax_plan(li, orders), JCtx()).to_pydict()
    assert got["o_month"] == want["o_month"] == list(range(1, 13))
    for g, w in zip(got["revenue"], want["revenue"]):
        assert abs(g - w) <= 1e-12 * abs(w)
    oracle = jg.host_oracle(li, orders)
    for m, g in zip(got["o_month"], got["revenue"]):
        assert abs(g - oracle[m]) <= 1e-12 * abs(oracle[m])


def test_join_groupby_calls_each_kernel_as_the_plan_implies(monkeypatch):
    """On the card each of these calls is one launch: one K3 sort for
    the build presort, one a partial, one for the final; K4 once for the
    build's sorted keys, three times a batch (probe, permutation,
    segment starts) and twice in the final."""
    calls = {"sort_pairs": [], "gather_rows": []}
    sort_pairs, gather_rows = ck.sort_pairs, ck.gather_rows

    def counted_sort(keys, payload=None):
        calls["sort_pairs"].append(keys.shape[0])
        return sort_pairs(keys, payload)

    def counted_gather(cols, valids, idx, live=None):
        calls["gather_rows"].append(idx.shape[0])
        return gather_rows(cols, valids, idx, live)

    monkeypatch.setattr(ck, "sort_pairs", counted_sort)
    monkeypatch.setattr(ck, "gather_rows", counted_gather)
    plan, _, _ = jg.build_plan(N_LI, N_ORD, BATCH, device="cpu")
    tcollect(plan, TCtx(device="cpu"))
    batches = N_LI // BATCH
    assert calls["sort_pairs"] == [N_ORD] + [BATCH] * batches \
        + [BATCH * batches]
    assert len(calls["gather_rows"]) == 1 + 3 * batches + 2


def _keyed_tables(rng, float_keys=False):
    """A stream side with a row id, nullable keys (some without a match)
    and a value; a build side with unique nullable keys."""
    n, m = 3000, 200
    if float_keys:
        pool = np.array([np.nan, -np.nan, 0.0, -0.0, 1.5, -2.5, np.inf],
                        np.float32)
        lk = rng.choice(pool, n).astype(np.float32)
        rk = np.array([np.nan, 0.0, 1.5, np.inf, 7.0], np.float32)
        m = len(rk)
        kt = "FLOAT32"
    else:
        lk = rng.integers(0, m + 40, n).astype(np.int32)
        rk = rng.permutation(m).astype(np.int32)
        kt = "INT32"
    li = {"l_id": np.arange(n, dtype=np.int64), "l_key": lk,
          "l_val": rng.uniform(0, 100, n).astype(np.float32)}
    orders = {"o_key": rk, "o_month": rng.integers(1, 13, m)
              .astype(np.int32)}
    lvalid = {"l_key": rng.random(n) < 0.9}
    rvalid = {"o_key": np.arange(m) != 1}
    lf = [("l_id", "INT64", False), ("l_key", kt, True),
          ("l_val", "FLOAT32", False)]
    rf = [("o_key", kt, True), ("o_month", "INT32", False)]
    return li, orders, lvalid, rvalid, lf, rf


def _rows(table: pa.Table):
    def norm(v):
        return "NaN" if isinstance(v, float) and math.isnan(v) else v
    return sorted(tuple(norm(v) for v in r.values())
                  for r in table.to_pylist())


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi",
                                       "left_anti"])
@pytest.mark.parametrize("float_keys", [False, True], ids=["int", "float"])
def test_join_types_match_reference(join_type, float_keys):
    rng = np.random.default_rng(3)
    li, orders, lvalid, rvalid, lf, rf = _keyed_tables(rng, float_keys)
    jplan = TpuShuffledHashJoinExec(
        [jcol("l_key")], [jcol("o_key")], join_type,
        _jax_source(li, lf, 1024, lvalid), _jax_source(orders, rf, 1024,
                                                       rvalid),
        build_unique_hint=True)
    tplan = GpuShuffledHashJoinExec(
        [tcol("l_key")], [tcol("o_key")], join_type,
        _torch_source(li, lf, 1024, lvalid),
        _torch_source(orders, rf, 1024, rvalid), build_unique_hint=True)
    want = jcollect(jplan, JCtx())
    got = tcollect(tplan, TCtx(device="cpu"))
    assert got.schema.names == want.schema.names
    assert _rows(got) == _rows(want)
    assert got.num_rows > 0


def test_inner_join_condition_matches_reference():
    from spark_rapids_tpu.expr import GreaterThan as JGt
    from spark_rapids_tpu_torch.expr import GreaterThan as TGt
    from spark_rapids_tpu_torch.expr import Literal as TLit
    rng = np.random.default_rng(6)
    li, orders, lvalid, rvalid, lf, rf = _keyed_tables(rng)
    jplan = TpuShuffledHashJoinExec(
        [jcol("l_key")], [jcol("o_key")], "inner",
        _jax_source(li, lf, 1024, lvalid),
        _jax_source(orders, rf, 1024, rvalid),
        condition=JGt(jcol("l_val"), JLit(np.float32(50.0), jdt.FLOAT32)),
        build_unique_hint=True)
    tplan = GpuShuffledHashJoinExec(
        [tcol("l_key")], [tcol("o_key")], "inner",
        _torch_source(li, lf, 1024, lvalid),
        _torch_source(orders, rf, 1024, rvalid),
        condition=TGt(tcol("l_val"), TLit(np.float32(50.0), tdt.FLOAT32)),
        build_unique_hint=True)
    want = jcollect(jplan, JCtx())
    got = tcollect(tplan, TCtx(device="cpu"))
    assert 0 < got.num_rows and _rows(got) == _rows(want)


def test_group_keys_follow_spark_equality():
    """NaN == NaN, -0.0 == 0.0 and null == null as group keys."""
    rng = np.random.default_rng(4)
    n = 2500
    k = rng.choice(np.array([np.nan, -np.nan, 0.0, -0.0, 3.25, -1.0],
                            np.float32), n)
    cols = {"k": k, "v": rng.uniform(-5, 5, n)}
    valid = {"k": rng.random(n) < 0.85, "v": rng.random(n) < 0.9}
    fields = [("k", "FLOAT32", True), ("v", "FLOAT64", True)]
    jplan = TpuHashAggregateExec(
        [jcol("k")], [JAlias(JSum(jcol("v")), "s"),
                      JAlias(JCount(jcol("v")), "c")],
        _jax_source(cols, fields, 1024, valid))
    tplan = GpuHashAggregateExec(
        [tcol("k")], [TSum(tcol("v")), TCount(tcol("v"))],
        _torch_source(cols, fields, 1024, valid))
    want = jcollect(jplan, JCtx())
    got = tcollect(tplan, TCtx(device="cpu"))
    assert got.num_rows == want.num_rows == 5  # null, -1, 0, 3.25, NaN
    wk = want.column(0).to_pylist()
    gk = got.column(0).to_pylist()
    assert [str(v) for v in gk] == [str(v) for v in wk]
    assert got.column(2).to_pylist() == want.column(2).to_pylist()
    for g, w in zip(got.column(1).to_pylist(), want.column(1).to_pylist()):
        assert abs(g - w) <= 1e-12 * max(1.0, abs(w))


def _dup_build(hint):
    rng = np.random.default_rng(5)
    li = {"l_orderkey": rng.integers(0, 64, 500).astype(np.int32),
          "l_extendedprice": rng.uniform(1, 2, 500).astype(np.float32),
          "l_discount": np.zeros(500, np.float32)}
    keys = np.arange(64, dtype=np.int32)
    keys[10] = 11  # key 11 twice
    orders = {"o_orderkey": keys, "o_month": np.ones(64, np.int32)}
    return jg.plan_over(jg.device_source(li, jg.LINEITEM_SCHEMA, 256, "cpu"),
                        jg.device_source(orders, jg.ORDERS_SCHEMA, 256,
                                         "cpu"),
                        build_unique_hint=hint)


def test_duplicated_build_key_with_hint_raises_at_collect():
    ctx = TCtx(device="cpu")
    with pytest.raises(RuntimeError, match="build_unique hint violated"):
        tcollect(_dup_build(hint=True), ctx)
    assert ctx.deferred_checks == []


def test_duplicated_build_key_without_hint_is_not_implemented():
    """Without the hint a duplicated build key (order 11 twice, order 10
    missing) takes the staged join: each line item meets every order of
    its key, held to numpy at rel 1e-12 (the fast path raised, naming
    ROADMAP item 9, until the staged join was ported)."""
    plan = _dup_build(hint=False)
    got = tcollect(plan, TCtx(device="cpu")).to_pydict()
    rng = np.random.default_rng(5)
    key = rng.integers(0, 64, 500).astype(np.int32)
    price = rng.uniform(1, 2, 500).astype(np.float32)
    keys = np.arange(64, dtype=np.int32)
    keys[10] = 11
    times = np.bincount(keys, minlength=64)[key]
    want = float((price.astype(np.float64) * times).sum())
    assert got["o_month"] == [1]
    assert abs(got["revenue"][0] - want) <= 1e-12 * want


def test_unported_joins_raise():
    """Right outer, full outer and cross raised naming ROADMAP item 9
    until they were ported: each now gives the reference's rows (4 x 4
    rows of one key; both sides' column is named ``a``, so the columns
    are compared by position)."""
    cols = {"a": np.zeros(4, np.int32)}
    li = _torch_source(cols, [("a", "INT32", False)], 128)
    ref = _jax_source(cols, [("a", "INT32", False)], 128)
    for jt in ("right_outer", "full_outer", "cross"):
        got = tcollect(GpuShuffledHashJoinExec([tcol("a")], [tcol("a")],
                                               jt, li, li),
                       TCtx(device="cpu"))
        want = jcollect(TpuShuffledHashJoinExec([jcol("a")], [jcol("a")],
                                                jt, ref, ref), JCtx())
        assert got.schema.types == want.schema.types, jt
        assert [c.to_pylist() for c in got.columns] \
            == [c.to_pylist() for c in want.columns], jt
        assert got.num_rows == 16
    # several keys run since the staged join: 4 x 4 rows of one key
    two = GpuShuffledHashJoinExec([tcol("a"), tcol("a")],
                                  [tcol("a"), tcol("a")], "inner", li, li)
    assert tcollect(two, TCtx(device="cpu")).num_rows == 16

"""Sort and limit, the port against the JAX package on the CPU.

``GpuSortExec`` (global and per batch), ``GpuLocalLimitExec`` and
``GpuGlobalLimitExec`` against ``TpuSortExec``, ``TpuLocalLimitExec`` and
``TpuGlobalLimitExec`` over the same Arrow batches: mixed directions,
nulls first and last, NaN, ``-0.0`` and ties, a string payload, lazy
selections, several batches. Rows must be equal, in order, bit for bit
(floats compared by their bits, so ``-0.0`` keeps its sign)."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import HostBatchSourceExec as JSource
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu.exec.basic import TpuFilterExec
from spark_rapids_tpu.exec.sort import SortOrder as JOrder
from spark_rapids_tpu.exec.sort import (TpuGlobalLimitExec,
                                        TpuLocalLimitExec, TpuSortExec)
from spark_rapids_tpu.expr import Literal as JLit
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.expr.predicates import GreaterThan as JGt
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.exec.base import ExecCtx, HostBatchSourceExec
from spark_rapids_tpu_torch.exec.base import collect_arrow
from spark_rapids_tpu_torch.exec.basic import GpuFilterExec
from spark_rapids_tpu_torch.exec.sort import (GpuGlobalLimitExec,
                                              GpuLocalLimitExec, GpuSortExec,
                                              SortOrder)
from spark_rapids_tpu_torch.expr import GreaterThan, Literal
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol


def _batches(seed, n=700, per=250):
    rng = np.random.default_rng(seed)
    f = rng.integers(-3, 4, n).astype(np.float64) / 2
    f[rng.uniform(0, 1, n) < 0.1] = np.nan
    f[rng.uniform(0, 1, n) < 0.1] = -0.0
    words = ["", "b", "ab", "Electronics", "héllo"]
    t = pa.table({
        "k": pa.array(rng.integers(0, 5, n).astype(np.int32),
                      mask=rng.uniform(0, 1, n) < 0.1),
        "f": pa.array(f, mask=rng.uniform(0, 1, n) < 0.1),
        "g": pa.array(rng.integers(-2, 2, n).astype(np.int64)),
        "f32": pa.array(rng.normal(0, 1, n).astype(np.float32)),
        "s": pa.array([words[i] for i in rng.integers(0, 5, n)],
                      mask=rng.uniform(0, 1, n) < 0.1),
        "row": pa.array(np.arange(n, dtype=np.int64)),
    })
    return t.combine_chunks().to_batches(max_chunksize=per)


def _bits(table):
    out = []
    for name in table.column_names:
        col = table.column(name)
        if pa.types.is_floating(col.type):
            v = col.to_numpy(zero_copy_only=False)
            valid = np.asarray(col.is_valid())
            out.append([(bool(ok), x.tobytes() if ok else None)
                        for ok, x in zip(valid, v)])
        else:
            out.append(col.to_pylist())
    return out


ORDERS = {
    "asc": [("k", True, None)],
    "desc_nulls_last": [("f", False, None), ("row", True, None)],
    "mixed": [("k", False, True), ("f", True, False), ("g", False, None)],
    "float_ties": [("f", True, True)],
    "f32_desc": [("f32", False, None)],
}


def _plans(batches, order, filtered, global_sort=True):
    js, ts = JSource(batches), HostBatchSourceExec(batches)
    if filtered:
        js = TpuFilterExec(JGt(jcol("g"), JLit(-2, jdt.INT64)), js)
        ts = GpuFilterExec(GreaterThan(tcol("g"), Literal(-2, tdt.INT64)),
                           ts)
    jo = [JOrder(jcol(c), a, nf) for c, a, nf in order]
    to = [SortOrder(tcol(c), a, nf) for c, a, nf in order]
    return (TpuSortExec(jo, js, global_sort=global_sort),
            GpuSortExec(to, ts, global_sort=global_sort))


def _same(jplan, tplan):
    want = jcollect(jplan, JCtx())
    got = collect_arrow(tplan, ExecCtx(device="cpu"))
    assert got.num_rows == want.num_rows
    assert _bits(got) == _bits(want)
    return got


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("name", sorted(ORDERS))
def test_global_sort_matches_reference(name, filtered):
    j, t = _plans(_batches(1), ORDERS[name], filtered)
    _same(j, t)


def test_per_batch_sort_matches_reference():
    j, t = _plans(_batches(2), ORDERS["mixed"], True, global_sort=False)
    _same(j, t)


@pytest.mark.parametrize("limit", [0, 1, 10, 250, 251, 699, 700, 5000])
def test_global_limit_over_sort_matches_reference(limit):
    j, t = _plans(_batches(3), ORDERS["mixed"], True)
    got = _same(TpuGlobalLimitExec(limit, j), GpuGlobalLimitExec(limit, t))
    assert got.num_rows <= limit


@pytest.mark.parametrize("limit", [0, 3, 260, 900])
def test_local_limit_over_batches_matches_reference(limit):
    batches = _batches(4)
    js = TpuFilterExec(JGt(jcol("g"), JLit(-2, jdt.INT64)),
                       JSource(batches))
    ts = GpuFilterExec(GreaterThan(tcol("g"), Literal(-2, tdt.INT64)),
                       HostBatchSourceExec(batches))
    _same(TpuLocalLimitExec(limit, js), GpuLocalLimitExec(limit, ts))


def test_string_sort_keys_raise():
    """String sort keys order by their ranks now (ascending and
    descending, nulls first and last, under a lazy selection), as the
    reference does, and decimal keys by their int64 lanes; an array key
    places the sort on the CPU, as the reference's planner does, and
    orders its rows as the reference's CPU sort does."""
    for order in ([("s", True, None), ("row", True, None)],
                  [("s", False, True), ("k", True, False),
                   ("row", False, None)]):
        _same(*_plans(_batches(5), order, True))
    dec = pa.table({"d": pa.array([5, -2, None, 0, 5, -7],
                                  pa.decimal128(5, 1)),
                    "row": pa.array(np.arange(6, dtype=np.int64))})
    for order in ([("d", True, None), ("row", True, None)],
                  [("d", False, True), ("row", False, None)]):
        js = JSource(dec.to_batches())
        ts = HostBatchSourceExec(dec.to_batches())
        _same(TpuSortExec([JOrder(jcol(c), a, nf) for c, a, nf in order],
                          js),
              GpuSortExec([SortOrder(tcol(c), a, nf) for c, a, nf in order],
                          ts))
    from spark_rapids_tpu.planner import overrides
    from spark_rapids_tpu_torch.planner import GpuOverrides
    arr = pa.table({"a": pa.array([[1, 2], [2], None, [], [1], [1, None]],
                                  pa.list_(pa.int32())),
                    "row": pa.array(np.arange(6, dtype=np.int64))})
    jpp = overrides(TpuSortExec([JOrder(jcol("a"))],
                                JSource(arr.to_batches())))
    tpp = GpuOverrides(device="cpu").apply(GpuSortExec(
        [SortOrder(tcol("a"))], HostBatchSourceExec(arr.to_batches())))
    assert tpp.fallback_nodes() == jpp.fallback_nodes() == ["SortExec"]
    assert tpp.collect().equals(jpp.collect())

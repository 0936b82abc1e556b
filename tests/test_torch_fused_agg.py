"""K2, the grouped filter -> product -> sum, the port against the JAX
package on the CPU.

- The contract edition's plain version against ``fused_filter_agg_xla``
  and ``fused_filter_agg_pallas(interpret=True)`` at the Pallas edition's
  shape (2048 x 128 rows), rel 1e-3 (``bench.py:767``): all three sum
  float32 in different orders.
- The engine edition, dispatched by the grouped aggregate where the
  scan's statistics bound the key, against the sort path on the same
  files, rel 1e-9 (both sum float64, in different orders), with nulls in
  values and keys and with empty groups.
- The reference's fused-scan query (``tests/test_fusion.py:46``,
  ``_q6_plan``) and q6 by line number through both packages, rel 1e-9.
- The dispatch rule: a span over 8, missing statistics and a computed key
  take the sort path; statistics that lie raise at collect.
"""
import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu import expr as jexpr
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu.exec.basic import TpuFilterExec, TpuProjectExec
from spark_rapids_tpu.expr.aggregates import Sum as JSum
from spark_rapids_tpu.io import TpuFileScanExec
from spark_rapids_tpu.ops.pallas_kernels import (fused_filter_agg_pallas,
                                                 fused_filter_agg_xla)
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch import expr as texpr
from spark_rapids_tpu_torch import tpch
from spark_rapids_tpu_torch.config import RapidsConf as TConf
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import collect_arrow as tcollect
from spark_rapids_tpu_torch.exec.basic import GpuFilterExec, GpuProjectExec
from spark_rapids_tpu_torch.expr.aggregates import Sum as TSum
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.ops import cuda_kernels as ck

ENGINE_RTOL = 1e-9
CONTRACT_RTOL = 1e-3


def test_contract_edition_matches_xla_and_pallas():
    rng = np.random.default_rng(0)
    n = 2048 * 128
    key = rng.integers(-1, 10, n).astype(np.int32)  # some outside 0..7
    q = rng.integers(1, 51, n).astype(np.float32)
    p = rng.uniform(900, 105000, n).astype(np.float32)
    d = (rng.integers(0, 11, n) / 100.0).astype(np.float32)
    s = rng.integers(8000, 10600, n).astype(np.int32)
    got = ck.fused_filter_agg(*[torch.from_numpy(a)
                                for a in (key, q, p, d, s)]).numpy()
    jargs = [jnp.asarray(a) for a in (key, q, p, d, s)]
    for want in (np.asarray(fused_filter_agg_xla(*jargs)),
                 np.asarray(fused_filter_agg_pallas(*jargs,
                                                    interpret=True))):
        assert got.shape == want.shape == (ck.FUSED_AGG_GROUPS,)
        assert got.dtype == want.dtype == np.float32
        assert (want != 0).sum() >= 6
        rel = np.abs(got.astype(np.float64) - want) / np.maximum(
            1.0, np.abs(want))
        assert rel.max() <= CONTRACT_RTOL, rel


def _fusion_file(d, n=6000, row_group_size=700, seed=0, key_lo=0,
                 key_hi=5, nulls=False, **kw):
    """``tests/test_fusion.py:28``'s file: q6 columns and an int64 key
    ``k`` in ``[key_lo, key_hi)``; with ``nulls``, nulls in the values
    and keys, and no row of group 3 passes the filter."""
    rng = np.random.default_rng(seed)
    k = rng.integers(key_lo, key_hi, n).astype(np.int64)
    q = rng.integers(1, 51, n).astype(np.float32)
    masks = {}
    if nulls:
        q[k == key_lo + 3] = 30.0  # an empty group
        masks = {c: rng.random(n) < 0.05 for c in ("q", "p", "d", "k")}
    t = pa.table({
        "q": pa.array(q, mask=masks.get("q")),
        "p": pa.array(rng.uniform(900, 105000, n).astype(np.float32),
                      mask=masks.get("p")),
        "d": pa.array((rng.integers(0, 11, n) / 100.0).astype(np.float32),
                      mask=masks.get("d")),
        "s": pa.array(rng.integers(8000, 10600, n).astype(np.int32)),
        "k": pa.array(k, mask=masks.get("k")),
    })
    path = os.path.join(str(d), "fusion.parquet")
    pq.write_table(t, path, row_group_size=row_group_size,
                   compression="snappy", **kw)
    return path


def _plan(pkg, scan, key="k"):
    """``_q6_plan`` (``tests/test_fusion.py:46``) over either package;
    ``key`` "k - 1" groups by a computed key."""
    if pkg == "jax":
        e, dt, Filter, Project, Agg, Sum = (jexpr, jdt, TpuFilterExec,
                                            TpuProjectExec,
                                            TpuHashAggregateExec, JSum)
    else:
        e, dt, Filter, Project, Agg, Sum = (texpr, tdt, GpuFilterExec,
                                            GpuProjectExec,
                                            GpuHashAggregateExec, TSum)
    col = e.UnresolvedColumn
    cond = e.And(e.And(e.GreaterThanOrEqual(col("s"),
                                            e.Literal(8766, dt.INT32)),
                       e.LessThan(col("s"), e.Literal(9131, dt.INT32))),
                 e.LessThan(col("q"), e.Literal(np.float32(24.0),
                                                dt.FLOAT32)))
    k = col("k") if key == "k" else e.Subtract(col("k"),
                                               e.Literal(1, dt.INT64))
    proj = Project([e.Alias(e.Multiply(col("p"), col("d")), "rev"),
                    e.Alias(k, "k")], Filter(cond, scan))
    return Agg([col("k")], [e.Alias(Sum(col("rev")), "revenue")], proj)


def _jax(path, key="k", settings=None):
    conf = JConf(settings or {})
    got = jcollect(_plan("jax", TpuFileScanExec([path], conf=conf), key),
                   JCtx(conf))
    return dict(zip(got.column("k").to_pylist(),
                    got.column("revenue").to_pylist()))


def _port(path, key="k", bounds=True, settings=None):
    ctx = TCtx(TConf(settings or {}), device="cpu")
    scan = GpuFileScanExec([path])
    if not bounds:
        scan._bounds = {"k": None}  # as a file without statistics reads
    got = tcollect(_plan("port", scan, key), ctx)
    keys = got.column("k").to_pylist()
    assert len(set(keys)) == len(keys)
    metrics = {label.split("#")[0]: {k: m.value for k, m in ms.items()}
               for label, ms in ctx.metrics.items()}
    return dict(zip(keys, got.column("revenue").to_pylist())), metrics


def _close(got, want, rtol=ENGINE_RTOL):
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
        else:
            assert abs(g - w) <= rtol * max(1.0, abs(w)), (k, g, w)


def test_q6_plan_matches_reference(tmp_path):
    """``_q6_plan``'s query through both packages: K2 a batch, spliced
    right after each batch's decode."""
    path = _fusion_file(tmp_path)
    settings = {"spark.rapids.sql.scan.coalesceTargetBytes":
                str(16 << 10)}
    got, m = _port(path, settings=settings)
    _close(got, _jax(path, settings=settings))
    scan, agg = m["FileScanExec"], m["HashAggregateExec"]
    assert scan["fusedDispatches"] >= 2
    assert scan["fusedDispatches"] == scan["scanPrograms"] \
        == agg["kernelDispatches"]
    assert scan["fallbackChunks"] == 0


def test_engine_edition_matches_sort_path(tmp_path):
    """Nulls in values and keys and an empty group: K2's partials merge
    to the sort path's result, and both to the reference's."""
    path = _fusion_file(tmp_path, key_lo=10, key_hi=18, nulls=True)
    got, m = _port(path)
    assert m["HashAggregateExec"]["kernelDispatches"] \
        == m["FileScanExec"]["scanPrograms"] > 0
    sort, ms = _port(path, bounds=False)
    assert "kernelDispatches" not in ms["HashAggregateExec"]
    _close(got, sort)
    _close(got, _jax(path))
    assert None in got and 13 not in got  # null key kept, group 3 empty


@pytest.mark.parametrize("case", ["wide_span", "no_statistics",
                                  "computed_key"])
def test_dispatch_rule_takes_the_sort_path(tmp_path, case):
    kw, key = {}, "k"
    if case == "wide_span":
        kw = {"key_lo": 0, "key_hi": 9}  # 9 values, over FUSED_AGG_GROUPS
    elif case == "no_statistics":
        kw = {"write_statistics": False}
    else:
        key = "k - 1"
    path = _fusion_file(tmp_path, **kw)
    got, m = _port(path, key=key)
    assert "kernelDispatches" not in m["HashAggregateExec"]
    _close(got, _jax(path, key=key))


def test_statistics_that_lie_raise_at_collect(tmp_path):
    """A file whose statistics say k is in 0..4 while a row that passes
    the filter holds 9: the query raises at its download, naming the
    column, instead of dropping the row."""
    n = 4000
    rng = np.random.default_rng(5)
    k = rng.integers(0, 5, n).astype(np.int32)
    marker = np.array([4, 3, 2, 1, 0, 1, 2, 3, 4, 4, 3, 3], np.int32)
    k[:marker.size] = marker
    q = rng.integers(1, 51, n).astype(np.float32)
    d = (rng.integers(0, 11, n) / 100.0).astype(np.float32)
    s = rng.integers(8000, 10600, n).astype(np.int32)
    q[0], d[0], s[0] = 10.0, np.float32(0.06), 9000  # row 0 passes
    path = str(tmp_path / "lie.parquet")
    pq.write_table(pa.table({
        "q": q, "p": rng.uniform(900, 105000, n).astype(np.float32),
        "d": d, "s": s, "k": k}), path, compression="NONE",
        use_dictionary=False)
    raw = bytearray(open(path, "rb").read())
    at = raw.find(marker.tobytes())
    assert at > 0 and raw.find(marker.tobytes(), at + 1) < 0
    raw[at:at + 4] = np.int32(9).tobytes()
    open(path, "wb").write(bytes(raw))
    scan = GpuFileScanExec([path])
    assert scan.column_bounds("k") == (0, 4)
    with pytest.raises(RuntimeError, match="column k"):
        tcollect(_plan("port", scan), TCtx(TConf(), device="cpu"))


def _linenumber_plan(pkg, paths):
    if pkg == "port":
        return tpch.build_q6_by_linenumber(GpuFileScanExec(
            paths, schema=tpch.LINEITEM_GROUPED_SCHEMA))
    e, col = jexpr, jexpr.UnresolvedColumn

    def f32(v):
        return e.Literal(np.float32(v), jdt.FLOAT32)

    cond = e.And(
        e.And(e.GreaterThanOrEqual(col("l_shipdate"),
                                   e.Literal(8766, jdt.DATE)),
              e.LessThan(col("l_shipdate"), e.Literal(9131, jdt.DATE))),
        e.And(e.And(e.GreaterThanOrEqual(col("l_discount"), f32(0.05)),
                    e.LessThanOrEqual(col("l_discount"), f32(0.07))),
              e.LessThan(col("l_quantity"), f32(24.0))))
    proj = TpuProjectExec(
        [e.Alias(e.Multiply(col("l_extendedprice"), col("l_discount")),
                 "rev"), e.Alias(col("l_linenumber"), "l_linenumber")],
        TpuFilterExec(cond, TpuFileScanExec(paths, schema=jdt.Schema(
            [jdt.StructField(name, t, True) for name, t in (
                ("l_quantity", jdt.FLOAT32), ("l_extendedprice", jdt.FLOAT32),
                ("l_discount", jdt.FLOAT32), ("l_shipdate", jdt.DATE),
                ("l_linenumber", jdt.INT32))]))))
    return TpuHashAggregateExec([col("l_linenumber")],
                                [e.Alias(JSum(col("rev")), "revenue")], proj)


def test_q6_by_linenumber_matches_reference_and_oracle(tmp_path):
    paths = tpch.write_lineitem(
        tpch.gen_lineitem(40_000, seed=3, linenumber=True), str(tmp_path),
        n_files=2, row_group_size=1 << 13, seed=3)
    conf = {"spark.rapids.sql.batchSizeRows": str(1 << 14)}
    ctx = TCtx(TConf(conf), device="cpu")
    got = tcollect(_linenumber_plan("port", paths), ctx)
    got = dict(zip(got.column("l_linenumber").to_pylist(),
                   got.column("revenue").to_pylist()))
    assert sorted(got) == list(range(1, 8))
    _close(got, tpch.host_q6_by_linenumber(paths))
    want = jcollect(_linenumber_plan("jax", paths), JCtx(JConf(conf)))
    _close(got, dict(zip(want.column("l_linenumber").to_pylist(),
                         want.column("revenue").to_pylist())))
    m = {label.split("#")[0]: {k: v.value for k, v in ms.items()}
         for label, ms in ctx.metrics.items()}
    # 20,000 rows a file in row groups of 8,192, 8,192 and 3,616,
    # coalesced across files into batches of at most 16,384 rows: 3
    assert m["FileScanExec"]["deviceChunks"] == 2 * 3 * 5
    assert m["FileScanExec"]["fusedDispatches"] \
        == m["HashAggregateExec"]["kernelDispatches"] == 3


def test_write_lineitem_regenerates_when_the_manifest_differs(tmp_path):
    """Files are reused only for the same data: a changed generator
    output, seed or file shape writes them anew."""
    cols = tpch.gen_lineitem(5000, seed=1, linenumber=True)
    paths = tpch.write_lineitem(cols, str(tmp_path), n_files=2, seed=1)
    stamp = [os.stat(p).st_mtime_ns for p in paths]
    assert tpch.write_lineitem(cols, str(tmp_path), n_files=2,
                               seed=1) == paths
    assert [os.stat(p).st_mtime_ns for p in paths] == stamp
    other = tpch.gen_lineitem(5000, seed=2, linenumber=True)
    tpch.write_lineitem(other, str(tmp_path), n_files=2, seed=2)
    got = pq.read_table(paths).column("l_quantity").to_numpy()
    assert np.array_equal(got, other["l_quantity"])
    fewer = {k: v for k, v in other.items() if k != "l_linenumber"}
    tpch.write_lineitem(fewer, str(tmp_path), n_files=2, seed=2)
    assert pq.read_table(paths).column_names == list(fewer)


def test_wrappers_check_the_key():
    n = 64
    cols = [torch.ones(n), torch.ones(n), torch.full((n,), 0.06),
            torch.full((n,), 9000, dtype=torch.int32)]
    key = torch.zeros(n, dtype=torch.int32)
    sums, nonnull, rows, outside = ck.filter_product_group_sum(
        cols, [None] * 4, None, n, ck.Q6_SPEC, key, None, 0, 1)
    assert rows.tolist() == [n, 0] and outside.item() == 0
    assert sums[0].item() == pytest.approx(n * np.float32(0.06))
    # the range check belongs to the kernel's wrapper
    with pytest.raises(ValueError, match="groups"):
        ck._check_key(key, None, n, 9, key.device)
    with pytest.raises(ValueError, match="int32 or int64"):
        ck._check_key(key.to(torch.int16), None, n, 8, key.device)

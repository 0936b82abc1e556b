"""Decimal columns in the port against the JAX package, on the CPU: the
Arrow bridge's round trips at precisions 1-18 (and the host-only layout
past 18 digits), the Parquet scan's counters and rows on the three
physical layouts Spark and pyarrow write (FIXED_LEN_BYTE_ARRAY, INT32,
INT64), the row-group statistics in lane units, Murmur3 partition ids
and sort orders over a decimal key, and, on the card (``gpu``), K3, K4
and K5 on the decimal cases of ``ops/kernel_checks.py``.

Decimals compare exactly: Python's ``decimal.Decimal`` values, no
tolerance.
"""
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from torch_dual_run import dual_run, run_port

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.columnar import arrow_to_device as j_up
from spark_rapids_tpu.columnar import device_to_arrow as j_down
from spark_rapids_tpu.ops import sort_keys as jsk
from spark_rapids_tpu.ops.hash import hash_columns_device, hash_columns_numpy
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.shuffle.partitioner import HashPartitioning as JHash
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.columnar import arrow_to_device, device_to_arrow
from spark_rapids_tpu_torch.columnar.column import lane_shape
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec, _lane_stat
from spark_rapids_tpu_torch.ops import sort_keys as tsk
from spark_rapids_tpu_torch.ops.hash import hash_columns
from spark_rapids_tpu_torch.shuffle.partitioner import HashPartitioning

N = 1 << 10


def decimal_array(precision: int, scale: int, n: int = N, seed: int = 0,
                  null_share: float = 0.15) -> pa.Array:
    """``n`` decimals from a seed: random unscaled values within the
    precision, the extremes +-(10^p - 1), 0 and +-1, and nulls."""
    rng = np.random.default_rng(seed + precision * 41 + scale)
    lim = 10 ** precision - 1
    v = [int(x) for x in rng.integers(-min(lim, (1 << 62)),
                                      min(lim, (1 << 62)) + 1, n)]
    v[:5] = [lim, -lim, 0, 1, -1]
    mask = rng.random(n) < null_share
    mask[:5] = False
    ctx = decimal.Context(prec=60)
    return pa.array([None if m else decimal.Decimal(x).scaleb(-scale, ctx)
                     for x, m in zip(v, mask)],
                    pa.decimal128(precision, scale))


@pytest.mark.parametrize("precision", range(1, 19))
def test_round_trip_matches_reference(precision):
    for scale in sorted({0, precision // 2, precision}):
        arr = decimal_array(precision, scale)
        rb = pa.record_batch({"d": arr})
        b = arrow_to_device(rb, None, torch.device("cpu"))
        assert b.columns[0].data.dtype == torch.int64
        assert b.columns[0].data.dim() == 1
        got = device_to_arrow(b)
        assert got.equals(rb), (precision, scale)
        assert j_down(j_up(rb)).equals(got)


@pytest.mark.parametrize("precision,scale", [(19, 1), (28, 2), (38, 10)])
def test_wide_decimal_round_trips_on_the_host(precision, scale):
    """Past 18 digits the reference has no layout; the port holds two
    words a row on the host only."""
    arr = decimal_array(precision, scale)
    rb = pa.record_batch({"d": arr})
    b = arrow_to_device(rb, None, torch.device("cpu"))
    assert tuple(b.columns[0].data.shape) == (b.capacity, 2)
    assert device_to_arrow(b).equals(rb)
    with pytest.raises(NotImplementedError, match="18 digits"):
        lane_shape(tdt.DecimalType(precision, scale), 8,
                   torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="precision > 18"):
        j_up(rb)


def _write(path, table, **kw):
    pq.write_table(table, path, row_group_size=N // 2, **kw)
    return path


def _scan_table(seed=3):
    return pa.table({
        "k": pa.array(np.arange(N, dtype=np.int64)),
        "price": decimal_array(7, 2, seed=seed),
        "amount": decimal_array(12, 2, seed=seed + 1),
    })


LAYOUTS = {
    # pyarrow's default: FIXED_LEN_BYTE_ARRAY, which K5 does not decode
    "flba": (["k", "price", "amount"], {}),
    # Spark's: INT32 up to 9 digits, INT64 up to 18
    "int32": (["k", "price"], {"store_decimal_as_integer": True}),
    "int64": (["k", "amount"], {"store_decimal_as_integer": True}),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("device_decode", ["true", "false"])
def test_scan_counters_and_rows_match_reference(tmp_path, layout,
                                                device_decode):
    cols, kw = LAYOUTS[layout]
    path = _write(str(tmp_path / f"{layout}.parquet"),
                  _scan_table().select(cols), **kw)
    phys = {pq.ParquetFile(path).metadata.row_group(0).column(i)
            .physical_type for i in range(1, len(cols))}
    assert phys == {"flba": {"FIXED_LEN_BYTE_ARRAY"}, "int32": {"INT32"},
                    "int64": {"INT64"}}[layout]
    conf = {"spark.rapids.sql.format.parquet.deviceDecode.enabled":
            device_decode}
    got, want = dual_run(f"SELECT {', '.join(cols)} FROM t",
                         {"t": path}, conf)
    assert got.equals(pq.read_table(path))
    _, chunks = run_port(f"SELECT {', '.join(cols)} FROM t", {"t": path},
                         conf)
    if device_decode == "true":
        dec_chunks = 2 * (len(cols) - 1)
        fallback = dec_chunks if layout == "flba" else 0
        assert chunks == [(2 * len(cols) - fallback, fallback)]


def test_decimal_statistics_in_lane_units(tmp_path):
    t = _scan_table()
    path = _write(str(tmp_path / "stats.parquet"), t,
                  store_decimal_as_integer=True)
    scan = GpuFileScanExec([path], schema=tdt.Schema(
        [tdt.StructField(f.name, tdt.from_arrow(f.type), True)
         for f in t.schema]))
    lo, hi = scan.column_bounds("amount")
    cents = [int(v.scaleb(2)) for v in t.column("amount").to_pylist()
             if v is not None]
    assert (lo, hi) == (min(cents), max(cents))
    t7 = tdt.DecimalType(7, 2)
    assert _lane_stat(decimal.Decimal("12.3"), t7) == 1230
    assert _lane_stat(decimal.Decimal("-0.05"), t7) == -5
    assert _lane_stat(7, t7) is None
    assert _lane_stat(7, tdt.INT64) == 7


def _key_batch(seed=5):
    rng = np.random.default_rng(seed)
    rb = pa.record_batch({
        "d": decimal_array(7, 2, seed=seed),
        "e": decimal_array(18, 4, seed=seed + 1),
        "i": pa.array(rng.integers(-5, 5, N).astype(np.int32)),
    })
    return rb


@pytest.mark.parametrize("names", [["d"], ["e"], ["d", "i", "e"]],
                         ids=["d7_2", "d18_4", "mixed"])
def test_murmur3_of_decimals_matches_reference(names):
    rb = _key_batch().select(names)
    b = arrow_to_device(rb, None, torch.device("cpu"))
    got = hash_columns(b.columns)[:N].numpy()
    jtypes = [jdt.from_arrow(rb.schema.field(n).type) for n in names]
    want = hash_columns_numpy([rb.column(i) for i in range(len(names))],
                              jtypes, N)
    assert np.array_equal(got, want)
    dev = np.asarray(hash_columns_device(j_up(rb).columns))[:N]
    assert np.array_equal(got, dev)


@pytest.mark.parametrize("n", [1, 16])
def test_decimal_partition_ids_match_reference(n):
    rb = _key_batch()
    b = arrow_to_device(rb, None, torch.device("cpu"))
    tp = HashPartitioning([tcol("d"), tcol("i")], n).bind(b.schema)
    got = tp.partition_ids(b, None)[:N].numpy()
    jb = j_up(rb)
    jp = JHash([jcol("d"), jcol("i")], n).bind(jb.schema)
    assert np.array_equal(got, np.asarray(jp.partition_ids_device(
        jb, JCtx().eval_ctx))[:N])
    assert np.array_equal(got, jp.partition_ids_cpu(rb, JCtx().eval_ctx))


@pytest.mark.parametrize("ascending,nulls_first",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_decimal_sort_order_matches_reference(ascending, nulls_first):
    rb = _key_batch().select(["d", "e"])
    b = arrow_to_device(rb, None, torch.device("cpu"))
    live = b.live_mask()
    spec = tsk.SortSpec(ascending, nulls_first)
    got = tsk.sort_permutation(b.columns, [spec, spec], live)[:N]
    jb = j_up(rb)
    jspec = jsk.SortSpec(ascending, nulls_first)
    want = np.asarray(jsk.sort_permutation(jb.columns, [jspec, jspec],
                                           jb.live_mask()))[:N]
    assert np.array_equal(got.numpy(), want)


def test_wide_decimal_sort_order_on_the_host():
    """Past 18 digits (host only) a key orders by its two words: held to
    Python's ordering of the values, nulls first."""
    arr = decimal_array(30, 3, seed=9)
    rb = pa.record_batch({"w": arr})
    b = arrow_to_device(rb, None, torch.device("cpu"))
    for asc in (True, False):
        perm = tsk.sort_permutation(
            b.columns, [tsk.SortSpec(asc, True)], b.live_mask())[:N]
        vals = arr.to_pylist()
        got = [vals[i] for i in perm.tolist()]
        nulls = [v for v in vals if v is None]
        rest = sorted((v for v in vals if v is not None), reverse=not asc)
        assert got == nulls + rest


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA device: K3, K4 and K5 run only "
                           "on the card")
def test_decimal_kernel_cases_on_the_card():
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    dev = torch.device("cuda", 0)
    names = {r["case"] for r in kc.check_k3(dev)}
    assert {"decimal_key_hi_2^20", "decimal_key_lo_2^20"} <= names
    assert "decimal_gather_2^20" in {r["case"] for r in kc.check_k4(dev)}
    k5 = [r for r in kc.check_k5(dev)
          if r["case"] == "decimal_int32_int64_2^20"]
    assert k5 and k5[-1]["pyarrow_equal"]


def test_decimal_kernel_cases_take_their_plain_versions_here(tmp_path):
    """The decimal cases of phase 3 on the CPU: K5's plain version
    decodes the INT32 and INT64 decimal row groups to pyarrow's values,
    and the K3 words order as the decimal column does."""
    from spark_rapids_tpu_torch.columnar.batch import GpuBatch
    from spark_rapids_tpu_torch.ops import cuda_kernels as ck
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    from spark_rapids_tpu_torch.ops.parquet_decode import decode_batch
    (case, items), = kc.decimal_layouts(str(tmp_path)).items()
    batches = []
    for scan, lay in items:
        blob = kc._blob(lay, "cpu")
        got = decode_batch(blob, lay)
        batches.append(device_to_arrow(GpuBatch(got, lay.schema,
                                                lay.n_rows)))
    assert kc._equals_file(items[0][0], batches)
    words = kc.decimal_words("cpu", n=1 << 12, n_sales=1 << 12)
    hi, lo = words["decimal_key_hi_2^12"], words["decimal_key_lo_2^12"]
    _, p_lo = ck.sort_pairs(lo)
    _, p = ck.sort_pairs(hi[p_lo.long()])
    order = p_lo[p.long()].numpy()
    cents, valid = kc._decimal_cents(1 << 12, n_sales=1 << 12)
    want = np.lexsort((np.arange(1 << 12), np.where(valid, cents, 0),
                       valid))
    assert np.array_equal(order, want)
    assert os.path.basename(scan.paths[0]) == "decimals.parquet"

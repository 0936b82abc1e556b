"""String columns in the port, against the JAX package on the CPU.

- The Arrow round trip with nulls, empty strings and multibyte text,
  whole arrays and slices.
- ``gather_strings`` (and strings inside ``gather_columns`` and the
  bounded concat) against the reference's ``gather_strings``: the same
  offsets and bytes.
- The device-decode path of a dictionary string chunk, a PLAIN one and a
  coalesced batch of both, against the JAX ``decode_row_group_device``
  (offsets, chars and validity bit for bit) and pyarrow; the scan on
  both decode paths against pyarrow with the reference's chunk counters.
Everything here is exact."""
import os

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.columnar.column import TpuColumnVector
from spark_rapids_tpu.io import parquet_device as jpd
from spark_rapids_tpu.ops.strings import gather_strings as jgather_strings
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.columnar import arrow_to_device, device_to_arrow
from spark_rapids_tpu_torch.columnar.batch import GpuBatch, bucket_rows
from spark_rapids_tpu_torch.columnar.column import GpuColumnVector
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import ExecCtx, collect_arrow
from spark_rapids_tpu_torch.io import parquet_plan as tpp
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.ops import parquet_decode as tpd
from spark_rapids_tpu_torch.ops.concat import concat_batches_bounded
from spark_rapids_tpu_torch.ops.gather import (ensure_compacted,
                                               gather_columns)
from spark_rapids_tpu_torch.ops.strings import gather_strings

WORDS = ["", "a", "Electronics", "héllo wörld", "長い文字列", "\x00z",
         "x" * 70]


def _strings(rng, n, null_rate=0.2):
    vals = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    return [None if rng.uniform() < null_rate else v for v in vals]


@pytest.mark.parametrize("kind", ["string", "binary"])
@pytest.mark.parametrize("n", [0, 1, 5, 300])
def test_arrow_round_trip(kind, n):
    rng = np.random.default_rng(n)
    vals = _strings(rng, n)
    if kind == "binary":
        vals = [None if v is None else v.encode() for v in vals]
    arr = pa.array(vals, pa.string() if kind == "string" else pa.binary())
    rb = pa.record_batch({"s": arr, "i": pa.array(np.arange(n))})
    b = arrow_to_device(rb, None, "cpu")
    c = b.columns[0]
    assert c.data is None and c.offsets.shape == (b.capacity + 1,)
    assert bool((c.offsets[1:] >= c.offsets[:-1]).all())
    assert c.device_size_bytes() == (4 * (b.capacity + 1) + c.chars.numel()
                                     + (b.capacity if c.validity is not None
                                        else 0))
    assert device_to_arrow(b).equals(rb)
    if n > 2:
        sl = rb.slice(1, n - 2)
        assert device_to_arrow(arrow_to_device(sl, None, "cpu")).equals(sl)


def _both(vals, cap):
    """The same strings as a port column and a reference column."""
    arr = pa.array(vals, pa.string())
    offs = np.frombuffer(arr.buffers()[1], np.int32)[:len(vals) + 1]
    chars = np.frombuffer(arr.buffers()[2], np.uint8)[:offs[-1]] \
        if arr.buffers()[2] is not None else np.zeros(0, np.uint8)
    valid = np.array([v is not None for v in vals])
    char_cap = max(len(chars), 16)
    t = GpuColumnVector.from_string_parts(tdt.STRING, offs, chars, valid,
                                          cap, char_cap, "cpu")
    j = TpuColumnVector.from_string_parts(jdt.STRING, offs, chars, valid,
                                          cap, char_cap)
    return t, j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_strings_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 200
    cap = bucket_rows(n)
    t, j = _both(_strings(rng, n), cap)
    idx = rng.integers(0, n, cap).astype(np.int32)
    live = rng.uniform(0, 1, cap) < 0.8
    char_cap = 70 * cap
    tg = gather_strings(t, torch.from_numpy(idx), char_cap,
                        torch.from_numpy(live))
    jg = jgather_strings(j, jnp.asarray(idx), char_cap,
                         out_live=jnp.asarray(live))
    assert np.array_equal(tg.offsets.numpy(), np.asarray(jg.offsets))
    assert np.array_equal(tg.chars.numpy(), np.asarray(jg.chars))
    want_valid = np.asarray(jg.validity) & live
    assert np.array_equal(tg.valid_mask().numpy(), want_valid)


def test_strings_ride_gather_columns_and_concat():
    rng = np.random.default_rng(7)
    n = 150
    vals = _strings(rng, n)
    rb = pa.record_batch({"s": pa.array(vals),
                          "k": pa.array(np.arange(n, dtype=np.int64))})
    b = arrow_to_device(rb, None, "cpu")
    perm = torch.from_numpy(rng.permutation(b.capacity).astype(np.int32))
    live = perm < n
    cols = gather_columns(b.columns, perm, live)
    got = ensure_compacted(GpuBatch(cols, b.schema, b.capacity, live))
    keys = device_to_arrow(got).column("k").to_pylist()
    assert device_to_arrow(got).column("s").to_pylist() == \
        [vals[k] for k in keys]
    sel = GpuBatch(b.columns, b.schema, n,
                   torch.arange(b.capacity) % 3 == 0)
    merged = ensure_compacted(concat_batches_bounded([b, sel, b]))
    want = vals + [v for i, v in enumerate(vals) if i % 3 == 0] + vals
    assert device_to_arrow(merged).column("s").to_pylist() == want


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("strings")
    rng = np.random.default_rng(3)
    n = 6000
    data = {"cat": pa.array(_strings(rng, n, 0.1)),
            "dense": pa.array(["Electronics", "Home", "Sports"] * (n // 3)),
            "k": pa.array(np.arange(n, dtype=np.int64))}
    out = {}
    for name, kw in (("dict", {}), ("plain", {"use_dictionary": False}),
                     ("lz4", {"compression": "lz4"})):
        path = os.path.join(str(d), f"{name}.parquet")
        pq.write_table(pa.table(data), path, row_group_size=2000,
                       **dict({"compression": "snappy"}, **kw))
        out[name] = path
    return out


def _plans(path, module, dtypes):
    pf = pq.ParquetFile(path)
    md = pf.metadata
    out = []
    with open(path, "rb") as f:
        for g in range(md.num_row_groups):
            plans = {}
            for ci in range(md.num_columns):
                name = md.schema.column(ci).name
                t = pf.schema_arrow.field(name).type
                plans[name] = module.plan_chunk(
                    f, md.row_group(g).column(ci), pf.schema.column(ci),
                    dtypes.from_arrow(t), t)
            out.append(plans)
    return out


@pytest.mark.parametrize("case", ["dict", "plain", "coalesced"])
def test_device_decode_matches_reference_and_pyarrow(files, case):
    path = files["plain" if case == "plain" else "dict"]
    jplans = _plans(path, jpd, jdt)
    tplans = _plans(path, tpp, tdt)
    if case == "coalesced":
        jplans = [{k: jpd.merge_chunk_plans([p[k] for p in jplans])
                   for k in jplans[0]}]
        tplans = [{k: tpp.merge_chunk_plans([p[k] for p in tplans])
                   for k in tplans[0]}]
    table = pq.read_table(path)
    row = 0
    for jp, tp in zip(jplans, tplans):
        n = tp["k"].n_rows
        cap = bucket_rows(n)
        schema = tdt.Schema([tdt.StructField(k, tdt.from_arrow(
            table.schema.field(k).type)) for k in tp])
        layout = tpd.BatchLayout(schema, cap, n, tp, {})
        blob = torch.zeros(layout.total_bytes, dtype=torch.uint8)
        layout.fill(blob.numpy()[:layout.prefix_bytes])
        cols = dict(zip(tp, tpd.decode_batch(blob, layout)))
        jcols = jpd.decode_row_group_device(
            {k: (p, jdt.from_arrow(table.schema.field(k).type))
             for k, p in jp.items()}, cap)
        for name in ("cat", "dense"):
            t, j = cols[name], jcols[name]
            total = int(t.offsets[n])
            assert np.array_equal(t.offsets[:n + 1].numpy(),
                                  np.asarray(j.offsets)[:n + 1]), name
            assert np.array_equal(t.chars[:total].numpy(),
                                  np.asarray(j.chars)[:total]), name
            assert np.array_equal(t.valid_mask()[:n].numpy(),
                                  np.asarray(j.validity)[:n]), name
            got = device_to_arrow(GpuBatch([t], tdt.Schema(
                [tdt.StructField(name, tdt.STRING)]), n))
            assert got.column(0).to_pylist() == \
                table.column(name).slice(row, n).to_pylist(), name
        row += n
    assert row == table.num_rows


@pytest.mark.parametrize("device_decode", ["true", "false"])
@pytest.mark.parametrize("case", ["dict", "plain", "lz4"])
def test_scan_reads_strings_on_both_paths(files, case, device_decode):
    """Both scan paths; an lz4 file's chunks (a codec the device decode
    does not take) fall back to pyarrow inside the device-decode scan."""
    path = files[case]
    conf = RapidsConf({"spark.rapids.sql.format.parquet.deviceDecode."
                       "enabled": device_decode})
    ctx = ExecCtx(conf, "cpu")
    out = collect_arrow(GpuFileScanExec([path]), ctx)
    assert out.equals(pq.read_table(path))
    if device_decode == "true":
        m = next(v for k, v in ctx.metrics.items()
                 if k.startswith("FileScanExec"))
        fallback = 3 * 3 if case == "lz4" else 0
        assert m["deviceChunks"].value == 3 * 3 - fallback
        assert m["fallbackChunks"].value == fallback


def test_decimal_columns_still_raise(tmp_path):
    """Decimal columns read on both scan paths now, as pyarrow reads
    them (tests/test_torch_decimal_columnar.py holds the counters to the
    reference); a nested column reads as pyarrow reads it too, a host
    chunk of reason ``nested`` on the device-decode path
    (tests/test_torch_nested_columns.py)."""
    import decimal
    path = str(tmp_path / "dec.parquet")
    table = pa.table({"d": pa.array([decimal.Decimal("1.5"), None],
                                    pa.decimal128(5, 1))})
    pq.write_table(table, path)
    nested = str(tmp_path / "nested.parquet")
    arrays = pa.table({"a": pa.array([[1, 2], None], pa.list_(pa.int32()))})
    pq.write_table(arrays, nested)
    for dd in ("true", "false"):
        conf = RapidsConf({"spark.rapids.sql.format.parquet.deviceDecode."
                           "enabled": dd})
        got = collect_arrow(GpuFileScanExec([path]), ExecCtx(conf, "cpu"))
        assert got.equals(table)
        got = collect_arrow(GpuFileScanExec([nested]), ExecCtx(conf, "cpu"))
        assert got.equals(arrays)


def test_projection_and_filter_share_string_buffers():
    """A projection that keeps a string column passes its buffers on, one
    that drops it touches none of them, and a lazy filter only narrows
    the validity: no chars are copied."""
    from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
    from spark_rapids_tpu_torch.exec.basic import GpuFilterExec, \
        GpuProjectExec
    from spark_rapids_tpu_torch.expr import GreaterThan, Literal
    from spark_rapids_tpu_torch.expr import UnresolvedColumn as col
    rb = pa.record_batch({"s": pa.array(_strings(np.random.default_rng(9),
                                                 50)),
                          "k": pa.array(np.arange(50, dtype=np.int32))})
    src = HostBatchSourceExec([rb])
    ctx = ExecCtx(device="cpu")
    (b,) = list(src.execute(ctx))
    kept = GpuProjectExec([col("s")], src)._run(b, ctx.eval_ctx)
    assert kept.columns[0].chars is b.columns[0].chars
    assert kept.columns[0].offsets is b.columns[0].offsets
    dropped = GpuProjectExec([col("k")], src)._run(b, ctx.eval_ctx)
    assert all(c.chars is None for c in dropped.columns)
    f = GpuFilterExec(GreaterThan(col("k"), Literal(10)), src)._run(
        b, ctx.eval_ctx)
    assert f.columns[0].chars is b.columns[0].chars
    assert device_to_arrow(f).column("s").to_pylist() == \
        rb.column(0).to_pylist()[11:]


def test_join_refuses_string_chars_past_int32():
    """A join whose gathered string column would pass the int32 offsets
    raises and names its ROADMAP item before it allocates the chars:
    2^16 stream rows, half of them matching a 64 KiB build string, 2^31
    + 2^15 bytes by stage A's exact count (the fast path hands the batch
    to the staged path past 2^28 chars)."""
    from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
    from spark_rapids_tpu_torch.exec.joins import GpuShuffledHashJoinExec
    from spark_rapids_tpu_torch.expr import UnresolvedColumn as col
    n = 1 << 16
    stream = HostBatchSourceExec([pa.record_batch(
        {"k": pa.array(np.arange(n, dtype=np.int64) % 2)})])
    build = HostBatchSourceExec([pa.record_batch(
        {"b": pa.array(np.arange(2, dtype=np.int64)),
         "s": pa.array(["x" * (1 << 16), "y"])})])
    join = GpuShuffledHashJoinExec([col("k")], [col("b")], "inner",
                                   stream, build, build_unique_hint=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        collect_arrow(join, ExecCtx(device="cpu"))


def test_string_gather_check_at_the_join_shape():
    """``kernel_checks.check_string_gather`` (the card's check of the NDS
    join's string gather) passes through the plain version: 32,768
    strings gathered into 2^20 rows against pyarrow's ``take``."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    rec = kc.check_string_gather("cpu")
    assert rec["offsets_equal"] and rec["chars_equal"] \
        and rec["validity_equal"]


def test_nds_batches_decode_to_pyarrow(tmp_path):
    """The NDS path's own batches (a 2^20-row ``store_sales`` batch of
    two row groups, the ``item`` and ``store`` batches with their
    dictionary string columns, the ``customer`` batch, ``item`` with an
    all-null string column written PLAIN), decoded by K5's
    plain version, equal pyarrow's reading of the same files, offsets and
    chars included."""
    from spark_rapids_tpu_torch.columnar.batch import GpuBatch
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    for case, items in kc.nds_layouts(str(tmp_path)).items():
        (scan, layout), = items
        blob = torch.zeros(layout.total_bytes, dtype=torch.uint8)
        layout.fill(blob.numpy()[:layout.prefix_bytes])
        got = device_to_arrow(GpuBatch(tpd.decode_batch(blob, layout),
                                       layout.schema, layout.n_rows))
        want = pq.read_table(scan.paths[0])
        assert pa.Table.from_batches([got]).equals(
            want.cast(got.schema)), case

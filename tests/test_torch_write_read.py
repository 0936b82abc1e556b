"""The scan's formats and the writer on the CPU against the JAX package:
CSV, JSON and ORC scans, column projection, row-group pushdown, Hive
partition columns and their strict type inference, Hive text (hostile
strings, Base64 binary, \\r, decimals, timestamps, an external CRLF
file), and write/read round trips in every format through the port's
device path and its CPU path; each read held to the reference's read of
the same files (rows and Arrow types equal, floats exact). The
counterparts of the reference's ``tests/test_io.py:485-720``,
``tests/test_session.py:111`` and ``tests/test_complex_types.py:280``;
the Hive-partitioned round trip and Hive text also go through both
packages' sessions (``torch_dual_run.dual_run_frames``) at 1 and 16
partitions, and a disabled format scans on the CPU."""
import datetime
import decimal
import json
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from data_gen import (DateGen, FloatGen, IntegerGen, LongGen, StringGen,
                      gen_table)
from torch_dual_run import assert_same_rows, dual_run_frames

import spark_rapids_tpu.datatypes as jdt
import spark_rapids_tpu_torch.datatypes as tdt
from spark_rapids_tpu.columnar.arrow_bridge import engine_schema as jes
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import HostBatchSourceExec as JSource
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu.io import TpuFileScanExec, TpuFileWriteExec
from spark_rapids_tpu.io.scan import _hive_partition_values as j_hive
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.columnar.arrow_bridge import engine_schema as tes
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec as TSource
from spark_rapids_tpu_torch.exec.base import collect_arrow as tcollect
from spark_rapids_tpu_torch.exec.base import collect_arrow_cpu
from spark_rapids_tpu_torch.io import GpuFileScanExec, GpuFileWriteExec
from spark_rapids_tpu_torch.io.scan import FileSplit, _decode_split, \
    _hive_partition_values as t_hive, _simple_conjuncts
from spark_rapids_tpu_torch.planner import GpuOverrides


def _scans(paths, **kw):
    """The port's and the reference's scan of the same files; a
    ``schema`` given as Arrow becomes each package's."""
    schema = kw.pop("schema", None)
    return (GpuFileScanExec(paths, schema=None if schema is None
                            else tes(schema), **kw),
            TpuFileScanExec(paths, schema=None if schema is None
                            else jes(schema), **kw))


def _read_both(paths, conf=None, **kw):
    """The port's rows on its device path and its CPU path, each held to
    the reference's; returns the port's."""
    tscan, jscan = _scans(paths, **kw)
    want = jcollect(jscan, JCtx())
    got = tcollect(tscan, TCtx(RapidsConf(conf or {}), device="cpu"))
    assert_same_rows(got, want, True, rtol=0)
    cpu = collect_arrow_cpu(tscan, TCtx(device="cpu"))
    assert_same_rows(cpu, want, True, rtol=0)
    return got


def test_csv_scan(tmp_path):
    import pyarrow.csv as pcsv
    rb = gen_table([IntegerGen(), FloatGen(jdt.FLOAT64),
                    StringGen(ascii_only=True, charset="abcdefgh123")],
                   n=300)
    p = str(tmp_path / "data.csv")
    pcsv.write_csv(pa.Table.from_batches([rb]), p)
    got = _read_both([p], fmt="csv")
    assert got.num_rows == 300


def test_json_scan(tmp_path):
    rb = gen_table([IntegerGen(), LongGen(), StringGen(ascii_only=True)],
                   n=200)
    p = str(tmp_path / "data.json")
    with open(p, "w") as f:
        for row in pa.Table.from_batches([rb]).to_pylist():
            f.write(json.dumps(row) + "\n")
    assert _read_both([p], fmt="json").num_rows == 200


def test_orc_scan(tmp_path):
    from pyarrow import orc
    rb = gen_table([IntegerGen(), LongGen(), FloatGen(jdt.FLOAT64),
                    StringGen()], n=300)
    p = str(tmp_path / "data.orc")
    orc.write_table(pa.Table.from_batches([rb]), p)
    assert _read_both([p], fmt="orc").num_rows == 300


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_column_projection(tmp_path, fmt):
    rb = gen_table([IntegerGen(), StringGen(ascii_only=True), LongGen()],
                   names=["a", "b", "c"])
    t = pa.Table.from_batches([rb])
    p = str(tmp_path / f"data.{fmt}")
    if fmt == "parquet":
        pq.write_table(t, p)
    elif fmt == "orc":
        from pyarrow import orc
        orc.write_table(t, p)
    else:
        from pyarrow import csv
        csv.write_csv(t, p)
    tscan, _ = _scans([p], fmt=fmt, columns=["c", "a"])
    assert tscan.output_schema.names == ["c", "a"]
    _read_both([p], fmt=fmt, columns=["c", "a"])


def test_pushdown_prunes_row_groups_and_stays_correct(tmp_path):
    """An ascending key's row groups have tight statistics: the
    pushdown's conjuncts keep 2 of 8, on both decode paths; the filter
    above still runs, and the rows equal the reference's."""
    from spark_rapids_tpu import expr as J
    from spark_rapids_tpu.exec import TpuFilterExec
    from spark_rapids_tpu_torch import expr as T
    from spark_rapids_tpu_torch.exec.basic import GpuFilterExec
    n = 4096
    t = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                  "v": pa.array(np.arange(n, dtype=np.float64) * 0.5)})
    p = str(tmp_path / "k.parquet")
    pq.write_table(t, p, row_group_size=512)

    def cond(E, dt):
        return E.And(E.GreaterThanOrEqual(E.UnresolvedColumn("k"),
                                          E.Literal(1000, dt.INT64)),
                     E.LessThan(E.UnresolvedColumn("k"),
                                E.Literal(1500, dt.INT64)))
    tscan = GpuFileScanExec([p], pushdown=cond(T, tdt))
    jscan = TpuFileScanExec([p], pushdown=cond(J, jdt))
    assert tscan.describe() == jscan.describe()
    assert len(tscan._device_rg_tasks(RapidsConf())) == 2
    rbs = _decode_split(FileSplit(p), "parquet", None, 1 << 20,
                        _simple_conjuncts(cond(T, tdt)))
    assert sum(r.num_rows for r in rbs) == 1024
    want = jcollect(TpuFilterExec(cond(J, jdt), jscan), JCtx())
    for dd in ("true", "false"):
        conf = RapidsConf(
            {"spark.rapids.sql.format.parquet.deviceDecode.enabled": dd})
        got = tcollect(GpuFilterExec(cond(T, tdt), tscan),
                       TCtx(conf, device="cpu"))
        assert_same_rows(got, want, True, rtol=0)
        assert got.num_rows == 500


def _canon(table):
    return {name: ["NaN" if isinstance(v, float) and math.isnan(v) else v
                   for v in vals]
            for name, vals in table.to_pydict().items()}


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv", "hivetext"])
def test_write_round_trip(tmp_path, fmt):
    """Written through the port's device path and its CPU path, read
    back: both equal the reference's own write read back."""
    gens = [IntegerGen(), LongGen(), FloatGen(jdt.FLOAT64)]
    if fmt != "csv":
        gens += [StringGen(), DateGen()]
    rb = gen_table(gens, n=700)
    schema = rb.schema
    tw = GpuFileWriteExec(TSource([rb], schema=tes(schema)),
                          str(tmp_path / "dev"), fmt=fmt)
    list(tw.execute(TCtx(device="cpu")))
    tw2 = GpuFileWriteExec(TSource([rb], schema=tes(schema)),
                           str(tmp_path / "cpu"), fmt=fmt)
    list(tw2.execute_cpu(TCtx(device="cpu")))
    jw = TpuFileWriteExec(JSource([rb], schema=jes(schema)),
                          str(tmp_path / "ref"), fmt=fmt)
    list(jw.execute(JCtx()))
    assert tw.written_files and tw2.written_files
    kw = {"schema": schema} if fmt == "hivetext" else {}
    ref_back = jcollect(_scans(jw.written_files, fmt=fmt, **kw)[1], JCtx())
    for files in (tw.written_files, tw2.written_files):
        back = _read_both(files, fmt=fmt, **kw)
        assert_same_rows(back, ref_back, True, rtol=0)
        assert back.num_rows == 700


def test_partitioned_write(tmp_path):
    rb = gen_table([IntegerGen(min_val=0, max_val=3, null_frac=0),
                    LongGen(), StringGen()], names=["part", "v", "s"])
    w = GpuFileWriteExec(TSource([rb], schema=tes(rb.schema)),
                         str(tmp_path / "out"), fmt="parquet",
                         partition_by=["part"])
    list(w.execute(TCtx(device="cpu")))
    assert any("part=" in f for f in w.written_files)
    import pyarrow.dataset as pads
    back = pads.dataset(str(tmp_path / "out"), format="parquet",
                        partitioning="hive").to_table()
    assert back.num_rows == rb.num_rows
    key = (lambda x: (x is None, x))
    assert sorted(back.column("v").to_pylist(), key=key) \
        == sorted(rb.column(1).to_pylist(), key=key)
    with pytest.raises(ValueError, match="parquet only"):
        list(GpuFileWriteExec(TSource([rb], schema=tes(rb.schema)),
                              str(tmp_path / "o2"), fmt="orc",
                              partition_by=["part"]).execute(
                                  TCtx(device="cpu")))


@pytest.mark.parametrize("values,kind", [
    (("nan", "inf", "1_0"), "string"), (("1", "-2", "+3"), "bigint"),
    (("1.5", "2e3", ".25"), "double"),
    (("7", "__HIVE_DEFAULT_PARTITION__", "8"), "bigint"),
    (("a%20b", "c"), "string")])
def test_hive_partition_inference_is_the_references(tmp_path, values,
                                                    kind):
    base = str(tmp_path)
    paths = [f"{base}/k={v}/j=x/f.parquet" for v in values]
    typed, schema = t_hive(paths)
    jtyped, jschema = j_hive(paths)
    assert typed == jtyped
    assert [f.dtype.simple_string() for f in schema.fields] == \
        [f.dtype.simple_string() for f in jschema.fields]
    assert schema.fields[0].dtype.simple_string() == kind
    # a prefix every file shares is not a partition
    assert t_hive([f"{base}/run=3/a.parquet", f"{base}/run=3/b.parquet"]) \
        == ({}, None)


@pytest.fixture(scope="module")
def nds_paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(1 << 12),
                            str(tmp_path_factory.mktemp("nds")))


@pytest.mark.parametrize("parts", ["1", "16"])
def test_hive_partition_columns_through_the_sessions(nds_paths, parts,
                                                     tmp_path):
    """item written partitioned by a string and an int column, read back
    with both as Hive columns (string and int64), through both
    sessions."""
    import uuid

    def build(s, E):
        where = str(tmp_path / uuid.uuid4().hex[:8])
        files = s.table("item").write(where, "parquet",
                                      partition_by=["i_category",
                                                    "i_brand_id"])
        return s.read_parquet(files)

    def chunks(pp):
        out = []
        for p in pp.root.paths:
            md = pq.ParquetFile(p).metadata
            out.append(md.num_row_groups * md.num_columns)
        return [(sum(out), 0)]
    got, want, _, _ = dual_run_frames(
        build, nds_paths, {"spark.sql.shuffle.partitions": parts},
        ordered=False, port_chunks=chunks)
    assert got.column_names[-2:] == ["i_category", "i_brand_id"]
    assert got.schema.field("i_brand_id").type == pa.int64()


@pytest.mark.parametrize("parts", ["1", "16"])
def test_hive_text_through_the_sessions(nds_paths, parts, tmp_path):
    import uuid

    def build(s, E):
        c = E.UnresolvedColumn
        df = s.table("item").select(c("i_item_sk"), c("i_category"),
                                    c("i_current_price"))
        files = df.write(str(tmp_path / uuid.uuid4().hex[:8]), "hivetext")
        return s._read(files, "hivetext", df.schema)
    got, _, _, _ = dual_run_frames(
        build, nds_paths, {"spark.sql.shuffle.partitions": parts},
        ordered=False)
    assert got.num_rows > 0


def _hive_rb():
    utc = datetime.timezone.utc
    return pa.record_batch({
        "i": pa.array([1, None, -3, 400], pa.int64()),
        "f": pa.array([0.5, 2.25, None, -1.0]),
        "b": pa.array([True, False, None, True]),
        "d": pa.array([datetime.date(2021, 3, 5), None,
                       datetime.date(1999, 12, 31),
                       datetime.date(2000, 1, 1)]),
        "s": pa.array(["plain", "with\x01delim", "multi\nline\r",
                       "back\\slash"]),
        "bin": pa.array([b"ab\x01c", None, b"\\x\nraw", b""]),
        "dec": pa.array([decimal.Decimal("1.50"), None,
                         decimal.Decimal("-0.25"), decimal.Decimal("0")],
                        pa.decimal128(10, 2)),
        "ts": pa.array([datetime.datetime(2021, 3, 5, 12, 0, 1, 250000,
                                          tzinfo=utc), None, None,
                        datetime.datetime(1969, 1, 1, tzinfo=utc)],
                       pa.timestamp("us", tz="UTC")),
    })


def test_hive_text_round_trip_hostile_values(tmp_path):
    """Delimiters, newlines, \\r and backslashes inside strings, Base64
    binary, decimals and timestamps: written by the port, read by both
    packages, equal to the source."""
    rb = _hive_rb()
    w = GpuFileWriteExec(TSource([rb], schema=tes(rb.schema)),
                         str(tmp_path / "ht"), fmt="hivetext")
    list(w.execute(TCtx(device="cpu")))
    back = _read_both(w.written_files, fmt="hivetext", schema=rb.schema)
    assert _canon(back) == _canon(pa.Table.from_batches([rb]))


def test_hive_text_crlf_external_file(tmp_path):
    p = str(tmp_path / "crlf.txt")
    with open(p, "wb") as f:
        f.write(b"1\x01alpha\r\n2\x01beta\r\n\\N\x01\\N\r\n3\x01x\\\\y")
    schema = pa.schema([("i", pa.int64()), ("s", pa.string())])
    back = _read_both([p], fmt="hivetext", schema=schema)
    assert back.column("i").to_pylist() == [1, 2, None, 3]
    assert back.column("s").to_pylist() == ["alpha", "beta", None, "x\\y"]


def test_hive_text_needs_a_schema(tmp_path):
    p = str(tmp_path / "x.txt")
    open(p, "w").write("1\n")
    with pytest.raises(ValueError, match="explicit schema"):
        GpuFileScanExec([p], fmt="hivetext")


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_a_disabled_format_scans_on_the_cpu(tmp_path, fmt):
    rb = gen_table([IntegerGen(), LongGen()], n=50)
    p = str(tmp_path / f"d.{fmt}")
    if fmt == "csv":
        from pyarrow import csv
        csv.write_csv(pa.Table.from_batches([rb]), p)
    else:
        pq.write_table(pa.Table.from_batches([rb]), p)
    conf = RapidsConf({f"spark.rapids.sql.format.{fmt}.enabled": "false"})
    pp = GpuOverrides(conf, "cpu").apply(GpuFileScanExec([p], fmt=fmt))
    assert pp.fallback_nodes() == ["FileScanExec"]
    assert "disabled by spark.rapids.sql.format" in pp.explain("NOT_ON_GPU")
    on = GpuOverrides(RapidsConf(), "cpu").apply(GpuFileScanExec([p],
                                                                 fmt=fmt))
    assert on.fallback_nodes() == []
    assert pp.collect().equals(on.collect())


def test_write_exec_placement():
    rb = gen_table([IntegerGen()], n=5)
    src = TSource([rb], schema=tes(rb.schema))
    assert GpuFileWriteExec(src, "/nowhere", "avro").gpu_supported() == \
        "write format avro not supported"
    assert GpuFileWriteExec(src, "/nowhere", "orc").gpu_supported() is None


def test_session_read_write_roundtrip(tmp_path):
    """``write_parquet`` then ``read_parquet`` (the reference's
    ``tests/test_session.py:111``), and ``read_csv``, ``read_json`` and
    ``read_orc`` over the same rows."""
    from spark_rapids_tpu_torch.session import GpuSession
    s = GpuSession(device="cpu")
    df = s.create_dataframe(pa.table({
        "k": pa.array(np.arange(100) % 7, pa.int64()),
        "v": pa.array(np.arange(100), pa.int64())}))
    files = df.write_parquet(str(tmp_path / "out"))
    assert files and all(os.path.exists(f) for f in files)
    got = s.read_parquet(files).collect().sort_by("v")
    assert got.column("v").to_pylist() == list(range(100))
    for fmt, read in (("orc", s.read_orc), ("csv", s.read_csv)):
        files = df.write(str(tmp_path / fmt), fmt)
        assert read(files).collect().sort_by("v").column("v").to_pylist() \
            == list(range(100))
    p = str(tmp_path / "v.json")
    with open(p, "w") as f:
        for row in df.collect().to_pylist():
            f.write(json.dumps(row) + "\n")
    assert s.read_json(p).collect().num_rows == 100


def test_write_keeps_its_plan_and_write_time(tmp_path):
    """``DataFrame.write`` keeps its planned write as
    ``last_write_plan``, whose run recorded the writer's ``writeTime``
    and wrote the files it returned."""
    from spark_rapids_tpu_torch.session import GpuSession
    s = GpuSession(device="cpu")
    df = s.create_dataframe(pa.table({"v": pa.array(np.arange(50),
                                                    pa.int64())}))
    files = df.write(str(tmp_path / "w"), "parquet")
    pp = df.last_write_plan
    assert pp.root_on_device is not None and pp.verify_report.ok
    times = [m["writeTime"].value for m in pp.last_ctx.metrics.values()
             if "writeTime" in m]
    assert len(times) == 1 and times[0] > 0
    assert pq.read_table(files).num_rows == 50


def test_hive_partition_values_on_read(tmp_path):
    """The reference's ``tests/test_complex_types.py:280``: two partition
    keys, read back with their values and an integral year."""
    from spark_rapids_tpu_torch.session import GpuSession
    s = GpuSession(device="cpu")
    tbl = pa.table({
        "k": pa.array([1, 2, 3, 4, 5, 6], pa.int64()),
        "region": pa.array(["eu", "us", "eu", "us", "eu", "us"]),
        "yr": pa.array([2023, 2023, 2024, 2024, 2023, 2024]),
    })
    paths = s.create_dataframe(tbl).write(str(tmp_path / "t"),
                                          partition_by=["region", "yr"])
    got = s.read_parquet(paths).collect().sort_by("k")
    assert got.column_names == ["k", "region", "yr"]
    assert got.select(["k", "region", "yr"]).to_pylist() == \
        tbl.to_pylist()
    assert got.schema.field("yr").type == pa.int64()
    assert torch.device("cpu") == s.device


HIVE_EDGE_FILES = [
    b"1\x01a\x011.5\x01true\n", b"\\N\x01\\N\x01\\N\x01\\N\n+3\x01x\x01.5\x01TRUE\r\n",
    b"1\x01a\\Nb\x012\x01false\n", b"1\x01a\x01x\x01t\n2\x01b\n",
    b"1\x01a\x011\x01true\x01extra\n", b"\n", b"1\x01a\rb\x011\x01true\n",
    b"7\x01\\N\x01nan\x01\\N", b"1\x01\x01\x01\n", b"\\N\x01a\x01-0\x01false\n\n",
    b"\r\n", b"a\r\n\r\nb", b"x\\N", b"\\N\r\n\\N", b"a\nb\nc",
    "\u0661\u0662\x01a\x01\u0661.5\x01True\n2\x01b\x01-1e3\x01no\n".encode(),
    b"+4\x01a\\\x01b\x011e3\x01TRUE\n\\-5\x01\\N\x01x\\.5\x01tr\\ue\n"]
#: (case, width) that pyarrow reads: every row of every field, no escape
#: but whole-field \N, no bare \r, no empty line
HIVE_FAST = {(0, 4), (1, 4), (7, 4), (8, 4), (13, 1), (14, 1), (15, 4)}


@pytest.mark.parametrize("width", [4, 1])
@pytest.mark.parametrize("case", range(len(HIVE_EDGE_FILES)))
def test_hive_text_edge_files_read_as_the_references(tmp_path, case, width):
    """Missing and extra fields, empty lines, bare and CRLF \\r, a \\N
    inside a field, signs, NaN text, digits outside ASCII, escaped
    numbers and no final newline: pyarrow's read
    (``_hive_text_arrow``, where the file has no escape) and the line
    walk give the reference's rows; a file pyarrow cannot read as the
    serde does takes the walk."""
    from spark_rapids_tpu.io.scan import _decode_hive_text as jread
    from spark_rapids_tpu_torch.io.scan import (_decode_hive_text,
                                                _hive_text_arrow)
    schema = pa.schema([("i", pa.int32()), ("s", pa.string()),
                        ("f", pa.float32()), ("b", pa.bool_())][:width]
                       if width == 4 else [("s", pa.string())])
    data = HIVE_EDGE_FILES[case]
    p = str(tmp_path / "e.txt")
    with open(p, "wb") as f:
        f.write(data)
    got = pa.Table.from_batches(_decode_hive_text(p, None, 2, tes(schema)),
                                schema=schema)
    want = pa.Table.from_batches(jread(p, None, 2, jes(schema)),
                                 schema=schema)
    assert got.to_pylist() == want.to_pylist()
    fast = _hive_text_arrow(data, schema.names, schema.names, tes(schema),
                            2) is not None
    assert fast == ((case, width) in HIVE_FAST)

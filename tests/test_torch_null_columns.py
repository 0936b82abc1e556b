"""Null columns on the CPU: string column chunks whose store holds no
strings, and ``NullType`` columns, held to the JAX package through the
dual-run assert (``torch_dual_run``), on both scan paths (device page
decode on, and ``deviceDecode.enabled=false``).

- A string column that is all null in a row group written without a
  dictionary (PLAIN, PLAIN with v2 data pages, DELTA_LENGTH_BYTE_ARRAY)
  stages a store of one offset; so does a file of no rows. Every such
  row decodes as start 0, length 0 (``ops/parquet_decode.py``
  ``_string_column``). The dictionary and DELTA_BYTE_ARRAY settings are
  held too.
- ``NullType``: ``SELECT NULL``, a Parquet column of Arrow type
  ``null``, and NULL as a CASE branch or a UNION ALL side. The
  reference refuses a UNION ALL of a NULL side with a typed one, where
  the port widens it as Spark does, and it cannot collect every
  ``CAST(NULL AS <type>)`` (ROADMAP section C): those are held to
  pyarrow."""
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu_torch import datatypes as dt
from spark_rapids_tpu_torch.columnar.arrow_bridge import (arrow_to_device,
                                                          device_to_arrow)
from torch_dual_run import assert_same_rows, dual_run, run_port

HOST_DECODE = {"spark.rapids.sql.format.parquet.deviceDecode.enabled":
               "false"}
PATHS = {"device_decode": {}, "host_decode": HOST_DECODE}

# pyarrow writer settings of the string column s
WRITERS = {
    "plain": {"use_dictionary": False},
    "plain_v2": {"use_dictionary": False, "data_page_version": "2.0"},
    "delta_length": {"use_dictionary": False,
                     "column_encoding": {"s": "DELTA_LENGTH_BYTE_ARRAY"}},
    "delta_byte_array": {"use_dictionary": False,
                         "column_encoding": {"s": "DELTA_BYTE_ARRAY"}},
    "dictionary": {},
}
ROWS = {"all_null": 3, "zero_rows": 0}


def _write(path, table, **kw):
    pq.write_table(table, path, **kw)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nulls")
    out = {}
    for wname, kw in WRITERS.items():
        for rname, n in ROWS.items():
            t = pa.table({"k": pa.array(range(1, n + 1), pa.int64()),
                          "s": pa.array([None] * n, pa.string())})
            out[wname, rname] = _write(d / f"{wname}_{rname}.parquet", t,
                                       **kw)
    out["typed"] = _write(d / "typed.parquet", pa.table(
        {"k": pa.array([1, 2, 3], pa.int64()),
         "v": pa.array([1.5, None, 2.5])}))
    out["arrow_null"] = _write(d / "arrow_null.parquet", pa.table(
        {"k": pa.array([1, 2, 3], pa.int64()), "n": pa.nulls(3)}))
    return out


@pytest.mark.parametrize("scan", list(PATHS))
@pytest.mark.parametrize("rows", list(ROWS))
@pytest.mark.parametrize("writer", list(WRITERS))
def test_string_chunk_with_an_empty_store(files, writer, rows, scan):
    paths = {"t": files[writer, rows]}
    conf = PATHS[scan]
    got, _ = dual_run("SELECT COUNT(*) AS c FROM t WHERE k > 1", paths,
                      conf)
    assert got.column("c").to_pylist() == [max(ROWS[rows] - 1, 0)]
    got, _ = dual_run("SELECT k, s FROM t WHERE k > 1", paths, conf)
    assert got.column("s").to_pylist() == [None] * max(ROWS[rows] - 1, 0)


@pytest.mark.parametrize("scan", list(PATHS))
@pytest.mark.parametrize("sql", [
    "SELECT NULL AS c FROM t",
    "SELECT k, NULL AS n FROM t WHERE k > 1",
    "SELECT CASE WHEN k > 1 THEN k ELSE NULL END AS c FROM t",
    "SELECT CASE WHEN k > 1 THEN NULL ELSE v END AS c FROM t",
    "SELECT CASE WHEN k > 1 THEN NULL END AS c FROM t",
    "SELECT NULL AS c FROM t UNION ALL SELECT NULL AS c FROM t"],
    ids=["select_null", "null_beside_a_column", "case_else_null",
         "case_then_null", "case_all_null", "union_of_nulls"])
def test_null_literals_match_the_reference(files, sql, scan):
    got, _ = dual_run(sql, {"t": files["typed"]}, PATHS[scan])
    assert got.num_rows > 0


@pytest.mark.parametrize("scan", list(PATHS))
@pytest.mark.parametrize("sql", ["SELECT k, n FROM t",
                                 "SELECT n FROM t WHERE k > 1"],
                         ids=["all_rows", "filtered"])
def test_arrow_null_parquet_column(files, sql, scan):
    got, _ = dual_run(sql, {"t": files["arrow_null"]}, PATHS[scan])
    assert got.schema.field("n").type == pa.null()


@pytest.mark.parametrize("scan", list(PATHS))
@pytest.mark.parametrize("sql, want", [
    ("SELECT k AS c FROM t UNION ALL SELECT NULL AS c FROM t",
     pa.table({"c": pa.array([1, 2, 3, None, None, None], pa.int64())})),
    ("SELECT NULL AS c FROM t UNION ALL SELECT v AS c FROM t",
     pa.table({"c": pa.array([None] * 3 + [1.5, None, 2.5])})),
    ("SELECT CAST(NULL AS INT) AS c, k FROM t",
     pa.table({"c": pa.nulls(3, pa.int32()),
               "k": pa.array([1, 2, 3], pa.int64())}))],
    ids=["union_null_second", "union_null_first", "cast_null_as_int"])
def test_null_widened_held_to_pyarrow(files, sql, want, scan):
    got, _ = run_port(sql, {"t": files["typed"]}, PATHS[scan])
    assert_same_rows(got, want, ordered=False, label=sql)


def test_arrow_bridge_round_trips_a_null_column():
    rb = pa.record_batch({"k": pa.array([4, 5], pa.int64()),
                          "n": pa.nulls(2)})
    batch = arrow_to_device(rb, None, torch.device("cpu"))
    assert isinstance(batch.schema[1].dtype, dt.NullType)
    assert device_to_arrow(batch).equals(rb)

"""The port's telemetry warehouse (``spark_rapids_tpu_torch/obs/
warehouse.py``, ``obs/attribution.py``) against the JAX package's.

- Sealed segments: a row appended by either package is read back by
  both (``read_rows``), a torn tail is salvaged, segments roll and the
  oldest are pruned, and a disabled warehouse writes nothing.
- ``drift_report``, ``render_warehouse`` and ``tail_rows`` return the
  reference's text, rc and rows on the same rows (a clean repeat, a
  seeded dispatch regression, fallback chunks, variants and bytes, a
  cross-``device_kind`` refusal, a same-device baseline further back).
- One row a collect for every outcome on the port, with the tracer and
  the event log on too: completed, cancelled (a query budget), degraded
  (the ladder's CPU rung) and failed (a missing file), ``device_kind``
  ``cpu``, and one trace each.
- Dual runs (``tests/torch_dual_run.py``) of six texts at 2^12 rows at
  1 and 4 partitions with the warehouse on in both packages: every row
  field equals the reference's but those in ``DIFFERENCES``, each with
  its reason, and the volatile ones (``VOLATILE``: ids, clocks; the
  per-operator rows compared by op id and label, without their times).
"""
import glob
import json
import os
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.obs import warehouse as jwh
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.lifecycle import QueryCancelled
from spark_rapids_tpu_torch.obs import warehouse as pwh
from spark_rapids_tpu_torch.session import GpuSession
from spark_rapids_tpu_torch.tools import nds_fallback as fb
from spark_rapids_tpu_torch.tools import nds_memory as nm
from torch_dual_run import assert_same_rows, run_port, run_reference


def _conf(d, cls=RapidsConf, **extra):
    base = {"spark.rapids.warehouse.dir": str(d)}
    base.update({k: str(v) for k, v in extra.items()})
    return cls(base)


def _row(**kw):
    r = {"query_id": "q1", "tenant": "default", "outcome": "completed",
         "device_kind": "cpu", "fingerprint": "fp0", "wall_s": 1.0,
         "fusion": {"fused_dispatches": 4, "jit_variants": 2,
                    "scan_programs": 4},
         "scan": {"device_chunks": 6, "fallback_chunks": 0},
         "bytes": {"host_written": 1000}, "spill": {}}
    r.update(kw)
    return r


# --- segments ---------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(pwh, jwh), (jwh, pwh)],
                         ids=["port-to-reference", "reference-to-port"])
def test_sealed_segments_cross_read(tmp_path, writer, reader):
    cls = RapidsConf if writer is pwh else JConf
    conf = _conf(tmp_path, cls)
    for i in range(3):
        assert writer.append_row(conf, _row(query_id=f"q{i}",
                                            ts=float(i)))
    got = reader.read_rows(str(tmp_path))
    assert [r["query_id"] for r in got] == ["q0", "q1", "q2"]
    assert got == writer.read_rows(str(tmp_path))
    assert all(r["version"] == 1 for r in got)
    assert reader.tail_rows(str(tmp_path), 2) == \
        writer.tail_rows(str(tmp_path), 2)
    from spark_rapids_tpu_torch.shuffle.integrity import read_sealed_file
    for seg in glob.glob(os.path.join(str(tmp_path), "wh-*.jsonl")):
        read_sealed_file(seg, lambda k, d: AssertionError(f"{k}: {d}"))


def test_torn_tail_salvaged_and_roll_retention(tmp_path):
    conf = _conf(tmp_path / "a")
    for i in range(3):
        pwh.append_row(conf, _row(query_id=f"q{i}", ts=float(i)))
    (seg,) = glob.glob(str(tmp_path / "a" / "wh-*.jsonl"))
    raw = open(seg, "rb").read()
    with open(seg, "wb") as f:
        f.write(raw + b'{"query_id": "q3", "torn')
    assert [r["query_id"] for r in pwh.read_rows(str(tmp_path / "a"))] \
        == ["q0", "q1", "q2"]
    with open(str(tmp_path / "a" / "wh-0-0.jsonl"), "wb") as f:
        f.write(b"\x00\xff\x01garbage")
    assert pwh.read_rows(str(tmp_path / "a")) == \
        jwh.read_rows(str(tmp_path / "a"))
    rolled = _conf(tmp_path / "b",
                   **{"spark.rapids.warehouse.segment.maxRows": "1",
                      "spark.rapids.warehouse.maxFiles": "2"})
    for i in range(5):
        pwh.append_row(rolled, _row(query_id=f"q{i}", ts=float(i)))
    assert len(glob.glob(str(tmp_path / "b" / "wh-*.jsonl"))) == 2
    assert [r["query_id"] for r in pwh.read_rows(str(tmp_path / "b"))] \
        == ["q3", "q4"]
    off = _conf(tmp_path / "c", **{"spark.rapids.warehouse.dir": ""})
    assert pwh.warehouse_dir(off) is None
    assert pwh.append_row(off, _row()) is None
    assert not glob.glob(str(tmp_path / "c" / "wh-*"))


# --- rollups and the drift sentinel -----------------------------------------

def _seeded(kind):
    """Row lists of the reference's drift scenarios."""
    if kind == "identical":
        return [_row(ts=1.0), _row(ts=2.0)]
    if kind == "dispatches":
        bad = _row(ts=2.0)
        bad["fusion"] = dict(bad["fusion"], fused_dispatches=5)
        return [_row(ts=1.0), bad]
    if kind == "fallback_variants_bytes":
        bad = _row(ts=2.0)
        bad["scan"] = {"device_chunks": 5, "fallback_chunks": 1}
        bad["fusion"] = dict(bad["fusion"], jit_variants=99)
        bad["bytes"] = {"host_written": 10000}
        return [_row(ts=1.0), bad]
    if kind == "cross_device":
        return [_row(ts=1.0, device_kind="cpu"),
                _row(ts=2.0, device_kind="NVIDIA H100 80GB HBM3")]
    if kind == "same_device_further_back":
        return [_row(ts=1.0, device_kind="cpu"),
                _row(ts=2.0, device_kind="NVIDIA H100 80GB HBM3"),
                _row(ts=3.0, device_kind="cpu")]
    assert kind == "tenants"
    return [_row(ts=1.0, tenant="etl"),
            _row(ts=2.0, tenant="adhoc", outcome="cancelled")]


SCENARIOS = ["identical", "dispatches", "fallback_variants_bytes",
             "cross_device", "same_device_further_back", "tenants"]


@pytest.mark.parametrize("kind", SCENARIOS)
def test_drift_and_rollups_equal_reference(tmp_path, kind):
    pdir, jdir = tmp_path / "port", tmp_path / "ref"
    for r in _seeded(kind):
        pwh.append_row(_conf(pdir), r)
        jwh.append_row(_conf(jdir, JConf), r)
    for kw in ({}, {"allow_cross_device": True},
               {"bytes_tolerance": 100.0, "variant_bound": 1000}):
        got = pwh.drift_report(str(pdir), **kw)
        want = jwh.drift_report(str(jdir), **kw)
        assert got == (want[0].replace(str(jdir), str(pdir)), want[1])
    assert pwh.render_warehouse(str(pdir)) == \
        jwh.render_warehouse(str(jdir)).replace(str(jdir), str(pdir))
    rep, rc = pwh.drift_report(str(pdir))
    assert rc == {"identical": 0, "dispatches": 1,
                  "fallback_variants_bytes": 1, "cross_device": 3,
                  "same_device_further_back": 0, "tenants": 0}[kind], rep


# --- one row a collect, every outcome ---------------------------------------

def _frame(session, nbatches=2, rows=200):
    tbl = pa.Table.from_batches([
        pa.RecordBatch.from_arrays(
            [pa.array(np.arange(rows, dtype=np.int64))], names=["a"])
        for _ in range(nbatches)])
    return session.create_dataframe(tbl)


def _outcome_run(tmp_path, outcome):
    # every sink on but the profiler (whose own syncs the collect does not
    # add elsewhere): the warehouse, the tracer and the event log
    wh = {"spark.rapids.warehouse.dir": str(tmp_path),
          "spark.rapids.trace.dir": str(tmp_path / "trace"),
          "spark.rapids.eventLog.dir": str(tmp_path / "events")}
    if outcome == "completed":
        s = GpuSession(wh, device="cpu")
        got = _frame(s).select("a").collect()
        assert got.num_rows == 400
    elif outcome == "cancelled":
        s = GpuSession(dict(wh, **{
            "spark.rapids.query.memoryBudgetBytes": "1",
            "spark.rapids.query.memoryBudget.action": "cancel"}),
            device="cpu")
        with pytest.raises(QueryCancelled):
            _frame(s).select("a").collect()
    elif outcome == "degraded":
        s = GpuSession(dict(wh, **{
            "spark.rapids.sql.test.injectRetryOOM.storm": "200",
            "spark.rapids.sql.oomRetry.maxSplits": "2"}), device="cpu")
        got = _frame(s, nbatches=1, rows=64).select("a").collect(
            s.query_context())
        assert got.column(0).to_pylist() == list(range(64))
    else:
        from spark_rapids_tpu_torch import datatypes as dt
        from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
        from spark_rapids_tpu_torch.planner import GpuOverrides
        schema = dt.Schema([dt.StructField("x", dt.INT64, True)])
        plan = GpuFileScanExec([str(tmp_path / "missing.parquet")],
                               schema=schema)
        with pytest.raises(Exception):
            GpuOverrides(RapidsConf(wh), "cpu").apply(plan).collect()
    rows = pwh.read_rows(str(tmp_path))
    assert len(rows) == 1, rows
    return rows[0]


@pytest.mark.parametrize("outcome",
                         ["completed", "cancelled", "degraded", "failed"])
def test_one_row_a_collect_with_its_outcome(tmp_path, outcome):
    row = _outcome_run(tmp_path, outcome)
    # every exit writes its trace too
    assert len(os.listdir(tmp_path / "trace")) == 1
    assert row["outcome"] == outcome
    assert row["device_kind"] == "cpu" and row["query_id"]
    assert row["fusion"]["jit_variants"] == 0
    assert set(row["bytes"]) == {"host_written", "host_fetched",
                                 "ici_written", "ici_fetched",
                                 "process_fetched", "gang_dcn",
                                 "gang_epochs"}
    assert set(row["spill"]) == {"write_bytes", "disk_write_bytes",
                                 "read_bytes"}
    if outcome == "completed":
        assert row["cancel"] is None and row["source"] == "plan"
        assert 0 < row["split"]["op_time_s"] or row["ops"]
        labels = {op["label"].split("#")[0]: op["rows"]
                  for op in row["ops"].values()}
        assert labels["HostBatchSourceExec"] == 400
    if outcome == "cancelled":
        assert row["cancel"]["reason"] == "budget"
        assert "error" not in row
    if outcome == "degraded":
        for rung in ("halve", "spill", "width1", "cpu"):
            assert row["ladder"].get(rung, 0) >= 1, row["ladder"]
        assert any(r.startswith("ladder_cpu_fallback:")
                   for r in row["fallback_reasons"])
    if outcome == "failed":
        assert row["error"]


def test_status_document_and_endpoint(tmp_path):
    from spark_rapids_tpu_torch.obs.metrics import (
        clear_status_provider, maybe_start_http_server, render_status,
        set_status_provider)
    doc = render_status()
    assert doc["pid"] == os.getpid()
    assert "device_bytes_in_use" in doc["memory"]
    assert "in_use" in doc["admission"]

    def provider():
        return {"warehouse_tail": pwh.tail_rows(str(tmp_path), 1)}

    pwh.append_row(_conf(tmp_path), _row())
    set_status_provider(provider)
    try:
        port = maybe_start_http_server(RapidsConf(
            {"spark.rapids.metrics.port": str(_free_port())}))
        assert port
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/status", timeout=10) as r:
            got = json.loads(r.read())
        assert got["warehouse_tail"][0]["query_id"] == "q1"
        clear_status_provider(lambda: {})  # a stale clear keeps it
        assert "warehouse_tail" in render_status()
    finally:
        clear_status_provider(provider)
    assert "warehouse_tail" not in render_status()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- dual runs --------------------------------------------------------------

N_SALES = 1 << 12
ROWS = 1024

#: row fields that differ between the packages by design: the texts
#: where they differ (None for every text) and the reason
DIFFERENCES = {
    "fusion.jit_variants": (None,
                            "the reference counts its per-node fused "
                            "XLA program caches; the port runs eager "
                            "PyTorch and kernels built once a source, "
                            "and caches no program per plan, so it "
                            "writes 0 (ROADMAP queue C)"),
    "fingerprint": (("q_like_intl",),
                    "the fingerprint hashes the plan's text, and an "
                    "expression renders differently (the port's "
                    "NOT (x LIKE 'p'), the reference's Not(Like(x))) in "
                    "q_like_intl's island filter; the other texts' "
                    "trees print alike"),
}
#: fields that change from run to run in either package
VOLATILE = ("ts", "query_id", "wall_s", "split", "admission_wait_s")

TEXTS = {
    "q3": (nds.SQL_QUERIES["q3"], {}),
    "q97": (nds.SQL_QUERIES["q97"], {}),
    "q_rank": (nds.SQL_QUERIES["q_rank"], {}),
    "q_like_intl": (fb.SQL_QUERIES["q_like_intl"],
                    fb.CONF["q_like_intl"]),
    # the sort out of core under 16 KiB: runs spilled to sealed files
    "q_sales_sorted": (nm.SQL_QUERIES["q_sales_sorted"],
                       dict(nm.conf_for("q_sales_sorted", 16 << 10),
                            **{"spark.rapids.sql.batchSizeRows": str(ROWS),
                               "spark.rapids.sql.verifyPlan": "false"})),
    # q3 under an OOM storm: halve, spill, width1, the CPU rerun
    "q3_ladder": (nds.SQL_QUERIES["q3"],
                  {"spark.rapids.sql.test.injectRetryOOM.storm": "64",
                   "spark.rapids.sql.oomRetry.maxSplits": "1"}),
}
DUAL = [(q, p) for q in TEXTS for p in (1, 4)]


@pytest.fixture(scope="module")
def nds_paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(N_SALES),
                            str(tmp_path_factory.mktemp("nds")),
                            row_group_size=ROWS)


def _field(row, dotted):
    v = row
    for k in dotted.split("."):
        v = (v or {}).get(k)
    return v


@pytest.mark.parametrize("q,parts", DUAL,
                         ids=[f"{q}-p{p}" for q, p in DUAL])
def test_dual_run_rows_equal_the_reference(nds_paths, tmp_path, q, parts):
    sql, conf = TEXTS[q]
    conf = dict(conf, **{"spark.sql.shuffle.partitions": str(parts),
                         "spark.rapids.memory.spillDir":
                             str(tmp_path / "spill")})
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    got, _ = run_port(sql, nds_paths,
                      dict(conf, **{"spark.rapids.warehouse.dir": pdir}))
    want, _ = run_reference(
        sql, nds_paths, dict(conf, **{"spark.rapids.warehouse.dir": jdir}))
    assert_same_rows(got, want, ordered=False, label=q)
    (prow,), (jrow,) = pwh.read_rows(pdir), jwh.read_rows(jdir)
    # each package's reader reads the other's segments
    assert jwh.read_rows(pdir) == [prow] and pwh.read_rows(jdir) == [jrow]
    for field, (texts, _) in DIFFERENCES.items():
        if texts is not None and q not in texts:
            continue
        top, _, sub = field.partition(".")
        for r in (prow, jrow):
            if sub:
                r[top] = {k: v for k, v in r[top].items() if k != sub}
            else:
                r.pop(top)
    for field in VOLATILE:
        prow.pop(field)
        jrow.pop(field)
    # per-operator rows by op id (each op's time is a clock)
    assert {k: (v["label"], v["rows"]) for k, v in prow.pop("ops").items()} \
        == {k: (v["label"], v["rows"]) for k, v in jrow.pop("ops").items()}
    assert prow == jrow, (q, parts)
    assert _field(prow, "outcome") == (
        "degraded" if q in ("q_like_intl", "q3_ladder") else "completed")
    if q == "q_sales_sorted":
        assert prow["spill"]["disk_write_bytes"] > 0
    if q == "q3_ladder":
        assert prow["ladder"] == {"halve": 1, "spill": 1, "width1": 1,
                                  "cpu": 1}


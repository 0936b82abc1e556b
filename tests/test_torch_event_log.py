"""The port's query event log (``spark_rapids_tpu_torch/tools/
event_log.py``) against the JAX package's (``spark_rapids_tpu/tools/
event_log.py``).

- A collect with ``spark.rapids.eventLog.dir`` set appends one query
  line, which the reference's ``read_event_logs`` reads; beside the
  reference's line for the same text over the same files (2^12 rows, 1
  and 4 partitions) it has the same keys, the same node list (operator,
  depth, placement; the reasons' text aside), the same fingerprint
  (``plan_fingerprint``, now here; ``obs/opmetrics`` re-exports it), the
  same per-operator rows, and the tracer's span rollup when tracing is
  on.
- The typed lines equal the reference's (time stamps and the
  packages' texts aside): ``sql_parse_error`` and ``sql_analysis_error``
  from ``GpuSession.sql``, ``plan_rejected`` from the verifier,
  ``query_cancelled`` from a deadline, the spill tier's
  ``disk_pressure`` (an injected full disk) and ``spill_read_failed`` (a
  corrupt spill file), and ``log_scheduler_events`` over a scheduler's
  summary and events.
- A torn last line is skipped by both readers; the oldest ``app-*``
  files beyond ``spark.rapids.trace.maxFiles`` go at write time.
"""
import json
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.tools import event_log as jel
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.columnar.arrow_bridge import arrow_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import ExecCtx
from spark_rapids_tpu_torch.memory import DeviceMemoryManager, \
    SpillReadError
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.tools import event_log as pel
from torch_dual_run import run_reference


@pytest.fixture(scope="module")
def nds_paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(1 << 12),
                            str(tmp_path_factory.mktemp("nds")),
                            row_group_size=1024)


def _events(d):
    got = list(pel.read_event_logs(str(d)))
    assert got == list(jel.read_event_logs(str(d)))
    return got


def _plan(paths, sql, conf):
    s = nds.session_over_files(paths, conf, device="cpu")
    return GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)


@pytest.mark.parametrize("q,parts", [("q3", 1), ("q3", 4), ("q_rank", 4)])
def test_query_line_equals_reference(nds_paths, tmp_path, q, parts):
    conf = {"spark.sql.shuffle.partitions": str(parts)}
    pdir, jdir = tmp_path / "port", tmp_path / "ref"
    pp = _plan(nds_paths, nds.SQL_QUERIES[q], dict(conf, **{
        "spark.rapids.eventLog.dir": str(pdir),
        "spark.rapids.trace.dir": str(tmp_path / "trace")}))
    pp.collect(ExecCtx(pp.conf, "cpu"))
    run_reference(nds.SQL_QUERIES[q], nds_paths,
                  dict(conf, **{"spark.rapids.eventLog.dir": str(jdir),
                                "spark.rapids.trace.dir":
                                    str(tmp_path / "jtrace")}))
    (got,), (want,) = _events(pdir), _events(jdir)
    assert set(got) == set(want)
    assert [(n["op"], n["depth"], n["on_device"]) for n in got["nodes"]] \
        == [(n["op"], n["depth"], n["on_device"]) for n in want["nodes"]]
    assert got["fingerprint"] == want["fingerprint"] == \
        pel.plan_fingerprint(pp.root)
    assert got["sql_enabled"] is True and got["plan"] == \
        pp.root.tree_string()
    rows = {k: m["rows"] for k, m in got["metrics"].items() if "rows" in m}
    assert rows == {k: m["rows"] for k, m in want["metrics"].items()
                    if "rows" in m}
    assert got["trace"]["spans"] > 0 and "op" in got["trace"]["by_cat"]
    assert got["conf"]["spark.sql.shuffle.partitions"] == str(parts)
    assert [s["op"] for s in got["op_sinks"]]


def test_fingerprint_lives_in_the_event_log():
    from spark_rapids_tpu_torch.obs import opmetrics
    assert opmetrics.plan_fingerprint is pel.plan_fingerprint
    from spark_rapids_tpu_torch.exec.basic import GpuProjectExec
    from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
    from spark_rapids_tpu_torch.expr import Alias, UnresolvedColumn as col

    def build(extra):
        src = HostBatchSourceExec([pa.record_batch(
            {"c0": pa.array([1, 2], pa.int32())})])
        plan = GpuProjectExec([Alias(col("c0"), "x")], src)
        if extra:
            plan = GpuProjectExec([Alias(col("x"), "y")], plan)
        return plan

    assert pel.plan_fingerprint(build(False)) == \
        pel.plan_fingerprint(build(False))
    assert pel.plan_fingerprint(build(False)) != \
        pel.plan_fingerprint(build(True))


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "wall_s")}


@pytest.mark.parametrize("text,slug", [
    ("SELEC 1", "sql_parse_error"),
    ("SELECT nope FROM store_sales", "sql_analysis_error")])
def test_sql_error_lines_equal_reference(nds_paths, tmp_path, text, slug):
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.sql import SqlError as JSqlError
    from spark_rapids_tpu.tools import nds as jnds
    from spark_rapids_tpu_torch.sql import SqlError
    s = nds.session_over_files(
        nds_paths, {"spark.rapids.eventLog.dir": str(tmp_path / "port")},
        device="cpu")
    with pytest.raises(SqlError):
        s.sql(text)
    js = TpuSession(conf={"spark.rapids.eventLog.dir":
                          str(tmp_path / "ref")})
    jnds.register_frames(js, {k: js.read_parquet(p)
                              for k, p in nds_paths.items()})
    with pytest.raises(JSqlError):
        js.sql(text)
    (got,), (want,) = _events(tmp_path / "port"), _events(tmp_path / "ref")
    assert got["type"] == slug
    assert _strip(got) == _strip(want)


def test_plan_rejected_line(tmp_path):
    from spark_rapids_tpu_torch.analysis.plan_verifier import \
        PlanVerificationError
    from spark_rapids_tpu_torch.exec.aqe import GpuAQEShuffleReadExec
    from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
    from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
    from spark_rapids_tpu_torch.shuffle.partitioner import \
        SinglePartitioning
    src = HostBatchSourceExec(
        [pa.record_batch({"a": pa.array([1, 2], pa.int64())})])
    bad = GpuAQEShuffleReadExec(GpuShuffleExchangeExec(
        SinglePartitioning(), src)).with_new_children([src])
    conf = RapidsConf({"spark.rapids.eventLog.dir": str(tmp_path),
                       "spark.sql.adaptive.enabled": "false"})
    with pytest.raises(PlanVerificationError) as err:
        GpuOverrides(conf, "cpu").apply(bad)
    (ev,) = _events(tmp_path)
    assert ev["type"] == "plan_rejected"
    assert ev["report"] == err.value.report.to_dict()
    assert ev["report"]["violations"][0]["reason"] == \
        "malformed_aqe_wrapper"
    assert ev["fingerprint"] == pel.plan_fingerprint(bad)


def test_query_cancelled_line(nds_paths, tmp_path):
    from spark_rapids_tpu_torch.lifecycle import QueryCancelled
    pp = _plan(nds_paths, nds.SQL_QUERIES["q3"], {
        "spark.rapids.eventLog.dir": str(tmp_path),
        "spark.rapids.query.deadline": "1e-9"})
    with pytest.raises(QueryCancelled):
        pp.collect(ExecCtx(pp.conf, "cpu"))
    (ev,) = _events(tmp_path)
    assert {k: ev[k] for k in ("type", "query", "reason", "source",
                               "cluster")} == {
        "type": "query_cancelled", "query": pp.last_qctx.query_id,
        "reason": "deadline", "source": "sql", "cluster": "local"}
    assert ev["detail"].startswith("deadline exceeded")


def _rb(n):
    rng = np.random.default_rng(n)
    return pa.record_batch({"i": pa.array(rng.integers(0, 9, n),
                                          pa.int64())})


@pytest.mark.parametrize("fault", ["disk_full", "corrupt"])
def test_spill_tier_lines(tmp_path, fault):
    from spark_rapids_tpu import memory as jmem
    from spark_rapids_tpu.columnar.arrow_bridge import \
        arrow_to_device as j_arrow_to_device
    extra = ({"spark.rapids.memory.test.injectDiskFull": 2}
             if fault == "disk_full" else
             {"spark.rapids.memory.test.injectSpillFault": "corrupt"})
    lines = []
    for name, cls, mod, to_dev in (
            ("port", RapidsConf, None,
             lambda rb: arrow_to_device(rb, None, torch.device("cpu"))),
            ("ref", JConf, jmem, j_arrow_to_device)):
        conf = cls(dict(extra, **{
            "spark.rapids.eventLog.dir": str(tmp_path / name / "ev"),
            "spark.rapids.memory.spillDir": str(tmp_path / name / "sp"),
            "spark.rapids.memory.device.budgetBytes": 1 << 22}))
        mm = DeviceMemoryManager(conf, "cpu") if mod is None \
            else mod.DeviceMemoryManager(conf)
        sb = mm.register(to_dev(_rb(128)))
        sb.spill(cascade=False)
        if fault == "disk_full":
            assert sb.spill_to_disk() is False
        else:
            assert sb.spill_to_disk()
            err = SpillReadError if mod is None else mod.SpillReadError
            with pytest.raises(err):
                sb.get_host()
        sb.release()
        (ev,) = _events(tmp_path / name / "ev")
        ev = _strip(ev)
        # the spill file's name is a fresh uuid in each package
        name_ok = os.path.basename(ev.pop("path")).startswith("spill")
        assert name_ok
        ev.pop("detail")
        lines.append(ev)
    assert lines[0] == lines[1]
    assert lines[0]["type"] == ("disk_pressure" if fault == "disk_full"
                                else "spill_read_failed")
    assert lines[0]["kind"] == ("enospc" if fault == "disk_full"
                                else "corrupt")


def test_scheduler_lines_and_retention(tmp_path):
    class Sched:
        events = [{"event": "task_ok", "task": "m0"}]
        tracer = None

        def summary(self):
            return {"attempts": 1}

    for mod, cls in ((pel, RapidsConf), (jel, JConf)):
        d = tmp_path / mod.__name__.split(".")[0]
        mod.log_scheduler_events(cls({"spark.rapids.eventLog.dir": str(d)}),
                                 "q1", Sched(), 1.5,
                                 op_sinks=[{"op": "x"}])
    (got,) = _events(tmp_path / "spark_rapids_tpu_torch")
    (want,) = _events(tmp_path / "spark_rapids_tpu")
    assert _strip(got) == _strip(want)
    base = tmp_path / "ret"
    base.mkdir()
    for i in range(7):
        p = base / f"app-{i}-1.jsonl"
        p.write_text(json.dumps({"a": i}) + "\n")
        os.utime(p, (2000 + i, 2000 + i))
    (base / "app-6-1.jsonl").write_text(
        json.dumps({"a": 6}) + "\n" + '{"torn": tru')
    assert [e["a"] for e in _events(base)] == list(range(7))
    pel.log_query_cancelled(
        RapidsConf({"spark.rapids.eventLog.dir": str(base),
                    "spark.rapids.trace.maxFiles": "3"}),
        type("E", (), {"query_id": "q", "reason": "user",
                       "detail": "d"})(), 0.1)
    assert len(os.listdir(base)) == 3

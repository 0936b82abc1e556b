"""The port's flight recorder and anomaly bundles (``spark_rapids_tpu_torch/
obs/recorder.py``, ``obs/anomaly.py``) against the JAX package's.

- The ring: the same records give the same events (time stamps aside)
  and the same drops under the event and byte bounds; a disabled ring
  records nothing; ``snapshot(since=)``; the tracer's span tap.
- The memory ledger: one scripted sequence of registrations, a spill, a
  read-back and releases on both packages' managers (batches with a
  null in every column, where their byte counts agree) records the same
  ``mem`` transitions, and ``memory_timeline`` gives the same high water
  and budget; an OOM retry records ``oom_retry`` and fires the same
  anomaly.
- ``AnomalyDetector.check_task``, ``anomalies_from_scheduler``,
  ``straggler_attribution``, ``conf_delta`` and
  ``build_incident_bundle`` give the reference's output on fixed event
  lists (ids and time stamps aside); ``tools/check_obs_output
  .check_flight`` accepts the port's bundle and the reference's
  ``profiling.triage_report`` renders it.
- Worker rings, flight dumps and incident bundles written by either
  package read back alike through both packages' readers, torn files
  skipped; retention prunes the oldest.
- The engine's events: a planned CPU island's ``plan`` event, the
  verifier's ``plan_rejected``, a cancelled query's ``cancel`` and
  ``cancelled_query``, the ladder's ``degrade`` and ``cpu_fallback``, a
  shuffle fetch failure's ``fetch_failure`` (and its counter).

The ring is process wide: each test clears it first.
"""
import importlib.util
import json
import os
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import memory as jmem
from spark_rapids_tpu.columnar.arrow_bridge import \
    arrow_to_device as j_arrow_to_device
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.obs import anomaly as janom
from spark_rapids_tpu.obs import recorder as jrec
from spark_rapids_tpu_torch import memory as tmem
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.columnar.arrow_bridge import arrow_to_device
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import ExecCtx
from spark_rapids_tpu_torch.obs import anomaly as panom
from spark_rapids_tpu_torch.obs import recorder as prec
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.planner import GpuOverrides

CPU = torch.device("cpu")


def _checker():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "check_obs_output.py")
    spec = importlib.util.spec_from_file_location("check_obs_fl", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_ts(evs):
    return [{k: v for k, v in e.items() if k != "ts"} for e in evs]


@pytest.fixture
def ring():
    """The port's process ring, cleared and at its default bounds."""
    prec.RECORDER.configure(RapidsConf())
    prec.RECORDER.clear()
    yield prec.RECORDER
    prec.RECORDER.configure(RapidsConf())


# --- the ring ---------------------------------------------------------------

def _fill(mod, max_events, max_bytes):
    r = mod.FlightRecorder(max_events=max_events, max_bytes=max_bytes)
    for i in range(12):
        r.record("mem", ev="reserve", bytes=i, detail="x" * (i * 10))
    r.record("span", name="s", cat="op", dur=0.5, pid=0)
    return r


@pytest.mark.parametrize("max_events,max_bytes",
                         [(2048, 1 << 20), (5, 1 << 20), (2048, 700)])
def test_ring_bounds_equal_reference(max_events, max_bytes):
    got, want = _fill(prec, max_events, max_bytes), \
        _fill(jrec, max_events, max_bytes)
    assert _no_ts(got.snapshot()) == _no_ts(want.snapshot())
    assert got.dropped == want.dropped
    assert len(got.snapshot()) <= max_events
    got.clear()
    assert got.snapshot() == [] and got.dropped == 0


def test_ring_disabled_since_and_span_tap(ring):
    ring.configure(RapidsConf({"spark.rapids.flight.enabled": "false",
                               "spark.rapids.flight.maxEvents": "3"}))
    assert not ring.enabled and ring.max_events == 3
    ring.record("mem", ev="x")
    assert ring.snapshot() == []
    ring.configure(RapidsConf())
    ring.record("mem", ev="old")
    t0 = time.time()
    ring.record("mem", ev="new")
    assert [e["ev"] for e in ring.snapshot(since=t0)] == ["new"]
    from spark_rapids_tpu_torch.obs.tracer import Tracer
    t = Tracer()
    with t.span("Op#op1", cat="op"):
        pass
    (tap,) = [e for e in ring.snapshot() if e["kind"] == "span"]
    assert tap["name"] == "Op#op1" and tap["cat"] == "op"


def test_concurrent_updates_lose_nothing():
    """More threads than cores record into one ring and move one counter
    and one histogram, switching every microsecond: no update is lost,
    and the ring's time stamps follow its order."""
    import sys
    import threading
    from spark_rapids_tpu_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    c = reg.counter("rapids_stress_total")
    h = reg.histogram("rapids_stress_seconds")
    rec = prec.FlightRecorder(max_events=1 << 20, max_bytes=1 << 30)
    n_threads, n = (os.cpu_count() or 4) + 2, 300

    def work():
        for i in range(n):
            c.inc()
            h.observe(0.002)
            rec.record("mem", ev="reserve", bytes=i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = reg.snapshot()
    assert snap["rapids_stress_total"]["samples"][""] == n_threads * n
    assert snap["rapids_stress_seconds"]["samples"][""]["count"] == \
        n_threads * n
    evs = rec.snapshot()
    assert len(evs) == n_threads * n and rec.dropped == 0
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)


# --- memory transitions -----------------------------------------------------

def _rb(n, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros(n, bool)
    mask[rng.integers(0, n, max(1, n // 9))] = True
    return pa.record_batch({
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      pa.int32(), mask=mask),
        "d": pa.array(rng.normal(0, 10, n), pa.float64(), mask=mask)})


def _ledger_script(mgr, to_device):
    sbs = [mgr.register(to_device(_rb(n, n))) for n in (64, 200, 96)]
    sbs[1].spill()
    sbs[1].get()
    for sb in sbs:
        sb.release()


def test_memory_transitions_equal_reference(ring, tmp_path):
    conf = {"spark.rapids.memory.device.budgetBytes": 1 << 30,
            "spark.rapids.memory.spillDir": str(tmp_path)}
    jrec.RECORDER.configure(JConf())
    jrec.RECORDER.clear()
    _ledger_script(tmem.DeviceMemoryManager(RapidsConf(conf), CPU),
                   lambda rb: arrow_to_device(rb, None, CPU))
    _ledger_script(jmem.DeviceMemoryManager(JConf(conf)), j_arrow_to_device)
    # this test's managers only (another ledger may release an old
    # query's entries meanwhile)
    got = [e for e in ring.snapshot()
           if e["kind"] == "mem" and e["budget"] == 1 << 30]
    want = [e for e in jrec.RECORDER.snapshot()
            if e["kind"] == "mem" and e["budget"] == 1 << 30]
    assert [e["ev"] for e in got] == ["budget", "reserve", "reserve",
                                      "reserve", "spill", "readback",
                                      "release", "release", "release"]
    assert _no_ts(got) == _no_ts(want)
    tl, jtl = prec.memory_timeline(got), jrec.memory_timeline(want)
    assert tl["high_water_bytes"] == jtl["high_water_bytes"] > 0
    assert tl["budget_bytes"] == jtl["budget_bytes"] == 1 << 30
    assert _no_ts(tl["events"]) == _no_ts(jtl["events"])


def test_oom_retry_recorded_and_fires_the_anomaly(ring, tmp_path):
    mgr = tmem.DeviceMemoryManager(RapidsConf({
        "spark.rapids.sql.test.injectRetryOOM": 1,
        "spark.rapids.memory.spillDir": str(tmp_path)}), CPU)
    before = REGISTRY.snapshot()["rapids_memory_oom_retries_total"][
        "samples"][""]
    outs = mgr.with_retry(arrow_to_device(_rb(8, 1), None, CPU),
                          lambda bb: bb)
    assert len(outs) == 2
    assert REGISTRY.snapshot()["rapids_memory_oom_retries_total"][
        "samples"][""] == before + 1 == before + mgr.oom_retries
    evs = ring.snapshot()
    assert any(e.get("ev") == "oom_retry" for e in evs)
    got = panom.AnomalyDetector().check_task(evs, failed=False)
    assert got == janom.AnomalyDetector().check_task(evs, failed=False)
    assert got[0] == "oom_retry_cascade"


# --- anomalies and bundles --------------------------------------------------

SCHED = [
    {"event": "task_submitted", "task": "t1"},
    {"event": "task_ok", "stage": "map s1", "task": "m0", "attempt": 0,
     "worker": 0, "wall_s": 1.0, "ts": 4.0},
    {"event": "task_ok", "stage": "map s1", "task": "m1", "attempt": 0,
     "worker": 1, "wall_s": 1.2, "ts": 4.5},
    {"event": "task_failed", "stage": "map s1", "task": "m2",
     "attempt": 0, "worker": 1, "ts": 5.0, "wall_s": 0.2,
     "reason": "boom"},
    {"event": "attempt_lost", "task": "t1"},
    {"event": "worker_respawn", "worker": 1, "ts": 6.0, "reason": "died"},
    {"event": "task_ok", "stage": "map s1", "task": "m2", "attempt": 1,
     "worker": 0, "wall_s": 9.0, "ts": 6.5},
    {"event": "straggler_detected", "stage": "map s1", "task": "m3",
     "attempt": 0, "worker": 0, "ts": 7.0, "reason": "slow"},
    {"event": "plan_rejected", "ts": 8.0, "reason": "hbm_over_budget"},
    {"event": "query_cancelled", "ts": 8.5, "reason": "deadline"},
]
TASK_EVENTS = {
    "failed": ([], True, "Boom\nValueError: x"),
    "spill_cascade": ([{"kind": "mem", "ev": "spill"}] * 3, False, ""),
    "one_spill": ([{"kind": "mem", "ev": "spill"}], False, ""),
    "disk_pressure": ([{"kind": "mem", "ev": "disk_pressure",
                        "fail_kind": "enospc"}] * 2, False, ""),
    "spill_failure": ([{"kind": "mem", "ev": "spill_read_failed",
                        "fail_kind": "corrupt"}], False, ""),
    "clean": ([], False, ""),
}


@pytest.mark.parametrize("case", sorted(TASK_EVENTS))
def test_detector_equals_reference(case):
    evs, failed, err = TASK_EVENTS[case]
    for thr in (2, 3):
        got = panom.AnomalyDetector(thr).check_task(evs, failed, err)
        assert got == janom.AnomalyDetector(thr).check_task(
            evs, failed, err)


def test_scheduler_mining_and_conf_delta_equal_reference():
    assert panom.anomalies_from_scheduler(SCHED) == \
        janom.anomalies_from_scheduler(SCHED)
    assert [a["kind"] for a in panom.anomalies_from_scheduler(SCHED)] == [
        "task_failed", "worker_respawn", "straggler_detected",
        "plan_rejected", "query_cancelled"]
    for factor in (4.0, 6.0):
        got = panom.straggler_attribution(SCHED, factor)
        assert got == janom.straggler_attribution(SCHED, factor)
    flagged = {(a["task"], a["attempt"])
               for a in panom.straggler_attribution(SCHED, 4.0)[
                   "map s1"]["flagged"]}
    assert flagged == {("m2", 0), ("m2", 1), ("m3", 0)}
    settings = {"spark.rapids.sql.enabled": "true",
                "spark.sql.shuffle.partitions": "4",
                "spark.rapids.flight.maxEvents": "2048",
                "spark.rapids.warehouse.dir": "/w",
                "some.unregistered.key": "v"}
    got = panom.conf_delta(RapidsConf(settings))
    assert got == janom.conf_delta(JConf(settings))
    assert got == {"spark.sql.shuffle.partitions": "4",
                   "spark.rapids.warehouse.dir": "/w",
                   "some.unregistered.key": "v"}


def _bundle(mod, conf_cls, dumps):
    driver = [{"ts": 9.0, "kind": "mem", "ev": "budget", "budget": 100,
               "device": 0, "host": 0},
              {"ts": 9.5, "kind": "mem", "ev": "reserve", "bytes": 10,
               "device": 10, "host": 0},
              {"ts": 9.6, "kind": "plan", "n_fallbacks": 1,
               "fallbacks": "FilterExec: LIKE"}]
    rings = [("w0:11", {"events": [
        {"ts": 9.9, "kind": "task", "ev": "claim", "task": "m0",
         "attempt": 0},
        {"ts": 9.95, "kind": "mem", "ev": "reserve", "bytes": 40,
         "device": 40, "host": 0, "budget": 100}]})]
    return mod.build_incident_bundle(
        query_id="q1", flight_id="abcd", seq=3,
        trigger_anomalies=mod.anomalies_from_scheduler(SCHED),
        driver_events=driver, worker_rings=rings, worker_dumps=dumps,
        sched_events=SCHED, metrics_snapshot={"driver": {}},
        conf=conf_cls({"spark.sql.shuffle.partitions": "4"}),
        straggler_factor=6.0, since=9.0)


def test_incident_bundle_equals_reference_and_validates(tmp_path):
    dumps = [{"proc": "w1", "task": "m2", "attempt": 0, "ts": 5.0,
              "trigger": "task_failure", "reason": "boom",
              "events": [{"ts": 9.95, "kind": "mem", "ev": "reserve",
                          "bytes": 40, "device": 40, "host": 0,
                          "budget": 100},
                         {"ts": 8.0, "kind": "mem", "ev": "old",
                          "device": 99}]}]
    got = _bundle(panom, RapidsConf, [dict(d) for d in dumps])
    want = _bundle(janom, JConf, [dict(d) for d in dumps])
    got.pop("ts")
    want.pop("ts")
    assert got == want
    assert got["incident_id"] == "incident-abcd-3"
    assert got["memory_timeline"]["high_water_bytes"] == 40
    assert got["plan_fallbacks"][0]["fallbacks"] == "FilterExec: LIKE"
    base = str(tmp_path / "incidents")
    path = prec.write_incident_bundle(base, dict(got, ts=1.0), max_files=2)
    assert _checker().check_flight(path) == []
    os.utime(path, (0, 0))
    from spark_rapids_tpu.tools.profiling import triage_report
    rep = triage_report(json.load(open(path)))
    assert "task_failed" in rep and "high water" in rep
    for i in range(3):
        p = prec.write_incident_bundle(
            base, dict(got, incident_id=f"incident-x-{i}"), max_files=2)
        os.utime(p, (100 + i, 100 + i))
    assert sorted(os.listdir(base)) == ["incident-x-1.json",
                                        "incident-x-2.json"]
    assert prec.next_incident_seq() < prec.next_incident_seq()
    assert prec.resolve_flight_dir(RapidsConf(), "/r") == "/r/flight"
    assert prec.resolve_flight_dir(RapidsConf(
        {"spark.rapids.flight.dir": "/f"})) == "/f"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_worker_files_cross_read(tmp_path, writer):
    mod = prec if writer == "port" else jrec
    rec = mod.FlightRecorder()
    rec.record("task", ev="claim", task="q1s1m0")
    root = str(tmp_path)
    path = mod.flush_worker_ring(root, 0, rec)
    assert mod.flush_worker_ring(root, 0, rec) == path  # nothing new
    fdir, tdir = os.path.join(root, "flight"), os.path.join(root, "tasks")
    os.makedirs(tdir)
    with open(os.path.join(fdir, "w1-12.ring.json"), "w") as f:
        f.write('{"proc": "w1", "events": [{"t')
    with open(os.path.join(fdir, "w2-13.ring.json"), "w") as f:
        json.dump({"proc": "w2", "events": "not-a-list"}, f)
    for name, body in (("q1s1m0.a0.w1.task.flight.json",
                        {"proc": "w1", "task": "q1s1m0", "events": []}),
                       ("q10s1m0.a0.w0.task.flight.json",
                        {"proc": "w0", "task": "q10s1m0", "events": []})):
        with open(os.path.join(tdir, name), "w") as f:
            json.dump(body, f)
    with open(os.path.join(tdir, "q1s1m1.a0.w0.task.flight.json"),
              "w") as f:
        f.write('{"torn":')
    got = prec.read_worker_rings(root)
    assert got == jrec.read_worker_rings(root)
    assert [t for t, _ in got] == [f"w0:{os.getpid()}"]
    assert got[0][1]["events"][0]["task"] == "q1s1m0"
    dumps = prec.read_flight_dumps(tdir, query_id="q1")
    assert dumps == jrec.read_flight_dumps(tdir, query_id="q1")
    assert [d["task"] for d in dumps] == ["q1s1m0"]
    assert prec.prune_oldest(tdir, 1, suffix=".flight.json") == 2


# --- the engine's events ----------------------------------------------------

@pytest.fixture(scope="module")
def nds_paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(1 << 12),
                            str(tmp_path_factory.mktemp("nds")),
                            row_group_size=1024)


def _plan(paths, sql, conf):
    s = nds.session_over_files(paths, conf, device="cpu")
    return GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)


def test_planner_and_verifier_events(ring, nds_paths):
    from spark_rapids_tpu_torch.tools import nds_fallback as fb
    _plan(nds_paths, fb.SQL_QUERIES["q_like_intl"], {})
    (plan,) = [e for e in ring.snapshot() if e["kind"] == "plan"]
    assert plan["n_fallbacks"] == 1
    assert plan["fallbacks"].startswith("FilterExec: ")
    ring.clear()
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
    with pytest.raises(PlanVerificationError) as err:
        GpuOverrides(RapidsConf({"spark.sql.adaptive.enabled": "false"}),
                     "cpu").apply(bad)
    (rej,) = [e for e in ring.snapshot() if e.get("ev") == "plan_rejected"]
    assert rej["kind"] == "plan"
    assert rej["reasons"] == ",".join(err.value.report.reasons())
    assert rej["n_violations"] == len(err.value.report.violations)


def test_lifecycle_events(ring, nds_paths):
    from spark_rapids_tpu_torch.lifecycle import QueryCancelled
    pp = _plan(nds_paths, nds.SQL_QUERIES["q3"],
               {"spark.rapids.query.deadline": "1e-9"})
    with pytest.raises(QueryCancelled):
        pp.collect(ExecCtx(pp.conf, "cpu"))
    evs = [e for e in ring.snapshot() if e["kind"] == "lifecycle"]
    assert [e["ev"] for e in evs] == ["cancel", "cancelled_query"]
    assert {e["reason"] for e in evs} == {"deadline"}
    assert evs[0]["query"] == evs[1]["query"] == pp.last_qctx.query_id
    ring.clear()
    pp = _plan(nds_paths, nds.SQL_QUERIES["q3"], {
        "spark.rapids.sql.test.injectRetryOOM.storm": "64",
        "spark.rapids.sql.oomRetry.maxSplits": "1"})
    pp.collect(ExecCtx(pp.conf, "cpu"))
    evs = [e for e in ring.snapshot() if e["kind"] == "lifecycle"]
    assert [(e["ev"], e.get("rung")) for e in evs] == [
        ("degrade", "spill"), ("degrade", "width1"), ("degrade", "cpu"),
        ("cpu_fallback", None)]
    assert any(e.get("ev") == "oom_retry" for e in ring.snapshot())
    assert any(e.get("ev") == "forced_spill" for e in ring.snapshot())


def test_sorted_high_water_passes_budget_in_both_packages(ring, nds_paths,
                                                          tmp_path):
    """The out-of-core sort under a budget smaller than a scan batch:
    each package's ledger charges the scan's in-flight batches, which it
    cannot evict, so in both rings the high water passes the budget."""
    from spark_rapids_tpu_torch.tools import nds_memory as nm
    from torch_dual_run import assert_same_rows, run_port, run_reference
    budget = 16 << 10
    conf = dict(nm.conf_for("q_sales_sorted", budget), **{
        "spark.rapids.sql.batchSizeRows": "1024",
        "spark.rapids.sql.verifyPlan": "false",
        "spark.rapids.flight.maxEvents": str(1 << 20),
        "spark.rapids.flight.maxBytes": str(1 << 30),
        "spark.rapids.memory.spillDir": str(tmp_path)})
    sql = nm.SQL_QUERIES["q_sales_sorted"]
    jrec.RECORDER.clear()
    try:
        got, _ = run_port(sql, nds_paths, conf)
        want, _ = run_reference(sql, nds_paths, conf)
        jevs = jrec.RECORDER.snapshot()
    finally:
        jrec.RECORDER.configure(JConf())
    assert_same_rows(got, want, ordered=True, label="q_sales_sorted")
    tl = prec.memory_timeline(
        [e for e in ring.snapshot() if e.get("budget") == budget])
    jtl = jrec.memory_timeline([e for e in jevs if e.get("budget") == budget])
    assert tl["budget_bytes"] == jtl["budget_bytes"] == budget
    assert tl["high_water_bytes"] > budget
    assert jtl["high_water_bytes"] > budget
    # both ledgers end empty
    assert tl["events"][-1]["device"] == jtl["events"][-1]["device"] == 0


def test_fetch_failure_event_and_counter(ring):
    from spark_rapids_tpu.shuffle import transport as jtr
    from spark_rapids_tpu_torch.shuffle import transport as ptr
    before = REGISTRY.counter(
        "rapids_shuffle_fetch_failures_total", "", ("kind",)) \
        .labels("corrupt").value
    ff = ptr.FetchFailure(3, "q1s1m0", "/x/blocks/p2.blk", "corrupt", "crc")
    ptr.record_fetch_failure(ff, 2, "host")
    assert REGISTRY.counter("rapids_shuffle_fetch_failures_total", "",
                            ("kind",)).labels("corrupt").value == before + 1
    jrec.RECORDER.configure(JConf())
    jrec.RECORDER.clear()
    jtr.record_fetch_failure(
        jtr.FetchFailure(3, "q1s1m0", "/x/blocks/p2.blk", "corrupt", "crc"),
        2, "host")
    assert _no_ts(e for e in ring.snapshot() if e["kind"] == "shuffle") \
        == _no_ts(jrec.RECORDER.snapshot())

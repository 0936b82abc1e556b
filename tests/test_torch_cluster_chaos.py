"""The process cluster's recovery paths under deterministic chaos
(``spark.rapids.tpu.test.injectFaults``), on the CPU with real worker
processes: the port's counterparts of ``tests/test_scheduler.py``'s
crash, hang, delay with speculation and persistent-failure tests and of
``tests/test_shuffle_recovery.py``'s corrupt, drop, eio and rerun-budget
tests, plus ``oom_storm`` and ``slow_admission``. Each holds the rows to
a pyarrow oracle, and the outcome (a retry, a lineage rerun or a raise)
to what the reference's test asserts. One cluster serves the module, the
faults riding each query's conf; its fixture's finalizer shuts it down,
and every query runs under a small stage timeout."""
import json
import os

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.cluster import GpuProcessCluster
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec
from spark_rapids_tpu_torch.exec.exchange import GpuShuffleExchangeExec
from spark_rapids_tpu_torch.expr import Alias, UnresolvedColumn as col
from spark_rapids_tpu_torch.expr.aggregates import Count, Sum
from spark_rapids_tpu_torch.lifecycle import QueryCancelled
from spark_rapids_tpu_torch.shuffle.partitioner import HashPartitioning

BASE = {"spark.rapids.tpu.scheduler.stageTimeout": "60",
        "spark.rapids.tpu.task.timeout": "60"}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = GpuProcessCluster(
        n_workers=2, device="cpu",
        root=str(tmp_path_factory.mktemp("chaos")),
        conf=RapidsConf(dict(BASE, **{
            "spark.rapids.tpu.heartbeat.interval": "0.2"})))
    yield c
    c.shutdown()


def _batches(sizes=((300, 1), (250, 2))):
    out = []
    for n, seed in sizes:
        rng = np.random.default_rng(seed)
        k = rng.integers(0, 21, n).astype(np.int32)
        out.append(pa.record_batch({
            "k": pa.array(k, mask=rng.random(n) < 0.1),
            "v": pa.array(rng.integers(-1000, 1000, n).astype(np.int64))}))
    return out


def _agg_plan(rbs, nparts=4):
    exch = GpuShuffleExchangeExec(HashPartitioning([col("k")], nparts),
                                  HostBatchSourceExec(rbs))
    return GpuHashAggregateExec(
        [col("k")], [Alias(Sum(col("v")), "s"),
                     Alias(Count(col("v")), "c")], exch)


def _oracle(rbs):
    g = pa.Table.from_batches(rbs).group_by("k").aggregate(
        [("v", "sum"), ("v", "count")])
    return g.select(["k", "v_sum", "v_count"]).rename_columns(
        ["k", "s", "c"])


def _rows(t):
    return sorted(t.to_pylist(), key=lambda d: tuple(
        (v is None, str(v)) for v in d.values()))


def _events(sched, kind, task=None):
    return [e for e in sched.events if e["event"] == kind
            and (task is None or e["task"] == task)]


def _run(cluster, faults, extra=None, rbs=None):
    """One query under ``faults`` (``{q}`` and ``{s}`` stand for its
    query and first shuffle ids): its rows checked against the oracle;
    returns the scheduler and the map task ids."""
    rbs = rbs or _batches()
    q, s = cluster._query_seq + 1, cluster._sid_seq + 1
    conf = RapidsConf(dict(BASE, **(extra or {}), **{
        "spark.rapids.tpu.test.injectFaults": faults.format(q=q, s=s)}))
    got = cluster.run_query(_agg_plan(rbs), conf)
    assert _rows(got) == _rows(_oracle(rbs).cast(got.schema))
    return cluster.last_scheduler, f"q{q}s{s}m0", f"q{q}s{s}m1"


def test_crash_midmap_retries_on_a_respawned_worker(cluster, tmp_path):
    log_dir = str(tmp_path / "events")
    sched, m0, _ = _run(cluster, "crash:q{q}s{s}m0:0",
                        {"spark.rapids.eventLog.dir": log_dir})
    failed = _events(sched, "task_failed", m0)
    assert failed and "worker died" in failed[0]["reason"]
    assert _events(sched, "task_ok", m0)[0]["attempt"] >= 1
    assert _events(sched, "worker_respawn")
    assert not _events(sched, "speculative_attempt")
    evs = [json.loads(line) for p in os.listdir(log_dir)
           for line in open(os.path.join(log_dir, p))]
    sched_evs = [e for e in evs if e.get("type") == "scheduler"]
    assert sched_evs and sched_evs[0]["summary"]["failures"] >= 1


def test_hang_past_the_heartbeat_recovers(cluster):
    sched, m0, _ = _run(cluster, "hang:q{q}s{s}m0:0",
                        {"spark.rapids.tpu.heartbeat.timeout": "2.0"})
    failed = _events(sched, "task_failed", m0)
    assert failed and "heartbeat stale" in failed[0]["reason"]
    assert _events(sched, "worker_respawn")
    assert _events(sched, "task_ok", m0)[0]["attempt"] >= 1


def test_delay_speculation_keeps_one_commit(cluster):
    rbs = _batches(((300, 1), (250, 2), (411, 3)))
    sched, m0, _ = _run(cluster, "delay:q{q}s{s}m0:0:4.0", {
        "spark.rapids.tpu.speculation": "true",
        "spark.rapids.tpu.speculation.multiplier": "1.5",
        "spark.rapids.tpu.speculation.minRuntime": "1.0"}, rbs)
    assert _events(sched, "speculative_attempt", m0)
    assert len(_events(sched, "task_ok", m0)) == 1
    sdir = os.path.join(cluster.root, "shuffle", f"s{m0.split('s')[1][:-2]}")
    committed = [n for n in os.listdir(sdir)
                 if n.startswith(m0) and n.endswith(".mapout")]
    assert len(committed) == 1


def test_corrupt_output_reruns_its_map_task_from_lineage(cluster,
                                                         tmp_path):
    sched, m0, _ = _run(cluster, "corrupt:q{q}s{s}m0:0", {
        "spark.rapids.metrics.enabled": "true",
        "spark.rapids.flight.dir": str(tmp_path / "incidents")})
    ffs = _events(sched, "fetch_failed")
    assert len(ffs) == 1 and "[corrupt]" in ffs[0]["reason"]
    assert m0 in ffs[0]["reason"]
    assert len(_events(sched, "stage_rerun", m0)) == 1
    assert [e["attempt"] for e in _events(sched, "task_ok", m0)] == [0, 1]
    assert not _events(sched, "task_failed")
    assert sched.summary()["fetch_failures"] == 1
    assert sched.summary()["stage_reruns"] == 1
    prom = cluster.prometheus_text()
    assert 'rapids_shuffle_fetch_failures_total{kind="corrupt"' in prom
    assert 'rapids_shuffle_stage_reruns_total{proc="driver"}' in prom
    incident = cluster.last_incident_path
    assert incident and os.path.exists(incident)
    with open(incident) as f:
        kinds = {a["kind"] for a in json.load(f)["anomalies"]}
    assert {"fetch_failed", "stage_rerun"} <= kinds


def test_dropped_output_and_a_crash_both_recover(cluster):
    sched, m0, m1 = _run(cluster, "drop:q{q}s{s}m0:0;crash:q{q}s{s}m1:0")
    failed = _events(sched, "task_failed", m1)
    assert failed and "worker died" in failed[0]["reason"]
    ffs = _events(sched, "fetch_failed")
    assert len(ffs) == 1 and "[missing]" in ffs[0]["reason"]
    assert len(_events(sched, "stage_rerun", m0)) == 1


def test_transient_eio_recovers_in_place(cluster):
    sched, _, _ = _run(cluster, "eio:q{q}s{s}m*:0:2", {
        "spark.rapids.shuffle.fetch.maxRetries": "4",
        "spark.rapids.shuffle.fetch.retryWaitMs": "5"})
    assert not _events(sched, "fetch_failed")
    assert not _events(sched, "stage_rerun")
    assert not _events(sched, "task_failed")


def test_persistent_eio_escalates_to_a_rerun(cluster):
    sched, m0, _ = _run(cluster, "eio:q{q}s{s}m0:0:50", {
        "spark.rapids.shuffle.fetch.maxRetries": "1",
        "spark.rapids.shuffle.fetch.retryWaitMs": "5"})
    ffs = _events(sched, "fetch_failed")
    assert ffs and "[io]" in ffs[0]["reason"]
    assert len(_events(sched, "stage_rerun", m0)) == 1


def test_rerun_budget_exhaustion_fails_the_query(cluster):
    with pytest.raises(RuntimeError, match="maxStageRetries"):
        _run(cluster, "drop:q{q}s{s}m0:0",
             {"spark.rapids.shuffle.maxStageRetries": "0"})
    sched = cluster.last_scheduler
    assert _events(sched, "fetch_failed")
    assert not _events(sched, "stage_rerun")


def test_persistent_task_failure_exhausts_attempts(cluster):
    from spark_rapids_tpu_torch import datatypes as dt
    from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
    schema = dt.Schema([dt.StructField("x", dt.INT64, True)])
    missing = GpuFileScanExec(["/nonexistent/x.parquet"], schema=schema)
    exch = GpuShuffleExchangeExec(HashPartitioning([col("x")], 2), missing)
    plan = GpuHashAggregateExec([], [Alias(Count(col("x")), "c")], exch)
    conf = RapidsConf(dict(BASE, **{
        "spark.rapids.tpu.task.maxAttempts": "2",
        "spark.rapids.tpu.scheduler.maxTaskFailuresPerWorker": "1"}))
    with pytest.raises(RuntimeError,
                       match="worker task .* failed after 2 attempts"):
        cluster.run_query(plan, conf)
    sched = cluster.last_scheduler
    assert len(_events(sched, "task_failed")) == 2
    assert _events(sched, "worker_blacklisted")
    assert not _events(sched, "fetch_failed")
    assert not _events(sched, "stage_rerun")


def test_oom_storm_is_absorbed_by_split_and_retry(cluster):
    """The storm's injected OOMs ride the final task's conf: its
    aggregate splits and retries (the worker's registry counts the
    retries) and the query's rows stand, with no task failure."""
    name = "rapids_memory_oom_retries_total"
    before = cluster.worker_counter(name)
    q = cluster._query_seq + 1
    sched, _, _ = _run(cluster, f"oom_storm:q{q}r*:0:2",
                       {"spark.rapids.metrics.enabled": "true"})
    assert not _events(sched, "task_failed")
    assert cluster.worker_counter(name) - before >= 2


def test_slow_admission_trips_the_admission_deadline(cluster):
    q = cluster._query_seq + 1
    conf = RapidsConf(dict(BASE, **{
        "spark.rapids.tpu.test.injectFaults": f"slow_admission:q{q}:0:1.0",
        "spark.rapids.query.admission.timeout": "0.3"}))
    with pytest.raises(QueryCancelled) as e:
        cluster.run_query(_agg_plan(_batches()), conf)
    assert e.value.reason == "admission"
    assert _events(cluster.last_scheduler, "query_cancelled")

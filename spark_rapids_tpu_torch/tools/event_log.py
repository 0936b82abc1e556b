"""Query event logs: the run record the offline tools read.

Counterpart of ``spark_rapids_tpu/tools/event_log.py``. With
``spark.rapids.eventLog.dir`` set, every ``PhysicalPlan.collect()``
appends one JSON line describing the query (``log_query_event``): the
plan tree, each node's placement and fallback reasons, the per-operator
metrics and top time sinks, the wall time, the conf, and the tracer's
span rollup when tracing is on. The other writers append one typed line
each: ``plan_rejected`` (the plan verifier refused the plan),
``sql_parse_error`` / ``sql_analysis_error`` (``GpuSession.sql``),
``query_cancelled`` (the lifecycle layer stopped the query) and the
spill tier's ``disk_pressure``, ``spill_write_failed`` and
``spill_read_failed`` (``memory.py``). ``log_scheduler_events`` is the
process cluster's (``cluster.py``) and needs only an object with the
scheduler's ``summary()`` and ``events``.

One file a process and directory (``app-<pid>-<ms>.jsonl``), append
only, pruned past ``spark.rapids.trace.maxFiles`` at write time;
``read_event_logs`` skips a torn last line. ``plan_fingerprint`` names a
query's shape across runs.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional

from ..config import register

__all__ = ["EVENT_LOG_DIR", "log_query_event", "log_scheduler_events",
           "log_plan_rejected", "log_sql_error", "log_query_cancelled",
           "log_spill_event", "read_event_logs", "plan_fingerprint"]

EVENT_LOG_DIR = register(
    "spark.rapids.eventLog.dir", "",
    "When set, every collect() appends a JSON-line query event "
    "(plan, placement, metrics, wall time) under this directory — the "
    "input to the offline qualification and profiling tools.")

_APP_FILE: Dict[tuple, str] = {}


def _app_path(base: str) -> str:
    key = (os.getpid(), os.path.abspath(base))
    if key not in _APP_FILE:
        os.makedirs(base, exist_ok=True)
        _APP_FILE[key] = os.path.join(
            base, f"app-{key[0]}-{int(time.time() * 1000)}.jsonl")
    return _APP_FILE[key]


def _prune_event_logs(conf, base: str) -> None:
    """Write-time retention (``spark.rapids.trace.maxFiles``, shared
    with the trace directory): the oldest ``app-*.jsonl`` beyond it go;
    the file just appended is the newest."""
    from ..obs.recorder import prune_oldest
    from ..obs.tracer import TRACE_MAX_FILES
    prune_oldest(base, conf.get(TRACE_MAX_FILES), prefix="app-",
                 suffix=".jsonl")


def plan_fingerprint(root) -> str:
    """Stable id for 'the same query shape' across runs: a hash of the
    operator tree with per-instance labels stripped."""
    import hashlib
    import re
    text = re.sub(r"#\d+", "", root.tree_string())
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def log_query_event(pp, ctx, wall_s: float) -> None:
    """Append one query event; pp is the PhysicalPlan, ctx the ExecCtx
    collect() used. No-op unless spark.rapids.eventLog.dir is set."""
    base = pp.conf.get(EVENT_LOG_DIR)
    if not base:
        return
    nodes = []

    def rec(meta, depth):
        nodes.append({
            "op": meta.node.pretty_name(),
            "depth": depth,
            "on_device": meta.on_device,
            "reasons": meta.reasons,
        })
        for c in meta.children:
            rec(c, depth + 1)

    rec(pp.meta, 0)
    # fold the deferred device row counts in first: every caller sits at
    # or after the query's download, which already synced
    opm = getattr(ctx, "opm", None) if ctx is not None else None
    if opm is not None:
        opm.finalize()
    metrics = {
        label: {name: m.value for name, m in ms.items()}
        for label, ms in (ctx.metrics if ctx else {}).items()}
    # the top per-operator time sinks ride the line itself, so a reader
    # gets operator attribution without the query's profile file
    op_sinks = []
    if metrics:
        from ..obs.opmetrics import fold_snapshots, top_op_sinks
        op_sinks = top_op_sinks(fold_snapshots([{"ops": metrics}]))
    event = {
        "ts": time.time(),
        "fingerprint": plan_fingerprint(pp.root),
        "wall_s": round(wall_s, 6),
        "sql_enabled": pp.conf.sql_enabled,
        "nodes": nodes,
        "metrics": metrics,
        "op_sinks": op_sinks,
        "conf": {k: str(v) for k, v in pp.conf.items().items()},
        "plan": pp.root.tree_string(),
    }
    tr = getattr(ctx, "tracer", None) if ctx is not None else None
    if tr is not None and getattr(tr, "enabled", False):
        # span rollup (counts and seconds by category, trace_id): ties
        # this line to its Chrome trace file
        event["trace"] = tr.summary()
    with open(_app_path(base), "a") as f:
        f.write(json.dumps(event, default=str) + "\n")
    _prune_event_logs(pp.conf, base)


def log_plan_rejected(conf, report, root, query_id: str = "") -> None:
    """Append one plan_rejected event: the static verifier refused to
    run this plan, the record of why a query never started. No-op
    unless spark.rapids.eventLog.dir is set."""
    base = conf.get(EVENT_LOG_DIR)
    if not base:
        return
    event = {
        "type": "plan_rejected",
        "ts": time.time(),
        "query": query_id,
        "fingerprint": plan_fingerprint(root),
        "report": report.to_dict(),
        "plan": root.tree_string(),
    }
    with open(_app_path(base), "a") as f:
        f.write(json.dumps(event) + "\n")
    _prune_event_logs(conf, base)


def log_sql_error(conf, err, sql_text: str) -> None:
    """Append one SQL frontend failure event (type = the error's
    stable slug, ``sql_parse_error`` / ``sql_analysis_error``) with
    line/col, detail code, and caret snippet — the "why didn't my SQL
    run" record, mirroring ``plan_rejected``. No-op unless
    spark.rapids.eventLog.dir is set."""
    base = conf.get(EVENT_LOG_DIR)
    if not base:
        return
    event = dict(err.to_dict())
    event["ts"] = time.time()
    event["sql"] = sql_text[:4000]
    with open(_app_path(base), "a") as f:
        f.write(json.dumps(event) + "\n")
    _prune_event_logs(conf, base)


def log_query_cancelled(conf, err, wall_s: float,
                        source: str = "plan",
                        cluster: str = "local") -> None:
    """Append one query_cancelled event: the lifecycle layer stopped
    this query — classified (user | deadline | budget | admission),
    mirroring ``plan_rejected`` as the "why didn't my query finish"
    record. ``err`` is the QueryCancelled. No-op unless
    spark.rapids.eventLog.dir is set."""
    base = conf.get(EVENT_LOG_DIR)
    if not base:
        return
    event = {
        "type": "query_cancelled",
        "ts": time.time(),
        "query": getattr(err, "query_id", ""),
        "reason": getattr(err, "reason", "user"),
        "detail": getattr(err, "detail", "")[:500],
        "wall_s": round(wall_s, 6),
        "source": source,
        "cluster": cluster,
    }
    with open(_app_path(base), "a") as f:
        f.write(json.dumps(event) + "\n")
    _prune_event_logs(conf, base)


def log_spill_event(conf, type_: str, **fields) -> None:
    """Append one spill-tier durability event — ``spill_write_failed``
    (a non-ENOSPC OSError refused a spill write), ``spill_read_failed``
    (a committed spill file failed its verified read-back, classified
    missing|corrupt|torn|io), or ``disk_pressure`` (ENOSPC or the live
    disk-residency budget refused the write; the batch stayed
    host-resident) — mirroring the shuffle tier's ``fetch_failed``
    evidence. No-op unless spark.rapids.eventLog.dir is set."""
    base = conf.get(EVENT_LOG_DIR)
    if not base:
        return
    event = {"type": type_, "ts": time.time()}
    event.update({k: v for k, v in fields.items() if v is not None})
    with open(_app_path(base), "a") as f:
        f.write(json.dumps(event) + "\n")
    _prune_event_logs(conf, base)


def log_scheduler_events(conf, query_id: str, sched, wall_s: float,
                         op_sinks: Optional[List[Dict]] = None) -> None:
    """Append one scheduler event per cluster query: the attempt
    timeline (submit/ok/failed/lost/speculative, worker deaths,
    respawns, blacklists) plus a rollup — what the profiler mines for
    retry overhead — and the query's top per-operator time sinks
    (cross-worker folded opmetrics). No-op unless
    spark.rapids.eventLog.dir is set."""
    base = conf.get(EVENT_LOG_DIR)
    if not base:
        return
    event = {
        "type": "scheduler",
        "ts": time.time(),
        "query": query_id,
        "wall_s": round(wall_s, 6),
        "summary": sched.summary(),
        "attempts": sched.events,
        "op_sinks": op_sinks or [],
    }
    tr = getattr(sched, "tracer", None)
    if tr is not None and getattr(tr, "enabled", False):
        event["trace"] = tr.summary()
    with open(_app_path(base), "a") as f:
        f.write(json.dumps(event) + "\n")
    _prune_event_logs(conf, base)


def read_event_logs(path: str) -> Iterator[dict]:
    """Every parseable event under a log dir (or a single file); torn
    trailing lines from crashed writers are skipped."""
    files: List[str] = []
    if os.path.isdir(path):
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.endswith(".jsonl")]
    elif os.path.exists(path):
        files = [path]
    for fp in files:
        with open(fp) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write

"""Per-operator runtime metrics: operator ids, the counting shims'
collector, the fused-stage timer, EXPLAIN ANALYZE and query profiles.

Counterpart of ``spark_rapids_tpu/obs/opmetrics.py``:

- **stable operator ids**: the planner stamps every node of a rebuilt
  plan with a pre-order ``_op_id`` (``assign_op_ids``), so one operator
  keeps one label (``<Op>#op<N>``, ``GpuExec.node_label``) across deep
  copies, pickles and runs of the same plan; a plan that never met the
  planner keeps the process-local ``#<counter>`` labels.
- **always-on accounting**: ``exec/base.py`` wraps every operator's
  ``execute``/``execute_cpu`` with a shim that adds rows, batches and
  output bytes (and the ``cpuFallback`` flag on the CPU path) under the
  node's label. A batch whose live rows are a device-side selection
  leaves its count on the device; ``OpMetricsCollector.finalize`` reads
  them all in one batched copy at the query's download, with no sync of
  its own (a non-blocking copy into pinned memory and an event wait).
- **the fused-stage timer**: a fused stage's launch returns before the
  device is done, so ``defer_stage_time`` records a CUDA event on the
  current stream at the stage's end and hands ``(metric, t0, event)`` to
  one process-wide watcher thread, which waits on the event and measures
  from the stage's host start to the device's completion. The query
  thread applies the measurements at the drain barrier in ``finalize``
  (no cross-thread ``+=`` on a live metric). A CPU context adds the wall
  time at once. On the card a failure to record or wait raises; the
  reference's 30 s escape for a wedged watcher stays, and every stamp
  is counted by kind (``OpMetricsCollector.stamps``).
- **cross-task folding** (``fold_snapshots``; ``flush_task_opmetrics``
  and ``read_task_opmetrics``, the file half of the cluster's harvest),
  **EXPLAIN ANALYZE** (``render_analyzed``) and **query profiles**
  (``build_profile``/``write_profile``/``read_profiles``: one
  ``profile-<id>.json`` a query under ``spark.rapids.history.dir``,
  pruned past ``spark.rapids.trace.maxFiles``, which ``obs/tracer.py``
  registers). ``plan_fingerprint`` lives in ``tools/event_log.py`` and
  ``prune_oldest`` in ``obs/recorder.py``; both are importable here.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import RapidsConf, register
from ..tools.event_log import plan_fingerprint
from .recorder import prune_oldest
from .tracer import TRACE_MAX_FILES

__all__ = ["OP_METRICS_ENABLED", "HISTORY_DIR", "HISTORY_ENABLED",
           "OpMetricsCollector", "assign_op_ids",
           "plan_source", "snapshot_ctx", "fold_ctx", "fold_snapshots",
           "flush_task_opmetrics", "read_task_opmetrics",
           "render_analyzed", "plan_nodes", "top_op_sinks",
           "plan_fingerprint", "build_profile", "write_profile",
           "read_profiles", "prune_oldest"]

OP_METRICS_ENABLED = register(
    "spark.rapids.metrics.op.enabled", True,
    "Always-on per-operator metric accounting (rows, batches, output "
    "bytes, CPU-fallback flags) on every executed operator, and the "
    "fused stages' opTime to device completion, feeding EXPLAIN "
    "ANALYZE and query profiles. Recording is a few integer adds a "
    "batch plus one batched copy of the device-side row counts at the "
    "query's download; disable only to rule it out while measuring.")
HISTORY_ENABLED = register(
    "spark.rapids.history.enabled", True,
    "Write one query-profile JSON per executed query (plan with stable "
    "operator ids + folded per-operator metrics) when "
    "spark.rapids.history.dir is set.")
HISTORY_DIR = register(
    "spark.rapids.history.dir", "",
    "Directory for persistent query profiles (profile-<id>.json, one "
    "per query, spark.rapids.trace.maxFiles retention). Empty disables "
    "profile history.")

#: metric names rendered as times (seconds, shown in ms)
_TIME_METRICS = frozenset((
    "opTime", "spillTime", "uploadTime", "uploadWaitTime", "scanTime",
    "assembleTime", "downloadTime", "writeTime", "concatTime",
    "ledgerWaitTime", "dispatchTime"))

#: identifiers and flags (folded by max across tasks), not accumulators
_IDENTITY_METRICS = frozenset(("fusedInto", "fusedChainOps",
                               "cpuFallback"))

#: how long a drain barrier waits for the watcher before it is declared
#: wedged (the reference's bound)
_DRAIN_TIMEOUT_S = 30.0

# the process-wide fused-stage watcher: one daemon thread, started at
# the first deferral (a thread a collector would leak one a query)
_STAGE_TIMEQ: Optional["queue.Queue"] = None
_STAGE_TIMER_LOCK = threading.Lock()
# set when a drain barrier times out: the watcher is stuck behind an
# event that never completes, so later stages add their wall time,
# each such stamp counted as "wedged"
_STAGE_TIMER_WEDGED = False


def _stage_timer_queue() -> "queue.Queue":
    global _STAGE_TIMEQ
    if _STAGE_TIMEQ is None:
        with _STAGE_TIMER_LOCK:
            if _STAGE_TIMEQ is None:
                q: "queue.Queue" = queue.Queue()
                threading.Thread(target=_stage_timer_loop, args=(q,),
                                 name="opm-stage-timer",
                                 daemon=True).start()
                _STAGE_TIMEQ = q
    return _STAGE_TIMEQ


def _stage_timer_loop(q: "queue.Queue") -> None:
    while True:
        item = q.get()
        if isinstance(item, threading.Event):
            item.set()  # a finalize's drain barrier
            continue
        collector, metric, t0, event = item
        item = None
        try:
            event.synchronize()
            done = time.perf_counter()
            result = (metric, done - t0, None)
        except BaseException as e:  # noqa: BLE001 — raised on the query
            result = (metric, 0.0, e)  # thread at its drain barrier
        event = None
        # measured here, applied on the query thread at the barrier
        with collector._times_lock:
            collector._stage_results.append(result)


class OpMetricsCollector:
    """The per-query collector the execute shims feed (module
    docstring). ``stamps`` counts how each fused stage's time was taken:
    ``event`` (a CUDA event the watcher waited on), ``cpu`` (a CPU
    context's synchronous add), ``wall`` (a device stage's wall add
    with op metrics off) and ``wedged`` (a wall add after the watcher
    was declared stuck)."""

    __slots__ = ("enabled", "_pending", "_active", "_deferred_times",
                 "_stage_results", "_times_lock", "stamps")

    def __init__(self, conf: Optional[RapidsConf] = None):
        conf = conf or RapidsConf()
        self.enabled = conf.get(OP_METRICS_ENABLED)
        self._pending: List[Tuple[object, torch.Tensor]] = []
        # label -> the claim of the counting shim live on this query's
        # stack: an execute that delegates to a wrapped super()
        # implementation, or runs a copy of its node (a CPU island's
        # body, a CPU reroute), counts each batch once
        self._active: Dict[str, object] = {}
        self._deferred_times = False
        self._stage_results: List[Tuple[object, float, object]] = []
        self._times_lock = threading.Lock()
        self.stamps = {"event": 0, "cpu": 0, "wall": 0, "wedged": 0}

    def enter(self, node):
        """Claim accounting for one node's execution: the claim, or None
        when a shim of a node with the same label already counts (the
        inner frame passes through)."""
        key = node.node_label()
        if key in self._active:
            return None
        claim = self._active[key] = object()
        return claim

    def exit(self, node, claim) -> None:
        """Release ``claim``; a claim a discarded attempt left is gone
        already and releases nothing."""
        key = node.node_label()
        if self._active.get(key) is claim:
            del self._active[key]

    def count_rows(self, metric, batch) -> None:
        """Add a device batch's live rows to ``metric`` without a sync:
        the host row count when there is no selection, else the
        selection's popcount, left on the device until ``finalize``."""
        sel = batch.selection
        if sel is None:
            metric.value += batch.row_count
            return
        live = sel[:batch.row_count].sum()
        if live.device.type != "cuda":
            metric.value += int(live)
            return
        self._pending.append((metric, live))

    # --- the fused-stage timer ------------------------------------------

    def add_wall_time(self, metric, t0: float, kind: str) -> None:
        """The synchronous stamp: wall time from ``t0`` to now, counted
        under ``kind`` (``cpu`` or ``wall``)."""
        metric.value += time.perf_counter() - t0
        self.stamps[kind] += 1

    def defer_stage_time(self, metric, t0: float, device) -> None:
        """Attribute the time from ``t0`` to the device's completion of
        the work queued so far on ``device``'s current stream to
        ``metric`` (module docstring). Raises if the event cannot be
        recorded."""
        if _STAGE_TIMER_WEDGED:
            metric.value += time.perf_counter() - t0
            self.stamps["wedged"] += 1
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        _stage_timer_queue().put((self, metric, t0, event))
        self._deferred_times = True
        self.stamps["event"] += 1

    def _drain_stage_times(self) -> None:
        """Barrier the watcher (FIFO: every stage this query queued is
        measured before the barrier is set) and apply the measurements
        on this thread; a wait the watcher failed raises here."""
        if not self._deferred_times:
            return
        self._deferred_times = False
        barrier = threading.Event()
        _stage_timer_queue().put(barrier)
        if not barrier.wait(timeout=_DRAIN_TIMEOUT_S):
            global _STAGE_TIMER_WEDGED
            _STAGE_TIMER_WEDGED = True
        with self._times_lock:
            results, self._stage_results = self._stage_results, []
        error = None
        for metric, secs, e in results:
            if e is not None:
                error = error or e
                continue
            metric.value += secs
        if error is not None:
            raise error

    def finalize(self) -> None:
        """Apply the watcher's stage times, then read every deferred
        row count in one non-blocking copy a device (into pinned memory,
        then an event wait: the download before it already synced)."""
        self._drain_stage_times()
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        by_device: Dict[torch.device, List[int]] = {}
        for i, (_, v) in enumerate(pending):
            by_device.setdefault(v.device, []).append(i)
        for dev, idx in by_device.items():
            host = torch.stack([pending[i][1] for i in idx]).to(
                "cpu", non_blocking=True)
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                done.synchronize()
            for i, v in zip(idx, host.tolist()):
                pending[i][0].value += int(v)

    def discard(self) -> None:
        """Drop a failed attempt's deferred row counts and its shims'
        claims (a generator the failure left suspended may be closed
        only later, and must not hold its node's label)."""
        self._pending = []
        self._active.clear()


def plan_source(root) -> str:
    """``sql`` when a node of the tree was compiled by the SQL front end
    (``sql_to_plan`` marks its root), else ``plan``."""
    stack, seen = [root], set()
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if getattr(n, "_sql_origin", False):
            return "sql"
        stack.extend(getattr(n, "children", ()))
    return "plan"


# --- stable operator ids ----------------------------------------------------

def assign_op_ids(root, force: bool = False) -> None:
    """Stamp every node with a stable pre-order id (1-based). An aliased
    subtree (one node under two parents) keeps one id; copies carry
    their ids. No-op when the root is stamped already, unless
    ``force``."""
    if not force and getattr(root, "_op_id", None) is not None:
        return
    seen = set()
    counter = [0]

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        counter[0] += 1
        node._op_id = counter[0]
        for c in getattr(node, "children", ()):
            walk(c)

    walk(root)


def _fold_key(label: str) -> str:
    """The stable ``op<N>`` part of a label when present, else the
    label."""
    if "#op" in label:
        return "op" + label.rsplit("#op", 1)[1]
    return label


# --- snapshots and folding --------------------------------------------------

def snapshot_ctx(ctx) -> Dict[str, Dict[str, float]]:
    """One query's per-operator metrics as plain numbers (the deferred
    row counts finalized first)."""
    opm = getattr(ctx, "opm", None)
    if opm is not None:
        opm.finalize()
    return {label: {name: m.value for name, m in ms.items()}
            for label, ms in ctx.metrics.items()}


def fold_snapshots(snaps: Sequence[Dict]) -> Dict[str, Dict]:
    """Fold snapshots (``{"task": ..., "ops": {label: {m: v}}}`` or bare
    ``{label: {m: v}}``) into ``{"op3": {"label", "metrics" (totals),
    "max" (per-task maxima), "tasks", "skew"}}``; ``skew`` is max over
    mean of the tasks' opTime. A snapshot that is not a mapping, or an
    entry that is not one, is skipped."""
    agg: Dict[str, Dict] = {}
    for snap in snaps:
        ops = snap.get("ops", snap) if isinstance(snap, dict) else {}
        if not isinstance(ops, dict):
            continue
        for label, ms in ops.items():
            if not isinstance(ms, dict):
                continue
            key = _fold_key(label)
            st = agg.setdefault(key, {"label": label, "metrics": {},
                                      "max": {}, "tasks": 0,
                                      "_op_times": []})
            if label < st["label"]:
                st["label"] = label
            st["tasks"] += 1
            for name, v in ms.items():
                if not isinstance(v, (int, float)):
                    continue
                if name in _IDENTITY_METRICS:
                    st["metrics"][name] = max(st["metrics"].get(name, 0), v)
                else:
                    st["metrics"][name] = st["metrics"].get(name, 0) + v
                if v > st["max"].get(name, float("-inf")):
                    st["max"][name] = v
            t = ms.get("opTime", 0.0)
            st["_op_times"].append(float(t) if isinstance(
                t, (int, float)) else 0.0)
    for st in agg.values():
        ts = st.pop("_op_times")
        mean = sum(ts) / len(ts) if ts else 0.0
        st["skew"] = round(max(ts) / mean, 2) if mean > 0 else 1.0
    return agg


def fold_ctx(ctx) -> Dict[str, Dict]:
    """The single-process fold: one snapshot, tasks=1."""
    return fold_snapshots([{"ops": snapshot_ctx(ctx)}])


def top_op_sinks(folded: Dict[str, Dict], n: int = 3) -> List[Dict]:
    """The ``n`` operators with the most opTime: ``{"op", "time_s",
    "rows"}``."""
    ranked = sorted(folded.values(),
                    key=lambda st: -st["metrics"].get("opTime", 0.0))
    out = []
    for st in ranked[:n]:
        t = st["metrics"].get("opTime", 0.0)
        if t <= 0:
            continue
        out.append({"op": st["label"], "time_s": round(t, 6),
                    "rows": int(st["metrics"].get("rows", 0))})
    return out


# --- task snapshot files ----------------------------------------------------

def flush_task_opmetrics(task_path: str, ctx, task_id: str,
                         attempt: int) -> Optional[str]:
    """Commit one task attempt's snapshot as ``<task_path>.opm.json``
    (written to a temporary name, then renamed). Returns the path, or
    None when op metrics are off or the write failed: accounting never
    fails a task."""
    opm = getattr(ctx, "opm", None)
    if opm is None or not opm.enabled:
        return None
    try:
        doc = {"task": task_id, "attempt": attempt,
               "ops": snapshot_ctx(ctx)}
        tmp = task_path + ".opm.json.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, task_path + ".opm.json")
        return task_path + ".opm.json"
    except OSError:
        return None


def read_task_opmetrics(tasks_dir: str,
                        winners: Sequence[Tuple[str, int, int]]) \
        -> List[Dict]:
    """The snapshots of the winning attempts, one per ``(task_id,
    attempt, worker)``; a missing or torn file is skipped."""
    out: List[Dict] = []
    for task_id, attempt, worker in winners:
        path = os.path.join(
            tasks_dir, f"{task_id}.a{attempt}.w{worker}.task.opm.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("ops"), dict):
            out.append(doc)
    return out


# --- rendering --------------------------------------------------------------

def _fmt_metric(name: str, v) -> str:
    if name in _TIME_METRICS:
        return f"{name}={v * 1e3:.2f}ms"
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    if name in ("outputBytes", "inputBytes") and v >= 10 << 20:
        return f"{name}={v / (1 << 20):.1f}MB"
    return f"{name}={v}"


_COMPACT_METRICS = ("rows", "batches", "opTime", "spillTime",
                    "uploadWaitTime", "ledgerWaitTime", "deviceChunks",
                    "fallbackChunks", "fusedDispatches", "scanPrograms")


def render_analyzed(root, folded: Dict[str, Dict],
                    wall_s: Optional[float] = None,
                    formatted: bool = False,
                    cluster: str = "local") -> str:
    """The EXPLAIN ANALYZE text: the executed tree, each node tagged by
    its id and annotated with its folded metrics (``formatted``: every
    metric; else the compact set). A node with no metrics of its own is
    marked as fused into a parent stage; a node that ran on the CPU
    ends in ``[CPU]``."""
    head = f"== Analyzed Physical Plan ({cluster}"
    if wall_s is not None:
        head += f", {wall_s * 1e3:.1f} ms"
    head += ") =="
    lines = [head]
    seen = set()

    def key_for(node):
        oid = getattr(node, "_op_id", None)
        return f"op{oid}" if oid is not None else node.node_label()

    def walk(node, depth):
        pad = "  " * depth
        label = node.node_label()
        st = folded.get(key_for(node)) or folded.get(label)
        tag = label.rsplit("#", 1)[1] if "#op" in label else label
        if st is None:
            ann = "[not executed directly: fused into a parent stage]"
        else:
            m = dict(st["metrics"])
            on_cpu = m.pop("cpuFallback", None) is not None
            fused_into = m.pop("fusedInto", None)
            chain_ops = m.pop("fusedChainOps", None)
            names = list(m) if formatted else \
                [n for n in _COMPACT_METRICS if n in m]
            parts = []
            if fused_into is not None:
                parts.append(f"fused into op{int(fused_into)}'s program")
            if chain_ops is not None and (formatted or chain_ops > 1):
                parts.append(f"fusedChainOps={int(chain_ops)}")
            parts += [_fmt_metric(n, m[n]) for n in names]
            if st.get("tasks", 1) > 1:
                parts.append(f"tasks={st['tasks']}")
                mx = st["max"].get("opTime")
                if mx:
                    parts.append(f"maxTaskOpTime={mx * 1e3:.2f}ms")
                parts.append(f"skew={st.get('skew', 1.0)}")
            ann = "[" + ", ".join(parts) + "]" + (" [CPU]" if on_cpu
                                                  else "")
        lines.append(f"{pad}{node.describe()} ({tag})  {ann}")
        if id(node) in seen:
            return  # an aliased subtree: its children once
        seen.add(id(node))
        for c in getattr(node, "children", ()):
            walk(c, depth + 1)

    walk(root, 0)
    return "\n".join(lines)


def plan_nodes(root) -> List[Dict]:
    """The plan as a flat pre-order list of ``{"depth", "label", "op",
    "describe"}``: the profile's plan record."""
    out = []

    def walk(node, depth):
        out.append({"depth": depth, "label": node.node_label(),
                    "op": node.pretty_name(),
                    "describe": node.describe()})
        for c in getattr(node, "children", ()):
            walk(c, depth + 1)

    walk(root, 0)
    return out


# --- query profiles ---------------------------------------------------------

def _device_kind(device) -> str:
    """The card's name for a CUDA context, ``cpu`` for a CPU one."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def build_profile(root, folded: Dict[str, Dict], wall_s: float,
                  query: str = "", source: str = "plan",
                  cluster: str = "local",
                  trace_id: Optional[str] = None,
                  conf: Optional[RapidsConf] = None,
                  extra: Optional[Dict] = None,
                  device=None) -> Dict:
    """One query's profile document; ``device_kind`` names the hardware
    the numbers were taken on (the card's name, or ``cpu``)."""
    pid = trace_id or uuid.uuid4().hex[:16]
    doc = {
        "version": 1,
        "profile_id": f"profile-{pid}",
        "ts": time.time(),
        "query": query,
        "source": source,
        "cluster": cluster,
        "wall_s": round(wall_s, 6),
        "device_kind": _device_kind(device),
        "fingerprint": plan_fingerprint(root),
        "nodes": plan_nodes(root),
        "ops": folded,
        "conf": {k: str(v) for k, v in (conf.items() if conf else {})
                 .items()},
    }
    if extra:
        doc.update(extra)
    return doc


def write_profile(conf: RapidsConf, doc: Dict) -> Optional[str]:
    """Commit one profile under ``spark.rapids.history.dir`` (temporary
    name, then rename) and prune past ``spark.rapids.trace.maxFiles``;
    None when history is off or the write failed."""
    base = conf.get(HISTORY_DIR)
    if not base or not conf.get(HISTORY_ENABLED):
        return None
    try:
        os.makedirs(base, exist_ok=True)
        path = os.path.join(base, doc["profile_id"] + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        prune_oldest(base, conf.get(TRACE_MAX_FILES),
                     prefix="profile-", suffix=".json")
        return path
    except OSError:
        return None


def read_profiles(path: str) -> List[Tuple[str, Dict]]:
    """Every readable profile under a history directory (or one file),
    oldest first; a torn file is skipped."""
    files: List[str] = []
    if os.path.isdir(path):
        files = [os.path.join(path, n) for n in sorted(os.listdir(path))
                 if n.startswith("profile-") and n.endswith(".json")]
    elif os.path.exists(path):
        files = [path]
    out: List[Tuple[str, Dict]] = []
    for fp in files:
        try:
            with open(fp) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("ops"), dict):
            out.append((fp, doc))
    out.sort(key=lambda t: t[1].get("ts", 0.0))
    return out

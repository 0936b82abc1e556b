"""Flight recorder: the always-on bounded black box.

Counterpart of ``spark_rapids_tpu/obs/recorder.py``. The tracer and the
metrics endpoint record only what was switched on before a query
started; this ring records with both off. One process-wide
``RECORDER`` keeps recent events, bounded by count and by approximate
bytes (the oldest go first, each counted in ``dropped``):

- span closures (``Tracer._record`` taps the ring while tracing is on);
- memory-ledger transitions (``memory.py``: reserve, release, spill,
  disk spill, read-back, OOM retry, with the device and host bytes in
  use after each, the HBM timeline ``memory_timeline`` replays);
- lifecycle events (``lifecycle.py``: cancel, degrade; ``planner.py``:
  the cancelled query, the CPU rerun), the planner's fallbacks and the
  verifier's refusals (``kind`` ``plan``), shuffle fetch failures.

The file half is here too: a worker's ring flushed to
``<root>/flight/w<K>-<pid>.ring.json`` (``flush_worker_ring``,
``read_worker_rings``), a failed task's ``<task>.flight.json`` dumps
(``read_flight_dumps``), and incident bundles written atomically under
``spark.rapids.flight.dir`` with write-time retention
(``write_incident_bundle``, ``prune_oldest``). The process cluster
(``cluster.py``) calls them.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..config import (FLIGHT_DIR, FLIGHT_ENABLED, FLIGHT_MAX_BYTES,
                      FLIGHT_MAX_EVENTS, RapidsConf)

__all__ = ["FlightRecorder", "RECORDER", "flush_worker_ring",
           "read_worker_rings", "read_flight_dumps", "memory_timeline",
           "write_incident_bundle", "resolve_flight_dir", "prune_oldest",
           "next_incident_seq"]

_EVENT_OVERHEAD = 48  # dict + ts + kind, approximate


def _approx_size(fields: Dict) -> int:
    n = _EVENT_OVERHEAD
    for k, v in fields.items():
        n += len(k) + (len(v) if isinstance(v, str) else 8)
    return n


class FlightRecorder:
    """Bounded (entries and bytes) append-only ring of recent events.
    ``record`` is one small dict and a deque append under a short lock;
    eviction is oldest first and counted, never an error."""

    def __init__(self, max_events: int = 2048, max_bytes: int = 1 << 20):
        self.enabled = True
        self.max_events = max_events
        self.max_bytes = max_bytes
        self.dropped = 0
        self._bytes = 0
        self._total = 0  # records ever: the ring flush's dirty mark
        self._ring: "deque[Tuple[Dict, int]]" = deque()
        self._lock = threading.Lock()

    def configure(self, conf: RapidsConf) -> None:
        """Adopt a query's ``spark.rapids.flight.*`` settings (process
        wide: the last configurer wins; the knobs are bounds)."""
        self.enabled = conf.get(FLIGHT_ENABLED)
        self.max_events = max(1, conf.get(FLIGHT_MAX_EVENTS))
        self.max_bytes = max(1024, conf.get(FLIGHT_MAX_BYTES))

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        sz = _approx_size(fields)
        with self._lock:
            # stamped under the lock: append order is time order
            ev = {"ts": time.time(), "kind": kind}
            ev.update(fields)
            self._ring.append((ev, sz))
            self._bytes += sz
            self._total += 1
            while self._ring and (len(self._ring) > self.max_events
                                  or self._bytes > self.max_bytes):
                _, s0 = self._ring.popleft()
                self._bytes -= s0
                self.dropped += 1

    def record_span(self, span) -> None:
        """The tracer's tap: a span's name, category and extent; its
        args stay out of the ring (they can be unbounded)."""
        if not self.enabled:
            return
        self.record("span", name=span.name, cat=span.cat,
                    dur=round(span.dur, 6), pid=span.pid)

    def snapshot(self, since: Optional[float] = None) -> List[Dict]:
        with self._lock:
            evs = [e for e, _ in self._ring]
        if since is not None:
            evs = [e for e in evs if e["ts"] >= since]
        return evs

    def clear(self) -> None:
        """Empty the ring (tests)."""
        with self._lock:
            self._ring.clear()
            self._bytes = 0
            self.dropped = 0


RECORDER = FlightRecorder()


# --- memory timeline ---------------------------------------------------------

def memory_timeline(events: List[Dict]) -> Dict:
    """The HBM timeline a ring (or several merged) implies: the ledger
    transitions in time order, the high-water device occupancy and the
    budget. Each process owns its device, so the high water is the worst
    single process's; ``per_proc`` splits it by the events' ``proc`` tag
    (untagged events are one series)."""
    mem = sorted((e for e in events if e.get("kind") == "mem"),
                 key=lambda e: e.get("ts", 0.0))
    per_proc: Dict[str, Dict[str, int]] = {}
    for e in mem:
        p = per_proc.setdefault(str(e.get("proc", "")),
                                {"high_water_bytes": 0,
                                 "budget_bytes": 0})
        p["high_water_bytes"] = max(p["high_water_bytes"],
                                    int(e.get("device", 0) or 0))
        if e.get("budget"):
            p["budget_bytes"] = int(e["budget"])
    high = max((p["high_water_bytes"] for p in per_proc.values()),
               default=0)
    budget = max((p["budget_bytes"] for p in per_proc.values()),
                 default=0)
    return {"events": mem, "high_water_bytes": high,
            "budget_bytes": budget, "per_proc": per_proc}


# --- worker-side persistence -------------------------------------------------
# A crash cannot write at death, so a worker flushes its ring to a file
# tagged with its pid when it claims a task and after each; a respawned
# worker writes a new file, and the dead one's last flush survives.

def _flight_root(root: str) -> str:
    return os.path.join(root, "flight")


_flush_marks: Dict[Tuple[str, int, int], int] = {}
_FLUSH_TAIL_EVENTS = 512  # the ring's tail a flush serializes


def flush_worker_ring(root: str, worker_id: int,
                      recorder: Optional[FlightRecorder] = None) -> str:
    """Write the ring's tail to ``<root>/flight/w<K>-<pid>.ring.json``
    (temporary name, then rename); a ring that has not grown since the
    last flush is not written again."""
    rec = recorder or RECORDER
    d = _flight_root(root)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"w{worker_id}-{os.getpid()}.ring.json")
    key = (root, worker_id, os.getpid())
    mark = rec._total
    if _flush_marks.get(key) == mark and os.path.exists(path):
        return path
    doc = {"proc": f"w{worker_id}", "pid": os.getpid(),
           "ts": time.time(), "dropped": rec.dropped,
           "events": rec.snapshot()[-_FLUSH_TAIL_EVENTS:]}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    _flush_marks[key] = mark
    # one file a respawn: bounded, the recent dead incarnations kept
    prune_oldest(d, 32, suffix=".ring.json")
    return path


def read_worker_rings(root: str) -> List[Tuple[str, Dict]]:
    """Every worker ring under the root, tagged ``w<K>:<pid>``; a torn
    file is skipped."""
    d = _flight_root(root)
    out: List[Tuple[str, Dict]] = []
    try:
        names = sorted(os.listdir(d))
    except FileNotFoundError:
        return out
    for n in names:
        if not n.endswith(".ring.json"):
            continue
        try:
            with open(os.path.join(d, n)) as f:
                doc = json.load(f)
            tag = f"{doc.get('proc', n)}:{doc.get('pid', '?')}"
            if not isinstance(doc.get("events"), list):
                continue
            out.append((tag, doc))
        except (OSError, json.JSONDecodeError):
            continue
    return out


def read_flight_dumps(tasks_dir: str,
                      query_id: str = "") -> List[Dict]:
    """The ``<task>.flight.json`` dumps under ``tasks_dir``, only one
    query's when ``query_id`` is given (``q1`` does not claim ``q10``'s);
    a torn file is skipped."""
    out: List[Dict] = []
    try:
        names = sorted(os.listdir(tasks_dir))
    except FileNotFoundError:
        return out
    for n in names:
        if not n.endswith(".flight.json"):
            continue
        if query_id and not (n.startswith(query_id)
                             and len(n) > len(query_id)
                             and not n[len(query_id)].isdigit()):
            continue
        try:
            with open(os.path.join(tasks_dir, n)) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or "task" not in doc:
                continue
            out.append(doc)
        except (OSError, json.JSONDecodeError):
            continue
    return out


# --- incident bundles --------------------------------------------------------

_seq_lock = threading.Lock()
_seq = 0


def next_incident_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def resolve_flight_dir(conf: RapidsConf,
                       cluster_root: Optional[str] = None) -> str:
    """``spark.rapids.flight.dir``, else ``<cluster root>/flight``, else
    empty."""
    d = conf.get(FLIGHT_DIR)
    if d:
        return d
    if cluster_root:
        return _flight_root(cluster_root)
    return ""


def write_incident_bundle(base_dir: str, bundle: Dict,
                          max_files: int = 200) -> str:
    """Commit one incident bundle (temporary name, then rename) and prune
    the oldest beyond ``max_files``."""
    os.makedirs(base_dir, exist_ok=True)
    path = os.path.join(base_dir, bundle["incident_id"] + ".json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f)
    os.replace(tmp, path)
    prune_oldest(base_dir, max_files, prefix="incident-", suffix=".json")
    return path


# --- retention ---------------------------------------------------------------

def prune_oldest(base_dir: str, keep: int, prefix: str = "",
                 suffix: str = "") -> int:
    """Unlink the oldest matching files beyond ``keep`` (by mtime);
    returns how many went (a file another pruner removed first is
    skipped)."""
    try:
        names = [n for n in os.listdir(base_dir)
                 if n.startswith(prefix) and n.endswith(suffix)]
    except OSError:
        return 0
    if len(names) <= keep:
        return 0
    entries = []
    for n in names:
        p = os.path.join(base_dir, n)
        try:
            entries.append((os.stat(p).st_mtime, n, p))
        except OSError:
            continue
    entries.sort()
    pruned = 0
    for _, _, p in entries[:max(0, len(entries) - keep)]:
        try:
            os.unlink(p)
            pruned += 1
        except OSError:
            pass
    return pruned

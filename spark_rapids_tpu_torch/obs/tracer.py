"""Span tracer with cross-process stitching.

Counterpart of ``spark_rapids_tpu/obs/tracer.py``. One ``Tracer`` a
query: ``PhysicalPlan.collect`` opens the ``query`` span (its args carry
the plan's fingerprint), and every operator's execute shim
(``exec/base.py``) opens an ``op`` span a call, named by the operator's
label and carrying its stable ``op_id``. Spans nest through a
thread-local stack; ``emit`` records a span whose extent is known after
the fact, and ``absorb`` merges spans another process serialized (the
process cluster's workers, ``cluster.py``). ``write_chrome`` writes one
Chrome ``trace_event`` JSON a query under ``spark.rapids.trace.dir``
(chrome://tracing or Perfetto), with write-time retention.

A span's length is host time: an ``op`` span lasts from the operator's
first batch request to its last batch, its children's included; the
device's time stays in the fused stages' ``opTime``, which a CUDA event
stamps (``obs/opmetrics.py``). Wall-clock ``time.time()`` stamps a
span's start and ``time.perf_counter()`` its duration. With
``spark.rapids.trace.dir`` unset ``tracer_from_conf`` returns
``NULL_TRACER``, whose ``span()`` is one shared no-op context manager.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional

from ..config import register
from .recorder import RECORDER as _FLIGHT, prune_oldest

__all__ = ["TRACE_DIR", "TRACE_MAX_SPANS", "TRACE_MAX_FILES", "Span",
           "Tracer", "NULL_TRACER", "tracer_from_conf", "spans_to_chrome",
           "load_chrome_trace"]

TRACE_DIR = register(
    "spark.rapids.trace.dir", "",
    "When set, every query records query/stage/operator spans (driver "
    "AND process-cluster workers, stitched via a propagated trace "
    "context) and writes one Chrome trace_event JSON under this "
    "directory — open it in chrome://tracing or Perfetto. Off by "
    "default; the disabled tracer is a shared no-op.")
TRACE_MAX_SPANS = register(
    "spark.rapids.trace.maxSpans", 100_000,
    "Per-tracer span buffer bound; spans past it are dropped and "
    "counted (trace JSON metadata reports dropped_spans) so a "
    "pathological query cannot exhaust driver memory.")
TRACE_MAX_FILES = register(
    "spark.rapids.trace.maxFiles", 200,
    "On-disk retention for spark.rapids.trace.dir and "
    "spark.rapids.eventLog.dir: at write time the oldest files beyond "
    "this count are pruned (atomic unlinks), so a long-lived session "
    "cannot accumulate trace/event JSONs without bound.")


class Span:
    """One closed span; plain data, serialized as a dict."""

    __slots__ = ("name", "cat", "span_id", "parent_id", "ts", "dur",
                 "pid", "args")

    def __init__(self, name: str, cat: str, span_id: str,
                 parent_id: Optional[str], ts: float, dur: float,
                 pid: int, args: Optional[Dict] = None):
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts = ts            # wall-clock start, seconds since epoch
        self.dur = dur          # seconds
        self.pid = pid          # 0 = driver, worker K = K + 1
        self.args = args or {}

    def to_dict(self) -> Dict:
        return {"name": self.name, "cat": self.cat, "span_id": self.span_id,
                "parent_id": self.parent_id, "ts": self.ts,
                "dur": self.dur, "pid": self.pid, "args": self.args}

    @staticmethod
    def from_dict(d: Dict) -> "Span":
        return Span(d["name"], d.get("cat", "default"), d["span_id"],
                    d.get("parent_id"), d["ts"], d["dur"],
                    d.get("pid", 0), d.get("args") or {})


class _LiveSpan:
    """Context manager for an in-flight span; ``span_id`` can be handed
    to children in other processes."""

    __slots__ = ("_tracer", "name", "cat", "span_id", "parent_id",
                 "args", "_ts", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 parent_id: Optional[str], args: Optional[Dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.span_id = tracer._next_id()
        self.parent_id = parent_id
        self.args = args

    def __enter__(self) -> "_LiveSpan":
        stack = self._tracer._stack()
        if self.parent_id is None and stack:
            self.parent_id = stack[-1]
        stack.append(self.span_id)
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        elif self.span_id in stack:
            # an operator's generator closed after a sibling opened (a
            # consumer that stopped early): its id must not stay behind
            # as the parent of later spans
            stack.remove(self.span_id)
        self._tracer._record(Span(self.name, self.cat, self.span_id,
                                  self.parent_id, self._ts, dur,
                                  self._tracer.pid, self.args))
        return False


class _NullSpan:
    """Shared no-op span: the cost of tracing when it is off."""

    __slots__ = ()
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded span collector for one process's share of a trace."""

    enabled = True

    def __init__(self, trace_id: Optional[str] = None, pid: int = 0,
                 max_spans: int = 100_000, id_prefix: str = "",
                 max_files: int = 200):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.pid = pid
        # span-id namespace: a worker prefixes its ids with the attempt,
        # so two attempts on one worker cannot mint the same id
        self.id_prefix = id_prefix
        self.max_spans = max_spans
        self.max_files = max_files
        self.spans: List[Span] = []
        self.dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # --- recording --------------------------------------------------------

    def _stack(self) -> List[str]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{self.id_prefix}{self.pid}.{self._seq}"

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
            else:
                self.spans.append(span)
        # the flight recorder's tap (it records without the tracer too)
        _FLIGHT.record_span(span)

    def span(self, name: str, cat: str = "default",
             parent_id: Optional[str] = None,
             args: Optional[Dict] = None) -> _LiveSpan:
        """Live span context manager; nests through the thread's stack
        unless ``parent_id`` pins its parent."""
        return _LiveSpan(self, name, cat, parent_id, args)

    def current_span_id(self) -> Optional[str]:
        """This thread's innermost open span."""
        s = self._stack()
        return s[-1] if s else None

    def emit(self, name: str, cat: str, ts: float, dur: float,
             span_id: Optional[str] = None,
             parent_id: Optional[str] = None, pid: Optional[int] = None,
             args: Optional[Dict] = None) -> str:
        """A span whose extent is already known; a given ``span_id``
        lets other processes parent onto it before it is emitted."""
        sid = span_id or self._next_id()
        self._record(Span(name, cat, sid, parent_id, ts, dur,
                          self.pid if pid is None else pid, args))
        return sid

    def absorb(self, span_dicts: List[Dict]) -> None:
        """Merge spans another process serialized; a torn entry is
        skipped."""
        for d in span_dicts:
            try:
                self._record(Span.from_dict(d))
            except (KeyError, TypeError):
                continue

    # --- export -----------------------------------------------------------

    def drain(self) -> List[Dict]:
        with self._lock:
            out = [s.to_dict() for s in self.spans]
        return out

    def summary(self) -> Dict:
        """Span counts and seconds by category, for the event log."""
        by_cat: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for s in self.spans:
                c = by_cat.setdefault(s.cat, {"spans": 0, "total_s": 0.0})
                c["spans"] += 1
                c["total_s"] = round(c["total_s"] + s.dur, 6)
            n = len(self.spans)
        return {"trace_id": self.trace_id, "spans": n,
                "dropped": self.dropped, "by_cat": by_cat}

    def write_chrome(self, base_dir: str,
                     name: Optional[str] = None) -> str:
        """Write one Chrome trace_event JSON (temporary name, then
        rename) and prune the oldest traces past ``max_files``; returns
        its path."""
        os.makedirs(base_dir, exist_ok=True)
        fname = name or f"trace-{self.trace_id}.json"
        path = os.path.join(base_dir, fname)
        doc = spans_to_chrome(self.drain(), self.trace_id, self.dropped)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        prune_oldest(base_dir, self.max_files, prefix="trace-",
                     suffix=".json")
        return path


def spans_to_chrome(span_dicts: List[Dict], trace_id: str,
                    dropped: int = 0) -> Dict:
    """Chrome trace_event JSON: complete (``X``) events in microseconds
    from the earliest span, one process a role (driver, worker K) named
    by ``M`` events; the span, parent and trace ids ride in ``args``."""
    events = []
    t0 = min((d["ts"] for d in span_dicts), default=0.0)
    pids = set()
    for d in span_dicts:
        pids.add(d.get("pid", 0))
        events.append({
            "name": d["name"], "cat": d.get("cat", "default"), "ph": "X",
            "ts": round((d["ts"] - t0) * 1e6, 3),
            "dur": round(d["dur"] * 1e6, 3),
            "pid": d.get("pid", 0), "tid": 0,
            "args": dict(d.get("args") or {}, span_id=d["span_id"],
                         parent_id=d.get("parent_id"), trace_id=trace_id),
        })
    for pid in sorted(pids):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "driver" if pid == 0
                     else f"worker {pid - 1}"}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace_id, "dropped_spans": dropped,
                          "epoch_origin_s": t0}}


def load_chrome_trace(path: str) -> List[Dict]:
    """A written trace back as span dicts (seconds)."""
    with open(path) as f:
        doc = json.load(f)
    t0 = float(doc.get("otherData", {}).get("epoch_origin_s", 0.0))
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        out.append({"name": ev["name"], "cat": ev.get("cat", "default"),
                    "span_id": args.pop("span_id", None),
                    "parent_id": args.pop("parent_id", None),
                    "ts": t0 + float(ev["ts"]) / 1e6,
                    "dur": float(ev["dur"]) / 1e6,
                    "pid": ev.get("pid", 0), "args": args})
    return out


class _NullTracer:
    """Tracing off: every call is a no-op and ``span()`` returns one
    shared context manager."""

    enabled = False
    trace_id = ""
    pid = 0
    spans: List[Span] = []
    dropped = 0

    def span(self, name, cat="default", parent_id=None, args=None):
        return _NULL_SPAN

    def current_span_id(self):
        return None

    def emit(self, *a, **kw):
        return None

    def absorb(self, span_dicts):
        pass

    def drain(self):
        return []

    def summary(self):
        return {}

    def write_chrome(self, base_dir, name=None):
        return ""


NULL_TRACER = _NullTracer()


def tracer_from_conf(conf, pid: int = 0, trace_id: Optional[str] = None):
    """A live ``Tracer`` when ``spark.rapids.trace.dir`` is set, else
    ``NULL_TRACER``."""
    if not conf.get(TRACE_DIR):
        return NULL_TRACER
    return Tracer(trace_id=trace_id, pid=pid,
                  max_spans=conf.get(TRACE_MAX_SPANS),
                  max_files=conf.get(TRACE_MAX_FILES))

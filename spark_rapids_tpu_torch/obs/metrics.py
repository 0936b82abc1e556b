"""Process-wide metrics registry with Prometheus text exposition.

Counterpart of ``spark_rapids_tpu/obs/metrics.py``. The engine's layers
move process-wide counters, gauges and histograms that can be read at
any moment, not only from a finished query's record:

- one module-level ``REGISTRY`` a process (the port's own: the JAX
  package's registry is another object);
- **bounded label sets**: a family keeps at most ``MAX_CHILDREN`` label
  combinations, and the rest share one ``__other__`` series;
- recording is attribute arithmetic under one short lock, always on;
  the exporters are what the conf gates: ``spark.rapids.metrics.port``
  serves ``/metrics`` (Prometheus text) and ``/status`` (JSON) on
  ``127.0.0.1``; ``spark.rapids.metrics.enabled`` makes each process
  cluster worker rewrite its registry's snapshot after every task
  (``flush_worker_metrics``), which the driver reads
  (``read_worker_metrics``) into ``GpuProcessCluster.prometheus_text``
  through ``render_merged_snapshots`` (a ``proc`` label each) and into
  the warehouse row's byte and spill deltas.

The families and where they move: ``rapids_query_duration_seconds``
(``planner.py``), ``rapids_memory_*``, ``rapids_disk_spill_in_use_bytes``
and ``rapids_spill_*`` (``memory.py``), ``rapids_query_cancelled_total``,
``rapids_query_degraded_total`` and ``rapids_admission_*``
(``lifecycle.py``), ``rapids_scan_*`` (``io/scan.py``) and
``rapids_shuffle_fetch_failures_total`` (``shuffle/transport.py``).
"""
from __future__ import annotations

import bisect
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import register

__all__ = ["METRICS_ENABLED", "METRICS_PORT", "MetricsRegistry",
           "REGISTRY", "QUERY_DURATION", "dump_prometheus",
           "maybe_start_http_server", "render_snapshot",
           "render_merged_snapshots", "DEFAULT_BUCKETS",
           "TRANSFER_BUCKETS", "render_status", "set_status_provider",
           "clear_status_provider", "flush_worker_metrics",
           "read_worker_metrics"]

METRICS_ENABLED = register(
    "spark.rapids.metrics.enabled", False,
    "Flush each cluster worker's metrics registry through the "
    "filesystem rendezvous (root/metrics/w<K>.json, rewritten after "
    "every task) so GpuProcessCluster.prometheus_text() can serve a "
    "driver-side aggregate with per-process 'proc' labels.")
METRICS_PORT = register(
    "spark.rapids.metrics.port", 0,
    "When > 0, serve this process's metrics registry as Prometheus "
    "text on http://127.0.0.1:<port>/metrics (tiny stdlib HTTP "
    "server, daemon thread, started lazily by the first query). "
    "0 disables.")

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   float("inf"))
# Finer low end for per-batch transfer-stage timings (scan assemble /
# upload): a batch's staging and copy take hundreds of microseconds to
# tens of milliseconds, which DEFAULT_BUCKETS lumps into two buckets.
TRANSFER_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                    0.05, 0.1, 0.25, 0.5, 1.0, 5.0, float("inf"))
MAX_CHILDREN = 64
_OTHER = "__other__"

# one short lock for every sample update: `self.value += v` is a
# LOAD/ADD/STORE triple the GIL can split, and shuffle counters are hit
# from the multithreaded writer pool — lock-free increments would
# silently undercount. One shared lock (not per-child) keeps children
# at one slot each; contention is negligible at metric update rates.
_update_lock = threading.Lock()


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with _update_lock:
            self.value += v


class _Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        # one store: a gauge is last writer wins (inc/dec take the lock)
        self.value = v

    def inc(self, v: float = 1.0) -> None:
        with _update_lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        with _update_lock:
            self.value -= v


class _Histogram:
    # counts are PER-BUCKET here (one increment per observe, found by
    # bisection over the bound tuple — TRANSFER_BUCKETS has 14 bounds
    # and scan feeders observe per batch, so a linear walk under the
    # global update lock was the registry's most expensive operation);
    # the cumulative Prometheus view is computed at snapshot time.
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        buckets = tuple(buckets)
        # enforce the +Inf terminal bound (Prometheus requires it, and
        # observe()'s bisection indexes by it) rather than trusting
        # every caller's bucket tuple
        if not buckets or buckets[-1] != float("inf"):
            buckets = buckets + (float("inf"),)
        self.buckets = buckets
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        # v belongs to the first bucket with le >= v (Prometheus
        # `v <= le` semantics) — exactly bisect_left; the +Inf bound
        # last (enforced in __init__) guarantees an index exists. Pure
        # read of an immutable tuple, so the search runs outside the
        # lock.
        i = bisect.bisect_left(self.buckets, v)
        with _update_lock:
            self.sum += v
            self.count += 1
            self.counts[i] += 1


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class _Family:
    """One named metric family; children keyed by label-value tuples."""

    def __init__(self, kind: str, name: str, help_: str,
                 labelnames: Tuple[str, ...],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.kind = kind
        self.name = name
        self.help = help_
        self.labelnames = labelnames
        self.buckets = tuple(buckets)
        # keep the family's bound list identical to its children's
        # (render zips them): _Histogram appends the +Inf terminal
        # bound when a caller omitted it
        if not self.buckets or self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not labelnames:  # unlabeled: the single child exists up front
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return _Histogram(self.buckets)
        return _KINDS[self.kind]()

    def labels(self, *values):
        """Child for one label combination; bounded — combination #65
        and beyond share the ``__other__`` series."""
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values!r}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_CHILDREN:
                    key = (_OTHER,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is None:
                        child = self._children[key] = self._new_child()
                else:
                    child = self._children[key] = self._new_child()
            return child

    # unlabeled conveniences delegate to the single child
    def inc(self, v: float = 1.0):
        self.labels().inc(v)

    def dec(self, v: float = 1.0):
        self.labels().dec(v)

    def set(self, v: float):
        self.labels().set(v)

    def observe(self, v: float):
        self.labels().observe(v)

    def snapshot(self) -> Dict:
        # _update_lock too: a histogram observe() mutates sum/count/
        # buckets as a unit, and a scrape between those writes would
        # violate the +Inf-bucket == _count invariant
        with self._lock, _update_lock:
            samples = {}
            for key, child in self._children.items():
                k = "\t".join(key)
                if self.kind == "histogram":
                    # cumulate the per-bucket counts here (not in
                    # observe): the snapshot is the wire/render format,
                    # so worker flushes and the renderer keep seeing
                    # Prometheus-cumulative buckets
                    samples[k] = {"counts": list(itertools.accumulate(
                                      child.counts)),
                                  "sum": child.sum, "count": child.count}
                else:
                    samples[k] = child.value
        return {"kind": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "buckets": list(self.buckets), "samples": samples}


class MetricsRegistry:
    """Named families; idempotent declaration (same name + kind returns
    the existing family, so module-level declarations are safe across
    reimports)."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _family(self, kind: str, name: str, help_: str,
                labelnames: Sequence[str],
                buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        with self._lock:
            f = self._families.get(name)
            if f is not None:
                if f.kind != kind:
                    raise ValueError(
                        f"metric {name} already registered as {f.kind}")
                return f
            f = _Family(kind, name, help_, tuple(labelnames), buckets)
            self._families[name] = f
            return f

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family("counter", name, help_, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family("gauge", name, help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family("histogram", name, help_, labelnames, buckets)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able state — what workers flush through the rendezvous."""
        with self._lock:
            fams = list(self._families.values())
        return {f.name: f.snapshot() for f in fams}

    def reset(self) -> None:
        """Testing: drop every family (module-level declarations
        re-create theirs on next use via the idempotent accessor)."""
        with self._lock:
            for f in self._families.values():
                with f._lock:
                    f._children.clear()
                    if not f.labelnames:
                        f._children[()] = f._new_child()


REGISTRY = MetricsRegistry()

# Per-query end-to-end latency: observed by PhysicalPlan.collect
# (cluster=local; the process cluster's cluster=process comes with it);
# source says how the plan was built (the SQL front end or an exec tree).
QUERY_DURATION = REGISTRY.histogram(
    "rapids_query_duration_seconds",
    "End-to-end query wall time from plan execution start to the "
    "collected result, by plan source (sql|plan) and execution tier "
    "(local|process).",
    ("source", "cluster"))


# --- Prometheus text exposition --------------------------------------------

def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: Optional[Dict[str, str]] = None) -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    for k, v in (extra or {}).items():
        parts.append(f'{k}="{_escape(v)}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _render_family(lines: List[str], name: str, snap: Dict,
                   extra: Optional[Dict[str, str]] = None) -> None:
    names = snap["labelnames"]
    for key, val in sorted(snap["samples"].items()):
        values = key.split("\t") if key else []
        if snap["kind"] == "histogram":
            # snapshot() already cumulated the per-bucket counts —
            # render them as-is; re-accumulating here would
            # double-count
            for le, c in zip(snap["buckets"], val["counts"]):
                ls = _label_str(names, values,
                                dict(extra or {}, le=_fmt_value(le)))
                lines.append(f"{name}_bucket{ls} {c}")
            ls = _label_str(names, values, extra)
            lines.append(f"{name}_sum{ls} {_fmt_value(val['sum'])}")
            lines.append(f"{name}_count{ls} {val['count']}")
        else:
            ls = _label_str(names, values, extra)
            lines.append(f"{name}{ls} {_fmt_value(val)}")


def render_snapshot(snapshot: Dict[str, Dict],
                    extra_labels: Optional[Dict[str, str]] = None) -> str:
    lines: List[str] = []
    for name in sorted(snapshot):
        snap = snapshot[name]
        if snap.get("help"):
            lines.append(f"# HELP {name} {snap['help']}")
        lines.append(f"# TYPE {name} {snap['kind']}")
        _render_family(lines, name, snap, extra_labels)
    return "\n".join(lines) + ("\n" if lines else "")


def render_merged_snapshots(
        tagged: Sequence[Tuple[str, Dict[str, Dict]]]) -> str:
    """Driver-side aggregation: one exposition document over several
    processes' snapshots, each series tagged ``proc=<tag>`` — summing
    across processes is the scraper's job (Prometheus sum by ())."""
    all_names: Dict[str, Dict] = {}
    for _, snap in tagged:
        for name, fam in snap.items():
            all_names.setdefault(name, fam)
    lines: List[str] = []
    for name in sorted(all_names):
        fam0 = all_names[name]
        if fam0.get("help"):
            lines.append(f"# HELP {name} {fam0['help']}")
        lines.append(f"# TYPE {name} {fam0['kind']}")
        for tag, snap in tagged:
            if name in snap:
                _render_family(lines, name, snap[name], {"proc": tag})
    return "\n".join(lines) + ("\n" if lines else "")


def dump_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """This process's registry as Prometheus text exposition format."""
    return render_snapshot((registry or REGISTRY).snapshot())


# --- optional HTTP endpoint -------------------------------------------------

_http_lock = threading.Lock()
_http_server = None

# /status enrichment: a component with live fleet state (the process
# cluster) registers a zero-arg provider returning a JSON-able dict
# merged into the base snapshot. One provider per process (a second
# registration replaces the first — same last-writer-wins contract as
# the ledger gauges).
_status_provider = None


def set_status_provider(fn) -> None:
    global _status_provider
    _status_provider = fn


def clear_status_provider(fn=None) -> None:
    """Unregister (only ``fn`` itself when given — a stale shutdown
    must not clobber a newer cluster's provider)."""
    global _status_provider
    if fn is None or _status_provider is fn:
        _status_provider = None


def render_status() -> Dict:
    """The /status JSON document: process vitals, memory-ledger
    occupancy, admission-queue depths per tenant, and whatever the
    registered provider (cluster: in-flight query, mesh/gang health,
    warehouse tail) contributes. Every section is best-effort — a
    half-initialized runtime still serves valid JSON."""
    doc: Dict = {"ts": time.time(), "pid": os.getpid()}
    try:
        from ..memory import DeviceMemoryManager
        # the ledger made last (a fresh one when there is none yet)
        shared = list(DeviceMemoryManager._shared.values())
        mm = shared[-1] if shared else DeviceMemoryManager.shared()
        doc["memory"] = {
            "device_bytes_in_use": int(mm.device_bytes),
            "device_budget_bytes": int(mm.budget),
            "host_bytes_in_use": int(mm.host_bytes),
            "disk_in_use_bytes": int(mm.disk_in_use_bytes),
            "disk_limit_bytes": int(mm.disk_limit),
            "spill_bytes_total": int(mm.spill_bytes),
            "disk_spill_bytes_total": int(mm.disk_spill_bytes),
        }
        doc["admission"] = mm.admission.snapshot()
    except Exception as e:  # noqa: BLE001 — vitals stay best-effort
        doc["memory_error"] = f"{type(e).__name__}: {e}"[:200]
    prov = _status_provider
    if prov is not None:
        try:
            extra = prov()
            if isinstance(extra, dict):
                doc.update(extra)
        except Exception as e:  # noqa: BLE001
            doc["provider_error"] = f"{type(e).__name__}: {e}"[:200]
    return doc


def maybe_start_http_server(conf) -> Optional[int]:
    """Start the /metrics endpoint once per process when
    ``spark.rapids.metrics.port`` > 0; returns the bound port (None
    when disabled). Idempotent and race-safe; bind failures are
    reported once and not retried every query."""
    port = conf.get(METRICS_PORT)
    if not port:
        return None
    if os.environ.get("RAPIDS_TPU_IS_WORKER"):
        # cluster workers inherit the driver's conf; the port belongs to
        # the driver — worker registries travel the filesystem
        # rendezvous and are served by prometheus_text() instead
        return None
    global _http_server
    with _http_lock:
        if _http_server is not None:
            return _http_server.server_address[1] \
                if _http_server != "failed" else None
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/status":
                    body = json.dumps(render_status()).encode()
                    ctype = "application/json"
                elif path in ("", "/metrics"):
                    body = dump_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # no stderr chatter
                pass

        try:
            srv = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        except OSError as e:
            import sys
            print(f"[rapids-obs] metrics port {port} unavailable: {e}",
                  file=sys.stderr)
            _http_server = "failed"
            return None
        t = threading.Thread(target=srv.serve_forever, daemon=True,
                             name="rapids-metrics-http")
        t.start()
        _http_server = srv
        return srv.server_address[1]


# --- worker-side rendezvous flush -------------------------------------------

def flush_worker_metrics(root: str, worker_id: int,
                         registry: Optional[MetricsRegistry] = None) -> str:
    """Atomically (re)write this worker's snapshot under the cluster
    rendezvous root; the driver merges the latest file per worker."""
    d = os.path.join(root, "metrics")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"w{worker_id}.json")
    snap = (registry or REGISTRY).snapshot()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f)
    os.replace(tmp, path)
    return path


def read_worker_metrics(root: str) -> List[Tuple[str, Dict]]:
    """Every worker snapshot under the rendezvous root, tagged w<K>."""
    d = os.path.join(root, "metrics")
    out: List[Tuple[str, Dict]] = []
    try:
        names = sorted(os.listdir(d))
    except FileNotFoundError:
        return out
    for n in names:
        if not (n.startswith("w") and n.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, n)) as f:
                out.append((n[:-len(".json")], json.load(f)))
        except (OSError, json.JSONDecodeError):
            continue  # torn write mid-flush: next flush replaces it
    return out

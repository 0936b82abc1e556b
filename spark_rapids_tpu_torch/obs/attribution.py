"""Per-query cost attribution: the warehouse row builder.

Counterpart of ``spark_rapids_tpu/obs/attribution.py``.
``QueryAttribution.begin`` (``PhysicalPlan.collect``) snapshots the
counters the row deltas; ``finish`` deltas them, folds in the query's
per-operator metrics (``obs/opmetrics.fold_ctx``), the lifecycle context
(tenant, admission wait, ladder rungs, a classified cancel) and the
flight rings' gang events, classifies the outcome ``completed |
cancelled | degraded | failed`` and appends the row
(``obs/warehouse.py``).

Where each field comes from, so nothing is counted twice:

* bytes by transport and spill bytes: registry counter deltas (this
  process's, plus the process cluster's workers' flushed snapshots,
  ``cluster.py``; the host-file transport's byte families move with
  ``shuffle/host.py``, the collective one's come with ROADMAP item 17,
  so those slots read 0 today);
* gang collective bytes and epochs: the worker rings' ``mesh_epoch``
  events (item 17; empty until then);
* scan chunks, fused dispatches, scan programs, per-operator rows and
  times: the query's own folded operator metrics, exact per query;
* ``device_kind``: the ctx's device, the card's name or ``cpu``
  (``opmetrics._device_kind``);
* ``fusion.jit_variants``: 0. The reference counts the entries of its
  per-node fused-program caches; the port runs eager PyTorch and builds
  its kernels once a source for the process, and keeps no per-plan
  program cache (ROADMAP queue C).

``finish`` never raises past its boundary and reads nothing back from
the device: the device's row counts reach it through ``fold_ctx`` after
the collect's download.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from . import warehouse
from .metrics import REGISTRY, read_worker_metrics
from .opmetrics import _device_kind

#: counter families the row deltas, keyed by (family, label) -> row slot
_BYTE_SLOTS: List[Tuple[str, str, str]] = [
    ("rapids_shuffle_bytes_written_total", "host", "host_written"),
    ("rapids_shuffle_bytes_fetched_total", "host", "host_fetched"),
    ("rapids_shuffle_bytes_written_total", "ici", "ici_written"),
    ("rapids_shuffle_bytes_fetched_total", "ici", "ici_fetched"),
    ("rapids_shuffle_bytes_fetched_total", "process", "process_fetched"),
]
_SPILL_SLOTS: List[Tuple[str, str, str]] = [
    ("rapids_memory_spill_bytes_total", "", "write_bytes"),
    ("rapids_memory_disk_spill_bytes_total", "", "disk_write_bytes"),
    ("rapids_spill_read_bytes_total", "", "read_bytes"),
]
_TRACKED = {name for name, _, _ in _BYTE_SLOTS + _SPILL_SLOTS}


def _flatten(snap: Dict) -> Dict[Tuple[str, str], float]:
    """Tracked counter samples of one registry snapshot, as
    {(family, label-key): value}."""
    out: Dict[Tuple[str, str], float] = {}
    for name in _TRACKED:
        fam = snap.get(name)
        if not fam or fam.get("kind") == "histogram":
            continue
        for lk, v in (fam.get("samples") or {}).items():
            if isinstance(v, (int, float)):
                out[(name, lk)] = float(v)
    return out


def _worker_totals(root: str) -> Dict[Tuple[str, str], float]:
    """Tracked counters summed across every worker's flushed registry
    snapshot (zero when workers don't flush — metrics disabled)."""
    tot: Dict[Tuple[str, str], float] = {}
    for _tag, snap in read_worker_metrics(root):
        for k, v in _flatten(snap).items():
            tot[k] = tot.get(k, 0.0) + v
    return tot


def _delta(now: Dict, base: Dict, name: str, label: str) -> int:
    d = now.get((name, label), 0.0) - base.get((name, label), 0.0)
    return max(0, int(d))


class QueryAttribution:
    """Counter bracket for one query; see module docstring."""

    __slots__ = ("conf", "cluster_root", "t0_wall", "t0_mono",
                 "_base", "_worker_base")

    def __init__(self, conf, cluster_root: Optional[str]):
        self.conf = conf
        self.cluster_root = cluster_root
        self.t0_wall = time.time()
        self.t0_mono = time.monotonic()
        self._base = _flatten(REGISTRY.snapshot())
        self._worker_base = _worker_totals(cluster_root) \
            if cluster_root else {}

    @classmethod
    def begin(cls, conf,
              cluster_root: Optional[str] = None
              ) -> Optional["QueryAttribution"]:
        """Snapshot baselines, or None when the warehouse is off (the
        kill switch makes the whole bracket one conf lookup)."""
        if warehouse.warehouse_dir(conf) is None:
            return None
        try:
            return cls(conf, cluster_root)
        except Exception:  # noqa: BLE001 — telemetry must not fail queries
            return None

    # --- harvest helpers --------------------------------------------------

    def _gang_events(self, query_id: str) -> Tuple[int, int]:
        """(bytes, epochs) of this query's gang collectives, mined from
        the worker flight rings. Events tagged with the owning query id
        match exactly; untagged events (older workers) fall back to the
        bracket's time window."""
        if not self.cluster_root:
            return 0, 0
        from .recorder import read_worker_rings
        bts = eps = 0
        for _tag, doc in read_worker_rings(self.cluster_root):
            for ev in doc.get("events", ()):
                if ev.get("ev") != "mesh_epoch":
                    continue
                q = ev.get("query", "")
                if q:
                    if q != query_id:
                        continue
                elif ev.get("ts", 0.0) < self.t0_wall:
                    continue
                bts += int(ev.get("bytes", 0) or 0)
                eps += 1
        return bts, eps

    def _op_rollup(self, folded: Dict) -> Tuple[Dict, Dict, Dict, float,
                                                float, List[str]]:
        """(ops, scan, fusion, op_time_s, dispatch_s, fallback_reasons)
        from the query's folded per-operator metrics."""
        ops: Dict[str, Dict] = {}
        scan = {"device_chunks": 0, "fallback_chunks": 0}
        fusion = {"fused_dispatches": 0, "scan_programs": 0}
        op_time = dispatch = 0.0
        reasons: List[str] = []
        for key, doc in sorted((folded or {}).items()):
            m = doc.get("metrics", {}) if isinstance(doc, dict) else {}
            t = float(m.get("opTime", 0.0) or 0.0)
            ops[key] = {"label": doc.get("label", key),
                        "rows": int(m.get("rows", 0) or 0),
                        "op_time_s": round(t, 6)}
            op_time += t
            dispatch += float(m.get("dispatchTime", 0.0) or 0.0)
            scan["device_chunks"] += int(m.get("deviceChunks", 0) or 0)
            scan["fallback_chunks"] += int(m.get("fallbackChunks", 0) or 0)
            fusion["fused_dispatches"] += int(m.get("fusedDispatches", 0)
                                              or 0)
            fusion["scan_programs"] += int(m.get("scanPrograms", 0) or 0)
            label = doc.get("label", key)
            if m.get("cpuFallback"):
                reasons.append(f"cpu_fallback:{label}")
            if m.get("ladderCpuFallback"):
                reasons.append(f"ladder_cpu_fallback:{label}")
        return ops, scan, fusion, op_time, dispatch, reasons

    @staticmethod
    def _classify(qctx, error, ladder_counts: Dict[str, int],
                  reasons: List[str]) -> Tuple[str, Optional[Dict]]:
        cancel = None
        token = getattr(qctx, "token", None) if qctx is not None else None
        if token is not None and getattr(token, "reason", None):
            cancel = {"reason": token.reason,
                      "detail": getattr(token, "detail", "")}
        if error is not None:
            from ..lifecycle import QueryCancelled
            if isinstance(error, QueryCancelled):
                if cancel is None:
                    cancel = {"reason": getattr(error, "reason", "user"),
                              "detail": str(error)}
                return "cancelled", cancel
            return "failed", cancel
        if cancel is not None:
            return "cancelled", cancel
        if any(ladder_counts.values()) or reasons:
            return "degraded", None
        return "completed", None

    # --- the row ----------------------------------------------------------

    def finish(self, *, root=None, folded: Optional[Dict] = None,
               qctx=None, wall_s: float = 0.0, source: str = "exec",
               cluster: Optional[Dict] = None, error=None,
               fingerprint: Optional[str] = None,
               extra: Optional[Dict] = None,
               device=None) -> Optional[Dict]:
        """Build and append this query's warehouse row (``device``: the
        ctx's); returns the row, or None when building or appending
        failed (never raises)."""
        try:
            row = self._build(root=root, folded=folded, qctx=qctx,
                              wall_s=wall_s, source=source,
                              cluster=cluster, error=error,
                              fingerprint=fingerprint, extra=extra,
                              device=device)
            warehouse.append_row(self.conf, row)
            return row
        except Exception:  # noqa: BLE001 — telemetry must not fail queries
            return None

    def _build(self, *, root, folded, qctx, wall_s, source, cluster,
               error, fingerprint, extra, device) -> Dict:
        now = _flatten(REGISTRY.snapshot())
        wnow = _worker_totals(self.cluster_root) \
            if self.cluster_root else {}

        def d(name: str, label: str) -> int:
            return (_delta(now, self._base, name, label)
                    + _delta(wnow, self._worker_base, name, label))

        bytes_row = {slot: d(name, label)
                     for name, label, slot in _BYTE_SLOTS}
        spill_row = {slot: d(name, label)
                     for name, label, slot in _SPILL_SLOTS}
        qid = getattr(qctx, "query_id", "") if qctx is not None else ""
        gang_bytes, gang_epochs = self._gang_events(qid)
        bytes_row["gang_dcn"] = gang_bytes
        bytes_row["gang_epochs"] = gang_epochs
        ops, scan, fusion, op_time, dispatch, reasons = \
            self._op_rollup(folded)
        fusion["jit_variants"] = 0  # no per-plan program cache
        ladder_counts: Dict[str, int] = {}
        ladder = getattr(qctx, "ladder", None) if qctx is not None else None
        if ladder is not None and getattr(ladder, "counts", None):
            ladder_counts = {k: int(v) for k, v in ladder.counts.items()
                            if v}
        outcome, cancel = self._classify(qctx, error, ladder_counts,
                                         reasons)
        if fingerprint is None and root is not None:
            try:
                from ..tools.event_log import plan_fingerprint
                fingerprint = plan_fingerprint(root)
            except Exception:  # noqa: BLE001
                fingerprint = None
        row = {
            "version": warehouse.ROW_VERSION,
            "ts": time.time(),
            "query_id": qid,
            "tenant": getattr(qctx, "tenant", "default")
            if qctx is not None else "default",
            "source": source,
            "device_kind": _device_kind(device),
            "fingerprint": fingerprint,
            "outcome": outcome,
            "cancel": cancel,
            "wall_s": round(float(wall_s), 6),
            "admission_wait_s": round(float(
                getattr(qctx, "admission_wait_s", 0.0) or 0.0), 6),
            "split": {"dispatch_s": round(dispatch, 6),
                      "op_time_s": round(op_time, 6)},
            "ops": ops,
            "bytes": bytes_row,
            "spill": spill_row,
            "scan": scan,
            "fusion": fusion,
            "ladder": ladder_counts,
            "fallback_reasons": reasons,
        }
        if error is not None and outcome == "failed":
            row["error"] = f"{type(error).__name__}: {error}"[:300]
        if cluster:
            row["cluster"] = cluster
        if extra:
            row.update(extra)
        return row

"""Query telemetry warehouse: one durable row a query.

Counterpart of ``spark_rapids_tpu/obs/warehouse.py``. Every collected
query, whether it completed, was cancelled, degraded (a ladder rung or a
CPU island) or failed, leaves one JSON row of what it cost and why
(``obs/attribution.py`` builds it): tenant, plan fingerprint,
``device_kind`` (the card's name, or ``cpu``), admission wait, the
dispatch and ``opTime`` split, per-operator rows and times, bytes moved
by transport, spill bytes, the scan's device and fallback chunks, the
fused dispatches, the rungs walked and the fallback reasons.

Rows append to sealed JSONL segments: each append rewrites the current
segment through the port's ``shuffle/integrity.py`` (temporary name,
CRC-32C footer, rename), so a crash leaves the previous sealed segment
or the new one. A reader verifies the seal and salvages line by line
from a torn or corrupt segment. The oldest segments beyond
``spark.rapids.warehouse.maxFiles`` go at write time.

``render_warehouse`` rolls the rows up by tenant and by fingerprint;
``drift_report`` compares the latest run of each fingerprint with its
previous run on the same ``device_kind`` and flags structural
regressions (more fused dispatches, fallback chunks appearing, a
variant count past its bound, bytes moved past a tolerance), refusing
(rc 3) a comparison across device kinds.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..config import register

WAREHOUSE_DIR = register(
    "spark.rapids.warehouse.dir", "",
    "Directory for warehouse segments (wh-<pid>-<ms>.jsonl, sealed "
    "with the shuffle-block CRC32C footer). Empty, the default, "
    "disables the warehouse: the writer is then one conf read a "
    "query.")
WAREHOUSE_MAX_FILES = register(
    "spark.rapids.warehouse.maxFiles", 64,
    "On-disk retention: oldest warehouse segments beyond this count "
    "are pruned at write time (spark.rapids.trace.maxFiles "
    "semantics), bounding a long-lived session's footprint.")
WAREHOUSE_SEGMENT_ROWS = register(
    "spark.rapids.warehouse.segment.maxRows", 128,
    "Rows per segment before the writer rolls to a new file. Each "
    "append rewrites the current segment through the sealed tmp+"
    "rename protocol, so smaller segments bound the rewrite cost.")
#: the drift sentinel's bounds (the reference's defaults; no conf key
#: until the profiling tools of ROADMAP item 18 read them): the relative
#: increase in bytes moved (transports + spill) between two runs of one
#: fingerprint on one ``device_kind`` that counts as a regression, and
#: the live JIT-variant count a run may not pass (the port's rows carry
#: 0, ROADMAP queue C, so only a reference row can pass it)
DRIFT_BYTES_TOLERANCE = 0.25
DRIFT_VARIANT_BOUND = 8

STATUS_ROWS = register(
    "spark.rapids.warehouse.statusRows", 5,
    "How many most-recent warehouse rows the /status endpoint "
    "embeds (query id, tenant, outcome, wall seconds).")

#: bump when row fields change shape incompatibly
ROW_VERSION = 1

__all__ = [
    "WAREHOUSE_DIR", "WAREHOUSE_MAX_FILES", "WAREHOUSE_SEGMENT_ROWS",
    "DRIFT_BYTES_TOLERANCE", "DRIFT_VARIANT_BOUND", "STATUS_ROWS",
    "ROW_VERSION",
    "WarehouseReadError", "warehouse_dir", "append_row", "read_rows",
    "tail_rows", "render_warehouse", "drift_report",
]


class WarehouseReadError(Exception):
    """Classified segment read failure (missing|torn|corrupt|io)."""

    def __init__(self, kind: str, path: str, detail: str = ""):
        self.kind = kind
        self.path = path
        self.detail = detail
        super().__init__(f"warehouse segment {kind}: {path} ({detail})")


def warehouse_dir(conf) -> Optional[str]:
    """The resolved warehouse directory, or None when the dir is empty."""
    try:
        d = conf.get(WAREHOUSE_DIR)
    except Exception:  # noqa: BLE001 — foreign conf objects
        return None
    return d or None


# --- writer -----------------------------------------------------------------

class _Segment:
    __slots__ = ("path", "lines", "pid")

    def __init__(self, path: str):
        self.path = path
        self.lines: List[str] = []
        self.pid = os.getpid()


_seg_lock = threading.Lock()
_segments: Dict[str, _Segment] = {}


def _new_segment(d: str) -> _Segment:
    base = f"wh-{os.getpid()}-{int(time.time() * 1000)}"
    path = os.path.join(d, base + ".jsonl")
    n = 0
    while os.path.exists(path):  # same-ms roll: disambiguate
        n += 1
        path = os.path.join(d, f"{base}-{n}.jsonl")
    return _Segment(path)


def append_row(conf, row: Dict) -> Optional[str]:
    """Append one query row to the current sealed segment; returns the
    segment path (None when the warehouse is disabled). Crash-safe:
    the segment is rewritten through tmp + CRC footer + rename, so a
    crash mid-append can never tear an existing row."""
    d = warehouse_dir(conf)
    if d is None:
        return None
    from ..shuffle.integrity import write_sealed_file
    from .recorder import prune_oldest
    row = dict(row)
    row.setdefault("version", ROW_VERSION)
    row.setdefault("ts", time.time())
    line = json.dumps(row, sort_keys=True, default=str)
    os.makedirs(d, exist_ok=True)
    with _seg_lock:
        seg = _segments.get(d)
        if seg is None or seg.pid != os.getpid() \
                or len(seg.lines) >= max(1, conf.get(WAREHOUSE_SEGMENT_ROWS)):
            seg = _new_segment(d)
            _segments[d] = seg
        seg.lines.append(line)
        payload = ("\n".join(seg.lines) + "\n").encode()
        try:
            # the lock serializes the rewrite itself: one row a query
            write_sealed_file(seg.path, payload)
        except OSError:
            # disk trouble must never fail the query it attributes;
            # drop the in-memory line too so state matches disk
            seg.lines.pop()
            return None
        prune_oldest(d, conf.get(WAREHOUSE_MAX_FILES),
                     prefix="wh-", suffix=".jsonl")
    return seg.path


# --- reader -----------------------------------------------------------------

def _segment_rows(path: str) -> Tuple[List[Dict], bool]:
    """Rows of one segment. Verified read first; a torn/corrupt seal
    falls back to raw line-by-line salvage (unparseable tail lines —
    including the binary footer — are skipped). Returns
    (rows, salvaged)."""
    from ..shuffle.integrity import read_sealed_file
    raw: Optional[bytes] = None
    salvaged = False
    try:
        raw = bytes(read_sealed_file(
            path, lambda kind, detail: WarehouseReadError(
                kind, path, detail)))
    except WarehouseReadError as e:
        if e.kind == "missing":
            return [], False
        salvaged = True
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return [], True
    rows: List[Dict] = []
    for ln in raw.split(b"\n"):
        if not ln.strip():
            continue
        try:
            doc = json.loads(ln)
        except (ValueError, UnicodeDecodeError):
            continue  # torn tail / sealed footer bytes
        if isinstance(doc, dict):
            rows.append(doc)
    return rows, salvaged


def read_rows(d: str) -> List[Dict]:
    """Every row across every segment, oldest first (by ``ts``).
    Torn/corrupt segments contribute their salvageable prefix."""
    rows: List[Dict] = []
    for path in sorted(glob.glob(os.path.join(d, "wh-*.jsonl"))):
        rows.extend(_segment_rows(path)[0])
    rows.sort(key=lambda r: r.get("ts", 0.0))
    return rows


def tail_rows(d: str, n: int) -> List[Dict]:
    """The newest ``n`` rows, compacted for the /status endpoint."""
    out = []
    for r in read_rows(d)[-max(0, n):]:
        out.append({k: r.get(k) for k in
                    ("query_id", "tenant", "outcome", "wall_s",
                     "device_kind", "fingerprint")})
    return out


# --- rollups + drift sentinel ----------------------------------------------

def _total_bytes(row: Dict) -> int:
    b = row.get("bytes") or {}
    s = row.get("spill") or {}
    return int(sum(int(v or 0) for v in b.values())
               + sum(int(v or 0) for v in s.values()))


def _rollup(rows: List[Dict]) -> Tuple[Dict, Dict]:
    """(per-tenant, per-fingerprint) aggregates."""
    tenants: Dict[str, Dict] = {}
    plans: Dict[str, List[Dict]] = {}
    for r in rows:
        t = tenants.setdefault(str(r.get("tenant") or "default"), {
            "queries": 0, "outcomes": {}, "wall_s": 0.0,
            "admission_wait_s": 0.0, "bytes": 0, "spill_write": 0})
        t["queries"] += 1
        oc = str(r.get("outcome") or "unknown")
        t["outcomes"][oc] = t["outcomes"].get(oc, 0) + 1
        t["wall_s"] += float(r.get("wall_s") or 0.0)
        t["admission_wait_s"] += float(r.get("admission_wait_s") or 0.0)
        t["bytes"] += _total_bytes(r)
        t["spill_write"] += int((r.get("spill") or {})
                                .get("write_bytes") or 0)
        fp = r.get("fingerprint")
        if fp:
            plans.setdefault(str(fp), []).append(r)
    return tenants, plans


def render_warehouse(d: str) -> str:
    """Human rollup: per-tenant cost table + per-plan-fingerprint
    structural summary over every readable row."""
    rows = read_rows(d)
    out = [f"=== telemetry warehouse ({d}) ===",
           f"rows: {len(rows)}"]
    if not rows:
        return "\n".join(out)
    tenants, plans = _rollup(rows)
    out.append("")
    out.append("-- per tenant --")
    for name in sorted(tenants):
        t = tenants[name]
        ocs = ",".join(f"{k}={v}" for k, v in sorted(t["outcomes"].items()))
        out.append(
            f"  {name:<12} queries={t['queries']:<4} [{ocs}] "
            f"wall={t['wall_s']:.3f}s adm_wait={t['admission_wait_s']:.3f}s "
            f"bytes={t['bytes']} spill_w={t['spill_write']}")
    out.append("")
    out.append("-- per plan fingerprint --")
    for fp in sorted(plans):
        runs = plans[fp]
        last = runs[-1]
        f = last.get("fusion") or {}
        sc = last.get("scan") or {}
        out.append(
            f"  {fp:<18} runs={len(runs):<3} "
            f"device_kind={last.get('device_kind')} "
            f"dispatches={f.get('fused_dispatches', 0)} "
            f"variants={f.get('jit_variants', 0)} "
            f"fallback_chunks={sc.get('fallback_chunks', 0)} "
            f"bytes={_total_bytes(last)}")
    return "\n".join(out)


def drift_report(d: str, *, bytes_tolerance: Optional[float] = None,
                 variant_bound: Optional[int] = None,
                 allow_cross_device: bool = False) -> Tuple[str, int]:
    """Structural drift between the latest run of each plan
    fingerprint and its most recent prior run on the SAME
    ``device_kind``. Returns ``(report, rc)``: rc 0 clean, rc 1
    regressions flagged, rc 3 refused (only a cross-``device_kind``
    baseline exists, as the reference's ``profiling compare`` refuses;
    ``allow_cross_device`` downgrades the refusal to a warning). The
    report's text is the reference's, word for word."""
    if bytes_tolerance is None:
        bytes_tolerance = DRIFT_BYTES_TOLERANCE
    if variant_bound is None:
        variant_bound = DRIFT_VARIANT_BOUND
    rows = read_rows(d)
    _, plans = _rollup(rows)
    flagged: List[str] = []
    refused: List[str] = []
    warnings: List[str] = []
    compared = 0
    for fp in sorted(plans):
        runs = plans[fp]
        latest = runs[-1]
        kind = latest.get("device_kind")
        base = None
        cross = None
        for prev in reversed(runs[:-1]):
            if prev.get("device_kind") == kind:
                base = prev
                break
            if cross is None:
                cross = prev
        if base is None and cross is not None:
            if not allow_cross_device:
                refused.append(
                    f"  {fp}: latest device_kind={kind!r} has only a "
                    f"{cross.get('device_kind')!r} baseline")
                continue
            warnings.append(
                f"  WARNING {fp}: comparing across device_kind "
                f"({cross.get('device_kind')!r} -> {kind!r}) — "
                f"structural counters may legitimately differ")
            base = cross
        if base is None:
            continue  # first run of this plan: nothing to compare
        compared += 1
        lf = latest.get("fusion") or {}
        bf = base.get("fusion") or {}
        ls = latest.get("scan") or {}
        bs = base.get("scan") or {}
        ld, bd = int(lf.get("fused_dispatches") or 0), \
            int(bf.get("fused_dispatches") or 0)
        if ld > bd:
            flagged.append(
                f"  REGRESSION {fp} fusedDispatches: {bd} -> {ld} "
                f"(+{ld - bd})")
        lfb, bfb = int(ls.get("fallback_chunks") or 0), \
            int(bs.get("fallback_chunks") or 0)
        if lfb > 0 and lfb > bfb:
            flagged.append(
                f"  REGRESSION {fp} fallbackChunks: {bfb} -> {lfb} "
                f"(scan left the device)")
        lv = int(lf.get("jit_variants") or 0)
        if lv > int(variant_bound):
            flagged.append(
                f"  REGRESSION {fp} jitVariants: {lv} exceeds bound "
                f"{int(variant_bound)}")
        lb, bb = _total_bytes(latest), _total_bytes(base)
        if bb > 0 and (lb - bb) / bb > float(bytes_tolerance):
            flagged.append(
                f"  REGRESSION {fp} bytesMoved: {bb} -> {lb} "
                f"(+{(lb - bb) / bb:.0%} > {float(bytes_tolerance):.0%} "
                f"tolerance)")
    if refused:
        head = ["=== drift REFUSED: device_kind mismatch ===",
                *refused,
                "",
                "Structural counters are only comparable on the same "
                "device_kind (see `profiling compare`). Re-run the "
                "baseline on this hardware, or pass "
                "--allow-cross-device to force."]
        return "\n".join(head), 3
    out = [f"=== warehouse drift ({d}) ===",
           f"fingerprints: {len(plans)}  compared: {compared}"]
    out.extend(warnings)
    if flagged:
        out.extend(flagged)
        out.append(f"drift: {len(flagged)} structural regression(s)")
        return "\n".join(out), 1
    out.append("drift: clean (no structural regressions)")
    return "\n".join(out), 0

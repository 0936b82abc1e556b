"""Anomaly triggers and incident bundles for the flight recorder.

Counterpart of ``spark_rapids_tpu/obs/anomaly.py``, as functions over
event lists; the process cluster (``cluster.py``) calls them:

- ``AnomalyDetector.check_task``: after a task attempt, over the ring's
  events since it started: a failure, refused disk-spill writes
  (``disk_pressure``), a spill-tier read or write failure, an OOM
  retry, or a spill cascade (at least ``spill_cascade_threshold``
  device-to-host spills) each decide a dump;
- ``anomalies_from_scheduler`` and ``straggler_attribution``: the
  anomalies of a scheduler's event list (failures, respawns,
  blacklists, stragglers, fetch failures, reruns, refused plans,
  cancelled queries) and each stage's attempts beside its median
  completed time;
- ``conf_delta``: the settings that differ from their defaults;
- ``build_incident_bundle``: one bundle of every process's ring (each
  event once, tagged with its process), the merged memory timeline, a
  metrics snapshot, the planner's fallback events, the conf delta and
  the attempts.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import ENTRIES, RapidsConf
from .recorder import memory_timeline

__all__ = ["AnomalyDetector", "anomalies_from_scheduler",
           "straggler_attribution", "build_incident_bundle"]

# scheduler event types that are anomalies in themselves (attempt_lost
# is a benign speculation loser; task_ok/submitted are normal traffic).
# fetch_failed / stage_rerun: a committed-then-lost or corrupt shuffle
# block and its lineage recovery — the query may still succeed, but
# durability loss is exactly what a flight recorder exists to explain.
# plan_rejected: the static verifier refused to run the plan — the
# bundle is how triage answers "why did this query never start".
# query_cancelled: the lifecycle layer stopped the query (user /
# deadline / budget / admission) — classified in the event's reason.
# spill_read_failed: a committed spill file failed its verified
# read-back (missing/corrupt/torn/io) and the task re-ran — the
# spill-tier mirror of fetch_failed.
_SCHED_ANOMALIES = ("task_failed", "worker_respawn", "worker_blacklisted",
                    "straggler_detected", "fetch_failed",
                    "spill_read_failed", "stage_rerun",
                    "plan_rejected", "query_cancelled")


class AnomalyDetector:
    """Worker-side trigger evaluation over one task attempt's events."""

    def __init__(self, spill_cascade_threshold: int = 3):
        self.spill_cascade_threshold = spill_cascade_threshold

    def check_task(self, events: Sequence[Dict], failed: bool,
                   error: str = "") -> Optional[Tuple[str, str]]:
        """(trigger, reason) when this attempt should dump, else None.
        ``events`` is the ring slice recorded since the attempt
        claimed (recorder.snapshot(since=claim_ts))."""
        if failed:
            return ("task_failure", error.strip().splitlines()[-1][:200]
                    if error else "task raised")
        pressure = [e for e in events if e.get("kind") == "mem"
                    and e.get("ev") == "disk_pressure"]
        if pressure:
            return ("disk_pressure",
                    f"{len(pressure)} refused disk-spill write"
                    f"{'' if len(pressure) == 1 else 's'} "
                    f"([{pressure[-1].get('fail_kind', '?')}]) — "
                    "batches stayed host-resident")
        spill_fail = [e for e in events if e.get("kind") == "mem"
                      and e.get("ev") in ("spill_read_failed",
                                          "spill_write_failed")]
        if spill_fail:
            e = spill_fail[-1]
            return ("spill_failure",
                    f"{len(spill_fail)} spill-tier failure"
                    f"{'' if len(spill_fail) == 1 else 's'} "
                    f"(last: {e.get('ev')} [{e.get('fail_kind', '?')}])")
        ooms = sum(1 for e in events
                   if e.get("kind") == "mem" and e.get("ev") == "oom_retry")
        if ooms:
            return ("oom_retry_cascade",
                    f"{ooms} device OOM split-and-retr"
                    f"{'y' if ooms == 1 else 'ies'} during the attempt")
        spills = sum(1 for e in events
                     if e.get("kind") == "mem" and e.get("ev") == "spill")
        if spills >= self.spill_cascade_threshold:
            return ("spill_cascade",
                    f"{spills} device->host spills during the attempt "
                    f"(threshold {self.spill_cascade_threshold})")
        return None


# --- driver-side mining ------------------------------------------------------

def anomalies_from_scheduler(events: Sequence[Dict]) -> List[Dict]:
    """Scheduler events that constitute anomalies, normalized to the
    bundle's anomaly shape."""
    out = []
    for e in events:
        if e.get("event") not in _SCHED_ANOMALIES:
            continue
        out.append({"kind": e["event"], "ts": e.get("ts", 0.0),
                    "proc": "driver", "task": e.get("task", ""),
                    "attempt": e.get("attempt", -1),
                    "worker": e.get("worker", -1),
                    "detail": (e.get("reason") or "")[:500]})
    return out


def straggler_attribution(events: Sequence[Dict],
                          factor: float) -> Dict[str, Dict]:
    """Per-stage attempt attribution: every attempt's outcome and
    runtime next to the stage's median completed-task time, with the
    attempts that exceeded ``factor`` x median (or failed) called out.
    Built purely from the scheduler event list, so it works on a
    harvested bundle with no live scheduler around."""
    stages: Dict[str, Dict] = {}
    for e in events:
        ev = e.get("event")
        if ev not in ("task_ok", "task_failed", "attempt_lost",
                      "straggler_detected"):
            continue
        st = stages.setdefault(e.get("stage", "?"),
                               {"attempts": [], "ok_durations": []})
        state = {"task_ok": "ok", "task_failed": "err",
                 "attempt_lost": "lost",
                 "straggler_detected": "straggler"}[ev]
        st["attempts"].append({
            "task": e.get("task", ""), "attempt": e.get("attempt", -1),
            "worker": e.get("worker", -1), "state": state,
            "runtime_s": e.get("wall_s", 0.0),
            "reason": (e.get("reason") or "")[:200]})
        if ev == "task_ok":
            st["ok_durations"].append(e.get("wall_s", 0.0))
    out: Dict[str, Dict] = {}
    for label, st in stages.items():
        durs = sorted(st["ok_durations"])
        med = durs[len(durs) // 2] if durs else 0.0
        cut = factor * med
        flagged = [a for a in st["attempts"]
                   if a["state"] in ("err", "straggler")
                   or (med > 0 and a["runtime_s"] > cut)]
        out[label] = {"median_ok_s": round(med, 6),
                      "straggler_cut_s": round(cut, 6),
                      "attempts": st["attempts"], "flagged": flagged}
    return out


# --- bundle assembly ---------------------------------------------------------

def conf_delta(conf: RapidsConf) -> Dict[str, str]:
    """The non-default part of the conf — what the operator changed is
    often the first triage question. Internal test knobs (fault
    injection) are the most interesting of all and are included."""
    out = {}
    for k, v in conf.items().items():
        e = ENTRIES.get(k)
        try:
            if e is not None and e.conv(v) == e.default:
                continue
        except (TypeError, ValueError):
            pass  # unparseable value: definitely not the default
        out[k] = str(v)
    return out


def build_incident_bundle(query_id: str, flight_id: str, seq: int,
                          trigger_anomalies: List[Dict],
                          driver_events: List[Dict],
                          worker_rings: List[Tuple[str, Dict]],
                          worker_dumps: List[Dict],
                          sched_events: List[Dict],
                          metrics_snapshot: Dict,
                          conf: RapidsConf,
                          straggler_factor: float,
                          since: float = 0.0) -> Dict:
    rings: Dict[str, List[Dict]] = {"driver": driver_events}
    # the merged timeline dedups by full event content: a failed
    # worker's flight dump embeds the same ring its w<K>-<pid> file
    # flushed, and counting both would replay every memory transition
    # twice in the HBM curve
    all_events: List[Dict] = []
    _seen = set()

    def _merge(evs, proc):
        # dedup on the RAW event (a failed worker's flight dump embeds
        # the same ring its w<K>-<pid> file flushed), then tag the
        # survivor with its process so the HBM timeline can keep
        # per-device occupancy series apart
        for e in evs:
            k = json.dumps(e, sort_keys=True, default=str)
            if k not in _seen:
                _seen.add(k)
                all_events.append(dict(e, proc=proc))

    _merge(driver_events, "driver")
    for tag, doc in worker_rings:
        rings[tag] = doc.get("events", [])
        _merge(rings[tag], tag)
    for d in worker_dumps:
        # dumps embed the full ring at failure time; the merged HBM
        # timeline must not smear an earlier query's occupancy in (the
        # raw dump stays in the bundle as evidence)
        _merge((e for e in d.get("events", [])
                if e.get("ts", 0.0) >= since),
               str(d.get("proc", "?")))
        trigger_anomalies.append({
            "kind": d.get("trigger", "task_failure"),
            "ts": d.get("ts", 0.0), "proc": d.get("proc", "?"),
            "task": d.get("task", ""), "attempt": d.get("attempt", -1),
            "worker": -1, "detail": (d.get("reason") or "")[:500]})
    trigger_anomalies.sort(key=lambda a: a.get("ts", 0.0))
    # plan fallback reasons ride the driver ring (planner.py tap)
    fallbacks = [e for e in driver_events if e.get("kind") == "plan"]
    return {
        "version": 1,
        "incident_id": f"incident-{flight_id}-{seq}",
        "ts": time.time(),
        "query": query_id,
        "anomalies": trigger_anomalies,
        "rings": rings,
        "memory_timeline": memory_timeline(all_events),
        "metrics": metrics_snapshot,
        "plan_fallbacks": fallbacks,
        "conf_delta": conf_delta(conf),
        "attempts": straggler_attribution(sched_events, straggler_factor),
        "worker_dumps": worker_dumps,
    }

"""Query lifecycle: cancellation, deadlines, fair admission and the
memory-pressure degradation ladder.

Counterpart of ``spark_rapids_tpu/lifecycle.py:56-675``:

- ``QueryContext``: a query id, tenant, deadline, memory budget and a
  ``CancellationToken``, made by ``PhysicalPlan.collect`` from the conf
  (or by the caller, ``GpuSession.query_context``) and carried by
  ``ExecCtx.qctx`` into every operator's execute shim and the scan.
- ``CancellationToken``: first cancel wins, classified ``user``,
  ``deadline``, ``budget`` or ``admission``; ``check()`` runs between
  batches and raises ``QueryCancelled``.
- ``FairAdmissionController``: the device's task slots
  (``spark.rapids.sql.concurrentGpuTasks``) behind bounded per-tenant
  queues; a free slot goes to the waiting tenant with the lowest
  in-use/weight ratio, FIFO within a tenant; a query still queued after
  ``admission.timeout`` is cancelled ``admission``.
- ``DegradationLadder``: under repeated device OOM, once split-and-retry
  has halved ``maxSplits`` times, each further OOM climbs one rung:
  ``spill`` (every unpinned catalog entry to the host), ``width1`` (new
  grants paused until the query runs alone), ``cpu`` (the collect root
  reruns the plan on ``execute_cpu``).

Each cancel (by reason) and rung (by name) moves the reference's
registry families, ``rapids_query_cancelled_total`` and
``rapids_query_degraded_total`` (``halve`` once a query), and records a
``lifecycle`` flight event (``cancel``, ``degrade``); admission observes
``rapids_admission_wait_seconds`` and keeps
``rapids_admission_queue_depth`` a tenant (``:132-151,220,400``). The
ladder's ``counts`` and the token's ``reason`` stay as the query's own
record.

The process cluster's half (the reference's ``:255-353,626-634``): a
task payload carries ``QueryContext.worker_payload`` (the query id,
tenant, wall-clock deadline and the rendezvous cancel marker's path);
the worker rebuilds a token with ``QueryContext.for_worker`` that polls
the marker between batches (``poll``, at most every 50 ms; a stat per
batch would dominate small stages) and honours the deadline on the wall
clock, without counting the cancel again (the driver's token counts it
once). ``read_cancel_marker`` reads the marker's reason and detail. The
driver waits up to ``spark.rapids.query.cancel.joinTimeout`` for its
claimed attempts to settle after it publishes the marker. A
``slow_admission`` chaos rule (``scheduler/chaos.py``) delays a matching
query's admission, the delay counting as queue time.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, Optional

from .config import RapidsConf, _bytes_conv, register
from .obs.metrics import REGISTRY as _METRICS
from .obs.recorder import RECORDER as _FLIGHT

__all__ = ["QueryCancelled", "CancellationToken", "QueryContext",
           "FairAdmissionController", "DegradationLadder",
           "CANCEL_REASONS", "LADDER_RUNGS", "LIFECYCLE_ENABLED",
           "CANCEL_JOIN_TIMEOUT", "read_cancel_marker"]

# --- conf -------------------------------------------------------------------

LIFECYCLE_ENABLED = register(
    "spark.rapids.lifecycle.enabled", True,
    "Query lifecycle layer: every collect() gets a QueryContext "
    "(cancellation token, deadline, tenant, memory budget) threaded "
    "through execution, fair per-tenant admission replaces the bare "
    "FIFO device semaphore, and repeated device OOM escalates the "
    "degradation ladder.")
QUERY_DEADLINE = register(
    "spark.rapids.query.deadline", 0.0,
    "Per-query wall-clock deadline in seconds (0 = none). Checked "
    "cooperatively between batches and at admission; expiry cancels the "
    "query with QueryCancelled(reason=deadline).")
QUERY_TENANT = register(
    "spark.rapids.query.tenant", "default",
    "Tenant label for fair admission: queries queue per tenant and "
    "slots are granted to the tenant with the lowest in-use/weight "
    "ratio (FIFO within a tenant).")
QUERY_BUDGET = register(
    "spark.rapids.query.memoryBudgetBytes", 0,
    "Per-query device-memory budget in bytes (0 = none). A query "
    "whose ledger occupancy would exceed it is treated as a device "
    "OOM for that query only: the degradation ladder engages "
    "(memoryBudget.action=degrade) or the query is cancelled with "
    "QueryCancelled(reason=budget) (action=cancel).", conv=_bytes_conv)
QUERY_BUDGET_ACTION = register(
    "spark.rapids.query.memoryBudget.action", "degrade",
    "What a per-query memory-budget violation does: 'degrade' feeds "
    "the degradation ladder (spill -> width-1 -> cancel when "
    "exhausted), 'cancel' cancels the query immediately with "
    "reason=budget.")
ADMISSION_TIMEOUT = register(
    "spark.rapids.query.admission.timeout", 30.0,
    "Queue-time deadline in seconds: a query still waiting for an "
    "admission slot after this long is rejected with "
    "QueryCancelled(reason=admission). 0 disables.")
ADMISSION_MAX_QUEUE = register(
    "spark.rapids.query.admission.maxQueuedPerTenant", 32,
    "Bounded per-tenant admission queue: a tenant with this many "
    "queries already waiting has further arrivals rejected "
    "immediately with QueryCancelled(reason=admission).")
ADMISSION_WEIGHTS = register(
    "spark.rapids.query.admission.weights", "",
    "Per-tenant admission weights, 'tenantA:3,tenantB:1' — slots are "
    "granted to the waiting tenant with the lowest in-use/weight "
    "ratio. Unlisted tenants weigh 1.")
CANCEL_JOIN_TIMEOUT = register(
    "spark.rapids.query.cancel.joinTimeout", 5.0,
    "Bounded reap on the cluster cancel path: after the driver "
    "publishes the cancel marker it waits up to this long for "
    "claimed in-flight attempts to observe it (between batches) and "
    "settle before the classified QueryCancelled is raised.")
LADDER_ENABLED = register(
    "spark.rapids.query.degradation.enabled", True,
    "Memory-pressure degradation ladder: when split-and-retry's "
    "halving budget is exhausted, escalate forced spill -> width-1 "
    "admission -> the plan's CPU path instead of failing the query at "
    "the first rung.")
LADDER_EXCLUSIVE_TIMEOUT = register(
    "spark.rapids.query.degradation.exclusiveTimeout", 10.0,
    "Width-1 rung bound: how long a degraded query waits for every "
    "other admitted query to drain (new grants are paused) before "
    "retrying anyway.")

CANCEL_REASONS = ("user", "deadline", "budget", "admission")
LADDER_RUNGS = ("halve", "spill", "width1", "cpu")

#: seconds between a cluster worker's stats of the cancel marker
_MARKER_POLL_S = 0.05

QUERY_CANCELLED = _METRICS.counter(
    "rapids_query_cancelled_total",
    "Queries cancelled, classified by reason: user (explicit "
    "cancel()), deadline (per-query wall deadline expired), budget "
    "(per-query memory budget unsatisfiable), admission (queue-time "
    "deadline or bounded tenant queue overflow).", ("reason",))
QUERY_DEGRADED = _METRICS.counter(
    "rapids_query_degraded_total",
    "Degradation-ladder rungs entered under memory pressure: halve "
    "(split-and-retry), spill (forced spill of spillable batches), "
    "width1 (single-task admission), cpu (classified per-operator CPU "
    "fallback).", ("rung",))
ADMISSION_WAIT = _METRICS.histogram(
    "rapids_admission_wait_seconds",
    "Time a query waited in the fair admission queue before its slot "
    "was granted.")
ADMISSION_QUEUE_DEPTH = _METRICS.gauge(
    "rapids_admission_queue_depth",
    "Queries currently waiting for an admission slot, per tenant.",
    ("tenant",))


class QueryCancelled(RuntimeError):
    """A query stopped by the lifecycle layer, classified by reason
    (``user | deadline | budget | admission``)."""

    def __init__(self, reason: str, detail: str = "",
                 query_id: str = ""):
        self.reason = reason
        self.detail = detail
        self.query_id = query_id
        super().__init__(
            f"query {query_id or '?'} cancelled [{reason}]"
            + (f": {detail}" if detail else ""))


class CancellationToken:
    """First-cancel-wins classified cancellation flag; ``check()`` is
    the cooperative call (one attribute read and, with a deadline, one
    clock read when nothing is cancelled). A cluster worker's token
    also polls the driver's cancel marker (``cancel_file``) and holds a
    wall-clock deadline (``deadline_wall``: the processes' monotonic
    clocks do not compare)."""

    def __init__(self, query_id: str = "", deadline_s: float = 0.0,
                 deadline_wall: float = 0.0,
                 cancel_file: Optional[str] = None,
                 count_metric: bool = True):
        self.query_id = query_id
        self.reason: Optional[str] = None
        self.detail = ""
        # a worker's token does not count: the query's one count is the
        # driver's
        self._count_metric = count_metric
        self._lock = threading.Lock()
        self._deadline_s = deadline_s
        self._deadline_mono = (time.monotonic() + deadline_s
                               if deadline_s > 0 else 0.0)
        self._deadline_wall = deadline_wall
        self._cancel_file = cancel_file
        self._next_poll = 0.0

    @property
    def cancelled(self) -> bool:
        return self.reason is not None

    def cancel(self, reason: str, detail: str = "") -> bool:
        """The first cancel wins; later calls return False."""
        if reason not in CANCEL_REASONS:
            raise ValueError(f"unknown cancel reason {reason!r} "
                             f"(want one of {CANCEL_REASONS})")
        with self._lock:
            if self.reason is not None:
                return False
            self.reason = reason
            self.detail = detail
        if self._count_metric:
            QUERY_CANCELLED.labels(reason).inc()
        _FLIGHT.record("lifecycle", ev="cancel", query=self.query_id,
                       reason=reason, detail=detail[:200])
        return True

    def error(self) -> QueryCancelled:
        return QueryCancelled(self.reason or "user", self.detail,
                              self.query_id)

    def poll_local(self) -> Optional[str]:
        """The cancel reason or None, enforcing the deadlines, with no
        file read (for callers that hold a lock)."""
        if self.reason is not None:
            return self.reason
        if self._deadline_mono and time.monotonic() > self._deadline_mono:
            self.cancel("deadline",
                        f"deadline exceeded ({self._deadline_s}s)")
        elif self._deadline_wall and time.time() > self._deadline_wall:
            self.cancel("deadline", "deadline exceeded (wall)")
        return self.reason

    def poll(self) -> Optional[str]:
        """The cancel reason or None; enforces the deadlines and, at most
        every ``_MARKER_POLL_S``, reads the cancel marker."""
        if self.poll_local() is not None:
            return self.reason
        if self._cancel_file is not None:
            now = time.monotonic()
            if now >= self._next_poll:
                self._next_poll = now + _MARKER_POLL_S
                if os.path.exists(self._cancel_file):
                    self.cancel(*read_cancel_marker(self._cancel_file))
        return self.reason

    def check(self) -> None:
        """Raise the classified ``QueryCancelled`` once cancelled."""
        if self.poll() is not None:
            raise self.error()


def read_cancel_marker(path: str) -> tuple:
    """``(reason, detail)`` of a rendezvous cancel marker: its first
    word is the reason when it is one, the rest the detail; anything
    else reads as ``user``."""
    reason, detail = "user", "cancel marker observed"
    try:
        with open(path) as f:
            head = f.read(600).strip()
    except OSError:
        return reason, detail
    if head:
        parts = head.split(" ", 1)
        if parts[0] in CANCEL_REASONS:
            reason = parts[0]
            if len(parts) > 1:
                detail = parts[1]
    return reason, detail


class QueryContext:
    """Per-query lifecycle state, carried by ``ExecCtx.qctx``."""

    def __init__(self, conf: Optional[RapidsConf] = None,
                 query_id: Optional[str] = None,
                 tenant: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 budget_bytes: Optional[int] = None,
                 token: Optional[CancellationToken] = None):
        conf = conf or RapidsConf()
        self.conf = conf
        self.query_id = query_id or f"qc{uuid.uuid4().hex[:10]}"
        self.tenant = tenant if tenant is not None \
            else conf.get(QUERY_TENANT)
        self.deadline_s = deadline_s if deadline_s is not None \
            else conf.get(QUERY_DEADLINE)
        self.budget_bytes = budget_bytes if budget_bytes is not None \
            else conf.get(QUERY_BUDGET)
        self.budget_action = conf.get(QUERY_BUDGET_ACTION)
        self.token = token or CancellationToken(
            self.query_id, deadline_s=self.deadline_s)
        self.ladder = DegradationLadder(self) \
            if conf.get(LADDER_ENABLED) else None
        # created -> queued -> admitted
        self.phase = "created"
        self.admission_wait_s = 0.0

    @classmethod
    def from_conf(cls, conf: RapidsConf,
                  query_id: Optional[str] = None) -> "QueryContext":
        return cls(conf, query_id=query_id)

    @classmethod
    def for_worker(cls, payload: Dict,
                   conf: RapidsConf) -> Optional["QueryContext"]:
        """A cluster worker's context from its task payload: a token
        that polls the driver's cancel marker and holds the wall-clock
        deadline; no ladder (a worker's OOM past split-and-retry stays
        a retryable task failure)."""
        lc = payload.get("lifecycle")
        if not lc:
            return None
        token = CancellationToken(
            lc.get("query_id", ""),
            deadline_wall=lc.get("deadline_wall", 0.0),
            cancel_file=lc.get("cancel_path"), count_metric=False)
        qx = cls(conf, query_id=lc.get("query_id"),
                 tenant=lc.get("tenant"), deadline_s=0.0, token=token)
        qx.ladder = None
        return qx

    def worker_payload(self, cancel_path: str) -> Dict:
        """The picklable part of this context a task payload carries."""
        wall = time.time() + max(
            0.0, self.token._deadline_mono - time.monotonic()) \
            if self.token._deadline_mono else 0.0
        return {"query_id": self.query_id, "tenant": self.tenant,
                "cancel_path": cancel_path, "deadline_wall": wall}

    def cancel(self, detail: str = "user requested") -> bool:
        return self.token.cancel("user", detail)

    def check(self) -> None:
        self.token.check()

    def poll(self) -> Optional[str]:
        return self.token.poll()


class DegradationLadder:
    """Per-query OOM escalation state, driven by
    ``memory.DeviceMemoryManager.with_retry``: ``halve`` is
    split-and-retry itself; each OOM after the halving budget climbs one
    rung (sticky at ``cpu``). ``counts`` holds the rungs entered."""

    def __init__(self, qctx: "QueryContext"):
        self._qctx = qctx
        self._idx = 0
        self.counts: Dict[str, int] = {}
        self.causes = []

    def note_halve(self) -> None:
        if "halve" not in self.counts:
            QUERY_DEGRADED.labels("halve").inc()
        self.counts["halve"] = self.counts.get("halve", 0) + 1

    def escalate(self, cause: str = "oom") -> str:
        """Enter the next rung above halving and return its name;
        ``cause`` is ``oom`` or ``disk_pressure``."""
        self._idx = min(self._idx + 1, len(LADDER_RUNGS) - 1)
        rung = LADDER_RUNGS[self._idx]
        self.counts[rung] = self.counts.get(rung, 0) + 1
        self.causes.append((rung, cause))
        QUERY_DEGRADED.labels(rung).inc()
        _FLIGHT.record("lifecycle", ev="degrade", rung=rung,
                       cause=cause, query=self._qctx.query_id)
        return rung


# --- fair admission ---------------------------------------------------------

def _parse_weights(spec: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            out[name.strip()] = max(float(w), 1e-9)
        except ValueError:
            raise ValueError(
                f"bad admission weight {part!r} in "
                f"spark.rapids.query.admission.weights "
                f"(want 'tenant:weight,...')") from None
    return out


class _Waiter:
    __slots__ = ("tenant", "query_id", "granted", "abandoned")

    def __init__(self, tenant: str, query_id: str):
        self.tenant = tenant
        self.query_id = query_id
        self.granted = False
        self.abandoned = False


class _Slot:
    """A granted slot; a context manager that releases it."""

    __slots__ = ("_ctl", "tenant", "query_id", "_released")

    def __init__(self, ctl: "FairAdmissionController", tenant: str,
                 query_id: str):
        self._ctl = ctl
        self.tenant = tenant
        self.query_id = query_id
        self._released = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

    def release(self):
        if not self._released:
            self._released = True
            self._ctl._release(self)


class FairAdmissionController:
    """Weighted fair admission over N slots (module docstring).
    ``slot(qctx)`` is the entry point; ``qctx=None`` is a plain
    semaphore (default tenant, no deadline, no queue bound)."""

    def __init__(self, slots: int, conf: Optional[RapidsConf] = None):
        conf = conf or RapidsConf()
        self._slots = max(1, int(slots))
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._tenant_use: Dict[str, int] = {}
        self._weights = _parse_weights(conf.get(ADMISSION_WEIGHTS))
        self._max_queue = max(1, conf.get(ADMISSION_MAX_QUEUE))
        self._timeout = conf.get(ADMISSION_TIMEOUT)
        self.in_use = 0
        self._exclusive: Optional[str] = None
        from .config import INJECT_FAULTS
        self._chaos_spec = str(conf.get(INJECT_FAULTS) or "")

    def snapshot(self) -> Dict:
        with self._cv:
            return {"slots": self._slots, "in_use": self.in_use,
                    "tenants": dict(self._tenant_use),
                    "queued": {t: len(q) for t, q in self._queues.items()
                               if q},
                    "exclusive": self._exclusive}

    def _weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def _grant_locked(self) -> None:
        """Hand free slots to waiters: lowest in-use/weight tenant
        first, FIFO within a tenant. Called under ``_cv``."""
        while self.in_use < self._slots:
            if self._exclusive is not None:
                break  # width-1 rung: grants paused
            best = None
            for tenant, q in self._queues.items():
                if not q:
                    continue
                score = (self._tenant_use.get(tenant, 0)
                         / self._weight(tenant))
                if best is None or score < best[0]:
                    best = (score, tenant)
            if best is None:
                break
            w: _Waiter = self._queues[best[1]].popleft()
            if w.abandoned:
                continue
            w.granted = True
            self.in_use += 1
            self._tenant_use[w.tenant] = \
                self._tenant_use.get(w.tenant, 0) + 1
            self._cv.notify_all()

    def _queue_gauge(self, tenant: str) -> None:
        ADMISSION_QUEUE_DEPTH.labels(tenant).set(
            len(self._queues.get(tenant, ())))

    def slot(self, qctx: Optional[QueryContext] = None) -> _Slot:
        """Block until admitted (or raise the classified
        ``QueryCancelled``); use as a context manager."""
        tenant = qctx.tenant if qctx is not None else "default"
        qid = qctx.query_id if qctx is not None else ""
        token = qctx.token if qctx is not None else None
        t0 = time.monotonic()
        adm_deadline = t0 + self._timeout \
            if qctx is not None and self._timeout > 0 else None
        # the chaos delay counts as queue time: that is its point
        self._maybe_chaos_delay(qid)
        if adm_deadline is not None and time.monotonic() > adm_deadline:
            self._reject(token,
                         f"no admission slot within {self._timeout}s "
                         f"(tenant {tenant!r})")
        w = _Waiter(tenant, qid)
        if qctx is not None:
            qctx.phase = "queued"
        with self._cv:
            q = self._queues.setdefault(tenant, deque())
            if qctx is not None and len(q) >= self._max_queue:
                self._reject(token,
                             f"tenant {tenant!r} admission queue full "
                             f"({self._max_queue} waiting)")
            q.append(w)
            self._queue_gauge(tenant)
            self._grant_locked()
            poll_s = 0.05 if (token is not None
                              or adm_deadline is not None) else None
            try:
                while not w.granted:
                    if token is not None and token.poll_local() is not None:
                        raise token.error()
                    if adm_deadline is not None \
                            and time.monotonic() > adm_deadline:
                        self._reject(
                            token,
                            f"no admission slot within "
                            f"{self._timeout}s (tenant {tenant!r})")
                    self._cv.wait(timeout=poll_s)
            except BaseException:
                w.abandoned = True
                if w.granted:
                    # granted between the last check and the raise
                    self._release_locked(tenant, qid)
                raise
            finally:
                if w in q:
                    q.remove(w)
                self._queue_gauge(tenant)
        ADMISSION_WAIT.observe(time.monotonic() - t0)
        if qctx is not None:
            qctx.phase = "admitted"
            qctx.admission_wait_s = time.monotonic() - t0
        return _Slot(self, tenant, qid)

    def _reject(self, token: CancellationToken, detail: str):
        token.cancel("admission", detail)
        raise token.error()

    def _release_locked(self, tenant: str, query_id: str) -> None:
        self.in_use -= 1
        c = self._tenant_use.get(tenant, 1) - 1
        if c <= 0:
            self._tenant_use.pop(tenant, None)
        else:
            self._tenant_use[tenant] = c
        if self._exclusive is not None and self._exclusive == query_id:
            self._exclusive = None
        self._grant_locked()
        self._cv.notify_all()

    def _release(self, slot: _Slot) -> None:
        with self._cv:
            self._release_locked(slot.tenant, slot.query_id)

    def _maybe_chaos_delay(self, query_id: str) -> None:
        """A ``slow_admission`` rule matching this query delays its
        admission by its seconds (default 2)."""
        if "slow_admission" not in self._chaos_spec:
            return
        from .scheduler.chaos import find_rule
        rule = find_rule(self._chaos_spec, -1, query_id or "?", 0,
                         modes=("slow_admission",))
        if rule is not None:
            time.sleep(rule.arg(2.0))

    def clear_exclusive(self, query_id: str) -> None:
        """Drop width-1 exclusivity held by this query; the collect
        root calls it at query end."""
        with self._cv:
            if self._exclusive == query_id:
                self._exclusive = None
                self._grant_locked()
                self._cv.notify_all()

    def await_exclusive(self, qctx: QueryContext,
                        timeout: float) -> None:
        """Width-1 rung: pause new grants and wait (bounded) until this
        query's slot is the only one in use. A second degrading query
        waits for the first's claim to clear instead of overwriting
        it."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cv:
            while self._exclusive is not None \
                    and self._exclusive != qctx.query_id \
                    and time.monotonic() < deadline:
                if qctx.token.poll_local() is not None:
                    return
                self._cv.wait(timeout=0.05)
            if self._exclusive is None:
                self._exclusive = qctx.query_id
            elif self._exclusive != qctx.query_id:
                return  # still contended past the bound: retry anyway
            while self.in_use > 1 and time.monotonic() < deadline:
                if qctx.token.poll_local() is not None:
                    break
                self._cv.wait(timeout=0.05)

"""Driver-side task scheduler for the filesystem rendezvous.

Counterpart of ``spark_rapids_tpu/scheduler/task_scheduler.py`` without
its gang route (``run_gang``, ``GangFailedError``: the mesh of ROADMAP
item 17). The TaskSetManager analog for ``GpuProcessCluster``:
`cluster.py` turns a stage into `TaskSpec`s and hands them to
`TaskScheduler.run_stage`, which owns everything that can go wrong
between submit and commit:

- **attempt tracking / bounded retry** — a failed attempt (``.err``
  marker, worker death, or hang) is retried on another worker up to
  ``spark.rapids.tpu.task.maxAttempts`` times, excluding workers that
  already failed this task;
- **worker blacklisting** — a worker with
  ``maxTaskFailuresPerWorker`` failures gets no new attempts;
- **liveness** — worker processes are polled for death, and heartbeat
  files (written by a worker-side thread) for wedging; a dead or wedged
  worker is killed and respawned (bounded by ``maxWorkerRespawns``)
  with its stale task files removed so a zombie can't re-claim them;
- **speculation** — with ``spark.rapids.tpu.speculation``, a task
  running ``speculation.multiplier``x the stage's median completed-task
  time gets a duplicate attempt; whichever commits first wins (the
  attempt-suffixed shuffle commit in shuffle/host.py makes the race
  safe — a loser's output atomically never appears).

Every transition is appended to ``self.events`` (task, attempt, worker,
event, wall_s, reason) — `cluster.run_query` forwards them to the event
log so tools/profiling.py can report retry overhead next to hotspots.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence

from ..config import (FLIGHT_STRAGGLER_FACTOR, HEARTBEAT_TIMEOUT,
                      MAX_TASK_FAILURES_PER_WORKER, MAX_WORKER_RESPAWNS,
                      RapidsConf, SPECULATION, SPECULATION_MIN_RUNTIME,
                      SPECULATION_MULTIPLIER, STAGE_TIMEOUT,
                      TASK_MAX_ATTEMPTS, TASK_TIMEOUT)
from ..obs.metrics import REGISTRY as _METRICS
from ..obs.recorder import RECORDER as _FLIGHT
from ..obs.tracer import NULL_TRACER

__all__ = ["TaskSpec", "TaskScheduler", "FetchFailedError"]

_POLL_S = 0.02
# a worker's interpreter, `import torch`, CUDA initialisation and the
# load of the built kernels come before its first beat
_FIRST_BEAT_GRACE_S = 60.0

# live scheduler health, scrapeable mid-query (the event list is only
# mined after the fact)
_SCHED_EVENTS = _METRICS.counter(
    "rapids_scheduler_events_total",
    "Task scheduler lifecycle events by type: task_submitted / task_ok "
    "/ task_failed / attempt_lost / speculative_attempt / "
    "worker_respawn / worker_blacklisted / straggler_detected / "
    "fetch_failed / spill_read_failed / stage_rerun / "
    "query_cancelled.",
    ("event",))


class FetchFailedError(RuntimeError):
    """Driver-side escalation of a reader-side shuffle FetchFailure:
    the named committed map output is lost/corrupt, so retrying the
    READING task against the same bytes is pointless — the caller
    (cluster.py) quarantines the output, re-executes the producing map
    task from lineage, and resumes the stage. Deliberately NOT a task
    failure: it never counts against the reduce task's attempt budget
    or the reading worker's blacklist score (Spark's FetchFailed
    semantics)."""

    def __init__(self, shuffle_id: int, map_task: str, kind: str,
                 path: str, task: str, attempt: int, worker: int,
                 completed):
        self.shuffle_id = int(shuffle_id)
        self.map_task = map_task
        self.kind = kind
        self.path = path
        self.task = task
        self.attempt = attempt
        self.worker = worker
        #: tasks of the interrupted stage that already committed —
        #: their output survives; only the rest re-run after recovery
        self.completed = set(completed)
        super().__init__(
            f"task {task} a{attempt} (worker {worker}): shuffle "
            f"{shuffle_id} map output {map_task} unreadable "
            f"[{kind}] at {path}")


@dataclasses.dataclass
class TaskSpec:
    """One schedulable unit: a picklable (kind, payload) the worker loop
    knows how to run, under a filesystem-safe stable id."""
    task_id: str
    kind: str
    payload: Dict


class _Attempt:
    # duration/timeout math runs on time.monotonic() so a wall-clock
    # step (NTP, manual set) can't fire spurious timeouts or respawns;
    # submit_wall exists only for event/span timestamps
    def __init__(self, spec: TaskSpec, number: int, worker: int,
                 path: str):
        self.spec = spec
        self.number = number
        self.worker = worker
        self.path = path
        self.submit_ts = time.monotonic()
        self.submit_wall = time.time()
        self.claim_ts: Optional[float] = None  # monotonic
        self.state = "running"  # running | ok | err | lost

    @property
    def runtime(self) -> float:
        return time.monotonic() - (self.claim_ts or self.submit_ts)

    @property
    def age(self) -> float:
        """Submit-to-now wall span for the attempt's trace span."""
        return time.monotonic() - self.submit_ts


class TaskScheduler:
    """One instance per query; stages run through it sequentially.

    ``pool`` is the cluster's worker pool: ``n``, ``alive(w)``,
    ``exit_info(w)``, ``kill(w)``, ``respawn(w)``,
    ``heartbeat_age(w)``, ``spawn_ts(w)``.
    """

    def __init__(self, pool, tasks_dir: str, conf: RapidsConf,
                 query_id: str = "q", tracer=NULL_TRACER, qctx=None):
        self.pool = pool
        self.tasks_dir = tasks_dir
        self.conf = conf
        self.query_id = query_id
        self.tracer = tracer
        # query lifecycle (lifecycle.py): the poll loop checks the
        # token/deadline every pass; on cancellation the driver
        # publishes a rendezvous marker workers poll between batches,
        # reaps in-flight attempts (bounded join), and raises the
        # classified QueryCancelled
        self._qctx = qctx
        self._cancel_path = os.path.join(
            tasks_dir, f"{query_id}.cancel")
        self._cancel_published = False
        from ..lifecycle import CANCEL_JOIN_TIMEOUT
        self._cancel_join_s = conf.get(CANCEL_JOIN_TIMEOUT)
        self._stage_span_id: Optional[str] = None
        self.events: List[Dict] = []
        self.worker_failures: Dict[int, int] = {}
        self.blacklist: set = set()
        self.respawns_used = 0
        # attempt NUMBERING is per-QUERY, not per-run_stage call: a
        # lineage stage rerun re-submits the same task ids, and
        # restarting at attempt 0 would re-trigger attempt-pinned chaos
        # rules and collide with the first run's rendezvous markers.
        # The maxAttempts BUDGET stays per-stage-run (attempts_used in
        # _run_stage) — successful earlier launches of a rerun task
        # must not eat its failure allowance.
        self._attempt_seq: Dict[str, int] = {}
        self._max_attempts = max(1, conf.get(TASK_MAX_ATTEMPTS))
        self._max_wfail = max(1, conf.get(MAX_TASK_FAILURES_PER_WORKER))
        self._max_respawns = conf.get(MAX_WORKER_RESPAWNS)
        self._task_timeout = conf.get(TASK_TIMEOUT)
        self._stage_timeout = conf.get(STAGE_TIMEOUT)
        self._hb_timeout = conf.get(HEARTBEAT_TIMEOUT)
        self._speculation = conf.get(SPECULATION)
        self._spec_mult = conf.get(SPECULATION_MULTIPLIER)
        self._spec_min_s = conf.get(SPECULATION_MIN_RUNTIME)
        # flight-recorder straggler trigger — always on, independent of
        # speculation (which LAUNCHES duplicates; this only RECORDS)
        self._straggler_factor = conf.get(FLIGHT_STRAGGLER_FACTOR)
        self._stragglers_seen: set = set()
        self._current_stage = ""

    # --- event log --------------------------------------------------------

    def _event(self, event: str, task: str = "", attempt: int = -1,
               worker: int = -1, wall_s: float = 0.0, reason: str = ""):
        self.events.append({
            "ts": time.time(), "event": event, "task": task,
            "attempt": attempt, "worker": worker,
            "stage": self._current_stage,
            "wall_s": round(wall_s, 6), "reason": reason[-500:]})
        _SCHED_EVENTS.labels(event).inc()
        # flight-recorder tap: scheduler transitions join the driver's
        # always-on ring (works with tracing disabled)
        _FLIGHT.record("sched", event=event, task=task, attempt=attempt,
                       worker=worker, stage=self._current_stage,
                       wall_s=round(wall_s, 6), reason=reason[-200:])

    # --- tracing ----------------------------------------------------------

    @staticmethod
    def attempt_span_id(task_id: str, number: int) -> str:
        """Deterministic id: workers parent their task spans onto the
        attempt span BEFORE the driver emits it (at harvest)."""
        return f"{task_id}.a{number}"

    def _close_attempt_span(self, att: _Attempt, state: str,
                            reason: str = ""):
        """Retroactive driver-side span covering submit -> retirement,
        on the worker's trace track (the attempt ran there)."""
        if not self.tracer.enabled:
            return
        args = {"worker": att.worker, "state": state}
        if reason:
            args["reason"] = reason[-200:]
        self.tracer.emit(
            f"attempt {att.spec.task_id} a{att.number}", "attempt",
            att.submit_wall, att.age,
            span_id=self.attempt_span_id(att.spec.task_id, att.number),
            parent_id=self._stage_span_id, pid=att.worker + 1, args=args)

    def _absorb_worker_spans(self, att: _Attempt):
        """Pull in the span file the worker committed next to its
        .ok/.err marker; a crashed worker simply has none."""
        if not self.tracer.enabled:
            return
        try:
            with open(att.path + ".spans") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        if isinstance(doc, dict):
            self.tracer.absorb(doc.get("spans") or [])
            # worker-side drops surface in the stitched trace's
            # dropped_spans (check_obs_output keys parent-linkage
            # strictness off it)
            self.tracer.dropped += int(doc.get("dropped", 0) or 0)
        else:  # bare span list (older flush shape)
            self.tracer.absorb(doc)

    def summary(self) -> Dict:
        """Rollup for the query event log / profiler."""
        c = {}
        for e in self.events:
            c[e["event"]] = c.get(e["event"], 0) + 1
        overhead = sum(e["wall_s"] for e in self.events
                       if e["event"] in ("task_failed", "attempt_lost",
                                         "fetch_failed"))
        return {
            "tasks_ok": c.get("task_ok", 0),
            "failures": c.get("task_failed", 0),
            "speculative_launched": c.get("speculative_attempt", 0),
            "speculative_lost": c.get("attempt_lost", 0),
            "workers_respawned": c.get("worker_respawn", 0),
            "workers_blacklisted": len(self.blacklist),
            "fetch_failures": c.get("fetch_failed", 0),
            "spill_read_failures": c.get("spill_read_failed", 0),
            "stage_reruns": c.get("stage_rerun", 0),
            "retry_overhead_s": round(overhead, 6),
        }

    def live_status(self) -> Dict:
        """Point-in-time view for the /status endpoint: the running
        stage plus monotonic event counts. Read unlocked from another
        thread — the event list only appends, so a snapshot copy is
        always a consistent prefix."""
        c: Dict[str, int] = {}
        for e in list(self.events):
            c[e["event"]] = c.get(e["event"], 0) + 1
        return {"query_id": self.query_id,
                "stage": self._current_stage,
                "tasks_ok": c.get("task_ok", 0),
                "tasks_failed": c.get("task_failed", 0),
                "stage_reruns": c.get("stage_rerun", 0),
                "cancelled": c.get("query_cancelled", 0) > 0}

    @staticmethod
    def _read_marker(path: str, suffix: str) -> Optional[Dict]:
        """A worker's structured classification marker (``.qcancel`` /
        ``.fetchfail`` / ``.spillfail``, written tmp+rename next to its
        ``.err`` BEFORE the .err commits), or None for ordinary task
        errors."""
        try:
            with open(path + "." + suffix) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return doc if isinstance(doc, dict) else None

    # --- worker selection -------------------------------------------------

    def _usable(self, w: int) -> bool:
        return w not in self.blacklist and self.pool.alive(w)

    def _load(self, running: List[_Attempt], w: int) -> int:
        return sum(1 for a in running if a.worker == w)

    def _pick_worker(self, running: List[_Attempt],
                     exclude: set) -> Optional[int]:
        """Least-loaded usable worker, preferring ones this task hasn't
        failed on; falls back to excluded workers rather than stalling
        (Spark does the same when locality/blacklist leave no one).
        None when every worker is dead or blacklisted — the caller
        decides whether to spend the respawn budget."""
        usable = [w for w in range(self.pool.n) if self._usable(w)]
        preferred = [w for w in usable if w not in exclude]
        pool = preferred or usable
        if pool:
            return min(pool, key=lambda w: (self._load(running, w), w))
        return None

    def _pick_respawn_candidate(
            self, running: List[_Attempt]) -> Optional[int]:
        """Every worker is dead or blacklisted: buy one back with the
        respawn budget (blacklist is per-incarnation, a fresh process
        starts clean). Prefer workers with no in-flight attempt —
        recycling a busy one retires its attempt, which can burn a
        task's last allowed try."""
        if self.respawns_used >= self._max_respawns:
            return None
        idle = [w for w in range(self.pool.n)
                if not any(a.worker == w for a in running)]
        return min(idle or range(self.pool.n),
                   key=lambda w: self.worker_failures.get(w, 0))

    def _respawn(self, w: int, reason: str):
        self._clear_worker_tasks(w)
        self.pool.respawn(w)
        self.respawns_used += 1
        self.blacklist.discard(w)
        self.worker_failures[w] = 0
        self._event("worker_respawn", worker=w, reason=reason)

    def _clear_worker_tasks(self, w: int):
        """Unlink task files addressed to a dead/killed worker so its
        respawned incarnation cannot re-claim them and race the retry
        as a zombie attempt."""
        try:
            names = os.listdir(self.tasks_dir)
        except FileNotFoundError:
            return
        suffix = f".w{w}.task"
        for n in names:
            if n.endswith(suffix):
                try:
                    os.unlink(os.path.join(self.tasks_dir, n))
                except OSError:
                    pass

    # --- submission -------------------------------------------------------

    def _launch(self, spec: TaskSpec, number: int, worker: int,
                running: List[_Attempt]) -> _Attempt:
        payload = dict(spec.payload)
        payload["task_id"] = spec.task_id
        payload["attempt"] = number
        if self._qctx is not None:
            # cancel marker path + wall deadline ride the pickle: the
            # worker's token polls the marker between batches and
            # honors the deadline locally even if the driver stalls
            payload["lifecycle"] = self._qctx.worker_payload(
                self._cancel_path)
        if self.tracer.enabled:
            # trace context rides the task pickle: the worker's spans
            # join the driver's trace under this attempt's span, and
            # the worker's span buffer honors the same bound
            payload["trace"] = {
                "trace_id": self.tracer.trace_id,
                "parent": self.attempt_span_id(spec.task_id, number),
                "max_spans": self.tracer.max_spans}
        name = f"{spec.task_id}.a{number}.w{worker}.task"
        path = os.path.join(self.tasks_dir, name)
        with open(path + ".tmp", "wb") as f:
            pickle.dump((spec.kind, payload), f, protocol=4)
        os.replace(path + ".tmp", path)
        att = _Attempt(spec, number, worker, path)
        running.append(att)
        return att

    # --- query lifecycle --------------------------------------------------

    def _check_lifecycle(self, running: List[_Attempt]) -> None:
        """One poll-loop pass of the lifecycle layer: enforce the
        query deadline / observe an external cancel, and on
        cancellation publish the marker, reap, and raise."""
        q = self._qctx
        if q is None or q.poll() is None:
            return
        self._cancel_and_reap(running)

    def _cancel_and_reap(self, running: List[_Attempt]) -> None:
        """The cancel fan-out: (1) atomically publish the rendezvous
        ``<query>.cancel`` marker every in-flight worker token polls
        between batches, (2) unlink unclaimed task files so no worker
        starts a dead query's work, (3) bounded-join the claimed
        attempts until they settle (.ok/.err) or the join timeout
        passes, then raise the classified QueryCancelled. Worker-side
        settlement runs the tasks' normal failure paths, so staged
        shuffle attempts abort and ledger entries release."""
        tok = self._qctx.token
        if not self._cancel_published:
            self._cancel_published = True
            try:
                with open(self._cancel_path + ".tmp", "w") as f:
                    f.write(f"{tok.reason} {tok.detail}"[:600])
                os.replace(self._cancel_path + ".tmp",
                           self._cancel_path)
            except OSError:
                pass  # workers still stop via the deadline/err paths
            self._event("query_cancelled",
                        reason=f"[{tok.reason}] {tok.detail}")
        for att in list(running):
            if att.claim_ts is None \
                    and not os.path.exists(att.path + ".claim"):
                # never claimed: retract the task file entirely
                try:
                    os.unlink(att.path)
                except OSError:
                    pass
                att.state = "lost"
                running.remove(att)
                self._close_attempt_span(att, "lost", "query cancelled")
                self._event("attempt_lost", att.spec.task_id,
                            att.number, att.worker, att.runtime,
                            "query cancelled before claim")
        deadline = time.monotonic() + max(0.0, self._cancel_join_s)
        while time.monotonic() < deadline:
            unsettled = [a for a in running
                         if not os.path.exists(a.path + ".ok")
                         and not os.path.exists(a.path + ".err")]
            if not unsettled:
                break
            time.sleep(_POLL_S)  # bounded by cancel.joinTimeout
        raise tok.error()

    # --- stage loop -------------------------------------------------------

    def run_stage(self, specs: Sequence[TaskSpec],
                  stage_label: str = "stage") -> None:
        """Run every spec to a committed ``.ok``; raises RuntimeError /
        TimeoutError when retries, respawns, or the stage clock run out."""
        with self.tracer.span(f"stage {stage_label}", cat="stage",
                              args={"tasks": len(specs)}) as sp:
            self._stage_span_id = getattr(sp, "span_id", None)
            self._current_stage = stage_label
            try:
                self._run_stage(specs, stage_label)
            finally:
                self._stage_span_id = None
                self._current_stage = ""

    def _run_stage(self, specs: Sequence[TaskSpec],
                   stage_label: str) -> None:
        deadline = time.monotonic() + self._stage_timeout
        running: List[_Attempt] = []
        done: set = set()
        attempts_used: Dict[str, int] = {}
        failed_on: Dict[str, set] = {s.task_id: set() for s in specs}
        queue: List[TaskSpec] = list(specs)
        durations: List[float] = []

        def fail_attempt(att: _Attempt, reason: str, worker_fault: bool):
            att.state = "err"
            running.remove(att)
            self._close_attempt_span(att, "err", reason)
            w = att.worker
            if worker_fault:
                self.worker_failures[w] = self.worker_failures.get(w, 0) + 1
                if self.worker_failures[w] >= self._max_wfail \
                        and w not in self.blacklist:
                    self.blacklist.add(w)
                    self._event("worker_blacklisted", worker=w,
                                reason=f"{self.worker_failures[w]} failures")
            failed_on[att.spec.task_id].add(w)
            self._event("task_failed", att.spec.task_id, att.number, w,
                        att.runtime, reason)
            if att.spec.task_id in done:
                return  # a sibling attempt already committed
            live = [a for a in running if a.spec.task_id == att.spec.task_id]
            if live:
                return  # the speculative sibling is still going
            if attempts_used[att.spec.task_id] >= self._max_attempts:
                raise RuntimeError(
                    f"worker task {att.spec.task_id} failed after "
                    f"{attempts_used[att.spec.task_id]} attempts "
                    f"({stage_label}):\n{reason}")
            queue.append(att.spec)

        def handle_worker_loss(w: int, reason: str):
            # an attempt that already wrote its .ok finished BEFORE the
            # worker was lost — leave it for the harvest pass instead of
            # recording a success as a worker-fault failure
            victims = [a for a in running if a.worker == w
                       and not os.path.exists(a.path + ".ok")]
            self._clear_worker_tasks(w)
            # pre-assigned-but-unclaimed tasks on w are victims too
            for att in victims:
                fail_attempt(att, reason, worker_fault=True)
            if self.respawns_used < self._max_respawns:
                self._respawn(w, reason)
            elif not any(self._usable(x) for x in range(self.pool.n)) \
                    and (queue or running):
                raise RuntimeError(
                    f"{reason}; respawn budget "
                    f"({self._max_respawns}) exhausted")

        # superseded attempts (task already committed by a sibling) keep
        # their worker busy but must not block stage completion — there
        # is no per-task kill in the filesystem protocol, so the stage
        # is done when every TASK is done, not every attempt
        def outstanding():
            return queue or any(a.spec.task_id not in done
                                for a in running)

        while outstanding():
            self._check_lifecycle(running)
            if time.monotonic() > deadline:
                pending = sorted({a.spec.task_id for a in running
                                  if a.spec.task_id not in done}
                                 | {s.task_id for s in queue})
                raise TimeoutError(
                    f"{stage_label}: tasks {pending} timed out after "
                    f"{self._stage_timeout}s")

            # launch queued (re)tries
            for spec in queue:
                w = self._pick_worker(running, failed_on[spec.task_id])
                if w is None:
                    w = self._pick_respawn_candidate(running)
                    if w is None:
                        raise RuntimeError(
                            f"worker task {spec.task_id} unschedulable: "
                            f"all workers dead or blacklisted and respawn "
                            f"budget ({self._max_respawns}) exhausted")
                    # any attempt still marked running on the candidate
                    # dies with the old incarnation — retire it first so
                    # the stage can't wait forever on a ghost
                    for att in [a for a in running if a.worker == w]:
                        fail_attempt(att, "worker recycled under attempt",
                                     worker_fault=False)
                    self._respawn(w, "no usable worker left")
                n = self._attempt_seq.get(spec.task_id, 0)
                self._attempt_seq[spec.task_id] = n + 1
                attempts_used[spec.task_id] = \
                    attempts_used.get(spec.task_id, 0) + 1
                self._launch(spec, n, w, running)
                self._event("task_submitted", spec.task_id, n, w)
            queue = []

            # harvest markers
            for att in list(running):
                if att not in running:
                    continue  # a handle_worker_loss() earlier in this
                    # pass already retired this snapshot entry
                if att.claim_ts is None and os.path.exists(
                        att.path + ".claim"):
                    att.claim_ts = time.monotonic()
                if os.path.exists(att.path + ".ok"):
                    att.state = "ok"
                    running.remove(att)
                    self._absorb_worker_spans(att)
                    tid = att.spec.task_id
                    if tid in done:
                        # zombie / speculation loser: completed after a
                        # sibling already won the commit race
                        att.state = "lost"
                        self._close_attempt_span(att, "lost")
                        self._event("attempt_lost", tid, att.number,
                                    att.worker, att.runtime)
                    else:
                        done.add(tid)
                        durations.append(att.runtime)
                        self._close_attempt_span(att, "ok")
                        self._event("task_ok", tid, att.number,
                                    att.worker, att.runtime)
                elif os.path.exists(att.path + ".err"):
                    try:
                        with open(att.path + ".err") as f:
                            tb = f.read()
                    except OSError:
                        tb = "(unreadable .err)"
                    self._absorb_worker_spans(att)
                    qc = self._read_marker(att.path, "qcancel")
                    if qc is not None and self._qctx is not None:
                        # the worker classified the stop itself (its
                        # token saw the marker/deadline/budget first):
                        # adopt the classification and take the cancel
                        # path — never a retry, never a worker fault
                        att.state = "err"
                        running.remove(att)
                        self._close_attempt_span(
                            att, "cancelled", qc.get("reason", ""))
                        from ..lifecycle import CANCEL_REASONS
                        r = qc.get("reason")
                        self._qctx.token.cancel(
                            r if r in CANCEL_REASONS else "user",
                            qc.get("detail", ""))
                        self._cancel_and_reap(running)
                    ff = self._read_marker(att.path, "fetchfail")
                    if ff is not None and ff.get("map_task"):
                        # classified shuffle-read failure with a known
                        # producer: escalate to lineage recovery
                        # instead of retrying the reader against the
                        # same bad bytes — and blame neither the
                        # reading task nor its worker
                        att.state = "err"
                        running.remove(att)
                        kind = ff.get("kind", "io")
                        reason = (f"[{kind}] shuffle "
                                  f"{ff.get('shuffle_id', -1)} map "
                                  f"{ff['map_task']} "
                                  f"({os.path.basename(ff.get('path') or '')})")
                        self._close_attempt_span(att, "fetchfail", reason)
                        self._event("fetch_failed", att.spec.task_id,
                                    att.number, att.worker, att.runtime,
                                    reason)
                        raise FetchFailedError(
                            ff.get("shuffle_id", -1), ff["map_task"],
                            kind, ff.get("path", ""), att.spec.task_id,
                            att.number, att.worker, completed=set(done))
                    sf = self._read_marker(att.path, "spillfail")
                    if sf is not None:
                        # classified spill-tier loss (SpillReadError):
                        # the task retries normally — re-execution
                        # regenerates the data the disk lost — but the
                        # worker is NEVER blamed: a corrupt/torn/
                        # missing spill file is bit rot or disk churn,
                        # not a process fault, and blacklisting the
                        # reader would punish the only machine that
                        # noticed
                        kind = sf.get("kind", "io")
                        reason = (f"[spill {kind}] "
                                  f"{os.path.basename(sf.get('path') or '')}"
                                  f": {(sf.get('detail') or '')[:200]}")
                        self._event("spill_read_failed",
                                    att.spec.task_id, att.number,
                                    att.worker, att.runtime, reason)
                        fail_attempt(att, reason, worker_fault=False)
                        continue
                    # a worker that stopped itself on the query's own
                    # cancel marker / deadline is healthy — don't let
                    # cooperative cancellation feed the blacklist
                    fail_attempt(att, tb,
                                 worker_fault="QueryCancelled" not in tb)
                elif att.claim_ts is not None \
                        and att.spec.task_id in done:
                    pass  # superseded: never kill a healthy worker (or
                    # spend respawn budget) over an attempt whose result
                    # no longer matters
                elif att.claim_ts is not None \
                        and time.monotonic() - att.claim_ts \
                        > self._task_timeout:
                    self.pool.kill(att.worker)
                    handle_worker_loss(
                        att.worker,
                        f"task {att.spec.task_id} attempt {att.number} "
                        f"exceeded {self._task_timeout}s; worker "
                        f"{att.worker} killed")

            # liveness: death + heartbeat staleness. Blacklisted workers
            # still get checked while they hold running attempts —
            # otherwise a pre-blacklist attempt stranded on a dead or
            # wedged worker is only caught by the stage deadline.
            for w in range(self.pool.n):
                if w in self.blacklist \
                        and not any(a.worker == w for a in running):
                    continue
                if not self.pool.alive(w):
                    if not any(a.worker == w for a in running):
                        continue  # idle corpse; respawn lazily on demand
                    rc, err = self.pool.exit_info(w)
                    handle_worker_loss(
                        w, f"worker died rc={rc}: {err[-2000:]}")
                    continue
                age = self.pool.heartbeat_age(w)
                if age is None:
                    # spawn_ts is monotonic (see _WorkerPool.spawn) so a
                    # wall-clock step can't kill a starting worker
                    grace = time.monotonic() - self.pool.spawn_ts(w)
                    if grace > max(self._hb_timeout, _FIRST_BEAT_GRACE_S):
                        self.pool.kill(w)
                        handle_worker_loss(
                            w, f"worker {w} never heartbeat "
                            f"({grace:.1f}s since spawn)")
                elif age > self._hb_timeout:
                    self.pool.kill(w)
                    handle_worker_loss(
                        w, f"worker {w} heartbeat stale ({age:.1f}s > "
                        f"{self._hb_timeout}s)")

            # flight-recorder straggler trigger: RECORD (don't act on)
            # any attempt running stragglerFactor x the stage's running
            # median — always on, so a straggler leaves forensics even
            # with speculation disabled. minRuntime floors it so short
            # healthy stages can't fire incidents.
            if durations:
                med = sorted(durations)[len(durations) // 2]
                cut = max(self._straggler_factor * med, self._spec_min_s)
                for att in running:
                    key = (att.spec.task_id, att.number)
                    if att.spec.task_id in done \
                            or key in self._stragglers_seen \
                            or att.runtime <= cut:
                        continue
                    self._stragglers_seen.add(key)
                    self._event(
                        "straggler_detected", att.spec.task_id,
                        att.number, att.worker, att.runtime,
                        f"runtime {att.runtime:.2f}s > "
                        f"{self._straggler_factor}x stage median "
                        f"{med:.2f}s")

            # speculation: duplicate the stragglers
            if self._speculation and durations:
                med = sorted(durations)[len(durations) // 2]
                cut = max(self._spec_mult * med, self._spec_min_s)
                for att in list(running):
                    tid = att.spec.task_id
                    if tid in done or att.runtime <= cut:
                        continue
                    if sum(1 for a in running
                           if a.spec.task_id == tid) > 1:
                        continue  # already speculating
                    if attempts_used.get(tid, 0) >= self._max_attempts:
                        continue
                    w = self._pick_worker(running, {att.worker}
                                          | failed_on[tid])
                    if w is None or w == att.worker:
                        continue
                    n = self._attempt_seq.get(tid, 0)
                    self._attempt_seq[tid] = n + 1
                    attempts_used[tid] = attempts_used.get(tid, 0) + 1
                    self._launch(att.spec, n, w, running)
                    self._event("speculative_attempt", tid, n, w,
                                att.runtime,
                                f"runtime {att.runtime:.2f}s > "
                                f"{cut:.2f}s cut")

            if running or queue:
                time.sleep(_POLL_S)

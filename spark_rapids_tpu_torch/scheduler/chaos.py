"""Deterministic fault injection for cluster workers.

Counterpart of ``spark_rapids_tpu/scheduler/chaos.py``, whole. Driven
by ``spark.rapids.tpu.test.injectFaults`` (config.py): a
semicolon-separated rule list evaluated by the WORKER, so a chosen
(task, attempt) can be made to crash, hang, run slow — or have its
*committed shuffle output* corrupted, dropped, or made transiently
unreadable — on whichever worker picked it up, or only on a specific
worker. Rules are pure functions of (worker, task, attempt): no
randomness, no state — the same spec reproduces the same failure
schedule every run, which is what makes the recovery paths
unit-testable on one host (Spark gets the equivalent via its
TaskSetManager test harness; production clusters get the faults for
free).

Three hook points:

- ``maybe_inject``        — BEFORE a claimed task runs (process-level
  faults: ``crash`` / ``hang`` / ``delay``; query-scoped:
  ``hang_query``).
- ``maybe_inject_output`` — AFTER a map task's atomic commit
  (shuffle-durability faults: ``corrupt`` / ``drop`` / ``eio``), the
  committed-then-lost class the lineage-recovery path exists for.
- ``conf_overrides``      — per-task conf rewrites applied before the
  task builds its ExecCtx (query-scoped: ``oom_storm``); plus
  ``slow_admission``, consumed driver-side by the fair admission
  controller (lifecycle.py) with the QUERY id as the task glob.

Grammar (whitespace-insensitive)::

    spec    := rule (';' rule)*
    rule    := mode ':' task_glob ':' attempt [':' arg] ['@w' worker]
    mode    := 'crash' | 'hang' | 'delay' | 'corrupt' | 'drop' | 'eio'
             | 'hang_query' | 'oom_storm' | 'slow_admission'
             | 'spill_corrupt' | 'spill_torn' | 'disk_full'
             | 'slow_disk'
    attempt := int | '*'

- ``crash``   — the worker process exits immediately (``os._exit``),
  leaving no .err marker: the death-detection path.
- ``hang``    — the worker suspends its heartbeat thread and sleeps,
  simulating a native call wedged while holding the GIL (a hung
  kernel build or launch): the heartbeat-staleness path. The sleep is bounded
  by the caller (heartbeat timeout x a small factor) so a missed
  driver kill fails the test in seconds, not minutes.
- ``delay``   — sleep ``arg`` seconds (default 2.0) before running the
  task normally: the straggler/speculation path.
- ``corrupt`` — after the map task commits, flip bytes mid-payload in
  every committed partition file: the CRC-mismatch (kind=corrupt)
  fetch-failure path.
- ``drop``    — after the map task commits, delete the whole committed
  ``.mapout`` dir: the committed-then-lost (kind=missing) path.
- ``eio``     — after the map task commits, write ``<file>.eio``
  countdown sidecars (``arg`` failing reads each, default 2): the
  transient-IO path; readers burn in-place retries, and counts above
  ``spark.rapids.shuffle.fetch.maxRetries`` escalate to a stage rerun.

Query-scoped modes (the lifecycle layer's chaos surface)::

- ``hang_query`` — the task stalls WITHOUT suspending its heartbeat
  (the worker stays healthy; the QUERY is wedged — a stuck source,
  not a stuck process): the sleep polls the query's rendezvous
  ``.cancel`` marker and raises the classified QueryCancelled the
  moment the driver publishes it — exactly how a cooperative
  between-batches cancel lands on a real stalled task. ``arg`` bounds
  the stall (default: the caller's hang bound) so a missed cancel
  runs the task normally instead of wedging the test.
- ``oom_storm`` — the task's conf gains
  ``spark.rapids.sql.test.injectRetryOOM.storm = arg`` (default 2):
  its FIRST ``arg`` retry-scope executions raise synthetic device
  OOM, driving split-and-retry (and, on the local path, the
  degradation ladder) under sustained pressure.
- ``slow_admission`` — evaluated by the DRIVER's fair admission
  controller with the query id as the task id: admission of a
  matching query is delayed ``arg`` seconds (default 2.0), the
  deterministic way to trip the queue-time deadline
  (``spark.rapids.query.admission.timeout`` →
  QueryCancelled(reason=admission)).

Spill-tier durability modes (conf-carried like ``oom_storm``; the
task's DeviceMemoryManager applies them — memory.py)::

- ``spill_corrupt`` / ``spill_torn`` — every spill file the task's
  manager commits is damaged post-commit (payload bytes flipped /
  trailer truncated): the verified read-back must classify the loss
  (``SpillReadError(kind=corrupt|torn)``) and the scheduler must
  retry the task WITHOUT blacklisting the reading worker.
- ``disk_full`` — the task's first ``arg`` (default 2) disk-spill
  writes raise ENOSPC mid-write
  (``spark.rapids.memory.test.injectDiskFull``): partial files must
  be cleaned, the batch must stay host-resident, and the pressure
  must surface classified (never a raw OSError out of an eviction
  cascade).
- ``slow_disk`` — every disk-spill write and read sleeps ``arg``
  seconds (default 0.05): the degraded-disk / straggling-spill path.

Examples::

    crash:q1s1m0:0            # kill the worker running map task 0,
                              # attempt 0, of query 1 / shuffle 1
    hang:*m1:0                # first attempt of any map task 1 wedges
    delay:q1s1m0:0:3.5        # attempt 0 runs 3.5s late
    crash:q1s1m0:0@w1         # only when worker 1 runs it
    corrupt:q1s1m0:0          # attempt 0's committed output is rotten
    eio:q1s1m*:0:5            # every map output needs 5 reads to stick
    hang_query:q1r*:*         # every final-stage task of query 1
                              # stalls until cancelled
    oom_storm:q1s1m0:0:6      # six injected OOMs at the start of the
                              # map task's retry scopes
    slow_admission:q2:0:3     # query q2 waits 3s for admission
    spill_corrupt:q1r0:0      # every spill file attempt 0 of the
                              # final task writes is rotten on read
    disk_full:q1r*:*:3        # final-stage tasks' first 3 disk-spill
                              # writes hit ENOSPC
"""
from __future__ import annotations

import dataclasses
import fnmatch
import os
import shutil
import time
from typing import List, Optional, Sequence

__all__ = ["ChaosRule", "parse_fault_spec", "find_rule", "maybe_inject",
           "maybe_inject_output", "conf_overrides"]

_PRE_MODES = ("crash", "hang", "delay", "hang_query")
_POST_MODES = ("corrupt", "drop", "eio")
#: query-scoped modes resolved OUTSIDE the worker pre/post hooks:
#: oom_storm and the spill-tier modes rewrite the task's conf
#: (conf_overrides); slow_admission is consumed by the driver's
#: admission controller
_CONF_MODES = ("oom_storm", "spill_corrupt", "spill_torn", "disk_full",
               "slow_disk")
_DRIVER_MODES = ("slow_admission",)
_MODES = _PRE_MODES + _POST_MODES + _CONF_MODES + _DRIVER_MODES

#: fallback hang bound when the caller has no conf in reach — still
#: finite so an orphaned chaos worker can't outlive its test run
_DEFAULT_HANG_BOUND_S = 120.0


@dataclasses.dataclass(frozen=True)
class ChaosRule:
    mode: str
    task_glob: str
    attempt: Optional[int]  # None = any attempt
    #: the optional 4th field (delay seconds / eio failing-read count /
    #: oom count / stall bound). None = not given — each mode applies
    #: its own default via ``arg()``; a sentinel default here would
    #: make an explicit ':2' indistinguishable from "no arg"
    seconds: Optional[float] = None
    worker: Optional[int] = None  # None = any worker

    def arg(self, default: float) -> float:
        return default if self.seconds is None else self.seconds

    def matches(self, worker_id: int, task_id: str, attempt: int) -> bool:
        if self.worker is not None and self.worker != worker_id:
            return False
        if self.attempt is not None and self.attempt != attempt:
            return False
        return fnmatch.fnmatchcase(task_id, self.task_glob)


def parse_fault_spec(spec: str) -> List[ChaosRule]:
    rules = []
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        worker = None
        if "@w" in raw:
            raw, _, w = raw.rpartition("@w")
            worker = int(w)
        parts = [p.strip() for p in raw.split(":")]
        if len(parts) < 3:
            raise ValueError(f"bad injectFaults rule {raw!r} (want "
                             "mode:task_glob:attempt[:arg])")
        if parts[0] not in _MODES:
            # never a silent no-op: an unknown mode is a spec typo the
            # test author must hear about, with the valid set named
            raise ValueError(
                f"unknown injectFaults mode {parts[0]!r} in rule "
                f"{raw!r}; valid modes: {', '.join(_MODES)}")
        mode, glob, att = parts[:3]
        attempt = None if att == "*" else int(att)
        seconds = float(parts[3]) if len(parts) > 3 else None
        rules.append(ChaosRule(mode, glob, attempt, seconds, worker))
    return rules


def find_rule(spec: str, worker_id: int, task_id: str, attempt: int,
              modes: Optional[Sequence[str]] = None) -> Optional[ChaosRule]:
    for r in parse_fault_spec(spec):
        if modes is not None and r.mode not in modes:
            continue
        if r.matches(worker_id, task_id, attempt):
            return r
    return None


def maybe_inject(spec: str, worker_id: int, task_id: str, attempt: int,
                 heartbeat=None,
                 hang_bound_s: Optional[float] = None,
                 cancel_path: Optional[str] = None) -> None:
    """Worker-side pre-run hook: apply the first matching process-level
    rule, if any. ``crash`` never returns; ``hang`` does not return
    while the driver behaves (it kills the process), but self-destructs
    after ``hang_bound_s`` — derived by the caller from the heartbeat
    timeout — so a missed kill fails the test quickly instead of
    parking for ten minutes; ``delay`` returns after sleeping;
    ``hang_query`` stalls with a LIVE heartbeat, polling
    ``cancel_path`` so a driver-published cancel lands as the
    classified QueryCancelled (the cooperative-cancel rehearsal)."""
    rule = find_rule(spec, worker_id, task_id, attempt, _PRE_MODES)
    if rule is None:
        return
    if rule.mode == "hang_query":
        bound = rule.arg(hang_bound_s if hang_bound_s is not None
                         else _DEFAULT_HANG_BOUND_S)
        t0 = time.monotonic()
        while time.monotonic() - t0 < bound:
            if cancel_path and os.path.exists(cancel_path):
                from ..lifecycle import (QueryCancelled,
                                         read_cancel_marker)
                reason, detail = read_cancel_marker(cancel_path)
                raise QueryCancelled(
                    reason, f"chaos hang_query observed cancel "
                            f"marker: {detail}")
            time.sleep(0.05)
        return  # bound elapsed without a cancel: run normally
    if rule.mode == "crash":
        # a death with nothing flushed: the worker loop flushed its
        # ring at the claim
        os._exit(13)
    if rule.mode == "hang":
        # a real wedge (native call holding the GIL) starves the
        # heartbeat thread too — simulate both halves
        if heartbeat is not None:
            heartbeat.suspend()
        time.sleep(hang_bound_s if hang_bound_s is not None
                   else _DEFAULT_HANG_BOUND_S)
        # the bound passed without the driver's kill: die, the ring was
        # flushed at the claim
        os._exit(14)
    if rule.mode == "delay":
        time.sleep(rule.arg(2.0))


def conf_overrides(spec: str, worker_id: int, task_id: str,
                   attempt: int) -> dict:
    """Per-task conf rewrites for conf-carried chaos modes, applied by
    the worker loop BEFORE the task builds its ExecCtx. ``oom_storm``
    maps to ``spark.rapids.sql.test.injectRetryOOM.storm`` (arg =
    injected-OOM count, default 2); the spill-tier modes map to the
    ``spark.rapids.memory.test.*`` injections the task's
    DeviceMemoryManager applies. Different modes compose (first
    matching rule per mode wins), so ``disk_full`` + ``slow_disk``
    can hit the same task — EXCEPT ``spill_corrupt`` + ``spill_torn``,
    which share the one injectSpillFault channel a manager has: both
    matching one (task, attempt) is a contradictory spec, and per the
    never-a-silent-no-op rule it is a named hard error rather than
    whichever rule happened to parse first."""
    out: dict = {}
    spill_fault_mode = None
    for rule in parse_fault_spec(spec):
        if rule.mode not in _CONF_MODES \
                or not rule.matches(worker_id, task_id, attempt):
            continue
        if rule.mode == "oom_storm":
            out.setdefault("spark.rapids.sql.test.injectRetryOOM.storm",
                           str(max(1, int(rule.arg(2)))))
        elif rule.mode in ("spill_corrupt", "spill_torn"):
            fault = "corrupt" if rule.mode == "spill_corrupt" else "torn"
            if spill_fault_mode is not None \
                    and spill_fault_mode != rule.mode:
                raise ValueError(
                    f"injectFaults modes {spill_fault_mode!r} and "
                    f"{rule.mode!r} both match task {task_id!r} "
                    f"attempt {attempt}: they share one spill-fault "
                    "injection channel and cannot compose on the same "
                    "task")
            spill_fault_mode = rule.mode
            out.setdefault("spark.rapids.memory.test.injectSpillFault",
                           fault)
        elif rule.mode == "disk_full":
            out.setdefault("spark.rapids.memory.test.injectDiskFull",
                           str(max(1, int(rule.arg(2)))))
        elif rule.mode == "slow_disk":
            out.setdefault("spark.rapids.memory.test.injectSlowDisk",
                           str(rule.arg(0.05)))
    return out


def maybe_inject_output(spec: str, worker_id: int, task_id: str,
                        attempt: int, mapout_dir: str) -> None:
    """Worker-side post-commit hook: damage the (task, attempt)'s
    COMMITTED shuffle output — the injection point for every
    shuffle-durability failure the lineage-recovery path must survive.
    Runs between the atomic commit and the ``.ok`` marker, so from the
    driver's view the map task succeeded and only the read side can
    discover the loss."""
    rule = find_rule(spec, worker_id, task_id, attempt, _POST_MODES)
    if rule is None or not os.path.isdir(mapout_dir):
        return
    if rule.mode == "drop":
        shutil.rmtree(mapout_dir, ignore_errors=True)
        return
    names = sorted(n for n in os.listdir(mapout_dir)
                   if n.endswith(".arrow"))
    for n in names:
        path = os.path.join(mapout_dir, n)
        if rule.mode == "corrupt":
            # flip bytes mid-payload: the footer (and the Arrow
            # framing around the flip) stays intact, so ONLY the CRC
            # can catch it — exactly the bit-rot class checksums exist
            # for
            size = os.path.getsize(path)
            # stay inside the payload: clobbering the 16-byte trailer
            # would read as "torn", a different failure class
            at = min(size // 2, size - 16 - 8)
            if at <= 0:
                continue
            with open(path, "r+b") as f:
                f.seek(at)
                chunk = f.read(8)
                f.seek(at)
                f.write(bytes(b ^ 0xFF for b in chunk))
        elif rule.mode == "eio":
            with open(path + ".eio", "w") as f:
                f.write(str(int(rule.arg(2))))

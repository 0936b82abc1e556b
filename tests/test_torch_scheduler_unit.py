"""The chaos rules and the task scheduler, the port against the JAX
package, with no worker process.

``parse_fault_spec``, ``find_rule`` and ``conf_overrides`` of both
packages agree on a list of specs, and a bad spec raises the same error
in both. Both ``TaskScheduler``s, driven by one scripted fake pool (a
copy of the pattern of ``tests/test_scheduler_unit.py``: a fake pool and
a thread that answers each attempt file by a script), give the same
attempts and events for a retry on another worker, a blacklist, bounded
retries running out, a worker's death and respawn, and speculation on
and off. Each package's events are compared task by task (the order of
two tasks' events within one poll pass depends on the answering
thread), and the worker events as a set."""
import os
import threading
import time

import pytest

from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.scheduler import TaskScheduler as JSched
from spark_rapids_tpu.scheduler import TaskSpec as JSpec
from spark_rapids_tpu.scheduler import chaos as jchaos
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.scheduler import TaskScheduler, TaskSpec
from spark_rapids_tpu_torch.scheduler import chaos

SPECS = [
    "", "crash:q1s1m0:0", "hang:*m1:*", "delay:q2*:1:3.5",
    "crash:t:0@w1", "crash:q1s1m0:0; delay:*m1:*:1.0@w1",
    "corrupt:q1s1m0:0", "drop:q1s*m*:*", "eio:q1s1m*:0:5",
    "hang_query:q1r*:*", "oom_storm:q1s1m0:0:6", "slow_admission:q2:0:3",
    "spill_corrupt:q1r0:0", "spill_torn:q1r1:*", "disk_full:q1r*:*:3",
    "slow_disk:q*:*:0.2", " crash : q1r0 : 1 ; eio:*:*",
]
BAD_SPECS = ["explode:x:0", "crash:x", "crash", "delay:x:y",
             "crash:x:0:fast", "crash:x:0@wq"]
PROBES = [(0, "q1s1m0", 0), (1, "q1s1m0", 0), (0, "q1s1m0", 1),
          (1, "q9s3m1", 7), (0, "q2x", 1), (1, "t", 0), (0, "q1r0", 0),
          (1, "q1r1", 3), (0, "q2", 0), (-1, "q2", 0)]


def _rule(r):
    return None if r is None else (r.mode, r.task_glob, r.attempt,
                                   r.seconds, r.worker)


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_rules_equal_the_reference(spec):
    assert [_rule(r) for r in chaos.parse_fault_spec(spec)] \
        == [_rule(r) for r in jchaos.parse_fault_spec(spec)]
    for w, task, att in PROBES:
        assert _rule(chaos.find_rule(spec, w, task, att)) \
            == _rule(jchaos.find_rule(spec, w, task, att))
        assert chaos.conf_overrides(spec, w, task, att) \
            == jchaos.conf_overrides(spec, w, task, att)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_chaos_specs_raise_the_reference_error(spec):
    with pytest.raises(Exception) as port:
        chaos.parse_fault_spec(spec)
    with pytest.raises(Exception) as ref:
        jchaos.parse_fault_spec(spec)
    assert type(port.value) is type(ref.value)
    assert str(port.value) == str(ref.value)


def test_contradictory_spill_modes_raise_the_reference_error():
    spec = "spill_corrupt:q1r0:0;spill_torn:q1r0:0"
    with pytest.raises(ValueError) as port:
        chaos.conf_overrides(spec, 0, "q1r0", 0)
    with pytest.raises(ValueError) as ref:
        jchaos.conf_overrides(spec, 0, "q1r0", 0)
    assert str(port.value) == str(ref.value)


def test_conf_modes_set_the_memory_managers_keys():
    from spark_rapids_tpu_torch.config import (TEST_DISK_FULL,
                                               TEST_RETRY_OOM_STORM,
                                               TEST_SLOW_DISK,
                                               TEST_SPILL_FAULT)
    spec = ("oom_storm:t:0:6; spill_torn:t:0; disk_full:t:0:3; "
            "slow_disk:t:0:0.2")
    conf = RapidsConf(chaos.conf_overrides(spec, 0, "t", 0))
    assert conf.get(TEST_RETRY_OOM_STORM) == 6
    assert conf.get(TEST_SPILL_FAULT) == "torn"
    assert conf.get(TEST_DISK_FULL) == 3
    assert conf.get(TEST_SLOW_DISK) == 0.2


# --- the scheduler over a fake pool -----------------------------------------

class FakePool:
    def __init__(self, n):
        self.n = n
        self.dead = set()
        self.respawned = []
        self._ts = time.monotonic()

    def alive(self, w):
        return w not in self.dead

    def exit_info(self, w):
        return 1, "fake worker death"

    def kill(self, w):
        self.dead.add(w)

    def respawn(self, w):
        self.dead.discard(w)
        self.respawned.append(w)

    def heartbeat_age(self, w):
        return 0.0

    def spawn_ts(self, w):
        return self._ts


class Responder:
    """The worker side: answers each new attempt file by
    ``script(task_id, attempt, worker, pool) -> 'ok' | 'err' | None``
    (None leaves it running)."""

    def __init__(self, tasks_dir, script, pool):
        self.tasks_dir = tasks_dir
        self.script = script
        self.pool = pool
        self._stop = threading.Event()
        self._seen = set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.01):
            for name in sorted(os.listdir(self.tasks_dir)):
                if not name.endswith(".task") or name in self._seen:
                    continue
                tid, a, w = name[:-len(".task")].rsplit(".", 2)
                verdict = self.script(tid, int(a[1:]), int(w[1:]),
                                      self.pool)
                if verdict is None:
                    continue
                self._seen.add(name)
                path = os.path.join(self.tasks_dir, name)
                with open(path + ".claim", "w") as f:
                    f.write("claimed")
                with open(path + "." + verdict, "w") as f:
                    f.write("synthetic failure" if verdict == "err"
                            else "ok")

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)


BASE = {
    "spark.rapids.tpu.task.maxAttempts": 2,
    "spark.rapids.tpu.task.timeout": 5.0,
    "spark.rapids.tpu.scheduler.stageTimeout": 10.0,
    "spark.rapids.tpu.scheduler.maxTaskFailuresPerWorker": 2,
    "spark.rapids.tpu.heartbeat.timeout": 100.0,
}


def _drive(pkg, tmp_path, script, tasks, over=None, n=2):
    """One package's scheduler over the fake pool: ``(per-task events,
    worker events, error or None, pool)``."""
    settings = dict(BASE, **(over or {}))
    d = str(tmp_path / pkg)
    os.makedirs(d)
    pool = FakePool(n)
    if pkg == "port":
        sched = TaskScheduler(pool, d, RapidsConf(settings))
        specs = [TaskSpec(t, "noop", {"conf": {}}) for t in tasks]
    else:
        sched = JSched(pool, d, JConf(settings))
        specs = [JSpec(t, "noop", {"conf": {}}) for t in tasks]
    r = Responder(d, script, pool)
    err = None
    try:
        sched.run_stage(specs)
    except Exception as e:  # noqa: BLE001 — compared below
        err = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    finally:
        r.stop()
    per_task = {t: [(e["event"], e["attempt"], e["worker"])
                    for e in sched.events if e["task"] == t]
                for t in tasks}
    workers = sorted({(e["event"], e["worker"]) for e in sched.events
                      if not e["task"]})
    return per_task, workers, err, sched.summary(), pool


def _both(tmp_path, script, tasks, over=None):
    port = _drive("port", tmp_path, script, tasks, over)
    ref = _drive("ref", tmp_path, script, tasks, over)
    assert port[:3] == ref[:3]
    for k in ("tasks_ok", "failures", "workers_respawned",
              "workers_blacklisted", "speculative_launched"):
        assert port[3][k] == ref[3][k], k
    return port


def test_retry_lands_on_another_worker(tmp_path):
    def script(tid, attempt, worker, pool):
        return "err" if tid == "t0" and worker == 0 else "ok"

    per_task, _, err, summary, _ = _both(tmp_path, script, ["t0", "t1"])
    assert err is None
    assert per_task["t0"] == [("task_submitted", 0, 0),
                              ("task_failed", 0, 0),
                              ("task_submitted", 1, 1), ("task_ok", 1, 1)]
    assert summary["failures"] == 1


def test_blacklist_after_max_failures(tmp_path):
    def script(tid, attempt, worker, pool):
        return "err" if worker == 0 else "ok"

    per_task, workers, err, _, _ = _both(
        tmp_path, script, ["t0", "t1", "t2"],
        {"spark.rapids.tpu.scheduler.maxTaskFailuresPerWorker": 1,
         "spark.rapids.tpu.task.maxAttempts": 4})
    assert err is None
    assert ("worker_blacklisted", 0) in workers
    assert all(ev[-1][0] == "task_ok" and ev[-1][2] == 1
               for ev in per_task.values())


def test_bounded_retry_exhaustion_raises(tmp_path):
    per_task, _, err, _, _ = _both(tmp_path, lambda *a: "err", ["t0"])
    assert err.startswith("RuntimeError: worker task t0 failed after 2 "
                          "attempts")
    assert [e[0] for e in per_task["t0"]] == [
        "task_submitted", "task_failed", "task_submitted", "task_failed"]


def test_worker_death_respawns_and_retries(tmp_path):
    killed = set()

    def script(tid, attempt, worker, pool):
        if tid == "t0" and attempt == 0:
            if id(pool) not in killed:
                killed.add(id(pool))
                pool.dead.add(worker)  # dies mid-task, never answers
            return None
        return "ok"

    per_task, workers, err, _, pool = _both(tmp_path, script, ["t0"])
    assert err is None
    assert ("worker_respawn", 0) in workers
    assert per_task["t0"][-1] == ("task_ok", 1, 1)


def _spec_script(done):
    def script(tid, attempt, worker, pool):
        if tid == "slow" and attempt == 0:
            return None  # the original straggles
        if tid == "slow":
            done.add(id(pool))
        return "ok"
    return script


def test_speculation_on_duplicates_the_straggler(tmp_path):
    over = {"spark.rapids.tpu.speculation": "true",
            "spark.rapids.tpu.speculation.multiplier": 1.0,
            "spark.rapids.tpu.speculation.minRuntime": 0.1}
    per_task, _, err, summary, pool = _both(
        tmp_path, _spec_script(set()), ["fast", "slow"], over)
    assert err is None
    # the straggler ran on worker 1, its duplicate on worker 0 wins
    assert per_task["slow"] == [
        ("task_submitted", 0, 1), ("straggler_detected", 0, 1),
        ("speculative_attempt", 1, 0), ("task_ok", 1, 0)]
    assert summary["failures"] == 0 and not pool.dead


def test_speculation_off_waits_for_the_straggler(tmp_path):
    first = {}

    def script(tid, attempt, worker, pool):
        if tid != "slow":
            return "ok"
        t0 = first.setdefault(id(pool), time.monotonic())
        return "ok" if time.monotonic() - t0 > 0.6 else None

    per_task, workers, err, summary, _ = _both(
        tmp_path, script, ["fast", "slow"],
        {"spark.rapids.tpu.speculation.minRuntime": 0.1})
    assert err is None
    assert per_task["slow"] == [("task_submitted", 0, 1),
                                ("straggler_detected", 0, 1),
                                ("task_ok", 0, 1)]
    assert summary["speculative_launched"] == 0 and not workers


def test_summary_and_live_status_keys_equal_the_reference(tmp_path):
    pool = FakePool(1)
    port = TaskScheduler(pool, str(tmp_path), RapidsConf(BASE))
    ref = JSched(pool, str(tmp_path), JConf(BASE))
    assert port.summary() == ref.summary()
    assert port.live_status() == ref.live_status()

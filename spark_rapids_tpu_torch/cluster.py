"""Multi-process execution: a driver and worker OS processes sharing the
card.

Counterpart of ``spark_rapids_tpu/cluster.py`` without its mesh route
(``_run_mesh_task``, ``_mesh_env_block`` to ``_run_gang_attempt``: ROADMAP
item 17; ``spark.rapids.tpu.mesh.enabled=true`` raises naming it). Each
worker is an OS process with its own CUDA context; stages exchange
through the host-file shuffle's Arrow IPC files (``shuffle/host.py``) on
a shared filesystem, and the driver is the scheduler:

- the driver splits the physical plan at shuffle exchanges into stages,
  deepest first (``_deepest_exchange``); a map stage ships each worker a
  pickled slice of the stage (one leaf's files or batches, or a range of
  an earlier shuffle's partitions, ``_split_leaf_input``) with the
  exchange's partitioning; the worker runs it and writes each map batch's
  partitions into an attempt's staging directory, published by the
  first commit (``HostShuffleTransport.commit_task_attempt``);
- the next stage reads those files through ``ProcessShuffleReadExec``,
  which takes the exchange's operator id, so the reduce side's rows fold
  under the exchange in EXPLAIN ANALYZE; the final stage's partition
  ranges split over the workers (``_slice_partitions``) and their Arrow
  results concatenate on the driver.

Rendezvous is on the filesystem: task pickles, claim/ok/err markers,
classified markers (``.qcancel``, ``.spillfail``, ``.fetchfail``) and
heartbeat files. ``scheduler/task_scheduler.py`` owns retries, worker
loss and respawn, speculation and stage timeouts; a classified fetch
failure quarantines the lost map output and reruns the task that made
it from lineage (``_run_stage_lineage``, bounded by
``spark.rapids.shuffle.maxStageRetries``).

**The device.** ``GpuProcessCluster(device=None)`` runs its workers on
``cuda``; they run on the CPU only when the caller passes
``device="cpu"``. The device rides the spawn environment
(``RAPIDS_GPU_WORKER_DEVICE``); each worker builds its ``ExecCtx`` on it
through ``resolve_device``, so a ``cuda`` worker on a host with no card
fails its task with that error in its ``.err`` marker and never runs on
the CPU. A kernel that fails to build or launch fails the task the same
way. The driver builds every kernel before it spawns (``_build.
build_all``), so a worker only loads the libraries before its first
heartbeat. The workers share the one card: with
``spark.rapids.memory.device.budgetBytes`` 0, each worker's ledger gets
its share, ``allocFraction`` x the card's memory over the workers
(``_task_conf``), where each would otherwise take it all.

**Plans.** A task pickle carries only plan structure: ``run_query``
deep-copies the plan before anything runs and refuses one that holds a
tensor, a generator, a lock or a thread-local (``plan_pickle_refusals``);
an operator's per-run state is rebuilt on the worker.

**What a task reports.** Beside its ``.ok``/``.err`` marker each attempt
commits its spans (``.spans``), its per-operator snapshot
(``.opm.json``), a flight dump when an anomaly trigger fires
(``.flight.json``), and ``.kernels.json``: the attempt's launches of
each kernel wrapper (the counters are per process), the process's
device and card name, and whether it ever loaded ``jax`` or the JAX
package. With ``spark.rapids.metrics.enabled`` each worker rewrites its
registry's snapshot after every task. The driver folds the winning
attempts' snapshots (``explain_analyze``, ``last_analyzed``, the
profile under ``spark.rapids.history.dir``), the kernel reports
(``last_kernel_reports``, ``kernel_launches``), the workers' registries
(``prometheus_text``, ``worker_counter``), and on an anomaly every
process's ring into one incident bundle; ``_status_doc`` is the
``/status`` provider.
"""
from __future__ import annotations

import copy
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from . import datatypes as dt
from .config import (FLIGHT_ENABLED, FLIGHT_STRAGGLER_FACTOR,
                     HEARTBEAT_INTERVAL, HEARTBEAT_TIMEOUT, INJECT_FAULTS,
                     MESH_ENABLED, SHUFFLE_FETCH_MAX_RETRIES,
                     SHUFFLE_FETCH_RETRY_WAIT_MS, SHUFFLE_MAX_STAGE_RETRIES,
                     WORKER_EXIT_TIMEOUT, RapidsConf, _to_bool)
from .exec.base import ExecCtx, GpuExec, LeafExec
from .lifecycle import QueryCancelled as _QueryCancelled
from .memory import SpillReadError as _SpillReadError
from .obs.metrics import (METRICS_ENABLED, REGISTRY, flush_worker_metrics,
                          maybe_start_http_server, read_worker_metrics,
                          render_merged_snapshots)
from .obs.recorder import (RECORDER, flush_worker_ring, next_incident_seq,
                           read_flight_dumps, read_worker_rings,
                           resolve_flight_dir, write_incident_bundle)
from .obs.tracer import (NULL_TRACER, TRACE_DIR, TRACE_MAX_FILES, Tracer,
                         tracer_from_conf)
from .scheduler import FetchFailedError, TaskScheduler, TaskSpec
from .shuffle import integrity
from .shuffle.host import (SHUF_BYTES_FETCHED, SHUF_FETCH_WAIT,
                           SHUF_PARTS_FETCHED, HostShuffleTransport)
from .shuffle.transport import FetchFailure, record_fetch_failure

__all__ = ["GpuProcessCluster", "ProcessShuffleReadExec",
           "run_process_query", "plan_pickle_refusals", "worker_main",
           "launch_counters",
           "ENV_DEVICE", "ENV_SHARING", "ENV_IS_WORKER"]

#: the spawn environment's keys: the workers' device, how many workers
#: share it, and the worker role (no worker binds the metrics port)
ENV_DEVICE = "RAPIDS_GPU_WORKER_DEVICE"
ENV_SHARING = "RAPIDS_GPU_WORKERS_SHARING"
ENV_IS_WORKER = "RAPIDS_TPU_IS_WORKER"

_STAGE_RERUNS = REGISTRY.counter(
    "rapids_shuffle_stage_reruns_total",
    "Map tasks re-executed from lineage because a reader classified "
    "their committed shuffle output as missing/corrupt/torn or "
    "persistently unreadable.")


class ProcessShuffleReadExec(LeafExec):
    """Reduce-side leaf: streams the committed Arrow IPC files a map stage
    wrote for ``partitions`` (the reference's ``:84``). Only committed
    attempts' output is visible, and the driver's list of committed map
    tasks (``expected_mapouts``) makes a vanished one a classified
    ``missing`` failure rather than fewer rows."""

    def __init__(self, shuffle_root: str, shuffle_id: int,
                 partitions: Sequence[int], schema: dt.Schema,
                 expected_mapouts: Optional[Sequence[str]] = None,
                 partitioning=None):
        super().__init__()
        self.shuffle_root = shuffle_root
        self.shuffle_id = shuffle_id
        self.partitions = list(partitions)
        self._schema = schema
        self.expected_mapouts = list(expected_mapouts or [])
        # the exchange's partitioning: which regions above may split
        self.partitioning = partitioning

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        return (f"ProcessShuffleReadExec [s{self.shuffle_id} "
                f"p={self.partitions}]")

    def gpu_supported(self):
        return None

    def _block_index(self):
        """``{pid: [(path, manifest meta)]}``: one directory walk and
        manifest parse a task."""
        d = os.path.join(self.shuffle_root, f"s{self.shuffle_id}")
        return integrity.expected_partition_index(
            d, self.expected_mapouts, shuffle_id=self.shuffle_id)

    def _host_batches(self, ctx: Optional[ExecCtx] = None):
        tracer = ctx.tracer if ctx is not None else NULL_TRACER
        conf = ctx.conf if ctx is not None else RapidsConf()
        retries = conf.get(SHUFFLE_FETCH_MAX_RETRIES)
        wait_s = conf.get(SHUFFLE_FETCH_RETRY_WAIT_MS) / 1e3
        fetched = SHUF_PARTS_FETCHED.labels("process")
        fbytes = SHUF_BYTES_FETCHED.labels("process")
        fwait = SHUF_FETCH_WAIT.labels("process")
        try:
            index = self._block_index()
        except FetchFailure as ff:
            record_fetch_failure(ff, -1, "process")
            raise
        for pid in self.partitions:
            # one file at a time; the fetch span covers the time blocked
            # on reads, emitted after the fact under the enclosing span
            parent = tracer.current_span_id()
            t_wall = time.time()
            io_s = 0.0
            try:
                for path, meta in index.get(pid, []):
                    t1 = time.perf_counter()
                    payload = integrity.read_block(
                        path, meta, shuffle_id=self.shuffle_id,
                        max_retries=retries, retry_wait_s=wait_s,
                        on_retry=lambda n, e: RECORDER.record(
                            "shuffle", ev="fetch_retry",
                            sid=self.shuffle_id, part=int(pid), n=n,
                            error=str(e)[:120]))
                    table = pa.ipc.open_file(
                        pa.BufferReader(payload)).read_all()
                    dt_io = time.perf_counter() - t1
                    io_s += dt_io
                    fwait.observe(dt_io)
                    fbytes.inc(table.nbytes)
                    for rb in table.combine_chunks().to_batches():
                        if rb.num_rows:
                            yield rb
            except FetchFailure as ff:
                # the worker loop turns it into a .fetchfail marker the
                # driver recovers from
                record_fetch_failure(ff, pid, "process")
                raise
            fetched.inc()
            RECORDER.record("shuffle", ev="fetch", sid=self.shuffle_id,
                            part=int(pid), wait_s=round(io_s, 6))
            if tracer.enabled:
                tracer.emit(f"shuffle_fetch s{self.shuffle_id} p{pid}",
                            "shuffle", t_wall, io_s, parent_id=parent)

    def execute(self, ctx: ExecCtx):
        from .columnar.arrow_bridge import arrow_to_device
        for rb in self._host_batches(ctx):
            b = arrow_to_device(rb, self._schema, ctx.device)
            # an upload is a ledger entry until handed over, as the
            # host transport's
            ctx.mm.register(b, pinned=True).release()
            yield b

    def execute_cpu(self, ctx: ExecCtx):
        yield from self._host_batches(ctx)


# --- the worker's side -------------------------------------------------------

def _worker_device() -> torch.device:
    """The spawn environment's device, resolved: ``cuda`` raises on a
    host with no card."""
    from .exec.base import resolve_device
    return resolve_device(os.environ.get(ENV_DEVICE, "cuda"))


def _task_conf(payload: Dict, device: torch.device) -> RapidsConf:
    """The task's conf; on a card the workers share, an unset device
    budget becomes this worker's share of the card."""
    from .memory import DEVICE_BUDGET, resolve_device_budget
    conf = RapidsConf(payload["conf"])
    sharing = int(os.environ.get(ENV_SHARING, "1") or 1)
    if device.type == "cuda" and sharing > 1 and not conf.get(DEVICE_BUDGET):
        share = resolve_device_budget(conf, device) // sharing
        conf = conf.with_settings({DEVICE_BUDGET.key: share})
    return conf


def _task_ctx(payload: Dict, tracer, obs_sink: Optional[Dict]) \
        -> ExecCtx:
    from .lifecycle import QueryContext
    device = _worker_device()
    conf = _task_conf(payload, device)
    ctx = ExecCtx(conf, device)
    ctx.tracer = tracer  # join the driver's trace
    # the worker's token polls the driver's cancel marker between batches
    ctx.qctx = QueryContext.for_worker(payload, conf)
    if obs_sink is not None:
        # before the run, so a failed attempt's partial snapshot flushes
        obs_sink["ctx"] = ctx
    return ctx


def _stage_batches(plan: GpuExec, ctx: ExecCtx, on_cpu: bool):
    """A stage's output as batches on the ctx's device, or as CPU
    tensors when the planner placed the stage's root on the CPU."""
    if not on_cpu:
        yield from plan.execute(ctx)
        return
    from .columnar.arrow_bridge import arrow_to_device
    cpu = torch.device("cpu")
    for rb in plan.execute_cpu(ctx):
        yield arrow_to_device(rb, plan.output_schema, cpu)


def _run_map_task(payload: Dict, tracer=NULL_TRACER,
                  obs_sink: Optional[Dict] = None) -> None:
    """Run a map slice and write its partitions into an attempt's
    staging directory, then commit (batch i of the slice is map id
    base + i). Losing the commit to a sibling attempt is success: the
    winner's output is whole."""
    ctx = _task_ctx(payload, tracer, obs_sink)
    plan: GpuExec = payload["plan"]
    on_cpu = bool(payload.get("on_cpu"))
    partitioning = payload["partitioning"].bind(plan.output_schema)
    transport = HostShuffleTransport(ctx.conf, threads=0,
                                     root=payload["shuffle_root"],
                                     device=ctx.device)
    sid = payload["shuffle_id"]
    task_key = payload.get("task_id", f"m{payload['map_id_base']}")
    attempt = payload.get("attempt", 0)
    transport.register_shuffle(sid, partitioning.num_partitions)
    staging = transport.begin_task_attempt(sid, task_key, attempt)
    base = payload["map_id_base"]
    ectx = ctx.host_ctx().eval_ctx if on_cpu else ctx.eval_ctx
    try:
        try:
            with ctx.mm.task_slot(ctx.qctx):
                for i, batch in enumerate(_stage_batches(plan, ctx,
                                                         on_cpu)):
                    with tracer.span(f"shuffle_write s{sid} m{base + i}",
                                     cat="shuffle"):
                        pids = partitioning.partition_ids(batch, ectx)
                        w = transport.writer(sid, base + i, subdir=staging)
                        w.write_unsplit(batch, pids)
                        w.close()
        finally:
            ctx.run_cleanups()
        ctx.check_deferred()
    except BaseException:
        ctx.discard_deferred()
        transport.abort_task_attempt(sid, task_key, attempt)
        raise
    with tracer.span(f"shuffle_commit s{sid}", cat="shuffle"):
        transport.commit_task_attempt(sid, task_key, attempt)


def _write_collect_result(plan: GpuExec, ctx: ExecCtx, payload: Dict) \
        -> None:
    """Run ``plan`` and publish the result as one Arrow IPC file; the
    hard link is the commit: the first attempt to link wins, a later one
    discards its own file."""
    from .columnar.arrow_bridge import arrow_schema
    from .exec.base import collect_arrow, collect_arrow_cpu
    table = collect_arrow_cpu(plan, ctx) if payload.get("on_cpu") \
        else collect_arrow(plan, ctx)
    out = payload["out"]
    tmp = f"{out}.a{payload.get('attempt', 0)}.tmp"
    with pa.OSFile(tmp, "wb") as f, \
            pa.ipc.new_file(f, arrow_schema(plan.output_schema)) as w:
        for rb in table.to_batches():
            if rb.num_rows:
                w.write_batch(rb)
    try:
        os.link(tmp, out)  # first commit wins (EEXIST: lost)
    except FileExistsError:
        pass
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _run_collect_task(payload: Dict, tracer=NULL_TRACER,
                      obs_sink: Optional[Dict] = None) -> None:
    """Run a reduce or final slice on this worker's device and publish
    its result."""
    ctx = _task_ctx(payload, tracer, obs_sink)
    _write_collect_result(payload["plan"], ctx, payload)


_TASK_KINDS = {"map": _run_map_task, "collect": _run_collect_task}


def launch_counters() -> Dict[str, object]:
    """Every kernel wrapper's launch counter, by wrapper name."""
    from .ops import cuda_kernels as ck
    from .ops.hash import xxhash64_strings
    from .ops.parquet_decode import decode_batch
    from .ops.regex import find_spans, regex_match
    fns = (decode_batch, ck.filter_product_sum, ck.masked_product_sum,
           ck.filter_product_group_sum, ck.fused_filter_agg, ck.sort_pairs,
           ck.sort_keys, ck.gather_rows, ck.gather, regex_match,
           xxhash64_strings, find_spans)
    return {f.__name__: f for f in fns}


def _launches() -> Dict[str, int]:
    return {k: int(f.launches) for k, f in launch_counters().items()}


def _reference_modules() -> List[str]:
    """Modules of jax or the JAX package this process has loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib",
                                         "spark_rapids_tpu"))


def _write_kernel_report(path: str, before: Dict[str, int], attempt: int,
                         task_id: str, worker_id: int) -> None:
    """The attempt's launch deltas and where it ran, as
    ``<task>.kernels.json`` (best effort)."""
    try:
        dev = os.environ.get(ENV_DEVICE, "cuda")
        name = torch.cuda.get_device_name() \
            if dev.startswith("cuda") and torch.cuda.is_available() \
            else "cpu"
        after = _launches()
        doc = {"task": task_id, "attempt": attempt, "worker": worker_id,
               "pid": os.getpid(), "device": dev, "device_name": name,
               "launches": {k: after[k] - before.get(k, 0)
                            for k in after},
               "reference_modules": _reference_modules()}
        tmp = path + ".kernels.json.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path + ".kernels.json")
    except Exception:  # noqa: BLE001 — a report never fails the task
        pass


def _flush_task_flight(root: str, worker_id: int, task_path: str,
                       task_id: str, attempt: int, since: float,
                       failed: bool, error: str = "") -> None:
    """After an attempt: when an anomaly trigger fires (a failure, an
    OOM retry, a spill cascade), commit ``<task>.flight.json`` next to
    the task's markers, then flush the worker's ring. Best effort."""
    if not RECORDER.enabled:
        return
    try:
        from .obs.anomaly import AnomalyDetector
        trig = AnomalyDetector().check_task(
            RECORDER.snapshot(since=since), failed, error)
        if trig is not None:
            kind, reason = trig
            doc = {"proc": f"w{worker_id}", "pid": os.getpid(),
                   "task": task_id, "attempt": attempt,
                   "trigger": kind, "reason": reason,
                   "ts": time.time(), "events": RECORDER.snapshot(),
                   "metrics": REGISTRY.snapshot()}
            tmp = task_path + ".flight.json.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, task_path + ".flight.json")
        flush_worker_ring(root, worker_id)
    except Exception:  # noqa: BLE001 — forensics never fail the task
        pass


def _flush_task_obs(root: str, worker_id: int, task_path: str, tracer,
                    settings: Dict, ctx=None, task_id: str = "?",
                    attempt: int = 0) -> None:
    """Commit the attempt's spans and per-operator snapshot next to its
    task file (before its marker, so the driver's harvest finds them),
    and with ``spark.rapids.metrics.enabled`` rewrite the worker's
    registry snapshot. Best effort."""
    try:
        if tracer.enabled:
            tmp = task_path + ".spans.tmp"
            with open(tmp, "w") as f:
                json.dump({"spans": tracer.drain(),
                           "dropped": tracer.dropped}, f)
            os.replace(tmp, task_path + ".spans")
        if ctx is not None:
            from .obs.opmetrics import flush_task_opmetrics
            flush_task_opmetrics(task_path, ctx, task_id, attempt)
        if _to_bool(settings.get(METRICS_ENABLED.key, False)):
            flush_worker_metrics(root, worker_id)
    except Exception:  # noqa: BLE001 — observability never fails a task
        pass


def _write_marker(path: str, suffix: str, doc: Dict) -> None:
    """Commit a classification marker (``.qcancel``, ``.spillfail``,
    ``.fetchfail``) next to a task's ``.err``, written then renamed."""
    tmp = f"{path}.{suffix}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, f"{path}.{suffix}")


def _write_text(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


class _Heartbeat:
    """A daemon thread rewriting ``heartbeats/w<K>.hb`` every
    ``interval`` seconds; the driver treats a stale file as a wedged
    worker. A native call that holds the interpreter lock starves this
    thread too; chaos ``hang`` simulates that through ``suspend``."""

    def __init__(self, root: str, worker_id: int, interval: float):
        self.path = os.path.join(root, "heartbeats", f"w{worker_id}.hb")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._beat()
        self._thread.start()

    def _beat(self):
        try:
            _write_text(self.path, str(time.time()))
        except OSError:
            pass

    def _run(self):
        while not self._stop.wait(self.interval):
            self._beat()

    def suspend(self):
        self._stop.set()


def _classify_failure(path: str, exc: BaseException) -> None:
    """The structured marker a classified failure leaves before its
    ``.err``: the driver then cancels (``qcancel``), retries without
    blaming the worker (``spillfail``) or reruns the producing map task
    from lineage (``fetchfail``)."""
    if isinstance(exc, _QueryCancelled):
        _write_marker(path, "qcancel", {"reason": exc.reason,
                                        "detail": (exc.detail or "")[:400]})
    if isinstance(exc, _SpillReadError):
        _write_marker(path, "spillfail",
                      {"kind": exc.kind, "path": exc.path,
                       "detail": (exc.detail or "")[:500]})
    if isinstance(exc, FetchFailure):
        _write_marker(path, "fetchfail",
                      {"shuffle_id": exc.shuffle_id,
                       "map_task": exc.map_task, "path": exc.path,
                       "kind": exc.kind,
                       "detail": (exc.detail or "")[:500]})


def _run_claimed(root: str, worker_id: int, path: str, kind: str,
                 payload: Dict, hb: _Heartbeat) -> None:
    """One claimed attempt: the cancel check, the chaos hooks, the task,
    its reports, then its ``.ok`` or classified ``.err``."""
    from .scheduler import chaos
    tctx = payload.get("trace")
    tracer = Tracer(
        trace_id=tctx["trace_id"], pid=worker_id + 1,
        max_spans=tctx.get("max_spans", 100_000),
        id_prefix=f"{payload.get('task_id', 't')}."
                  f"a{payload.get('attempt', 0)}.") \
        if tctx else NULL_TRACER
    settings = payload.get("conf", {}) or {}
    task_id = payload.get("task_id", "?")
    attempt = payload.get("attempt", 0)
    spec = settings.get(INJECT_FAULTS.key, "")
    obs_sink: Dict = {}
    # the claim, recorded and flushed before the chaos hook and the task,
    # so even an os._exit leaves the attempt's events behind
    RECORDER.configure(RapidsConf(settings))
    claim_wall = time.time()
    RECORDER.record("task", ev="claim", task=task_id, attempt=attempt,
                    task_kind=kind, worker=worker_id)
    if RECORDER.enabled:
        try:
            flush_worker_ring(root, worker_id)
        except OSError:
            pass
    before = _launches()
    try:
        _write_text(path + ".claim", f"{worker_id} {time.time()}")
        lc = payload.get("lifecycle") or {}
        if lc.get("cancel_path") and os.path.exists(lc["cancel_path"]):
            from .lifecycle import QueryCancelled, read_cancel_marker
            r, d = read_cancel_marker(lc["cancel_path"])
            raise QueryCancelled(
                r, f"cancel marker observed at task claim: {d}",
                lc.get("query_id", ""))
        # conf-carried chaos (oom_storm, the spill-tier modes) before the
        # task builds its ctx and memory manager
        overrides = chaos.conf_overrides(spec, worker_id, task_id, attempt)
        if overrides:
            payload["conf"] = dict(payload.get("conf") or {}, **overrides)
        chaos.maybe_inject(
            spec, worker_id, task_id, attempt, hb,
            hang_bound_s=max(5.0, RapidsConf(settings).get(
                HEARTBEAT_TIMEOUT) * 3),
            cancel_path=lc.get("cancel_path"))
        with tracer.span(f"task {task_id} a{attempt}", cat="task",
                         parent_id=tctx["parent"] if tctx else None,
                         args={"kind": kind, "worker": worker_id}):
            _TASK_KINDS[kind](payload, tracer, obs_sink)
        if kind == "map":
            # durability chaos after the commit: the task succeeds, and
            # only the read side can find the loss
            chaos.maybe_inject_output(
                spec, worker_id, task_id, attempt,
                os.path.join(payload["shuffle_root"],
                             f"s{payload['shuffle_id']}",
                             f"{task_id}.mapout"))
        _write_kernel_report(path, before, attempt, task_id, worker_id)
        _flush_task_obs(root, worker_id, path, tracer, settings,
                        ctx=obs_sink.get("ctx"), task_id=task_id,
                        attempt=attempt)
        RECORDER.record("task", ev="ok", task=task_id, attempt=attempt,
                        worker=worker_id)
        _flush_task_flight(root, worker_id, path, task_id, attempt,
                           claim_wall, failed=False)
        _write_text(path + ".ok", "ok")
    except BaseException as exc:  # every failure leaves an .err
        tb = traceback.format_exc()
        _write_kernel_report(path, before, attempt, task_id, worker_id)
        _flush_task_obs(root, worker_id, path, tracer, settings,
                        ctx=obs_sink.get("ctx"), task_id=task_id,
                        attempt=attempt)
        RECORDER.record("task", ev="err", task=task_id, attempt=attempt,
                        worker=worker_id,
                        error=tb.strip().splitlines()[-1][:200])
        _flush_task_flight(root, worker_id, path, task_id, attempt,
                           claim_wall, failed=True, error=tb)
        _classify_failure(path, exc)
        _write_text(path + ".err", tb)
        if not isinstance(exc, Exception):
            raise  # an interrupt or exit stops the worker after its .err


def worker_main(root: str, worker_id: int, poll_s: float = 0.02,
                heartbeat_interval: float = 0.5) -> None:
    """The worker's loop: claim the task files addressed to this worker,
    run each, write its markers; return when ``<root>/shutdown``
    appears."""
    tasks_dir = os.path.join(root, "tasks")
    hb = _Heartbeat(root, worker_id, heartbeat_interval)
    hb.start()
    while True:
        if os.path.exists(os.path.join(root, "shutdown")):
            return
        ran = False
        try:
            names = sorted(os.listdir(tasks_dir))
        except FileNotFoundError:
            names = []
        for name in names:
            if not name.endswith(f".w{worker_id}.task"):
                continue
            path = os.path.join(tasks_dir, name)
            if os.path.exists(path + ".ok") or os.path.exists(path + ".err"):
                continue
            try:
                with open(path, "rb") as f:
                    kind, payload = pickle.load(f)
            except (OSError, EOFError):
                continue  # unlinked under us: the worker was declared lost
            except Exception:  # noqa: BLE001
                # a pickle that cannot load is a task failure with a
                # traceback, not a worker death
                _write_text(path + ".err", traceback.format_exc())
                ran = True
                continue
            _run_claimed(root, worker_id, path, kind, payload, hb)
            ran = True
        if not ran:
            time.sleep(poll_s)


class _WorkerPool:
    """The N worker processes: spawn, poll, kill, respawn and heartbeat
    staleness, the seam ``TaskScheduler`` drives liveness through."""

    def __init__(self, root: str, n: int, env: Dict[str, str],
                 heartbeat_interval: float, exit_timeout_s: float = 10.0):
        self.root = root
        self.n = n
        self._env = env
        self._hb_interval = heartbeat_interval
        self._exit_timeout_s = exit_timeout_s
        self._procs: List[Optional[subprocess.Popen]] = [None] * n
        self._errlogs: List[Optional[Tuple[str, object]]] = [None] * n
        self._spawn_ts = [0.0] * n
        # (heartbeat mtime, monotonic time it was seen) a worker: its
        # staleness runs on the driver's monotonic clock
        self._hb_seen: List[Optional[Tuple[float, float]]] = [None] * n
        for w in range(n):
            self.spawn(w)

    def spawn(self, w: int) -> None:
        errpath = os.path.join(self.root, f"worker-{w}.err")
        errf = open(errpath, "ab")  # appended: respawns keep the history
        self._errlogs[w] = (errpath, errf)
        # stderr into a file, not a pipe: an undrained pipe blocks the
        # worker once it fills
        self._procs[w] = subprocess.Popen(
            [sys.executable, "-m", "spark_rapids_tpu_torch.cluster",
             "--root", self.root, "--worker", str(w),
             "--heartbeat", str(self._hb_interval)],
            env=self._env, stdout=subprocess.DEVNULL, stderr=errf)
        self._spawn_ts[w] = time.monotonic()
        # a fresh incarnation must not look wedged through its
        # predecessor's last beat
        self._hb_seen[w] = None
        try:
            os.unlink(self._hb_path(w))
        except OSError:
            pass

    def alive(self, w: int) -> bool:
        p = self._procs[w]
        return p is not None and p.poll() is None

    def exit_info(self, w: int) -> Tuple[Optional[int], str]:
        p = self._procs[w]
        rc = p.returncode if p is not None else None
        err = ""
        if self._errlogs[w] is not None:
            try:
                with open(self._errlogs[w][0], "rb") as f:
                    err = f.read().decode(errors="replace")
            except OSError:
                pass
        return rc, err

    def kill(self, w: int) -> None:
        p = self._procs[w]
        if p is not None and p.poll() is None:
            p.kill()
            try:
                p.wait(timeout=self._exit_timeout_s)
            except subprocess.TimeoutExpired:
                pass

    def respawn(self, w: int) -> None:
        self.kill(w)
        if self._errlogs[w] is not None:
            try:
                self._errlogs[w][1].close()
            except OSError:
                pass
        self.spawn(w)

    def _hb_path(self, w: int) -> str:
        return os.path.join(self.root, "heartbeats", f"w{w}.hb")

    def heartbeat_age(self, w: int) -> Optional[float]:
        try:
            mtime = os.stat(self._hb_path(w)).st_mtime
        except OSError:
            return None  # no beat yet this incarnation
        seen = self._hb_seen[w]
        now = time.monotonic()
        if seen is None or seen[0] != mtime:
            self._hb_seen[w] = (mtime, now)
            return 0.0
        return now - seen[1]

    def spawn_ts(self, w: int) -> float:
        return self._spawn_ts[w]

    def shutdown(self) -> None:
        with open(os.path.join(self.root, "shutdown"), "w") as f:
            f.write("1")
        for w in range(self.n):
            p = self._procs[w]
            if p is None:
                continue
            try:
                p.wait(timeout=self._exit_timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=self._exit_timeout_s)
                except subprocess.TimeoutExpired:
                    pass
        for log in self._errlogs:
            if log is not None:
                try:
                    log[1].close()
                except OSError:
                    pass


# --- plans that travel -------------------------------------------------------

class _RefusingPickler(pickle.Pickler):
    """Pickles a plan and names what must not travel in it: a tensor
    (device state of the driver), a generator, a lock or a thread-local
    (per-run state)."""

    _LOCKS = (type(threading.Lock()), type(threading.RLock()),
              threading.local)

    def __init__(self, f):
        super().__init__(f, protocol=4)
        self.refusals: List[str] = []

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            self.refusals.append(f"tensor {tuple(obj.shape)} on "
                                 f"{obj.device}")
        elif isinstance(obj, torch.Generator):
            self.refusals.append("torch.Generator")
        elif isinstance(obj, self._LOCKS) \
                or isinstance(obj, threading.Condition):
            self.refusals.append(type(obj).__name__)
        else:
            return NotImplemented
        return type(None), ()


def plan_pickle_refusals(plan) -> List[str]:
    """What in ``plan`` must not go into a task pickle (empty when it
    travels as structure only); a plan that cannot pickle at all names
    the error."""
    p = _RefusingPickler(io.BytesIO())
    try:
        p.dump(plan)
    except Exception as e:  # noqa: BLE001 — reported, not raised
        return [f"unpicklable: {type(e).__name__}: {e}"]
    return p.refusals


def _cpu_placed(root: GpuExec, root_on_device: bool) -> set:
    """``id`` of every node the planner placed on the CPU: below a
    ``HostToDeviceExec`` down to the next ``DeviceToHostExec``, and from
    the root when the root is on the CPU."""
    from .exec.transitions import DeviceToHostExec, HostToDeviceExec
    out: set = set()

    def walk(node, on_device):
        if not on_device:
            out.add(id(node))
        for c in getattr(node, "children", ()):
            if isinstance(node, HostToDeviceExec):
                walk(c, False)
            elif isinstance(node, DeviceToHostExec):
                walk(c, True)
            else:
                walk(c, on_device)

    walk(root, root_on_device)
    return out


class GpuProcessCluster:
    """N worker processes on ``device`` (``cuda`` unless the caller
    names ``cpu``) against a filesystem rendezvous root; queries run
    under ``scheduler.TaskScheduler`` (module docstring)."""

    def __init__(self, n_workers: int = 2, root: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None, device=None,
                 conf: Optional[RapidsConf] = None):
        self.conf = conf or RapidsConf()
        if self.conf.get(MESH_ENABLED):
            raise NotImplementedError(
                "spark.rapids.tpu.mesh.enabled=true: the process cluster's "
                "mesh route (gang scheduling over NCCL collectives) is not "
                "ported yet; it waits for ROADMAP item 17")
        self.n_workers = n_workers
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.root = root or tempfile.mkdtemp(prefix="rapids_gpu_cluster_")
        self._own_root = root is None
        # a reused root holds an earlier run's files, which the
        # first-commit protocol would take for winning siblings
        import shutil
        for sub in ("tasks", "shuffle", "results", "heartbeats",
                    "metrics", "flight"):
            d = os.path.join(self.root, sub)
            if not self._own_root and os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d, exist_ok=True)
        try:
            os.unlink(os.path.join(self.root, "shutdown"))
        except OSError:
            pass
        if self.device.type == "cuda" and torch.cuda.is_available():
            # every kernel built before the spawn: a worker only loads
            # the libraries before its first heartbeat
            from .ops._build import build_all
            build_all()
        wenv = dict(os.environ)
        # workers import the package by name from the driver's tree
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        pyp = wenv.get("PYTHONPATH", "")
        if pkg_parent not in pyp.split(os.pathsep):
            wenv["PYTHONPATH"] = (pkg_parent + os.pathsep + pyp
                                  if pyp else pkg_parent)
        wenv[ENV_DEVICE] = str(self.device)
        wenv[ENV_SHARING] = str(n_workers)
        wenv[ENV_IS_WORKER] = "1"
        if env:
            wenv.update(env)
        self.pool = _WorkerPool(self.root, n_workers, wenv,
                                self.conf.get(HEARTBEAT_INTERVAL),
                                self.conf.get(WORKER_EXIT_TIMEOUT))
        self._query_seq = 0
        self._sid_seq = 0
        self._quarantine_seq = 0
        self.last_scheduler: Optional[TaskScheduler] = None
        self.last_qctx = None
        self._running_qctx = None  # set only while run_query runs
        self.last_trace_path: Optional[str] = None
        self.last_incident_path: Optional[str] = None
        self.last_plan: Optional[GpuExec] = None
        self.last_opmetrics: Dict = {}
        self.last_profile_path: Optional[str] = None
        self.last_kernel_reports: List[Dict] = []
        self.last_wall_s: Optional[float] = None
        maybe_start_http_server(self.conf)
        from .obs.metrics import set_status_provider
        set_status_provider(self._status_doc)
        RECORDER.configure(self.conf)
        # spill namespaces of dead owners (an earlier crashed run's)
        try:
            from .config import DISK_ORPHAN_TTL, SPILL_DIR
            from .memory import sweep_orphan_spill_dirs
            sweep_orphan_spill_dirs(self.conf.get(SPILL_DIR),
                                    self.conf.get(DISK_ORPHAN_TTL),
                                    force=True)
        except Exception:  # noqa: BLE001 — the sweep never fails boot
            pass

    def shutdown(self) -> None:
        from .obs.metrics import clear_status_provider
        clear_status_provider(self._status_doc)
        self.pool.shutdown()
        if self._own_root:
            import shutil
            shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def _status_doc(self) -> Dict:
        """The cluster's part of ``/status``: plain reads of driver
        state, no lock and no device work."""
        q = self._running_qctx
        in_flight = []
        if q is not None:
            in_flight.append({
                "query_id": q.query_id, "tenant": q.tenant,
                "phase": getattr(q, "phase", "unknown"),
                "cancelled": q.token.reason})
        doc: Dict = {
            "cluster": {"n_workers": self.n_workers, "root": self.root,
                        "device": str(self.device)},
            "in_flight": in_flight,
        }
        sched = self.last_scheduler
        if sched is not None and q is not None:
            try:
                doc["scheduler"] = sched.live_status()
            except Exception:  # noqa: BLE001 — status is best effort
                pass
        try:
            from .obs.warehouse import STATUS_ROWS, tail_rows, warehouse_dir
            d = warehouse_dir(self.conf)
            if d:
                doc["warehouse_tail"] = tail_rows(
                    d, self.conf.get(STATUS_ROWS))
        except Exception:  # noqa: BLE001
            pass
        return doc

    def cancel_running(self, detail: str = "user requested") -> bool:
        """Cancel the running ``run_query`` from another thread: the
        scheduler's next pass publishes the marker, reaps the attempts,
        and ``run_query`` raises ``QueryCancelled(reason=user)``. False
        when no query is running or it was cancelled already."""
        q = self._running_qctx
        if q is None:
            return False
        return q.cancel(detail)

    # --- queries ----------------------------------------------------------

    def _admission_gate(self, conf: RapidsConf, qctx):
        """The driver's fair admission slot, from the same pool as a
        local collect on the device (no gate without a lifecycle
        context, or for a card this host does not have)."""
        import contextlib
        from .memory import DeviceMemoryManager
        if qctx is None or (self.device.type == "cuda"
                            and not torch.cuda.is_available()):
            return contextlib.nullcontext()
        return DeviceMemoryManager.shared(conf, self.device) \
            .task_slot(qctx)

    def run_query(self, plan, conf: Optional[RapidsConf] = None,
                  qctx=None) -> pa.Table:
        """Run a physical plan (a ``PhysicalPlan`` or its root) across the
        workers: stages split at the shuffle exchanges, map output
        exchanged as Arrow IPC files, the final partitions' results
        concatenated here. The query runs under a ``QueryContext``
        (admission, deadline, cancellation fanned out through the
        rendezvous marker); every attempt goes to the event log when
        ``spark.rapids.eventLog.dir`` is set."""
        conf = conf or self.conf
        settings = conf.items()
        root_on_device = getattr(plan, "root_on_device", True)
        plan = getattr(plan, "root", plan)
        plan = copy.deepcopy(plan)
        refused = plan_pickle_refusals(plan)
        if refused:
            raise TypeError(
                "the plan holds state that must not go into a task "
                f"pickle: {sorted(set(refused))[:8]}")
        # the adaptive reader materializes its exchange through an
        # in-process handle; the cluster is the exchange
        plan = _strip_aqe_reads(plan)
        from .obs.opmetrics import assign_op_ids
        assign_op_ids(plan)
        cpu_nodes = _cpu_placed(plan, root_on_device)
        self.last_plan = plan
        self.last_opmetrics = {}
        self.last_kernel_reports = []
        self._query_seq += 1
        qid = self._query_seq
        from .lifecycle import (LIFECYCLE_ENABLED, QueryCancelled,
                                QueryContext)
        if qctx is None and conf.get(LIFECYCLE_ENABLED):
            qctx = QueryContext.from_conf(conf, query_id=f"q{qid}")
        self.last_qctx = qctx
        self._running_qctx = qctx
        from .obs.attribution import QueryAttribution
        attrib = QueryAttribution.begin(conf, cluster_root=self.root)
        tracer = tracer_from_conf(conf)
        RECORDER.configure(conf)
        sched = TaskScheduler(self.pool, os.path.join(self.root, "tasks"),
                              conf, query_id=f"q{qid}", tracer=tracer,
                              qctx=qctx)
        self.last_scheduler = sched
        self._verify_plan(plan, conf, qid, sched)
        t0 = time.time()
        t0_mono = time.monotonic()
        ok = False
        err = None
        try:
            args = None
            if tracer.enabled:
                from .tools.event_log import plan_fingerprint
                args = {"fingerprint": plan_fingerprint(plan)}
            with tracer.span(f"query q{qid}", cat="query", args=args):
                with self._admission_gate(conf, qctx):
                    if qctx is not None:
                        qctx.phase = "running"
                    result = self._run_query_stages(
                        plan, settings, qid, sched, cpu_nodes,
                        root_on_device, conf)
            ok = True
            return result
        except QueryCancelled as e:
            err = e
            if not any(ev["event"] == "query_cancelled"
                       for ev in sched.events):
                sched._event("query_cancelled",
                             reason=f"[{e.reason}] {e.detail}"[:400])
            from .obs.opmetrics import plan_source
            from .tools.event_log import log_query_cancelled
            try:
                log_query_cancelled(conf, e, time.monotonic() - t0_mono,
                                    source=plan_source(plan),
                                    cluster="process")
            except OSError:
                pass
            raise
        except BaseException as e:
            err = e
            raise
        finally:
            self._running_qctx = None
            self._finish_query(plan, conf, qid, sched, tracer, attrib,
                               qctx, t0, time.monotonic() - t0_mono, ok,
                               err)

    def _finish_query(self, plan, conf, qid, sched, tracer, attrib, qctx,
                      t0: float, wall_s: float, ok: bool, err) -> None:
        """Whatever the outcome: the trace, the folds of the workers'
        snapshots and kernel reports, the event-log line, the warehouse
        row, the profile (a finished query) and the incident bundle (an
        anomalous one)."""
        if tracer.enabled:
            try:
                self.last_trace_path = tracer.write_chrome(
                    conf.get(TRACE_DIR),
                    name=f"trace-{tracer.trace_id}-q{qid}.json")
            except OSError:
                pass
        self.last_wall_s = wall_s
        from .obs.opmetrics import plan_source, top_op_sinks
        try:
            self.last_opmetrics = self._fold_opmetrics(sched)
        except Exception:  # noqa: BLE001 — attribution is best effort
            self.last_opmetrics = {}
        self.last_kernel_reports = self._read_kernel_reports(sched)
        from .tools.event_log import log_scheduler_events
        try:
            log_scheduler_events(conf, f"q{qid}", sched, wall_s,
                                 op_sinks=top_op_sinks(self.last_opmetrics))
        except OSError:
            pass
        if attrib is not None:
            attrib.finish(
                root=plan, folded=self.last_opmetrics, qctx=qctx,
                wall_s=wall_s, source=plan_source(plan),
                cluster={"kind": "process", "n_workers": self.n_workers},
                error=err, device=self._kind_device())
        if ok:
            from .obs.metrics import QUERY_DURATION
            QUERY_DURATION.labels(plan_source(plan),
                                  "process").observe(wall_s)
            self._write_profile(plan, conf, qid, tracer, sched, wall_s)
        try:
            self._maybe_write_incident(conf, qid, sched, tracer, t0)
        except Exception:  # noqa: BLE001 — forensics never mask the query
            pass

    def _kind_device(self):
        """The device the warehouse row and profile name, when this host
        can read its name."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            return None
        return self.device

    def _verify_plan(self, plan: GpuExec, conf: RapidsConf, qid: int,
                     sched: TaskScheduler) -> None:
        """The static contract pass before any task is scheduled; a
        refusal is a ``plan_rejected`` scheduler event, its sinks and an
        incident bundle, then ``PlanVerificationError``."""
        from .config import VERIFY_PLAN
        if not conf.get(VERIFY_PLAN):
            return
        from .analysis.plan_verifier import (PlanVerificationError,
                                             report_rejection, verify_plan)
        report = verify_plan(plan, conf, self._kind_device())
        if report.ok:
            return
        sched._event("plan_rejected", reason=report.summary()[:500])
        report_rejection(conf, report, plan, query_id=f"q{qid}")
        try:
            self._maybe_write_incident(conf, qid, sched, NULL_TRACER,
                                       time.time() - 1.0)
        except Exception:  # noqa: BLE001
            pass
        raise PlanVerificationError(report)

    # --- the folds: op metrics, kernels, registries -------------------------

    @staticmethod
    def _winners(sched: TaskScheduler) -> List[Tuple[str, int, int]]:
        return [(e["task"], e["attempt"], e["worker"])
                for e in sched.events if e["event"] == "task_ok"]

    def _fold_opmetrics(self, sched: TaskScheduler) -> Dict:
        """The winning attempts' per-operator snapshots folded into
        totals, per-task maxima and skew; a losing or crashed attempt's
        file is left out (partial attribution)."""
        from .obs.opmetrics import fold_snapshots, read_task_opmetrics
        snaps = read_task_opmetrics(os.path.join(self.root, "tasks"),
                                    self._winners(sched))
        return fold_snapshots(snaps)

    def _read_kernel_reports(self, sched: TaskScheduler) -> List[Dict]:
        """Every attempt's ``.kernels.json`` of this query, winners and
        failures alike, with ``won`` set on the winners."""
        tasks = os.path.join(self.root, "tasks")
        won = set(self._winners(sched))
        out = []
        seen = set()
        for e in sched.events:
            if e["event"] not in ("task_ok", "task_failed",
                                  "attempt_lost"):
                continue
            key = (e["task"], e["attempt"], e["worker"])
            if key in seen:
                continue
            seen.add(key)
            path = os.path.join(tasks, f"{e['task']}.a{e['attempt']}"
                                       f".w{e['worker']}.task.kernels.json")
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            doc["won"] = key in won
            out.append(doc)
        return out

    def kernel_launches(self, winners_only: bool = True) \
            -> Dict[int, Dict[str, int]]:
        """The last query's kernel launches summed a worker, by wrapper
        name (the winning attempts' only, unless asked)."""
        out: Dict[int, Dict[str, int]] = {}
        for doc in self.last_kernel_reports:
            if winners_only and not doc.get("won"):
                continue
            acc = out.setdefault(int(doc["worker"]), {})
            for k, v in doc.get("launches", {}).items():
                acc[k] = acc.get(k, 0) + int(v)
        return out

    def worker_counter(self, name: str, label: str = "") -> float:
        """A registry counter summed over the workers' latest flushed
        snapshots (``spark.rapids.metrics.enabled``)."""
        total = 0.0
        for _tag, snap in read_worker_metrics(self.root):
            fam = snap.get(name)
            if fam:
                total += float(fam.get("samples", {}).get(label, 0) or 0)
        return total

    def prometheus_text(self) -> str:
        """One exposition document over the driver's registry and every
        worker snapshot flushed through the rendezvous, each series
        labelled ``proc="driver"`` or ``"w<K>"``."""
        tagged = [("driver", REGISTRY.snapshot())]
        tagged.extend(read_worker_metrics(self.root))
        return render_merged_snapshots(tagged)

    def _write_profile(self, plan: GpuExec, conf: RapidsConf, qid: int,
                       tracer, sched: TaskScheduler, wall_s: float) -> None:
        """One query profile (``spark.rapids.history.dir``) with the
        folded per-operator metrics."""
        from .obs.opmetrics import (HISTORY_DIR, build_profile, plan_source,
                                    write_profile)
        if not conf.get(HISTORY_DIR):
            return
        try:
            tid = tracer.trace_id if getattr(tracer, "enabled", False) \
                else None
            doc = build_profile(
                plan, self.last_opmetrics, wall_s, query=f"q{qid}",
                source=plan_source(plan), cluster="process",
                trace_id=tid, conf=conf, device=self._kind_device(),
                extra={"scheduler": sched.summary(),
                       "n_workers": self.n_workers})
            self.last_profile_path = write_profile(conf, doc)
        except Exception:  # noqa: BLE001 — history never fails the query
            pass

    def last_analyzed(self, formatted: bool = False) -> str:
        """EXPLAIN ANALYZE of the last ``run_query``: the executed plan
        with its operators' metrics folded across the workers."""
        if self.last_plan is None:
            raise RuntimeError("no query has run on this cluster")
        from .obs.opmetrics import render_analyzed
        return render_analyzed(self.last_plan, self.last_opmetrics,
                               wall_s=self.last_wall_s,
                               formatted=formatted, cluster="process")

    def explain_analyze(self, plan, conf: Optional[RapidsConf] = None,
                        formatted: bool = False) -> str:
        """Run ``plan`` across the workers and return its EXPLAIN
        ANALYZE text (``GpuSession.sql('EXPLAIN ANALYZE ...')`` with a
        cluster attached comes here)."""
        self.run_query(plan, conf)
        return self.last_analyzed(formatted=formatted)

    def _maybe_write_incident(self, conf: RapidsConf, qid: int,
                              sched: TaskScheduler, tracer,
                              t0: float) -> None:
        """The driver's ring, every worker's ring file and flight dumps
        and the registries into one incident bundle under the flight
        directory, when the query had an anomaly."""
        if not conf.get(FLIGHT_ENABLED):
            return
        from .obs.anomaly import (anomalies_from_scheduler,
                                  build_incident_bundle)
        anomalies = anomalies_from_scheduler(sched.events)
        dumps = read_flight_dumps(os.path.join(self.root, "tasks"),
                                  query_id=f"q{qid}")
        if not anomalies and not dumps:
            return
        import uuid
        fid = tracer.trace_id if getattr(tracer, "enabled", False) \
            else uuid.uuid4().hex[:16]
        metrics = {"driver": REGISTRY.snapshot()}
        for tag, snap in read_worker_metrics(self.root):
            metrics[tag] = snap
        # the workers' rings scoped to this query, as the driver's
        rings = []
        for tag, doc in read_worker_rings(self.root):
            evs = [e for e in doc.get("events", [])
                   if e.get("ts", 0.0) >= t0]
            if evs:
                rings.append((tag, dict(doc, events=evs)))
        bundle = build_incident_bundle(
            query_id=f"q{qid}", flight_id=fid, seq=next_incident_seq(),
            trigger_anomalies=anomalies,
            driver_events=RECORDER.snapshot(since=t0),
            worker_rings=rings, worker_dumps=dumps,
            sched_events=sched.events, metrics_snapshot=metrics,
            conf=conf, straggler_factor=conf.get(FLIGHT_STRAGGLER_FACTOR),
            since=t0)
        self.last_incident_path = write_incident_bundle(
            resolve_flight_dir(conf, self.root), bundle,
            max_files=conf.get(TRACE_MAX_FILES))

    # --- stages -------------------------------------------------------------

    def _run_stage_lineage(self, sched: TaskScheduler,
                           specs: Sequence[TaskSpec], label: str,
                           shuffle_root: str,
                           map_specs: Dict[int, List[TaskSpec]],
                           budget: List[int]) -> None:
        """Run a stage; a classified fetch failure quarantines the lost
        map output, reruns only the map task that made it (itself under
        this protection) and resumes the stage without its committed
        tasks. ``budget`` is the query's rerun allowance."""
        pending = list(specs)
        while True:
            try:
                sched.run_stage(pending, stage_label=label)
                return
            except FetchFailedError as ff:
                lost = next((s for s in map_specs.get(ff.shuffle_id, [])
                             if s.task_id == ff.map_task), None)
                if lost is None:
                    raise RuntimeError(
                        f"{label}: shuffle {ff.shuffle_id} map output "
                        f"{ff.map_task!r} is {ff.kind} and no lineage "
                        f"is available to recompute it") from ff
                if budget[0] <= 0:
                    raise RuntimeError(
                        f"{label}: map output {ff.map_task} lost "
                        f"({ff.kind}) with the stage-rerun budget "
                        f"(spark.rapids.shuffle.maxStageRetries) "
                        f"exhausted") from ff
                budget[0] -= 1
                self._quarantine_mapout(shuffle_root, ff.shuffle_id,
                                        ff.map_task)
                _STAGE_RERUNS.inc()
                sched._event(
                    "stage_rerun", task=ff.map_task, worker=ff.worker,
                    reason=f"{label} hit fetch failure [{ff.kind}] on "
                           f"{ff.task} a{ff.attempt}; re-executing "
                           f"{ff.map_task} from lineage")
                self._run_stage_lineage(
                    sched, [lost], f"map s{ff.shuffle_id} rerun",
                    shuffle_root, map_specs, budget)
                pending = [s for s in pending
                           if s.task_id not in ff.completed]

    def _quarantine_mapout(self, shuffle_root: str, sid: int,
                           task_key: str) -> None:
        """Fence a bad committed output out of every reader's view (they
        list ``*.mapout`` only), keeping its bytes; output already gone
        has nothing to fence."""
        d = os.path.join(shuffle_root, f"s{sid}", f"{task_key}.mapout")
        self._quarantine_seq += 1
        try:
            os.rename(d, os.path.join(
                os.path.dirname(d),
                f"{task_key}.quarantine{self._quarantine_seq}"))
        except OSError:
            pass

    def _run_query_stages(self, plan: GpuExec, settings: Dict, qid: int,
                          sched: TaskScheduler, cpu_nodes: set,
                          root_on_device: bool,
                          conf: RapidsConf) -> pa.Table:
        shuffle_root = os.path.join(self.root, "shuffle")
        # every shuffle's map tasks stay addressable for the query, so a
        # later stage's fetch failure can rerun exactly one of them
        map_specs: Dict[int, List[TaskSpec]] = {}
        rerun_budget = [conf.get(SHUFFLE_MAX_STAGE_RETRIES)]
        while True:
            exch = _deepest_exchange(plan)
            if exch is None:
                break
            self._sid_seq += 1
            sid = self._sid_seq
            on_cpu = id(exch) in cpu_nodes
            slices = _split_leaf_input(exch.child, self.n_workers)
            specs = [TaskSpec(f"q{qid}s{sid}m{i}", "map", {
                "plan": child_slice,
                "partitioning": exch.partitioning,
                "shuffle_root": shuffle_root,
                "shuffle_id": sid,
                "map_id_base": i * 100_000,
                "on_cpu": on_cpu,
                "conf": settings,
            }) for i, child_slice in enumerate(slices)]
            map_specs[sid] = specs
            self._run_stage_lineage(sched, specs, f"map s{sid}",
                                    shuffle_root, map_specs, rerun_budget)
            n = exch.partitioning.num_partitions
            read = ProcessShuffleReadExec(
                shuffle_root, sid, list(range(n)),
                exch.child.output_schema,
                expected_mapouts=[s.task_id for s in specs],
                partitioning=exch.partitioning)
            # the exchange's id: the reduce side's rows fold under it
            read._op_id = getattr(exch, "_op_id", None)
            plan = _replace_node(plan, exch, read)
        outs = []
        specs = []
        # a final region with a global operator runs whole on one worker
        split = _distribution(plan) is not None
        for w in range(self.n_workers):
            final = _slice_partitions(copy.deepcopy(plan), w,
                                      self.n_workers) if split else None
            if final is None:
                if w == 0:
                    final = plan  # no shuffle read: one worker runs it
                else:
                    continue
            out = os.path.join(self.root, "results", f"q{qid}_r{w}.arrow")
            outs.append(out)
            specs.append(TaskSpec(f"q{qid}r{w}", "collect",
                                  {"plan": final, "out": out,
                                   "on_cpu": not root_on_device,
                                   "conf": settings}))
        self._run_stage_lineage(sched, specs, "final", shuffle_root,
                                map_specs, rerun_budget)
        from .columnar.arrow_bridge import arrow_schema
        target = arrow_schema(plan.output_schema)
        tables = []
        for out in outs:
            with pa.OSFile(out, "rb") as f:
                tables.append(pa.ipc.open_file(f).read_all())
        tables = [t.cast(target) for t in tables if t.num_rows] \
            or [target.empty_table()]
        return pa.concat_tables(tables)


def run_process_query(plan, n_workers: int = 2,
                      conf: Optional[RapidsConf] = None,
                      device=None) -> pa.Table:
    """Start a cluster, run one query, stop it."""
    with GpuProcessCluster(n_workers, conf=conf, device=device) as cluster:
        return cluster.run_query(plan, conf)


# --- plan surgery ------------------------------------------------------------

def _strip_aqe_reads(plan: GpuExec) -> GpuExec:
    """Each adaptive reader replaced by its exchange: the cluster splits
    stages at exchanges, and a reader above a ``ProcessShuffleReadExec``
    would materialize a node that has no map side."""
    from .exec.aqe import GpuAQEShuffleReadExec
    if isinstance(plan, GpuAQEShuffleReadExec):
        return _strip_aqe_reads(plan.child)
    kids = getattr(plan, "children", ())
    if kids:
        new = tuple(_strip_aqe_reads(c) for c in kids)
        if any(n is not o for n, o in zip(new, kids)):
            plan = plan.with_new_children(new)
    return plan


def _deepest_exchange(plan: GpuExec):
    """A shuffle exchange with none below it (the next runnable map
    stage), or None."""
    from .exec.exchange import GpuShuffleExchangeExec
    found = None

    def walk(node):
        nonlocal found
        for c in getattr(node, "children", ()):
            walk(c)
        if isinstance(node, GpuShuffleExchangeExec) and found is None:
            if not _contains_exchange(node.child):
                found = node

    walk(plan)
    return found


def _contains_exchange(plan: GpuExec) -> bool:
    from .exec.exchange import GpuShuffleExchangeExec
    if isinstance(plan, GpuShuffleExchangeExec):
        return True
    return any(_contains_exchange(c) for c in getattr(plan, "children", ()))


def _replace_node(plan: GpuExec, old: GpuExec, new: GpuExec) -> GpuExec:
    if plan is old:
        return new
    kids = getattr(plan, "children", ())
    if kids:
        nkids = tuple(_replace_node(c, old, new) for c in kids)
        if any(n is not o for n, o in zip(nkids, kids)):
            plan = plan.with_new_children(nkids)
    return plan


def _split_leaf_input(plan: GpuExec, n: int) -> List[GpuExec]:
    """A map stage's input in up to n tasks: a stage fed by an earlier
    shuffle by partition range; otherwise by one leaf's files or batches,
    round robin, the stage's other leaves whole in every task (a join
    distributes over its split side). An aliased leaf (one node under two
    parents) is never split, and a stage with nothing to split is one
    task."""
    from .exec.base import HostBatchSourceExec
    from .io.scan import GpuFileScanExec

    if _contains_read(plan):
        if _distribution(plan) is None:
            return [plan]
        out = []
        for w in range(n):
            p = _slice_partitions(copy.deepcopy(plan), w, n)
            if p is not None:
                out.append(p)
        if out:
            return out
    leaves: List[Tuple[tuple, GpuExec]] = []

    def walk(node, path):
        kids = getattr(node, "children", ())
        if not kids:
            leaves.append((path, node))
        for i, c in enumerate(kids):
            walk(c, path + (i,))

    walk(plan, ())
    counts: Dict[int, int] = {}
    for _, lf in leaves:
        counts[id(lf)] = counts.get(id(lf), 0) + 1
    best = None  # (pieces, path, is_scan)
    for path, lf in leaves:
        if counts[id(lf)] > 1:
            continue
        if isinstance(lf, GpuFileScanExec) and len(lf.paths) > 1:
            pieces, is_scan = len(lf.paths), True
        elif isinstance(lf, HostBatchSourceExec) and len(lf.batches) > 1:
            pieces, is_scan = len(lf.batches), False
        else:
            continue
        if not _leaf_split_ok(plan, path):
            continue
        if best is None or pieces > best[0]:
            best = (pieces, path, is_scan)
    if best is None:
        return [plan]
    _, path, is_scan = best
    out = []
    for i in range(n):
        p = copy.deepcopy(plan)
        node = p
        for j in path:
            node = node.children[j]
        pieces = (node.paths if is_scan else node.batches)[i::n]
        if not pieces:
            continue
        if is_scan:
            node.paths = list(pieces)
        else:
            node.batches = list(pieces)
        out.append(p)
    return out or [plan]


def _contains_read(plan: GpuExec) -> bool:
    if isinstance(plan, ProcessShuffleReadExec):
        return True
    return any(_contains_read(c) for c in getattr(plan, "children", ()))


def _slice_partitions(plan: GpuExec, w: int, n: int):
    """Every ``ProcessShuffleReadExec`` cut to worker w's share of its
    partitions (both sides of a join the same share); None when w gets
    none anywhere."""
    reads: List[ProcessShuffleReadExec] = []
    seen = set()

    def walk(node):
        if isinstance(node, ProcessShuffleReadExec) \
                and id(node) not in seen:
            # an aliased read sliced twice would leave partitions unread
            seen.add(id(node))
            reads.append(node)
        for c in getattr(node, "children", ()):
            walk(c)

    walk(plan)
    if not reads:
        return None
    any_parts = False
    for r in reads:
        r.partitions = r.partitions[w::n]
        any_parts = any_parts or bool(r.partitions)
    return plan if any_parts else None


# --- which regions split -----------------------------------------------------
# The in-process engine runs each stage as one stream, so the planner puts
# an exchange only under a grouped aggregate or a DISTINCT; a sort, a
# limit, a global aggregate or a window is global over its input. A
# region splits by partition range only where every operator is local to
# the partitions (``_distribution``), and by a leaf's pieces only where
# every operator on the path to that leaf distributes over it
# (``_leaf_split_ok``); anywhere else the region runs as one task.

def _key_ordinals(exprs) -> Optional[Tuple[int, ...]]:
    """The ordinals of bound column references, or None when a key is
    an expression."""
    from .expr.base import BoundReference
    out = []
    for e in exprs:
        while type(e).__name__ == "Alias":
            e = e.child
        if not isinstance(e, BoundReference):
            return None
        out.append(e.ordinal)
    return tuple(out)


def _distribution(node) -> Optional[Tuple]:
    """How a region's output is spread over its reads' partition slices:
    None when the node needs every partition at once (a global operator,
    a replicated leaf), else ``(ordinals, dtypes)`` of the hash keys its
    rows stay partitioned by (``((), ())`` when no output column is
    one)."""
    from .exec.aggregate import GpuHashAggregateExec
    from .exec.basic import GpuFilterExec, GpuProjectExec
    from .exec.exchange import GpuCoalesceBatchesExec
    from .exec.generate import GpuGenerateExec
    from .exec.joins import _BaseJoinExec
    from .exec.misc import GpuUnionExec
    from .exec.transitions import DeviceToHostExec, HostToDeviceExec
    from .exec.window import GpuWindowExec
    none: Tuple = ((), ())
    if isinstance(node, ProcessShuffleReadExec):
        keys = getattr(node.partitioning, "key_exprs", None)
        ords = _key_ordinals(keys) if keys else None
        if ords is None:
            return none
        return ords, tuple(str(e.dtype) for e in keys)
    if isinstance(node, (GpuFilterExec, GpuCoalesceBatchesExec,
                         HostToDeviceExec, DeviceToHostExec,
                         GpuGenerateExec)):
        return _distribution(node.child)
    if isinstance(node, GpuProjectExec):
        d = _distribution(node.child)
        if d is None or not d[0]:
            return d
        src = [(_key_ordinals([e]) or (None,))[0] for e in node.exprs]
        try:
            return tuple(src.index(o) for o in d[0]), d[1]
        except ValueError:
            return none  # a key column is projected away
    if isinstance(node, GpuHashAggregateExec):
        d = _distribution(node.child)
        groups = _key_ordinals(node.group_exprs)
        if d is None or not d[0] or not groups \
                or not set(d[0]) <= set(groups):
            return None
        return tuple(groups.index(o) for o in d[0]), d[1]
    if isinstance(node, GpuWindowExec):
        d = _distribution(node.child)
        parts = _key_ordinals(node.part_exprs)
        if d is None or not d[0] or not parts \
                or not set(d[0]) <= set(parts):
            return None
        return d
    if isinstance(node, _BaseJoinExec):
        ld, rd = (_distribution(c) for c in node.children)
        lk, rk = _key_ordinals(node.left_keys), _key_ordinals(node.right_keys)
        if ld is None or rd is None or not ld[0] or lk is None \
                or ld[0] != lk or rd[0] != rk or ld[1] != rd[1]:
            return None
        return ld
    if isinstance(node, GpuUnionExec):
        return none if all(_distribution(c) is not None
                           for c in node.children) else None
    return None


#: the sides a join distributes over, by join type
_JOIN_SPLIT_SIDES = {"inner": (0, 1), "cross": (0, 1), "left_outer": (0,),
                     "left_semi": (0,), "left_anti": (0,),
                     "right_outer": (1,)}


def _leaf_split_ok(root, path: tuple) -> bool:
    """Whether every operator from ``root`` down ``path`` distributes
    over the leaf at its end (the others stay whole in every task)."""
    from .exec.basic import GpuFilterExec, GpuProjectExec
    from .exec.exchange import GpuCoalesceBatchesExec
    from .exec.generate import GpuGenerateExec
    from .exec.joins import _BaseJoinExec
    from .exec.misc import GpuUnionExec
    from .exec.transitions import DeviceToHostExec, HostToDeviceExec
    rowwise = (GpuFilterExec, GpuProjectExec, GpuCoalesceBatchesExec,
               HostToDeviceExec, DeviceToHostExec, GpuGenerateExec,
               GpuUnionExec)
    node = root
    for i in path:
        if isinstance(node, _BaseJoinExec):
            if i not in _JOIN_SPLIT_SIDES.get(node.join_type, ()):
                return False
        elif not isinstance(node, rowwise):
            return False
        node = node.children[i]
    return True


def _main(argv: Sequence[str]) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--heartbeat", type=float, default=0.5)
    args = ap.parse_args(argv)
    if os.environ.get(ENV_DEVICE, "cuda") == "cpu":
        # the workers share the host's cores
        torch.set_num_threads(1)
    worker_main(args.root, args.worker, heartbeat_interval=args.heartbeat)


if __name__ == "__main__":
    _main(sys.argv[1:])

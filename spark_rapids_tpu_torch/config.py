"""RapidsConf equivalent: typed config registry with the ``spark.rapids.*``
namespace preserved.

Counterpart of ``spark_rapids_tpu/config.py:1``, copied entry for entry
so that one plain settings dict means the same thing to both packages.
Entry docs describe the JAX engine where the port has no counterpart
yet; the port's first slice reads ``batchSizeRows``,
``stageFusion.enabled``, ``parquet.reader.type``,
``parquet.multiThreadedRead.numThreads``, ``scan.prefetchBatches`` and
``parquet.deviceDecode.enabled``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, Optional

__all__ = ["ConfEntry", "RapidsConf", "register", "ENTRIES"]


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]
    internal: bool = False
    startup_only: bool = False


ENTRIES: Dict[str, ConfEntry] = {}


def _to_bool(v):
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes")


def _to_int(v):
    return int(v)


def _to_float(v):
    return float(v)


def _to_str(v):
    return str(v)


def _bytes_conv(v):
    """Parse '512m', '2g', '1024' style byte sizes (Spark conf convention)."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    mult = 1
    for suffix, m in (("kb", 1 << 10), ("mb", 1 << 20), ("gb", 1 << 30),
                      ("tb", 1 << 40), ("k", 1 << 10), ("m", 1 << 20),
                      ("g", 1 << 30), ("t", 1 << 40), ("b", 1)):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
            mult = m
            break
    return int(float(s) * mult)


def register(key, default, doc, conv=None, internal=False, startup_only=False):
    if conv is None:
        conv = {bool: _to_bool, int: _to_int, float: _to_float,
                str: _to_str}.get(type(default), _to_str)
    e = ConfEntry(key, default, doc, conv, internal, startup_only)
    ENTRIES[key] = e
    return e


# --- Core enablement ------------------------------------------------------
SQL_ENABLED = register(
    "spark.rapids.sql.enabled", True,
    "Master kill switch: when false every operator stays on CPU.")
EXPLAIN = register(
    "spark.rapids.sql.explain", "NONE",
    "Explain why parts of a plan did or did not run on TPU: "
    "NONE, ALL, NOT_ON_GPU.")
INCOMPATIBLE_OPS = register(
    "spark.rapids.sql.incompatibleOps.enabled", True,
    "Allow ops whose behavior can differ slightly from Spark "
    "(e.g. float aggregation ordering).")
VARIABLE_FLOAT_AGG = register(
    "spark.rapids.sql.variableFloatAgg.enabled", True,
    "Allow float/double aggregations whose result can vary with "
    "parallel reduction order.")
ANSI_ENABLED = register(
    "spark.sql.ansi.enabled", False,
    "ANSI mode: overflow/invalid-cast raise instead of null/wrap.")
CASE_SENSITIVE = register(
    "spark.sql.caseSensitive", False,
    "Case sensitivity for column resolution (Spark default false).")
SESSION_TZ = register(
    "spark.sql.session.timeZone", "UTC",
    "Session time zone; the TPU path supports UTC only (like early "
    "spark-rapids), other zones fall back per-expression.")

VERIFY_PLAN = register(
    "spark.rapids.sql.verifyPlan", True,
    "Static plan verification before execution: every physical plan is "
    "checked bottom-up against the operators' declared contracts "
    "(child/output schema and dtype agreement, nullability "
    "propagation, exchange co-partitioning, AQE-wrapper "
    "well-formedness, a static HBM footprint estimate vs the memory "
    "ledger budget) and rejected with a named reason instead of "
    "failing mid-query. See analysis/plan_verifier.py.")

STAGE_FUSION = register(
    "spark.rapids.sql.stageFusion.enabled", True,
    "Compose chains of per-batch operators (project/filter/expand/"
    "aggregate partial/exchange partition-key split) into one XLA "
    "program per batch — the whole-stage-codegen analog. Filters stay "
    "as lazy selection masks inside a fused stage instead of paying "
    "stream compaction.")

SCAN_STAGE_FUSION = register(
    "spark.rapids.sql.stageFusion.scan.enabled", True,
    "Extend whole-stage fusion THROUGH the parquet device-decode scan: "
    "the downstream fused chain (filter -> project -> partial-agg "
    "tail) is spliced into the fused-decode program, so each coalesced "
    "row-group batch pays ONE program dispatch for "
    "decode+filter+project+partial-agg instead of a decode dispatch "
    "plus a chain dispatch (and skips the full-batch HBM "
    "materialization between them). Requires stageFusion.enabled and "
    "the parquet deviceDecode path; per-scan fusedDispatches/"
    "scanPrograms metrics prove the dispatch count.")

SCAN_FUSED_DONATE = register(
    "spark.rapids.sql.scan.fused.donateInputs", True,
    "Donate the staged decode blob (and the fused chain's uploaded "
    "host-fallback/partition columns) into the fused-decode program "
    "(jax donate_argnums): XLA reuses their HBM for the outputs "
    "instead of holding input + output live across the dispatch — the "
    "direct attack on scan-path HBM round-trips. Ignored on the CPU "
    "backend (donation is unimplemented there and would only warn).")

# --- Batching / memory ----------------------------------------------------
BATCH_SIZE_BYTES = register(
    "spark.rapids.sql.batchSizeBytes", 1 << 30,
    "Target output batch size in bytes for coalescing (reference default "
    "2GiB ceiling / 1GiB typical).", conv=_bytes_conv)
BATCH_SIZE_ROWS = register(
    "spark.rapids.sql.batchSizeRows", 1 << 20,
    "Target max rows per device batch; capacities are bucketed to "
    "powers of two up to this for bounded XLA recompilation.",
    conv=_to_int)
CONCURRENT_TPU_TASKS = register(
    "spark.rapids.sql.concurrentGpuTasks", 2,
    "Max concurrent tasks that may hold the device semaphore "
    "(name kept from the reference conf surface).")
ALLOC_FRACTION = register(
    "spark.rapids.memory.gpu.allocFraction", 0.85,
    "Fraction of device HBM the buffer pool may use.")
HOST_SPILL_LIMIT = register(
    "spark.rapids.memory.host.spillStorageSize", 8 << 30,
    "Bytes of host memory usable for spilled device buffers before "
    "falling through to disk.", conv=_bytes_conv)
SPILL_DIR = register(
    "spark.rapids.memory.spillDir",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_spill"),
    "Base directory for disk-tier spill files (default under the "
    "temporary directory, $TMPDIR). Each process spills "
    "under its own incarnation namespace "
    "<host>-<pid>-<incarnation>/ so crashed processes' files are "
    "attributable and reclaimable (see memory.sweep_orphan_spill_dirs).")
DISK_SPILL_LIMIT = register(
    "spark.rapids.memory.disk.limit", 0,
    "Byte budget for LIVE disk-tier spill residency (0 = unlimited). "
    "A spill that would breach it first evicts the oldest unpinned "
    "disk entries back to the host tier; if the budget still cannot "
    "fit the write, the batch stays host-resident and the breach is "
    "classified as disk pressure (metric + event log + flight "
    "recorder) instead of failing the caller's eviction cascade.",
    conv=_bytes_conv)
DISK_READ_RETRIES = register(
    "spark.rapids.memory.disk.readRetries", 3,
    "Transient (EIO-class) spill-file read failures are retried in "
    "place this many times with exponential backoff before the read "
    "escalates a classified SpillReadError(kind=io). Missing, corrupt "
    "and torn spill files are never retried in place — rereading bad "
    "bytes cannot fix them.")
DISK_READ_RETRY_WAIT_MS = register(
    "spark.rapids.memory.disk.readRetryWaitMs", 50,
    "Base wait between in-place spill read retries, doubling per "
    "retry.", conv=_to_float)
DISK_ORPHAN_TTL = register(
    "spark.rapids.memory.disk.orphanTTL", 86400.0,
    "Age bound (seconds) for the orphan-spill sweep's fallback: an "
    "incarnation spill directory whose owner pid cannot be proven "
    "dead (a different host on a shared filesystem) is reclaimed only "
    "once it is at least this old. Same-host directories with a dead "
    "owner pid are reclaimed immediately at manager/cluster startup.")
OOM_RETRY_ENABLED = register(
    "spark.rapids.sql.oomRetry.enabled", True,
    "Enable the task-level retry/split-and-retry framework on device OOM.")
OOM_MAX_SPLITS = register(
    "spark.rapids.sql.oomRetry.maxSplits", 8,
    "Max times an input batch may be split in half under OOM retry.")
OOM_RETRY_BLOCKING = register(
    "spark.rapids.sql.oomRetry.blocking", True,
    "Block on each stage's device result inside the retry scope. XLA "
    "dispatch is asynchronous, so without this a real device "
    "RESOURCE_EXHAUSTED surfaces at a later sync point outside the "
    "retry and split-and-retry never engages; with it, the stage result "
    "completes (or fails) inside the scope at the cost of cross-batch "
    "dispatch overlap.")

# --- Shuffle --------------------------------------------------------------
SHUFFLE_MODE = register(
    "spark.rapids.shuffle.mode", "LOCAL",
    "Shuffle transport: LOCAL (device-resident spillable store — the "
    "single-process default), HOST (Arrow IPC files, synchronous), "
    "MULTITHREADED (Arrow IPC files with parallel codec threads), ICI "
    "(SPMD all-to-all collectives over the device mesh; requires an "
    "explicit IciShuffleTransport since it needs the mesh).")
SHUFFLE_COMPRESSION = register(
    "spark.rapids.shuffle.compression.codec", "lz4",
    "Codec for host shuffle partitions: none, lz4, zstd (the codecs "
    "Arrow IPC buffer compression defines).")
SHUFFLE_THREADS = register(
    "spark.rapids.shuffle.multiThreaded.writer.threads", 4,
    "Serialization/compression threads for MULTITHREADED shuffle.")
SHUFFLE_PARTITIONS = register(
    "spark.sql.shuffle.partitions", 16,
    "Default partition count for exchanges (Spark conf name).")
ICI_MAX_PAYLOAD = register(
    "spark.rapids.shuffle.ici.maxPartitionBytes", 256 << 20,
    "Per-shard payload bucket ceiling for the ICI all-to-all exchange.",
    conv=_bytes_conv)
SHUFFLE_FETCH_MAX_RETRIES = register(
    "spark.rapids.shuffle.fetch.maxRetries", 3,
    "Transient (EIO-class) shuffle block read failures are retried in "
    "place this many times with exponential backoff before the reader "
    "escalates a classified FetchFailure to the driver. Missing, "
    "corrupt, and torn blocks are never retried in place — rereading "
    "bad bytes cannot fix them.")
SHUFFLE_FETCH_RETRY_WAIT_MS = register(
    "spark.rapids.shuffle.fetch.retryWaitMs", 50,
    "Base wait between in-place shuffle fetch retries, doubling per "
    "retry.", conv=_to_float)
SHUFFLE_CLOSE_JOIN_TIMEOUT = register(
    "spark.rapids.shuffle.close.joinTimeout", 10.0,
    "Seconds HostShuffleTransport.close() waits for outstanding "
    "multithreaded writer futures before abandoning them (a wedged "
    "codec/filesystem thread must not hang teardown forever).")
SHUFFLE_MAX_STAGE_RETRIES = register(
    "spark.rapids.shuffle.maxStageRetries", 4,
    "Lineage-recovery budget per query: how many map-task "
    "re-executions (regenerating shuffle output a reader found "
    "missing/corrupt/torn or persistently unreadable) may run before "
    "the query fails — the spark.stage.maxConsecutiveAttempts analog "
    "for the process cluster.")

# --- IO -------------------------------------------------------------------
PARQUET_ENABLED = register(
    "spark.rapids.sql.format.parquet.enabled", True,
    "Enable TPU-accelerated Parquet input/output.")
PARQUET_READER_TYPE = register(
    "spark.rapids.sql.format.parquet.reader.type", "MULTITHREADED",
    "PERFILE, MULTITHREADED (parallel footer+data fetch), or COALESCING "
    "(merge small files into one decode).")
PARQUET_MULTITHREADED_THREADS = register(
    "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads", 8,
    "Reader thread pool size for MULTITHREADED parquet.")
PARQUET_DEVICE_DECODE = register(
    "spark.rapids.sql.format.parquet.deviceDecode.enabled", True,
    "Decode Parquet pages on the device: encoded column chunks "
    "(dictionary indices, RLE runs, PLAIN bytes, string stores, delta "
    "miniblocks) cross the host->device link instead of fully-decoded "
    "columns, and the expansion runs as an XLA program in HBM (the "
    "GpuParquetScan-decodes-into-HBM analog). The envelope covers v1 "
    "AND v2 data pages of flat columns in PLAIN (including BYTE_ARRAY "
    "strings), PLAIN_/RLE_DICTIONARY, DELTA_BINARY_PACKED and "
    "DELTA_LENGTH_BYTE_ARRAY encodings under snappy/zstd/gzip/brotli. "
    "Chunks still outside it (nested, FIXED_LEN_BYTE_ARRAY, "
    "DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT, LZ4) decode on host per "
    "chunk, counted by the scan's fallback-reason histogram.")
CSV_ENABLED = register(
    "spark.rapids.sql.format.csv.enabled", True,
    "Enable accelerated CSV reads.")
JSON_ENABLED = register(
    "spark.rapids.sql.format.json.enabled", True,
    "Enable accelerated JSON reads.")
ORC_ENABLED = register(
    "spark.rapids.sql.format.orc.enabled", True,
    "Enable accelerated ORC reads/writes.")
HIVE_TEXT_ENABLED = register(
    "spark.rapids.sql.format.hiveText.enabled", True,
    "Enable accelerated Hive text-serde reads/writes (LazySimpleSerDe "
    "defaults: \\x01 delimiter, \\N nulls).")
#: each scan format's enable key (a disabled format scans on the CPU)
FORMAT_CONF = {"parquet": PARQUET_ENABLED, "orc": ORC_ENABLED,
               "csv": CSV_ENABLED, "json": JSON_ENABLED,
               "hivetext": HIVE_TEXT_ENABLED}
PARQUET_COMPRESSION = register(
    "spark.sql.parquet.compression.codec", "snappy",
    "Compression codec for Parquet writes: none, snappy, zstd, lz4, gzip.")
MAX_PARTITION_BYTES = register(
    "spark.sql.files.maxPartitionBytes", 128 << 20,
    "Split files into partitions of at most this many bytes.",
    conv=_bytes_conv)
# --- AQE ------------------------------------------------------------------
ADAPTIVE_ENABLED = register(
    "spark.sql.adaptive.enabled", True,
    "Adaptive re-planning at shuffle stage boundaries: runtime "
    "join-strategy switch (shuffled->broadcast when the materialized "
    "build side is small), partition coalescing + skew split, exchange "
    "reuse. On by default: the join switch decides from sync-free "
    "capacity metadata, and partition stats are only consulted where "
    "the transport gathered them for free (see "
    "spark.rapids.sql.adaptive.freeStatsOnly).")
ADAPTIVE_FREE_STATS = register(
    "spark.rapids.sql.adaptive.freeStatsOnly", True,
    "With AQE: only use per-partition statistics gathered as part of "
    "work a transport already did — the host transport's writer-side "
    "byte counts (recorded while splitting each downloaded map batch; "
    "zero device access to serve), the local transport's writer-side "
    "count kernels (dispatched async with each map batch's split, "
    "folded in by one deferred few-int32 readback at the stage "
    "boundary), the ICI exchange's epoch readback. No payload "
    "downloads, no read-time stats kernels, no spill re-uploads — "
    "adaptive coalesce/skew engages on the default paths for at most "
    "one tiny transfer per exchange. Transports/shuffles without "
    "recorded stats report none and the reader passes through; set "
    "false on co-located hosts to let them sync for stats anyway.")
AUTO_BROADCAST_THRESHOLD = register(
    "spark.sql.autoBroadcastJoinThreshold", 10 << 20,
    "AQE demotes a shuffled hash join to broadcast when the "
    "materialized build-side stage is at most this many bytes "
    "(capacity-based estimate, no device sync). -1 disables.",
    conv=_bytes_conv)
ADAPTIVE_COALESCE = register(
    "spark.sql.adaptive.coalescePartitions.enabled", True,
    "With AQE: merge adjacent shuffle partitions below the advisory "
    "size into one device batch (GpuShuffleCoalesceExec analog).")
ADAPTIVE_ADVISORY_BYTES = register(
    "spark.sql.adaptive.advisoryPartitionSizeInBytes", 64 << 20,
    "Target post-shuffle partition size for AQE coalescing/splitting.",
    conv=_bytes_conv)
ADAPTIVE_SKEW_FACTOR = register(
    "spark.sql.adaptive.skewJoin.skewedPartitionFactor", 5,
    "With AQE: a partition this many times the median is skewed.")
ADAPTIVE_SKEW_THRESHOLD = register(
    "spark.sql.adaptive.skewJoin.skewedPartitionThresholdInBytes",
    256 << 20,
    "With AQE: minimum size for skew handling to kick in.",
    conv=_bytes_conv)
SCAN_PREFETCH_BATCHES = register(
    "spark.rapids.sql.scan.prefetchBatches", 2,
    "Decoded batches uploaded ahead of the consumer: host->device "
    "transfer of batch N+1 overlaps device compute on batch N "
    "(SURVEY.md §7.3.4). 0 disables the upload pipeline.")
SCAN_UPLOAD_THREADS = register(
    "spark.rapids.sql.scan.uploadThreads", 3,
    "Feeder threads for the device-decode parquet scan: blob assembly "
    "+ device_put + fused-decode dispatch of row group N+1 run here "
    "while the consumer computes on batch N, so the host->device "
    "tunnel is never serial with compute. 0 disables the overlap "
    "(assemble/upload on the consumer thread).")
SCAN_INFLIGHT_BATCHES = register(
    "spark.rapids.sql.scan.inFlightBatches", 4,
    "Bounded in-flight device-residency window for pipelined scan "
    "uploads: at most this many assembled-but-not-yet-consumed device "
    "batches may exist at once (each is registered with the device "
    "memory ledger while in flight, so eviction pressure sees them).")
SCAN_COALESCE_TARGET_BYTES = register(
    "spark.rapids.sql.scan.coalesceTargetBytes", 32 << 20,
    "Device-decode scan: coalesce consecutive small row groups of one "
    "schema toward this many decoded output bytes before a single "
    "fused-decode dispatch (fewer, larger transfers and programs; rows "
    "stay capped by spark.rapids.sql.batchSizeRows). 0 dispatches one "
    "program per row group.", conv=_bytes_conv)

APPROX_PERCENTILE_EXACT = register(
    "spark.rapids.sql.approxPercentile.exact", True,
    "approx_percentile strategy: true = exact rank over the single-pass "
    "group sort (rank error 0; concatenates the whole input like "
    "collect_*); false = mergeable fixed-width quantile summary "
    "(t-digest-style) that partials/merges per batch and across the "
    "mesh — rank error ~1/sqrt(accuracy) per merge level, bounded "
    "memory.")

JOIN_VERIFY_UNIQUE_HINT = register(
    "spark.rapids.sql.join.verifyUniqueHint", True,
    "Verify DataFrame.join(..., build_unique=True) hints: a false hint "
    "would silently drop duplicate matches. When the build analysis "
    "readback happens anyway the hint is validated for free (falling "
    "back to the duplicate-correct staged path); on the zero-readback "
    "fast path a device-side duplicate probe is recorded and raised at "
    "the query's first natural download — no extra host sync.")

# --- Process-cluster scheduler --------------------------------------------
TASK_MAX_ATTEMPTS = register(
    "spark.rapids.tpu.task.maxAttempts", 4,
    "Max attempts per cluster task (1 = no retry). A task that fails on "
    "one worker is retried on another, like Spark's spark.task.maxFailures.")
TASK_TIMEOUT = register(
    "spark.rapids.tpu.task.timeout", 300.0,
    "Seconds a claimed task attempt may run before the driver declares "
    "the worker hung, kills it, and retries the task elsewhere.")
STAGE_TIMEOUT = register(
    "spark.rapids.tpu.scheduler.stageTimeout", 600.0,
    "Wall-clock ceiling for one stage of a process-cluster query, "
    "including every retry and respawn.")
MAX_TASK_FAILURES_PER_WORKER = register(
    "spark.rapids.tpu.scheduler.maxTaskFailuresPerWorker", 2,
    "Blacklist a worker after this many task failures (errors, deaths, "
    "or hangs) — no new attempts are scheduled on it.")
MAX_WORKER_RESPAWNS = register(
    "spark.rapids.tpu.scheduler.maxWorkerRespawns", 4,
    "Total worker process respawns a query may spend recovering from "
    "dead or wedged workers before the failure is fatal.")
WORKER_EXIT_TIMEOUT = register(
    "spark.rapids.tpu.worker.exitTimeout", 10.0,
    "Seconds the driver waits for a worker process to exit after a "
    "kill or cluster shutdown before moving on (startup-time knob: "
    "the pool reads it when the cluster spawns).", startup_only=True)
HEARTBEAT_INTERVAL = register(
    "spark.rapids.tpu.heartbeat.interval", 0.5,
    "Seconds between worker heartbeat-file writes (startup-time knob: "
    "workers read it when the cluster spawns them).", startup_only=True)
HEARTBEAT_TIMEOUT = register(
    "spark.rapids.tpu.heartbeat.timeout", 10.0,
    "Driver-side staleness bound: a worker whose heartbeat file is "
    "older than this is considered wedged and is killed + respawned. "
    "A hung native call (e.g. a stuck Pallas compile) holds the GIL and "
    "starves the heartbeat thread, so wedged-in-native workers trip "
    "this too.")
MESH_ENABLED = register(
    "spark.rapids.tpu.mesh.enabled", False,
    "Multi-host mesh runtime: bootstrap jax.distributed across the "
    "TpuProcessCluster worker fleet so one logical device mesh spans "
    "every worker's local devices, and run mesh-eligible queries as "
    "gang-scheduled SPMD tasks whose shuffle exchanges ride the ICI "
    "collective across the process boundary (startup-time knob: the "
    "pool wires the rendezvous env when the cluster spawns).",
    startup_only=True)
MESH_COORDINATOR_PORT = register(
    "spark.rapids.tpu.mesh.coordinatorPort", 0,
    "TCP port for the jax.distributed coordinator (hosted by worker "
    "process 0). 0 picks a free ephemeral port at cluster boot.",
    startup_only=True)
MESH_DEVICES_PER_PROCESS = register(
    "spark.rapids.tpu.mesh.devicesPerProcess", 2,
    "Local devices each worker process contributes to the global mesh. "
    "On the CPU backend this provisions XLA virtual devices "
    "(--xla_force_host_platform_device_count); on real TPU hosts the "
    "locally attached chips are used and this is a consistency check.",
    startup_only=True)
MESH_BOOTSTRAP_TIMEOUT = register(
    "spark.rapids.tpu.mesh.bootstrapTimeout", 45.0,
    "Seconds a worker blocks in the jax.distributed rendezvous (and "
    "the driver waits for every worker's mesh-ready marker) before "
    "mesh bootstrap is declared failed and queries fall back to the "
    "file-based shuffle path.", startup_only=True)
MESH_BARRIER_TIMEOUT = register(
    "spark.rapids.tpu.mesh.barrierTimeout", 60.0,
    "Seconds a gang member waits at a cross-process exchange barrier "
    "(manifest rendezvous) for its peers before classifying the "
    "exchange as a fetch failure [io] — bounds how long a gang can "
    "wedge when a peer dies mid-stage.")
MESH_GANG_RETRIES = register(
    "spark.rapids.tpu.mesh.gangRetries", 1,
    "Whole-gang retries after a gang member fails: the fleet is "
    "respawned under a fresh mesh incarnation and the gang reruns "
    "from scratch. Exhausting the budget falls back to the classic "
    "file-based stage path instead of failing the query.")
SPECULATION = register(
    "spark.rapids.tpu.speculation", False,
    "Speculative execution: launch a duplicate attempt of a task "
    "running longer than speculation.multiplier x the stage's median "
    "completed-task time; whichever attempt commits first wins "
    "(map output commits are atomic, so the loser's files never mix in).")
SPECULATION_MULTIPLIER = register(
    "spark.rapids.tpu.speculation.multiplier", 4.0,
    "A running task is a straggler when its runtime exceeds this many "
    "times the median completed-task runtime of its stage.")
SPECULATION_MIN_RUNTIME = register(
    "spark.rapids.tpu.speculation.minRuntime", 1.0,
    "Never speculate a task that has been running for less than this "
    "many seconds (guards against duplicating short tasks).")
INJECT_FAULTS = register(
    "spark.rapids.tpu.test.injectFaults", "",
    "Testing: deterministic fault injection in cluster workers. "
    "Semicolon-separated rules 'mode:task_glob:attempt[:arg]' with "
    "mode crash | hang | delay | corrupt | drop | eio (process/"
    "shuffle-durability faults), hang_query | oom_storm | "
    "slow_admission (query-scoped lifecycle faults; slow_admission "
    "matches the QUERY id and is applied by the driver's admission "
    "controller), or spill_corrupt | spill_torn | disk_full | "
    "slow_disk (spill-tier durability faults, applied by the task's "
    "memory manager), task_glob an fnmatch pattern over task ids "
    "(e.g. 'q1s1m0'), attempt an int or '*'. Unknown modes are a "
    "hard parse error, never a silent no-op. See scheduler/chaos.py.",
    internal=True)

# --- Flight recorder ------------------------------------------------------
FLIGHT_ENABLED = register(
    "spark.rapids.flight.enabled", True,
    "Always-on flight recorder: every process keeps a bounded ring of "
    "recent span closures, memory-ledger transitions, scheduler events "
    "and shuffle waits, and dumps a self-contained incident bundle "
    "when an anomaly fires (task failure, worker death, OOM-retry or "
    "spill cascade, statistical straggler) — forensics without having "
    "pre-enabled tracing. Recording is a bounded deque append; disable "
    "only to rule the recorder out while debugging the recorder.")
FLIGHT_DIR = register(
    "spark.rapids.flight.dir", "",
    "Directory for incident bundles "
    "(incident-<trace_id>-<seq>.json). Empty = <cluster root>/flight "
    "for process-cluster queries, so bundles land somewhere useful "
    "even with zero configuration.")
FLIGHT_MAX_EVENTS = register(
    "spark.rapids.flight.maxEvents", 2048,
    "Per-process flight-recorder ring bound in events; the oldest "
    "events are evicted first (black-box semantics).")
FLIGHT_MAX_BYTES = register(
    "spark.rapids.flight.maxBytes", 1 << 20,
    "Per-process flight-recorder ring bound in (approximate) bytes — "
    "the second bound that keeps a pathological event burst from "
    "exhausting memory even under maxEvents.", conv=_bytes_conv)
FLIGHT_STRAGGLER_FACTOR = register(
    "spark.rapids.flight.stragglerFactor", 6.0,
    "Statistical straggler trigger: a running attempt whose runtime "
    "exceeds this many times the stage's running median completed-task "
    "time (and the speculation.minRuntime floor) is recorded as an "
    "anomaly — independent of whether speculation is enabled.")

# --- UDF ------------------------------------------------------------------
UDF_COMPILER_ENABLED = register(
    "spark.rapids.sql.udfCompiler.enabled", True,
    "Translate simple Python UDF bytecode into engine expressions so they "
    "run on TPU (reference: JVM bytecode udf-compiler).")

# --- Metrics / debug ------------------------------------------------------
METRICS_LEVEL = register(
    "spark.rapids.sql.metrics.level", "MODERATE",
    "ESSENTIAL, MODERATE, or DEBUG operator metric collection. DEBUG "
    "blocks on device results inside timed regions so opTime is real "
    "device time (slower; per-batch sync).")
PROFILE_PATH = register(
    "spark.rapids.profile.path", "",
    "When set, PhysicalPlan.collect runs under a torch.profiler "
    "session (CPU activity, and CUDA on a CUDA device) and writes its "
    "Chrome trace (torch-<pid>-<ms>.pt.trace.json) into this directory "
    "(open with chrome://tracing, Perfetto or TensorBoard).")
MEM_DEBUG = register(
    "spark.rapids.memory.gpu.debug", "NONE",
    "NONE or STDOUT: log every device buffer alloc/free.")
LEAK_DEBUG = register(
    "spark.rapids.refcount.debug", False,
    "Track buffer refcount leaks and report at shutdown with alloc sites.")
TEST_RETRY_OOM_INJECT = register(
    "spark.rapids.sql.test.injectRetryOOM", 0,
    "Testing: force a synthetic device OOM after N allocations "
    "(0 = disabled).", internal=True)
TEST_RETRY_OOM_STORM = register(
    "spark.rapids.sql.test.injectRetryOOM.storm", 0,
    "Testing: the FIRST N retry-scope executions all raise synthetic "
    "device OOM (0 = disabled) — the sustained-pressure injection the "
    "degradation ladder is walked with; chaos mode 'oom_storm' sets "
    "it per cluster task.", internal=True)
TEST_SPILL_FAULT = register(
    "spark.rapids.memory.test.injectSpillFault", "",
    "Testing: damage every committed spill file this manager writes — "
    "'corrupt' flips payload bytes (only the CRC can catch it), "
    "'torn' truncates the trailer. Set per cluster task by chaos "
    "modes 'spill_corrupt' / 'spill_torn'.", internal=True)
TEST_DISK_FULL = register(
    "spark.rapids.memory.test.injectDiskFull", 0,
    "Testing: the FIRST N disk-spill writes raise ENOSPC mid-write "
    "(0 = disabled) — the full-disk rehearsal; chaos mode 'disk_full' "
    "sets it per cluster task.", internal=True)
TEST_SLOW_DISK = register(
    "spark.rapids.memory.test.injectSlowDisk", 0.0,
    "Testing: sleep this many seconds before every disk-spill write "
    "and read (0 = disabled) — the degraded-disk rehearsal; chaos "
    "mode 'slow_disk' sets it per cluster task.", internal=True)


class RapidsConf:
    """Settings snapshot, read once per query/executor like the reference's
    RapidsConf. Treat instances handed to a query as frozen: derive changed
    configurations with ``with_settings``; ``set``/``unset`` exist for the
    session-level mutable conf only (SparkConf analog)."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def get(self, entry_or_key):
        if isinstance(entry_or_key, ConfEntry):
            e = entry_or_key
        else:
            e = ENTRIES.get(entry_or_key)
            if e is None:
                return self._settings.get(entry_or_key)
        if e.key in self._settings:
            return e.conv(self._settings[e.key])
        return e.default

    def is_op_enabled(self, kind: str, name: str) -> bool:
        """Per-op kill switch: spark.rapids.sql.exec.<Name> /
        .expression.<Name> / .input.<Name> — default on; any falsy value
        disables the op on TPU."""
        v = self._settings.get(f"spark.rapids.sql.{kind}.{name}")
        if v is None:
            return True
        return _to_bool(v)

    def with_settings(self, extra: Dict[str, Any]) -> "RapidsConf":
        s = dict(self._settings)
        s.update(extra)
        return RapidsConf(s)

    def set(self, key, value):
        self._settings[key] = value

    def unset(self, key):
        self._settings.pop(key, None)

    def items(self):
        return dict(self._settings)

    # Convenience accessors used on hot paths
    @property
    def batch_size_rows(self):
        return self.get(BATCH_SIZE_ROWS)

    @property
    def batch_size_bytes(self):
        return self.get(BATCH_SIZE_BYTES)

    @property
    def sql_enabled(self):
        return self.get(SQL_ENABLED)

    @property
    def ansi(self):
        return self.get(ANSI_ENABLED)


def generate_docs() -> str:
    """docs/configs.md generated from the registry, as the reference does."""
    lines = ["# Configuration", "",
             "Generated from `spark_rapids_tpu_torch/config.py` — do not edit.", "",
             "| Key | Default | Description |", "|---|---|---|"]
    for key in sorted(ENTRIES):
        e = ENTRIES[key]
        if e.internal:
            continue
        lines.append(f"| `{e.key}` | `{e.default}` | {e.doc} |")
    return "\n".join(lines) + "\n"

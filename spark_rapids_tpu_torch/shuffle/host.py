"""Host Arrow-IPC shuffle transport: the host-file shuffle.

Counterpart of ``spark_rapids_tpu/shuffle/host.py``. A map batch is
downloaded once, whole, with its partition-id lane (``_write_map_batch``
through ``device_to_arrow``), split on the host with numpy, and each
non-empty partition is written as a compressed Arrow IPC file sealed with
the CRC-32C footer of ``integrity.py`` (one file a map batch and
partition). A read streams a partition's files back through
``arrow_to_device`` onto the transport's device.

Two modes behind one class, as ``spark.rapids.shuffle.mode`` names them:

- ``HOST``: the download and the write run on the writer's thread;
- ``MULTITHREADED``: a pool of ``spark.rapids.shuffle.multiThreaded
  .writer.threads`` downloads and writes while the map side goes on; a
  read waits for the shuffle's outstanding writes. A pool thread's copy
  waits on an event recorded on the producer's stream, and the closure
  holds the batch until its copy is done, so the caching allocator
  cannot hand its memory out mid-copy. At most twice the pool's threads
  are outstanding: the producer blocks past that.

The codecs are Arrow IPC's own (``spark.rapids.shuffle.compression
.codec`` = ``none`` | ``lz4`` | ``zstd``); ``snappy`` is not an IPC codec
and is refused.

The task-attempt protocol (``begin_task_attempt``, ``commit_task_attempt``,
``abort_task_attempt``): an attempt writes into a private staging
directory and publishes it, with its manifest (each file's size, CRC and
decoded bytes), by one ``os.rename`` onto ``<task>.mapout``. The rename
fails onto a non-empty directory, so the first commit wins and a zombie
or speculative sibling's files never appear; a sentinel keeps a zero-row
output non-empty. Staging directories are invisible to readers, which
list committed manifests only (``integrity.expected_partition_index``).

``partition_stats`` serves decoded bytes per partition counted at write
time (from committed manifests alone for a transport that did not write
the shuffle), with no device work; ``stage_bytes`` is their sum.
``read_partition`` reads each block with in-place retries
(``spark.rapids.shuffle.fetch.maxRetries``) and raises a classified
``FetchFailure`` (missing, corrupt, torn, io).

Registry families, labelled by ``transport`` (``host`` here, ``process``
for the cluster's reader): ``rapids_shuffle_partitions_written_total``,
``rapids_shuffle_bytes_written_total``,
``rapids_shuffle_partitions_fetched_total``,
``rapids_shuffle_bytes_fetched_total``,
``rapids_shuffle_fetch_wait_seconds``, and the fetch failures by kind.
"""
from __future__ import annotations

import concurrent.futures
import errno
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa
import torch

from .. import datatypes as dt
from ..config import (RapidsConf, SHUFFLE_CLOSE_JOIN_TIMEOUT,
                      SHUFFLE_COMPRESSION, SHUFFLE_FETCH_MAX_RETRIES,
                      SHUFFLE_FETCH_RETRY_WAIT_MS, SHUFFLE_THREADS)
from ..columnar.batch import GpuBatch
from ..obs.metrics import REGISTRY as _METRICS
from ..obs.recorder import RECORDER as _FLIGHT
from . import integrity
from .transport import (SHUF_FETCH_FAILURES, FetchFailure,
                        ShuffleTransport, ShuffleWriteHandle,
                        record_fetch_failure)

__all__ = ["HostShuffleTransport", "SHUF_PARTS_WRITTEN",
           "SHUF_BYTES_WRITTEN", "SHUF_PARTS_FETCHED",
           "SHUF_BYTES_FETCHED", "SHUF_FETCH_WAIT", "SHUF_FETCH_FAILURES"]

_LOG = logging.getLogger(__name__)

_IPC_CODECS = ("none", "lz4", "zstd")

SHUF_PARTS_WRITTEN = _METRICS.counter(
    "rapids_shuffle_partitions_written_total",
    "Shuffle partition files (or collective blocks) written.",
    ("transport",))
SHUF_BYTES_WRITTEN = _METRICS.counter(
    "rapids_shuffle_bytes_written_total",
    "Bytes of shuffle output written (serialized size).",
    ("transport",))
SHUF_PARTS_FETCHED = _METRICS.counter(
    "rapids_shuffle_partitions_fetched_total",
    "Shuffle partitions fetched by the read side.", ("transport",))
SHUF_BYTES_FETCHED = _METRICS.counter(
    "rapids_shuffle_bytes_fetched_total",
    "Bytes of shuffle input fetched (deserialized size).",
    ("transport",))
SHUF_FETCH_WAIT = _METRICS.histogram(
    "rapids_shuffle_fetch_wait_seconds",
    "Time the read side blocked waiting for shuffle data (file reads "
    "or collective realization).", ("transport",))


class _HostWriter(ShuffleWriteHandle):
    def __init__(self, transport: "HostShuffleTransport", shuffle_id: int,
                 map_id: int, subdir: Optional[str] = None):
        self._t = transport
        self._sid = shuffle_id
        self._mid = map_id
        self._subdir = subdir

    def write_unsplit(self, batch: GpuBatch,
                      pids: Optional[torch.Tensor]) -> None:
        ready = None
        dev = pids.device if pids is not None else \
            (batch.columns[0].device if batch.columns else None)
        if dev is not None and dev.type == "cuda" \
                and self._t._pool is not None:
            # the pool thread's copy waits for what the producer's
            # stream has enqueued on the batch
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ready = (ev, dev)
        self._t._submit(self._sid, lambda: self._t._write_map_batch(
            self._sid, self._mid, batch, pids, self._subdir, ready))


class HostShuffleTransport(ShuffleTransport):
    """The host-file shuffle (module docstring). ``threads`` 0 is
    ``HOST``; None takes the conf's pool size (``MULTITHREADED``).
    ``device`` is where a read uploads (the exchange's ctx device)."""

    def __init__(self, conf: Optional[RapidsConf] = None,
                 threads: Optional[int] = None,
                 root: Optional[str] = None, device=None):
        conf = conf or RapidsConf()
        self.codec = conf.get(SHUFFLE_COMPRESSION)
        if self.codec not in _IPC_CODECS:
            raise ValueError(
                f"unsupported host-shuffle codec {self.codec!r}; Arrow "
                f"IPC supports {_IPC_CODECS}")
        self._conf = conf
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        if threads is None:
            threads = conf.get(SHUFFLE_THREADS)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=threads, thread_name_prefix="shuffle-write") \
            if threads > 0 else None
        # backpressure: every outstanding write holds its map batch on
        # the device, so the producer blocks past twice the pool
        self._slots = threading.BoundedSemaphore(threads * 2) \
            if threads > 0 else None
        self.root = root or tempfile.mkdtemp(prefix="rapids_gpu_shuffle_")
        self._own_root = root is None
        self._futures: Dict[int, List] = {}
        self._schemas: Dict[int, dt.Schema] = {}
        # a failed write is sticky: every later read of its shuffle
        # raises it, not only the one that drained its future
        self._failed: Dict[int, BaseException] = {}
        # staging dir -> {file: {size, crc, raw}} for the commit manifest
        self._manifests: Dict[str, Dict[str, Dict]] = {}
        self._nparts: Dict[int, int] = {}
        # decoded bytes per partition, counted at write time
        self._pstats: Dict[int, Dict[int, int]] = {}
        self._fetch_retries = conf.get(SHUFFLE_FETCH_MAX_RETRIES)
        self._fetch_wait_s = conf.get(SHUFFLE_FETCH_RETRY_WAIT_MS) / 1e3
        self._mm = None
        self._lock = threading.Lock()

    def set_memory_manager(self, mm) -> None:
        """The ledger a read's uploads are registered in until their
        consumer takes them (the exchange passes its ctx's)."""
        self._mm = mm

    # --- write side -------------------------------------------------------

    def _ipc_options(self):
        codec = None if self.codec == "none" else self.codec
        return pa.ipc.IpcWriteOptions(compression=codec)

    def _sdir(self, shuffle_id: int) -> str:
        return os.path.join(self.root, f"s{shuffle_id}")

    def _path(self, sid: int, mid: int, pid: int,
              subdir: Optional[str] = None) -> str:
        d = subdir if subdir is not None else self._sdir(sid)
        return os.path.join(d, f"m{mid:05d}_p{pid}.arrow")

    def _submit(self, sid: int, fn) -> None:
        if self._pool is None:
            fn()
            return
        self._slots.acquire()

        def run():
            try:
                fn()
            finally:
                self._slots.release()
        with self._lock:
            self._futures.setdefault(sid, []).append(self._pool.submit(run))

    def _write_rb(self, sid: int, mid: int, pid: int, rb: pa.RecordBatch,
                  subdir: Optional[str] = None) -> None:
        path = self._path(sid, mid, pid, subdir)
        sink = pa.BufferOutputStream()
        with pa.ipc.new_file(sink, rb.schema,
                             options=self._ipc_options()) as w:
            w.write_batch(rb)
        size, crc = integrity.write_block(path,
                                          sink.getvalue().to_pybytes())
        with self._lock:
            # "raw" rides the manifest so a transport that did not write
            # the shuffle rebuilds the statistics from manifests alone
            self._manifests.setdefault(os.path.dirname(path), {})[
                os.path.basename(path)] = {"size": size, "crc": crc,
                                           "raw": int(rb.nbytes)}
            if subdir is None:
                # a direct write is visible now; a staged one credits the
                # statistics at its commit, so a speculative duplicate
                # never counts a partition twice
                ps = self._pstats.setdefault(sid, {})
                ps[pid] = ps.get(pid, 0) + int(rb.nbytes)
        SHUF_PARTS_WRITTEN.labels("host").inc()
        SHUF_BYTES_WRITTEN.labels("host").inc(rb.nbytes)

    def _write_map_batch(self, sid: int, mid: int, batch: GpuBatch,
                         pids: Optional[torch.Tensor],
                         subdir: Optional[str] = None,
                         ready=None) -> None:
        """One download for the whole map batch: the partition ids ride
        as one more int32 lane (the download's compaction keeps each row
        with its id), then a numpy take a partition."""
        from ..columnar.arrow_bridge import arrow_schema, device_to_arrow
        from ..columnar.column import GpuColumnVector
        if ready is not None:
            ev, dev = ready
            torch.cuda.current_stream(dev).wait_event(ev)
        with self._lock:
            self._schemas.setdefault(sid, batch.schema)
        if pids is None:
            rb = device_to_arrow(batch)
            if rb.num_rows:
                self._write_rb(sid, mid, 0, rb, subdir)
            return
        ext_schema = dt.Schema(
            list(batch.schema.fields)
            + [dt.StructField("__pid__", dt.INT32, False)])
        lane = GpuColumnVector(dt.INT32, pids.to(torch.int32))
        rb = device_to_arrow(GpuBatch(list(batch.columns) + [lane],
                                      ext_schema, batch.row_count,
                                      selection=batch.selection))
        pid_np = np.asarray(rb.column(rb.num_columns - 1))
        core = pa.RecordBatch.from_arrays(
            [rb.column(i) for i in range(rb.num_columns - 1)],
            schema=arrow_schema(batch.schema))
        for p in np.unique(pid_np):
            idx = np.nonzero(pid_np == p)[0]
            self._write_rb(sid, mid, int(p),
                           core.take(pa.array(idx, pa.int64())), subdir)

    # --- the task-attempt commit protocol ---------------------------------

    def _staging(self, shuffle_id: int, task_key: str, attempt: int) -> str:
        return os.path.join(self._sdir(shuffle_id),
                            f"{task_key}.a{attempt}.staging")

    def begin_task_attempt(self, shuffle_id: int, task_key: str,
                           attempt: int) -> str:
        """Make and return this attempt's private staging directory."""
        d = self._staging(shuffle_id, task_key, attempt)
        os.makedirs(d, exist_ok=True)
        # rename() succeeds onto an EMPTY directory: the sentinel keeps a
        # committed zero-row output non-empty, so a sibling cannot win
        # twice (readers list only *_p<N>.arrow)
        with open(os.path.join(d, ".attempt"), "w") as f:
            f.write(f"{task_key} a{attempt}")
        return d

    def _credit_stats(self, shuffle_id: int, entries: Dict) -> None:
        """A committed attempt's decoded bytes into the statistics."""
        if not entries:
            return
        with self._lock:
            ps = self._pstats.setdefault(shuffle_id, {})
            for name, meta in entries.items():
                m = integrity._PID_RE.search(name)
                if m is None:
                    continue
                pid = int(m.group(1))
                ps[pid] = ps.get(pid, 0) + int((meta or {}).get("raw", 0))

    def commit_task_attempt(self, shuffle_id: int, task_key: str,
                            attempt: int) -> bool:
        """Publish the attempt's output atomically; False when a sibling
        committed first (this attempt's staging is then discarded)."""
        self._drain(shuffle_id)
        staging = self._staging(shuffle_id, task_key, attempt)
        final = os.path.join(self._sdir(shuffle_id), f"{task_key}.mapout")
        with self._lock:
            entries = self._manifests.pop(staging, {})
        try:
            integrity.write_manifest(staging, task_key, attempt, entries)
        except OSError:
            pass  # staging already gone: the rename below settles it
        try:
            os.rename(staging, final)
            self._credit_stats(shuffle_id, entries)
            return True
        except OSError as e:
            # lost the race, or the driver aborted this attempt; any other
            # failure is data loss, not a lost race
            if e.errno in (errno.EEXIST, errno.ENOTEMPTY) \
                    or not os.path.exists(staging):
                shutil.rmtree(staging, ignore_errors=True)
                return False
            raise

    def abort_task_attempt(self, shuffle_id: int, task_key: str,
                           attempt: int) -> None:
        staging = self._staging(shuffle_id, task_key, attempt)
        with self._lock:
            self._manifests.pop(staging, None)
        shutil.rmtree(staging, ignore_errors=True)

    @staticmethod
    def committed_partition_files(sdir: str, partition_id: int):
        """Paths of one partition's committed blocks."""
        return [p for p, _ in integrity.expected_partition_files(
            sdir, partition_id)]

    # --- the transport interface ------------------------------------------

    def register_shuffle(self, shuffle_id: int, num_partitions: int):
        os.makedirs(self._sdir(shuffle_id), exist_ok=True)
        with self._lock:
            self._nparts[shuffle_id] = num_partitions

    def writer(self, shuffle_id: int, map_id: int,
               subdir: Optional[str] = None) -> ShuffleWriteHandle:
        return _HostWriter(self, shuffle_id, map_id, subdir)

    def partition_stats(self, shuffle_id: int) -> Optional[List[int]]:
        """Decoded bytes per partition, counted at write time (no device
        work); a transport that did not write the shuffle rebuilds them
        from the committed manifests. None when nothing was written or a
        block has no recorded size."""
        self._drain(shuffle_id)
        with self._lock:
            n = self._nparts.get(shuffle_id)
            ps = dict(self._pstats.get(shuffle_id, {}))
        if not ps:
            idx = integrity.expected_partition_index(
                self._sdir(shuffle_id), shuffle_id=shuffle_id)
            for pid, blocks in idx.items():
                for _, meta in blocks:
                    if not meta or "raw" not in meta:
                        return None  # partial stats would mislead AQE
                ps[pid] = sum(meta["raw"] for _, meta in blocks)
            if not any(ps.values()):
                return None
        if n is None:
            n = max(ps) + 1 if ps else 0
        return [int(ps.get(p, 0)) for p in range(n)]

    def stage_bytes(self, shuffle_id: int) -> Optional[int]:
        stats = self.partition_stats(shuffle_id)
        return sum(stats) if stats is not None else None

    def _drain(self, sid: int) -> None:
        """Settle a shuffle's outstanding writes; the first error is kept
        and raised by this and every later drain of the shuffle."""
        with self._lock:
            futs = self._futures.pop(sid, [])
        first: Optional[BaseException] = None
        for f in futs:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 — any writer error
                if first is None:      # must reach the readers
                    first = e
        with self._lock:
            if first is not None:
                self._failed.setdefault(sid, first)
            err = self._failed.get(sid)
        if err is not None:
            raise RuntimeError(
                f"shuffle {sid} had a failed async write; its output "
                f"is incomplete") from err

    def read_partitions(self, shuffle_id: int, first: int, last: int):
        for p in range(first, last + 1):
            yield from self.read_partition(shuffle_id, p)

    def read_partition(self, shuffle_id: int, partition_id: int):
        """One partition's batches on the transport's device, a batch a
        block, read and uploaded one block ahead of the consumer."""
        from ..columnar.arrow_bridge import arrow_to_device
        from ..memory import DeviceMemoryManager
        from ..pipeline import pipelined_map
        t0 = time.perf_counter()
        self._drain(shuffle_id)  # the multithreaded writers' wait
        schema = self._schemas.get(shuffle_id)
        try:
            blocks = integrity.expected_partition_files(
                self._sdir(shuffle_id), partition_id,
                shuffle_id=shuffle_id)
        except FetchFailure as ff:
            record_fetch_failure(ff, partition_id, "host")
            raise
        drain_s = time.perf_counter() - t0
        SHUF_FETCH_WAIT.labels("host").observe(drain_s)
        SHUF_PARTS_FETCHED.labels("host").inc()
        _FLIGHT.record("shuffle", ev="drain_wait", sid=int(shuffle_id),
                       part=int(partition_id), wait_s=round(drain_s, 6))
        mm = self._mm
        if mm is None and self.device.type != "cpu":
            mm = DeviceMemoryManager.shared(self._conf, self.device)
        inflight = set()  # ledger entries not yet handed to the consumer
        ilock = threading.Lock()
        closed = [False]

        def load(block):
            path, meta = block
            try:
                payload = integrity.read_block(
                    path, meta, shuffle_id=shuffle_id,
                    max_retries=self._fetch_retries,
                    retry_wait_s=self._fetch_wait_s,
                    on_retry=lambda n, e: _FLIGHT.record(
                        "shuffle", ev="fetch_retry", sid=int(shuffle_id),
                        part=int(partition_id), n=n, error=str(e)[:120]))
            except FetchFailure as ff:
                record_fetch_failure(ff, partition_id, "host")
                raise
            table = pa.ipc.open_file(pa.BufferReader(payload)).read_all()
            batches = [arrow_to_device(rb, schema, self.device)
                       for rb in table.combine_chunks().to_batches()
                       if rb.num_rows]
            # uploads in flight are ledger entries until delivered, one
            # by one, so a failed registration releases the earlier ones
            sbs = []
            if mm is not None:
                try:
                    for b in batches:
                        sbs.append(mm.register(b, pinned=True))
                except BaseException:
                    for sb in sbs:
                        sb.release()
                    raise
            with ilock:
                if closed[0]:
                    for sb in sbs:
                        sb.release()
                    return table.nbytes, batches, []
                inflight.update(sbs)
            return table.nbytes, batches, sbs

        gen = pipelined_map(load, blocks, threads=1, window=2)
        try:
            while True:
                t1 = time.perf_counter()
                try:
                    nbytes, batches, sbs = next(gen)
                except StopIteration:
                    break
                SHUF_FETCH_WAIT.labels("host").observe(
                    time.perf_counter() - t1)
                SHUF_BYTES_FETCHED.labels("host").inc(nbytes)
                with ilock:
                    inflight.difference_update(sbs)
                for sb in sbs:
                    sb.release()  # the consumer owns them now
                yield from batches
        finally:
            gen.close()
            with ilock:
                closed[0] = True
                leftovers = list(inflight)
                inflight.clear()
            for sb in leftovers:
                sb.release()

    def unregister_shuffle(self, shuffle_id: int):
        """Release the shuffle's directory and bookkeeping even after a
        failed write, then raise that write's error."""
        err: Optional[BaseException] = None
        try:
            self._drain(shuffle_id)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err = e
        sdir = self._sdir(shuffle_id)
        with self._lock:
            self._schemas.pop(shuffle_id, None)
            self._failed.pop(shuffle_id, None)
            self._nparts.pop(shuffle_id, None)
            self._pstats.pop(shuffle_id, None)
            for d in [d for d in self._manifests
                      if d == sdir or d.startswith(sdir + os.sep)]:
                del self._manifests[d]
        shutil.rmtree(sdir, ignore_errors=True)
        if err is not None:
            raise err

    def close(self) -> None:
        """Wait up to ``spark.rapids.shuffle.close.joinTimeout`` for the
        outstanding writes, abandon the rest with a log line, and remove
        a root this transport made."""
        join_s = self._conf.get(SHUFFLE_CLOSE_JOIN_TIMEOUT)
        if self._pool is not None:
            with self._lock:
                futs = [f for fs in self._futures.values() for f in fs]
                self._futures.clear()
            self._pool.shutdown(wait=False)
            if futs:
                _, pending = concurrent.futures.wait(futs, timeout=join_s)
                if pending:
                    _LOG.warning(
                        "HostShuffleTransport.close: abandoning %d "
                        "outstanding shuffle write(s) still running "
                        "after %.0fs", len(pending), join_s)
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)

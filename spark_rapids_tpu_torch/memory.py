"""Device memory runtime: the byte ledger, the spill catalog, admission
and split-and-retry.

Counterpart of ``spark_rapids_tpu/memory.py:105-1297`` (the RAPIDS
Accelerator's GpuSemaphore, RapidsBufferCatalog with its device, host
and disk stores, SpillableColumnarBatch and the retry iterators). The
defense against a working set larger than the card:

1. admission: ``task_slot`` over ``lifecycle.FairAdmissionController``
   (``spark.rapids.sql.concurrentGpuTasks`` slots);
2. a byte ledger against the device budget (``resolve_device_budget``:
   ``spark.rapids.memory.device.budgetBytes``, else ``allocFraction`` x
   the card's memory). A registered batch is spillable: past the budget
   the least recently used unpinned entries go to host Arrow, and past
   ``spark.rapids.memory.host.spillStorageSize`` on to sealed Arrow IPC
   files (``shuffle/integrity.py``) under the process's spill namespace;
   ``get`` brings one back;
3. split-and-retry: ``with_retry`` halves a batch on device OOM and runs
   the halves in turn, up to ``spark.rapids.sql.oomRetry.maxSplits``
   times; with a ``QueryContext`` the degradation ladder climbs from
   there (``_climb_ladder``).

What differs from the reference:

- **OOM.** XLA reports RESOURCE_EXHAUSTED late, so the reference syncs
  inside the retry scope near the budget (``oomRetry.blocking``).
  PyTorch raises ``torch.OutOfMemoryError`` on the host thread when an
  allocation fails, so nothing is synced here. Only that error and the
  injected ``TpuRetryOOM`` are retried: a failed launch or an illegal
  address is a sticky CUDA fault and propagates. The retry runs outside
  the ``except`` block with the error's traceback dropped, since the
  traceback's frames hold the failed attempt's tensors.
- **Freeing.** A spilled batch frees its device memory when its last
  reference drops; the ledger's ``device_bytes`` is what the catalog
  holds, not ``torch.cuda.memory_allocated()``. Nothing calls
  ``torch.cuda.empty_cache()``: the caching allocator reuses the blocks.
- **Bytes.** The ledger charges ``GpuBatch.device_size_bytes()``, host
  arithmetic over shapes, never a readback. The port's batch leaves out
  the validity of a column without nulls and counts a lazy selection's
  mask, so its bytes for the same Arrow input differ from the
  reference's (``device_size_bytes`` in ``columnar/batch.py``).
- **Counters.** The reference's ten registry families move where its
  do (``obs/metrics.py``: six ``rapids_memory_*``,
  ``rapids_disk_spill_in_use_bytes`` and three ``rapids_spill_*``), and
  every ledger transition publishes the gauges (``_sync_gauges``) and
  records a ``mem`` flight event with the bytes in use after it
  (``_flight_mem``). A refused disk write or a failed read-back writes
  an event-log line (``tools/event_log.log_spill_event``). The manager
  keeps its counts as attributes too (``spill_bytes``,
  ``disk_spill_bytes``, ``spill_read_bytes``, ``oom_retries``,
  ``forced_spill_bytes``, ``spill_read_failures`` and
  ``spill_write_failures`` by kind): a manager's own, where the
  registry's are the process's. The host ledger a CPU island runs under
  (``host()``) publishes nothing: its batches are not on the device.

Test injections, as in the reference: ``spark.rapids.sql.test
.injectRetryOOM`` (the N-th retry scope raises) and ``.storm`` (the
first N all raise), ``spark.rapids.memory.test.injectDiskFull``,
``.injectSpillFault`` and ``.injectSlowDisk``.
"""
from __future__ import annotations

import contextlib
import errno
import os
import re
import shutil
import threading
import time
import uuid
from collections import OrderedDict
from typing import Callable, List, Optional

import torch

from .config import (ALLOC_FRACTION, CONCURRENT_TPU_TASKS, DISK_ORPHAN_TTL,
                     DISK_READ_RETRIES, DISK_READ_RETRY_WAIT_MS,
                     DISK_SPILL_LIMIT, HOST_SPILL_LIMIT, LEAK_DEBUG,
                     MEM_DEBUG, OOM_MAX_SPLITS, OOM_RETRY_ENABLED,
                     SPILL_DIR, TEST_DISK_FULL, TEST_RETRY_OOM_INJECT,
                     TEST_RETRY_OOM_STORM, TEST_SLOW_DISK, TEST_SPILL_FAULT,
                     RapidsConf, _bytes_conv, register)
from .lifecycle import (ADMISSION_MAX_QUEUE, ADMISSION_TIMEOUT,
                        ADMISSION_WEIGHTS, LADDER_EXCLUSIVE_TIMEOUT,
                        FairAdmissionController)
from .obs.metrics import REGISTRY as _METRICS
from .obs.recorder import RECORDER as _FLIGHT

__all__ = ["DeviceMemoryManager", "SpillableBatch", "SpillReadError",
           "TpuRetryOOM", "QueryBudgetExceeded", "DEVICE_BUDGET",
           "resolve_device_budget", "split_batch", "spill_namespace",
           "sweep_orphan_spill_dirs", "is_oom_error"]

DEVICE_BUDGET = register(
    "spark.rapids.memory.device.budgetBytes", 0,
    "Device memory byte budget for the spillable-batch catalog; 0 = auto "
    "(allocFraction x the device's reported memory, 6GiB on the CPU). "
    "Tests set this low to force spill.", conv=_bytes_conv)

# the ledger's state (gauges: the last manager to move wins) and its
# monotonic pressure counters, readable mid-query
_MEM_DEVICE_IN_USE = _METRICS.gauge(
    "rapids_memory_device_bytes_in_use",
    "Device bytes the spillable-batch ledger currently charges "
    "against the HBM budget.")
_MEM_DEVICE_BUDGET = _METRICS.gauge(
    "rapids_memory_device_budget_bytes",
    "Device HBM budget the ledger evicts against "
    "(spark.rapids.memory.device.budgetBytes, resolved).")
_MEM_HOST_IN_USE = _METRICS.gauge(
    "rapids_memory_host_bytes_in_use",
    "Host-tier bytes held by spilled batches.")
_MEM_SPILL_BYTES = _METRICS.counter(
    "rapids_memory_spill_bytes_total",
    "Total bytes ever spilled device -> host.")
_MEM_DISK_SPILL_BYTES = _METRICS.counter(
    "rapids_memory_disk_spill_bytes_total",
    "Total bytes ever tiered host -> disk.")
_MEM_OOM_RETRIES = _METRICS.counter(
    "rapids_memory_oom_retries_total",
    "Device OOM events answered by split-and-retry (each splits one "
    "batch in half and reruns).")
_DISK_IN_USE = _METRICS.gauge(
    "rapids_disk_spill_in_use_bytes",
    "LIVE disk-tier spill residency (bytes of committed spill files "
    "not yet read back or released) — returns to zero when every "
    "query's batches are released.")
_SPILL_READ_BYTES = _METRICS.counter(
    "rapids_spill_read_bytes_total",
    "Total bytes read back (and CRC-verified) from the disk spill "
    "tier. With the write counters this closes the spill byte "
    "ledger per query for the telemetry warehouse.")
_SPILL_READ_FAILURES = _METRICS.counter(
    "rapids_spill_read_failures_total",
    "Spill-file read-backs that failed verification, classified: "
    "missing (file gone), corrupt (CRC mismatch), torn (truncated "
    "trailer / size disagreement), io (persistently unreadable after "
    "the bounded in-place retries).", ("kind",))
_SPILL_WRITE_FAILURES = _METRICS.counter(
    "rapids_spill_write_failures_total",
    "Disk-spill writes that could not commit, classified: enospc "
    "(the filesystem is full — real or injected), budget (the live "
    "disk residency budget spark.rapids.memory.disk.limit could not "
    "fit the file even after evicting old disk entries), io (any "
    "other OSError). The batch stays host-resident in every case — "
    "a failed spill never loses data or crashes the eviction "
    "cascade.", ("kind",))


class TpuRetryOOM(RuntimeError):
    """Device OOM surfaced to the retry framework (the reference's name,
    the GpuRetryOOM analog). ``ladder_exhausted`` marks the terminal
    form: halve, spill and width1 were walked and the OOM remains; the
    collect root answers it with the plan's CPU path."""

    ladder_exhausted = False


class QueryBudgetExceeded(TpuRetryOOM):
    """A per-query budget (``spark.rapids.query.memoryBudgetBytes``)
    would be exceeded: it feeds the same retry and ladder, but its
    terminal rung is ``QueryCancelled(reason=budget)``."""


class SpillReadError(RuntimeError):
    """A disk-tier spill file failed its verified read-back, classified
    ``missing``, ``corrupt``, ``torn`` or ``io``."""

    KINDS = ("missing", "corrupt", "torn", "io")

    def __init__(self, kind: str, path: str, detail: str = ""):
        self.kind = kind if kind in self.KINDS else "io"
        self.path = path
        self.detail = detail
        super().__init__(
            f"spill file unreadable [{self.kind}] at {path}"
            + (f": {detail}" if detail else ""))


# --- incarnation-scoped spill namespaces and the orphan sweep ---------------

#: how long a refused disk write keeps classifying memory pressure as
#: budget-terminal
_DISK_PRESSURE_WINDOW_S = 30.0

#: one token a process lifetime, so a recycled pid gets a new namespace
_INCARNATION = uuid.uuid4().hex[:8]
_SWEPT_ROOTS: set = set()
_SWEEP_LOCK = threading.Lock()


def _hostname() -> str:
    import platform
    return (platform.node() or "localhost").split(".")[0]


def spill_namespace(base: str) -> str:
    """This process's spill directory: ``<base>/<host>-<pid>-<incarnation>``."""
    return os.path.join(
        base, f"{_hostname()}-{os.getpid()}-{_INCARNATION}")


def _pid_alive(pid: int) -> bool:
    if pid <= 1:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists under another owner, or cannot be told
    return True


def sweep_orphan_spill_dirs(base: str, ttl_s: float = 86400.0,
                            force: bool = False) -> List[str]:
    """Remove spill namespaces whose owner is gone: a same-host
    directory whose pid is dead at once, a foreign-host one past
    ``ttl_s``; a live same-host pid's directory is never touched. Runs
    once a root a process unless ``force``; returns the removed paths and
    never raises."""
    with _SWEEP_LOCK:
        key = os.path.abspath(base)
        if not force and key in _SWEPT_ROOTS:
            return []
        _SWEPT_ROOTS.add(key)
    removed: List[str] = []
    own = os.path.basename(spill_namespace(base))
    host = _hostname()
    pat = re.compile(r"^(?P<host>.+)-(?P<pid>\d+)-[0-9a-f]{8}$")
    try:
        names = os.listdir(base)
    except OSError:
        return removed
    now = time.time()
    for n in names:
        p = os.path.join(base, n)
        try:
            m = pat.match(n)
            if n == own:
                continue
            if m is not None and os.path.isdir(p):
                if m.group("host") == host:
                    dead = not _pid_alive(int(m.group("pid")))
                else:  # a file's mtime is wall clock
                    dead = now - os.path.getmtime(p) > ttl_s
                if dead:
                    shutil.rmtree(p, ignore_errors=True)
                    removed.append(p)
            elif n.startswith("spill-") and n.endswith(".arrow") \
                    and os.path.isfile(p) \
                    and now - os.path.getmtime(p) > ttl_s:
                os.unlink(p)
                removed.append(p)
        except OSError:
            continue
    return removed


def _device_memory(device=None) -> int:
    """The card's memory in bytes; 6 GiB for the CPU (the reference's
    fallback)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(idx).total_memory)
    return 6 << 30


def resolve_device_budget(conf: Optional[RapidsConf] = None,
                          device=None) -> int:
    """The byte budget the ledger evicts against:
    ``spark.rapids.memory.device.budgetBytes``, or ``allocFraction`` x
    the device's memory when unset."""
    conf = conf or RapidsConf()
    budget = conf.get(DEVICE_BUDGET)
    if not budget:
        budget = int(_device_memory(device) * conf.get(ALLOC_FRACTION))
    return budget


def is_oom_error(e: BaseException) -> bool:
    """Device OOM: PyTorch's allocation failure or the injected
    ``TpuRetryOOM``, and nothing else (a failed launch or an illegal
    address is a fault, never retried)."""
    return isinstance(e, (TpuRetryOOM, torch.OutOfMemoryError))


def split_batch(batch):
    """Two halves of a device batch at the capacity midpoint (the
    GpuSplitAndRetryOOM halving): fixed-width lanes and the selection
    are sliced, a string's or an array's offsets too while its chars or
    elements stay shared (the offsets are absolute), a struct's children
    with its rows (``column.slice_rows``), and the host row count splits as
    ``min(rc, h)`` and ``max(rc - h, 0)``. Positional, not
    selection-aware, as the reference's."""
    from .columnar.batch import GpuBatch
    from .columnar.column import slice_rows
    cap = batch.capacity
    if cap < 2:
        raise TpuRetryOOM("cannot split a 1-row batch further")
    h = cap // 2
    rc = batch.row_count

    def sl(t, lo, hi):
        return None if t is None else t[lo:hi]

    pairs = [(slice_rows(c, 0, h), slice_rows(c, h, cap))
             for c in batch.columns]
    b1 = GpuBatch([p[0] for p in pairs], batch.schema, min(rc, h),
                  selection=sl(batch.selection, 0, h))
    b2 = GpuBatch([p[1] for p in pairs], batch.schema, max(rc - h, 0),
                  selection=sl(batch.selection, h, cap))
    return b1, b2


class SpillableBatch:
    """A catalog entry that tiers device -> host Arrow -> sealed disk
    Arrow IPC (SpillableColumnarBatch)."""

    def __init__(self, mgr: "DeviceMemoryManager", batch):
        self._mgr = mgr
        self._device = batch
        self._device_of = batch.device
        self._host = None
        self._disk_path = None
        self._disk_size = 0       # committed spill-file bytes, footer in
        self._no_disk_until = 0.0  # barred from re-tiering (anti-churn)
        self._promote_bad = False  # a failed read-back seen by eviction
        self._schema = batch.schema
        self.nbytes = batch.device_size_bytes()
        self.host_nbytes = 0
        self.spill_count = 0
        # this batch's tier transitions, taken before the ledger lock
        self._state_lock = threading.RLock()

    @property
    def on_device(self) -> bool:
        return self._device is not None

    @property
    def on_disk(self) -> bool:
        return self._disk_path is not None

    def spill(self, cascade: bool = True, best_effort: bool = False):
        """Download to host Arrow, drop the device batch and credit the
        ledger; host pressure cascades to disk. Lock order: this batch's
        state lock, then the ledger lock; eviction passes
        ``best_effort`` and only try-acquires, so a busy batch is
        skipped."""
        acquired = self._state_lock.acquire(blocking=not best_effort)
        if not acquired:
            return
        try:
            if self._device is None:
                return
            from .columnar.arrow_bridge import device_to_arrow
            host = device_to_arrow(self._device)
            with self._mgr._lock:
                if id(self) not in self._mgr._catalog:
                    return  # released meanwhile
                self._host = host
                self._device = None
                self.spill_count += 1
                self.host_nbytes = host.nbytes
                self._mgr.device_bytes -= self.nbytes
                self._mgr.spill_bytes += self.nbytes
                self._mgr.spill_count += 1
                self._mgr.host_bytes += self.host_nbytes
            if self._mgr._publish:
                _MEM_SPILL_BYTES.inc(self.nbytes)
            self._mgr._sync_gauges()
            self._mgr._flight_mem("spill", self.nbytes)
            self._mgr._debug("spill", self)
        finally:
            self._state_lock.release()
        if cascade:
            self._mgr._evict_host_to_disk()

    def spill_to_disk(self, best_effort: bool = False) -> bool:
        """Host Arrow -> a sealed Arrow IPC file in the spill namespace,
        committed by tmp + rename. A write the disk refuses (ENOSPC, real
        or injected, or ``spark.rapids.memory.disk.limit`` still breached
        after evicting older disk entries) leaves the batch on the host
        and records classified disk pressure. True when the file
        committed."""
        acquired = self._state_lock.acquire(blocking=not best_effort)
        if not acquired:
            return False
        try:
            if self._host is None or self._disk_path is not None:
                return False
            if time.monotonic() < self._no_disk_until:
                return False
            with self._mgr._lock:
                if id(self) not in self._mgr._catalog:
                    return False
            import pyarrow as pa
            from .shuffle.integrity import FOOTER_LEN, write_sealed_file
            mgr = self._mgr
            sink = pa.BufferOutputStream()
            with pa.ipc.new_file(sink, self._host.schema) as w:
                w.write_batch(self._host)
            payload = sink.getvalue()
            fsize = len(payload) + FOOTER_LEN
            if not mgr._disk_budget_admit(fsize):
                return False
            # fsize is reserved in disk_in_use_bytes: released below on
            # every path that does not commit
            committed = False
            try:
                os.makedirs(mgr.spill_dir, exist_ok=True)
                path = os.path.join(mgr.spill_dir,
                                    f"spill-{uuid.uuid4().hex}.arrow")
                for retry in (False, True):
                    try:
                        if mgr._slow_disk_s > 0:
                            time.sleep(mgr._slow_disk_s)
                        write_sealed_file(
                            path, payload,
                            fail_hook=mgr._maybe_inject_disk_full)
                        break
                    except OSError as e:
                        enospc = getattr(e, "errno", None) == errno.ENOSPC
                        if enospc and not retry:
                            # first answer: older disk entries back to
                            # the host, then one retry
                            mgr._evict_disk_to_host(fsize)
                            continue
                        mgr._note_disk_pressure(
                            "enospc" if enospc else "io", path, str(e))
                        return False
                mgr._maybe_damage_spill_file(path, len(payload))
                committed = True
            finally:
                if not committed:
                    with mgr._lock:
                        mgr.disk_in_use_bytes -= fsize
                    mgr._sync_gauges()
            mgr._clear_disk_pressure()
            self._disk_path = path
            self._disk_size = fsize
            self._promote_bad = False
            self._host = None
            with mgr._lock:
                mgr.host_bytes -= self.host_nbytes
                mgr.disk_spill_bytes += self.host_nbytes
            if mgr._publish:
                _MEM_DISK_SPILL_BYTES.inc(self.host_nbytes)
            mgr._sync_gauges()
            mgr._flight_mem("disk_spill", self.host_nbytes)
            return True
        finally:
            self._state_lock.release()

    def _promote_to_host(self) -> int:
        """Disk -> host (the disk-pressure answer): a verified read-back,
        the file unlinked. Try-acquire only; returns the disk bytes
        freed, 0 when busy or when the read failed (a bad file is left
        for its consumer to classify)."""
        if not self._state_lock.acquire(blocking=False):
            return 0
        try:
            if self._disk_path is None or self._host is not None \
                    or self._promote_bad:
                return 0
            freed = self._disk_size
            try:
                host = self._read_disk()
            except SpillReadError:
                self._promote_bad = True
                return 0
            self._host = host
            self._no_disk_until = time.monotonic() + 5.0
            with self._mgr._lock:
                self._mgr.host_bytes += self.host_nbytes
            self._mgr._sync_gauges()
            return freed
        finally:
            self._state_lock.release()

    def _read_disk(self):
        """Verified read-back of the spill file (footer and CRC checked,
        transient IO retried in place); every failure a classified
        ``SpillReadError``, leaving the tier state as it was."""
        import pyarrow as pa
        from .shuffle import integrity
        mgr = self._mgr
        path = self._disk_path
        if mgr._slow_disk_s > 0:
            time.sleep(mgr._slow_disk_s)
        try:
            payload = integrity.read_sealed_file(
                path, lambda kind, detail: SpillReadError(kind, path,
                                                          detail),
                max_retries=mgr.disk_read_retries,
                retry_wait_s=mgr.disk_read_wait_s,
                on_retry=lambda n, e: mgr._flight_mem(
                    "spill_read_retry", 0, n=n, error=str(e)[:120]),
                missing_detail="committed spill file is gone")
            with mgr._lock:
                mgr.spill_read_bytes += len(payload)
            if mgr._publish:
                _SPILL_READ_BYTES.inc(len(payload))
            table = pa.ipc.open_file(
                pa.BufferReader(payload)).read_all().combine_chunks()
        except SpillReadError as e:
            mgr._note_spill_read_failure(e)
            raise
        with contextlib.suppress(OSError):
            # the read verified; a failing unlink is a bounded leak the
            # next incarnation's sweep reclaims
            os.unlink(self._disk_path)
        self._disk_path = None
        with mgr._lock:
            mgr.disk_in_use_bytes -= self._disk_size
        self._disk_size = 0
        mgr._sync_gauges()
        rbs = table.to_batches()
        if rbs:
            return rbs[0]
        return pa.RecordBatch.from_arrays(
            [pa.array([], type=fld.type) for fld in table.schema],
            schema=table.schema)

    def get_host(self):
        """Host Arrow view: downloaded if still on the device, read back
        (and verified) if on disk; a failed read-back writes its
        event-log line here, outside the batch's own lock scope."""
        try:
            with self._state_lock:
                if self._host is None and self._disk_path is not None:
                    self._host = self._read_disk()
                    with self._mgr._lock:
                        self._mgr.host_bytes += self.host_nbytes
                    self._mgr._sync_gauges()
                if self._host is None:
                    from .columnar.arrow_bridge import device_to_arrow
                    return device_to_arrow(self._device)
                return self._host
        except SpillReadError as e:
            self._mgr._log_spill_read_failure(e)
            raise

    def get(self):
        """The device batch, uploaded again (and the ledger charged
        again) if spilled."""
        with self._state_lock:
            if self._device is None:
                from .columnar.arrow_bridge import arrow_to_device
                host = self.get_host()
                self._mgr._charge(self, self.nbytes)
                try:
                    device = arrow_to_device(host, self._schema,
                                             self._device_of)
                except BaseException:
                    # a failed upload must not strand its charge
                    self._mgr._uncharge(self, self.nbytes)
                    raise
                # the upload holds only the live rows (a selection was
                # compacted at the download): the ledger holds what the
                # card holds, so a later spill credits what it frees
                # (the reference keeps the registered size)
                self._device = device
                self._host = None
                now = device.device_size_bytes()
                with self._mgr._lock:
                    self._mgr.host_bytes -= self.host_nbytes
                    self._mgr.readback_count += 1
                    self._mgr.device_bytes += now - self.nbytes
                self.nbytes = now
                self._mgr._sync_gauges()
            self._mgr._touch(self)
            return self._device

    def pin(self):
        self._mgr.pin(self)

    def unpin(self):
        self._mgr.unpin(self)

    def release(self):
        """Drop the entry: its ledger bytes, its disk file, its
        references. Idempotent."""
        with self._state_lock:
            self._mgr._release(self)
            if self._disk_path is not None:
                with contextlib.suppress(OSError):
                    os.unlink(self._disk_path)
                self._disk_path = None
                if self._disk_size:
                    with self._mgr._lock:
                        self._mgr.disk_in_use_bytes -= self._disk_size
                    self._disk_size = 0
                    self._mgr._sync_gauges()
            self._device = None
            self._host = None


class DeviceMemoryManager:
    """Budget ledger, spill catalog, admission and retry. Execution paths
    use ``DeviceMemoryManager.shared(conf, device)``: one manager a memory
    configuration and device in the process, so concurrent queries draw
    slots and budget from one ledger. Tests construct their own."""

    _shared: dict = {}
    _shared_lock = threading.Lock()

    @classmethod
    def shared(cls, conf: Optional[RapidsConf] = None,
               device=None) -> "DeviceMemoryManager":
        """The process's manager for this conf's memory settings and this
        device; an injection conf always gets a new one (its countdowns
        are per-test state)."""
        conf = conf or RapidsConf()
        if conf.get(TEST_RETRY_OOM_INJECT) \
                or conf.get(TEST_RETRY_OOM_STORM) \
                or conf.get(TEST_DISK_FULL) \
                or conf.get(TEST_SPILL_FAULT) \
                or conf.get(TEST_SLOW_DISK):
            return cls(conf, device)
        key = (str(device), conf.get(DEVICE_BUDGET),
               conf.get(ALLOC_FRACTION), conf.get(CONCURRENT_TPU_TASKS),
               conf.get(OOM_RETRY_ENABLED), conf.get(OOM_MAX_SPLITS),
               conf.get(HOST_SPILL_LIMIT), conf.get(SPILL_DIR),
               conf.get(DISK_SPILL_LIMIT), conf.get(DISK_READ_RETRIES),
               conf.get(DISK_READ_RETRY_WAIT_MS), conf.get(DISK_ORPHAN_TTL),
               conf.get(MEM_DEBUG), conf.get(LEAK_DEBUG),
               conf.get(ADMISSION_TIMEOUT), conf.get(ADMISSION_MAX_QUEUE),
               conf.get(ADMISSION_WEIGHTS))
        with cls._shared_lock:
            mgr = cls._shared.get(key)
            if mgr is None:
                mgr = cls(conf, device)
                cls._shared[key] = mgr
            return mgr

    _host = None

    @classmethod
    def host(cls) -> "DeviceMemoryManager":
        """The ledger a CPU island runs under (``ExecCtx.host_ctx``): an
        unbounded budget, no split-and-retry, no injection, so host
        batches never spill and never take an out-of-core path, as the
        reference's CPU path uses no ledger."""
        with cls._shared_lock:
            if cls._host is None:
                cls._host = cls(RapidsConf({
                    DEVICE_BUDGET.key: 1 << 62,
                    OOM_RETRY_ENABLED.key: False}), "cpu", publish=False)
            return cls._host

    def __init__(self, conf: Optional[RapidsConf] = None, device=None,
                 publish: bool = True):
        self.conf = conf or RapidsConf()
        self.device = device
        # False for the host ledger: no gauges, counters or flight events
        self._publish = publish
        self.budget = resolve_device_budget(self.conf, device)
        self._lock = threading.RLock()
        self._catalog: "OrderedDict[int, SpillableBatch]" = OrderedDict()
        self._pin_counts: dict = {}
        self.device_bytes = 0
        self.host_bytes = 0          # host-tier residency
        self.disk_in_use_bytes = 0   # live disk-tier residency
        # monotonic counts (the reference's registry metrics)
        self.spill_bytes = 0         # bytes ever spilled device -> host
        self.spill_count = 0
        self.disk_spill_bytes = 0    # bytes ever tiered host -> disk
        self.spill_read_bytes = 0    # verified disk read-backs
        self.readback_count = 0      # uploads of spilled entries
        self.oom_retries = 0         # batches halved on OOM
        self.forced_spill_bytes = 0  # the ladder's spill rung
        self.spill_read_failures: dict = {}
        self.spill_write_failures: dict = {}
        self.host_limit = self.conf.get(HOST_SPILL_LIMIT)
        self.spill_root = self.conf.get(SPILL_DIR)
        self.spill_dir = spill_namespace(self.spill_root)
        self.disk_limit = self.conf.get(DISK_SPILL_LIMIT)
        self.disk_read_retries = self.conf.get(DISK_READ_RETRIES)
        self.disk_read_wait_s = \
            self.conf.get(DISK_READ_RETRY_WAIT_MS) / 1e3
        self._disk_pressure_until = 0.0
        self._spill_fault = self.conf.get(TEST_SPILL_FAULT)
        self._disk_full_countdown = self.conf.get(TEST_DISK_FULL)
        self._slow_disk_s = self.conf.get(TEST_SLOW_DISK)
        sweep_orphan_spill_dirs(self.spill_root,
                                self.conf.get(DISK_ORPHAN_TTL))
        self.admission = FairAdmissionController(
            self.conf.get(CONCURRENT_TPU_TASKS), self.conf)
        self._retry_enabled = self.conf.get(OOM_RETRY_ENABLED)
        self.max_splits = self.conf.get(OOM_MAX_SPLITS)
        self._inject_after = self.conf.get(TEST_RETRY_OOM_INJECT)
        self._inject_storm = self.conf.get(TEST_RETRY_OOM_STORM)
        self._op_count = 0
        self._mem_debug = self.conf.get(MEM_DEBUG) == "STDOUT"
        self._leak_debug = self.conf.get(LEAK_DEBUG)
        self._alloc_sites: dict = {}
        if self._publish:
            _MEM_DEVICE_BUDGET.set(self.budget)
        self._sync_gauges()
        self._flight_mem("budget")

    def _sync_gauges(self) -> None:
        """Publish the ledger to the registry: three attribute writes,
        run on every transition."""
        if not self._publish:
            return
        _MEM_DEVICE_IN_USE.set(self.device_bytes)
        _MEM_HOST_IN_USE.set(self.host_bytes)
        _DISK_IN_USE.set(self.disk_in_use_bytes)

    def _flight_mem(self, ev: str, nbytes: int = 0, **extra) -> None:
        """The flight recorder's tap: every ledger transition with the
        bytes in use after it (the HBM timeline
        ``obs/recorder.memory_timeline`` replays) and the budget on
        every event (a ring scoped to a query's window keeps it)."""
        if self._publish:
            _FLIGHT.record("mem", ev=ev, bytes=int(nbytes),
                           device=self.device_bytes, host=self.host_bytes,
                           budget=self.budget, **extra)

    def _debug(self, event: str, sb: "SpillableBatch"):
        if self._mem_debug:
            print(f"[rapids-mem] {event} id={id(sb):#x} "
                  f"bytes={sb.nbytes} device={self.device_bytes} "
                  f"host={self.host_bytes}")

    def leak_report(self) -> str:
        """Catalog entries never released, with their registration
        sites under ``spark.rapids.refcount.debug``."""
        with self._lock:
            live = [(id(sb), sb.nbytes,
                     self._alloc_sites.get(id(sb), "<site untracked>"))
                    for sb in self._catalog.values()]
        if not live:
            return "no leaked catalog entries"
        lines = [f"{len(live)} catalog entr"
                 f"{'y' if len(live) == 1 else 'ies'} never released:"]
        for key, nbytes, site in live:
            lines.append(f"  id={key:#x} bytes={nbytes}\n    {site}")
        return "\n".join(lines)

    @property
    def catalog_size(self) -> int:
        return len(self._catalog)

    # --- catalog / ledger -------------------------------------------------

    def register(self, batch, pinned: bool = False) -> SpillableBatch:
        """Add a device batch to the catalog; with ``pinned`` it is
        pinned before eviction runs, so it is never its own victim."""
        sb = SpillableBatch(self, batch)
        with self._lock:
            self._catalog[id(sb)] = sb
            if pinned:
                self._pin_counts[id(sb)] = \
                    self._pin_counts.get(id(sb), 0) + 1
            self.device_bytes += sb.nbytes
            if self._leak_debug:
                import traceback
                self._alloc_sites[id(sb)] = "".join(
                    traceback.format_stack(limit=6)[:-1]).strip()
        self._evict_to_fit(exclude=id(sb) if pinned else None)
        self._sync_gauges()
        self._flight_mem("reserve", sb.nbytes)
        self._debug("register", sb)
        return sb

    def _charge(self, sb: SpillableBatch, nbytes: int):
        with self._lock:
            self.device_bytes += nbytes
            self._catalog[id(sb)] = sb
        # the caller holds sb's state lock: keep it out of both tiers
        self._evict_to_fit(exclude=id(sb))
        self._sync_gauges()
        self._flight_mem("readback", nbytes)

    def _uncharge(self, sb: SpillableBatch, nbytes: int):
        with self._lock:
            self.device_bytes -= nbytes
        self._sync_gauges()
        self._flight_mem("readback_undo", nbytes)

    def _touch(self, sb: SpillableBatch):
        with self._lock:
            if id(sb) in self._catalog:
                self._catalog.move_to_end(id(sb))

    def _release(self, sb: SpillableBatch):
        with self._lock:
            if self._catalog.pop(id(sb), None) is not None:
                if sb.on_device:
                    self.device_bytes -= sb.nbytes
                elif sb._host is not None:
                    self.host_bytes -= sb.host_nbytes
            self._pin_counts.pop(id(sb), None)
            self._alloc_sites.pop(id(sb), None)
        self._sync_gauges()
        self._flight_mem("release", sb.nbytes)
        self._debug("release", sb)

    def _evict_host_to_disk(self, exclude: Optional[int] = None):
        """The host tier past ``spillStorageSize`` cascades to disk;
        victims' state locks are only try-acquired."""
        with self._lock:
            if self.host_bytes <= self.host_limit:
                return
            victims = [sb for sb in self._catalog.values()
                       if sb._host is not None and not sb.on_device
                       and id(sb) != exclude]
        for sb in victims:
            if self.host_bytes <= self.host_limit:
                break
            window_before = self._disk_pressure_until
            if not sb.spill_to_disk(best_effort=True) \
                    and self._disk_pressure_until > window_before:
                break  # the disk refused this write: the rest would too

    # --- disk tier: budget, pressure, fault injection ---------------------

    def disk_pressure_active(self) -> bool:
        """Inside the window after a refused disk write."""
        return time.monotonic() < self._disk_pressure_until

    def _clear_disk_pressure(self) -> None:
        self._disk_pressure_until = 0.0

    def _note_disk_pressure(self, kind: str, path: str,
                            detail: str) -> None:
        """A refused disk write: counted by kind, a flight event and an
        event-log line; ``enospc`` and ``budget`` open the pressure
        window the ladder's terminal rung reads (the event is then
        ``disk_pressure``), a transient ``io`` error does not
        (``spill_write_failed``)."""
        pressure = kind in ("enospc", "budget")
        if pressure:
            self._disk_pressure_until = \
                time.monotonic() + _DISK_PRESSURE_WINDOW_S
        with self._lock:
            self.spill_write_failures[kind] = \
                self.spill_write_failures.get(kind, 0) + 1
        ev = "disk_pressure" if pressure else "spill_write_failed"
        if self._publish:
            _SPILL_WRITE_FAILURES.labels(kind).inc()
        self._flight_mem(ev, 0, fail_kind=kind, path=path,
                         detail=detail[:160])
        from .tools.event_log import log_spill_event
        with contextlib.suppress(OSError):
            log_spill_event(self.conf, ev, kind=kind, path=path,
                            detail=detail[:300])

    def _note_spill_read_failure(self, e: "SpillReadError") -> None:
        """Counted by kind and a flight event where the read failed;
        its event-log line is ``get_host``'s."""
        with self._lock:
            self.spill_read_failures[e.kind] = \
                self.spill_read_failures.get(e.kind, 0) + 1
        if self._publish:
            _SPILL_READ_FAILURES.labels(e.kind).inc()
        self._flight_mem("spill_read_failed", 0, fail_kind=e.kind,
                         path=e.path, detail=e.detail[:160])

    def _log_spill_read_failure(self, e: "SpillReadError") -> None:
        from .tools.event_log import log_spill_event
        with contextlib.suppress(OSError):
            log_spill_event(self.conf, "spill_read_failed", kind=e.kind,
                            path=e.path, detail=e.detail[:300])

    def _disk_budget_admit(self, fsize: int) -> bool:
        """Reserve ``fsize`` of live disk residency under the ledger
        lock; over ``disk.limit`` the oldest unpinned disk entries go
        back to the host first, and a limit still breached refuses the
        write as ``budget`` pressure."""
        if not self.disk_limit:
            with self._lock:
                self.disk_in_use_bytes += fsize
            return True
        with self._lock:
            if self.disk_in_use_bytes + fsize <= self.disk_limit:
                self.disk_in_use_bytes += fsize
                return True
            over = self.disk_in_use_bytes + fsize - self.disk_limit
        self._evict_disk_to_host(over)
        with self._lock:
            if self.disk_in_use_bytes + fsize <= self.disk_limit:
                self.disk_in_use_bytes += fsize
                return True
        self._note_disk_pressure(
            "budget", self.spill_dir,
            f"disk spill residency {self.disk_in_use_bytes} + {fsize} "
            f"> limit {self.disk_limit}")
        return False

    def _evict_disk_to_host(self, need: int) -> int:
        """The oldest unpinned disk entries back to the host until
        ``need`` disk bytes are free."""
        with self._lock:
            victims = [sb for key, sb in self._catalog.items()
                       if sb.on_disk
                       and self._pin_counts.get(key, 0) <= 0]
        freed = 0
        for sb in victims:
            if freed >= need:
                break
            freed += sb._promote_to_host()
        if freed:
            self._sync_gauges()
            self._flight_mem("disk_evict", freed)
        return freed

    def _maybe_inject_disk_full(self) -> None:
        """``injectDiskFull``: the first N disk writes raise ENOSPC after
        the payload and before the commit."""
        if self._disk_full_countdown <= 0:
            return
        with self._lock:
            if self._disk_full_countdown <= 0:
                return
            self._disk_full_countdown -= 1
        raise OSError(
            errno.ENOSPC,
            "injected ENOSPC (spark.rapids.memory.test.injectDiskFull)")

    def _maybe_damage_spill_file(self, path: str, payload_len: int) -> None:
        """``injectSpillFault``: ``corrupt`` flips payload bytes (only
        the CRC can tell), ``torn`` truncates into the trailer."""
        if not self._spill_fault:
            return
        try:
            if self._spill_fault == "corrupt":
                at = max(0, min(payload_len // 2, payload_len - 8))
                with open(path, "r+b") as f:
                    f.seek(at)
                    chunk = f.read(8)
                    f.seek(at)
                    f.write(bytes(b ^ 0xFF for b in chunk))
            elif self._spill_fault == "torn":
                with open(path, "r+b") as f:
                    f.truncate(max(0, os.path.getsize(path) - 8))
        except OSError:
            pass

    def _select_victims(self, exclude: Optional[int] = None) \
            -> List[SpillableBatch]:
        """LRU device -> host victims until the ledger fits the budget
        (under the ledger lock; the spills run outside it)."""
        victims: List[SpillableBatch] = []
        projected = self.device_bytes
        if projected <= self.budget:
            return victims
        for key, sb in self._catalog.items():
            if projected <= self.budget:
                break
            if key == exclude or self._pin_counts.get(key, 0) > 0:
                continue
            if sb.on_device:
                victims.append(sb)
                projected -= sb.nbytes
        return victims

    def _evict_to_fit(self, exclude: Optional[int] = None):
        """Select under the ledger lock, spill outside it, cascade the
        host tier to disk."""
        with self._lock:
            victims = self._select_victims(exclude)
        for v in victims:
            v.spill(cascade=False, best_effort=True)
        self._evict_host_to_disk(exclude=exclude)

    def transient_reservation(self, nbytes: int):
        """Context manager: a ledger charge for short-lived device
        staging that gets no catalog entry."""

        @contextlib.contextmanager
        def _ctx():
            n = int(nbytes)
            with self._lock:
                self.device_bytes += n
            try:
                self._evict_to_fit()
                self._sync_gauges()
                self._flight_mem("staging_reserve", n)
                yield
            finally:
                with self._lock:
                    self.device_bytes -= n
                self._sync_gauges()
                self._flight_mem("staging_release", n)
        return _ctx()

    def pin(self, sb: SpillableBatch):
        """Refcounted: pinned until the last unpin."""
        with self._lock:
            self._pin_counts[id(sb)] = self._pin_counts.get(id(sb), 0) + 1

    def unpin(self, sb: SpillableBatch):
        with self._lock:
            c = self._pin_counts.get(id(sb), 0) - 1
            if c <= 0:
                self._pin_counts.pop(id(sb), None)
            else:
                self._pin_counts[id(sb)] = c

    # --- admission --------------------------------------------------------

    def task_slot(self, qctx=None):
        """The device's admission slot (fair, cancellable with a
        ``QueryContext``)."""
        return self.admission.slot(qctx)

    # --- forced spill (the ladder's spill rung) ---------------------------

    def spill_all_unpinned(self) -> int:
        """Spill every unpinned device entry to the host (cascading to
        disk) whatever the headroom; returns the bytes spilled."""
        with self._lock:
            victims = [sb for key, sb in self._catalog.items()
                       if sb.on_device
                       and self._pin_counts.get(key, 0) <= 0]
        freed = 0
        for sb in victims:
            before = sb.on_device
            sb.spill(cascade=False, best_effort=True)
            if before and not sb.on_device:
                freed += sb.nbytes
        self._evict_host_to_disk()
        with self._lock:
            self.forced_spill_bytes += freed
        self._flight_mem("forced_spill", freed)
        return freed

    # --- OOM retry --------------------------------------------------------

    def _maybe_inject_oom(self):
        if self._inject_after or self._inject_storm:
            with self._lock:
                self._op_count += 1
                n = self._op_count
            if self._inject_after and n == self._inject_after:
                raise TpuRetryOOM(
                    f"injected OOM at op {n} "
                    "(spark.rapids.sql.test.injectRetryOOM)")
            if self._inject_storm and n <= self._inject_storm:
                raise TpuRetryOOM(
                    f"injected OOM storm op {n}/{self._inject_storm} "
                    "(spark.rapids.sql.test.injectRetryOOM.storm)")

    def _check_query_budget(self, batch, qctx) -> None:
        """The per-query budget: ledger bytes plus the batch in hand
        must fit; ``action=cancel`` cancels at once, ``degrade`` raises
        the budget OOM into the ladder."""
        if qctx is None or not qctx.budget_bytes:
            return
        occupancy = self.device_bytes + batch.device_size_bytes()
        if occupancy <= qctx.budget_bytes:
            return
        detail = (f"query memory budget exceeded: {occupancy} > "
                  f"{qctx.budget_bytes} bytes")
        if qctx.budget_action == "cancel":
            qctx.token.cancel("budget", detail)
            raise qctx.token.error()
        raise QueryBudgetExceeded(detail)

    def with_retry(self, batch, fn: Callable, depth: int = 0,
                   qctx=None) -> List:
        """``[fn(batch)]``, or on device OOM the results of the halves
        in order, recursively up to ``maxSplits``
        (RmmRapidsRetryIterator.withRetry); with a ``QueryContext`` the
        per-query budget is checked here and the ladder climbs once the
        halving budget is spent."""
        try:
            self._maybe_inject_oom()
            self._check_query_budget(batch, qctx)
            return [fn(batch)]
        except Exception as e:  # noqa: BLE001 — filtered below
            if not self._retry_enabled or not is_oom_error(e):
                raise
            # the traceback's frames hold the failed attempt's tensors
            cause = e.with_traceback(None)
            cause.__context__ = None
        # retried outside the except block, so nothing of the failed
        # attempt stays referenced while the halves run
        return self._after_oom(batch, fn, depth, qctx, cause)

    def _after_oom(self, batch, fn, depth, qctx, cause) -> List:
        ladder = qctx.ladder if qctx is not None else None
        if depth < self.max_splits and batch.capacity >= 2:
            with self._lock:
                self.oom_retries += 1
            if self._publish:
                _MEM_OOM_RETRIES.inc()
            self._flight_mem("oom_retry", batch.device_size_bytes(),
                             depth=depth)
            if ladder is not None:
                ladder.note_halve()
            b1, b2 = split_batch(batch)
            del batch
            out = self.with_retry(b1, fn, depth + 1, qctx)
            del b1
            out.extend(self.with_retry(b2, fn, depth + 1, qctx))
            return out
        if ladder is None:
            if isinstance(cause, QueryBudgetExceeded) and qctx is not None:
                qctx.token.cancel("budget", str(cause))
                raise qctx.token.error() from cause
            raise cause
        return self._climb_ladder(batch, fn, depth, qctx, cause)

    def _climb_ladder(self, batch, fn: Callable, depth: int, qctx,
                      cause: BaseException) -> List:
        """The halving budget is spent: enter the next rung and retry
        (a failing retry re-enters here a rung higher, up to ``cpu``)."""
        disk_starved = self.disk_pressure_active()
        rung = qctx.ladder.escalate(
            cause="disk_pressure" if disk_starved else "oom")
        if rung == "spill":
            self.spill_all_unpinned()
            return self.with_retry(batch, fn, depth, qctx)
        if rung == "width1":
            self.admission.await_exclusive(
                qctx, self.conf.get(LADDER_EXCLUSIVE_TIMEOUT))
            return self.with_retry(batch, fn, depth, qctx)
        # terminal: a budget (the query's or the disk's) cannot be met on
        # the CPU either
        if isinstance(cause, QueryBudgetExceeded) or disk_starved:
            detail = str(cause)
            if disk_starved:
                detail = ("memory pressure with the disk spill tier "
                          "refusing writes (full disk or "
                          "spark.rapids.memory.disk.limit): " + detail)
            qctx.token.cancel("budget", detail)
            raise qctx.token.error() from cause
        exc = TpuRetryOOM(
            "degradation ladder exhausted (halve -> spill -> width1): "
            + str(cause))
        exc.ladder_exhausted = True
        raise exc from cause

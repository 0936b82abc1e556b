"""Shuffle transport interface and the in-process store.

Counterpart of ``spark_rapids_tpu/shuffle/transport.py:55-250``
(``FetchFailure``, ``ShuffleWriteHandle``, ``ShuffleTransport``,
``_MapEntry``, ``LocalShuffleTransport``): the seam between partition
routing and how batches move. The local store keeps each map batch
whole, with its partition ids as one more int32 lane (``_MapEntry``,
``write_unsplit``); a read of a run of adjacent partitions (one, or a
group the adaptive reader coalesces) makes one selection view of each
map batch in map order, sharing the batch's buffers. With a memory
manager attached (``set_memory_manager``, as the exchange does) each map
batch is one ledger entry, lane included, that spills to the host and
comes back as one, so a row keeps its partition. A one-partition stage
stores the batch as it is, with no lane.

A spill frees device memory only once nobody else holds the batch, and
the writer's loop and the reader's consumer each hold the last batch
handed to them while they ask for the next. So the entry handed over
last stays pinned until the next hand-over of its stage
(``_hand_over``): the ledger evicts the one before it, which its taker
has let go, and a spill frees what it credits. A stage's read-back
entries are read in one pass a partition group, one upload a map batch
each.

Writer-side statistics: with AQE on, the exchange hands the store each
map batch's live rows per partition, a few int64s counted on the device
next to the split, with no sync; ``partition_stats`` reads them all back
in one copy at the stage boundary and spreads each map batch's bytes
over its partitions by those counts, as the reference does
(``_fold_pending_stats``). The host-file and multi-threaded transports
are ``shuffle/host.py``; the collective one waits for item 17.

``record_fetch_failure`` is every shuffle reader's classified-failure
tap (the reference's ``:38-50``): ``rapids_shuffle_fetch_failures_total``
by kind and a ``shuffle``/``fetch_failure`` flight event. The local store
holds its batches in memory and never fails a fetch; the readers of
sealed blocks (``shuffle/integrity.py``, the host-file transport
``shuffle/host.py`` and the cluster's reader) raise the ``FetchFailure``
it records.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch
from ..columnar.column import GpuColumnVector
from ..obs.metrics import REGISTRY as _METRICS
from ..obs.recorder import RECORDER

__all__ = ["FetchFailure", "FETCH_FAILURE_KINDS", "ShuffleWriteHandle",
           "ShuffleTransport", "LocalShuffleTransport",
           "SHUF_FETCH_FAILURES", "record_fetch_failure"]

FETCH_FAILURE_KINDS = ("missing", "corrupt", "torn", "io")

SHUF_FETCH_FAILURES = _METRICS.counter(
    "rapids_shuffle_fetch_failures_total",
    "Classified shuffle fetch failures by kind: missing (block or "
    "committed map output gone), corrupt (CRC mismatch), torn "
    "(malformed integrity footer/manifest), io (transient OSError "
    "that survived the in-place retries).", ("kind",))


def record_fetch_failure(ff: "FetchFailure", partition_id: int,
                         transport: str) -> None:
    """A classified fetch failure into the registry (by kind) and the
    flight ring, the same shape whichever transport the bytes rode."""
    SHUF_FETCH_FAILURES.labels(ff.kind).inc()
    RECORDER.record("shuffle", ev="fetch_failure", sid=ff.shuffle_id,
                    part=int(partition_id), fail_kind=ff.kind,
                    map=str(ff.map_task or ""),
                    path=os.path.basename(ff.path or ""),
                    transport=transport)


class FetchFailure(RuntimeError):
    """A shuffle block failed to fetch or verify, classified by ``kind``
    (``missing``, ``corrupt``, ``torn`` or ``io``); ``map_task`` is the
    committed map task's key when known (the reference's ``:55``)."""

    def __init__(self, shuffle_id: int, map_task, path: str, kind: str,
                 detail: str = ""):
        assert kind in FETCH_FAILURE_KINDS, kind
        self.shuffle_id = int(shuffle_id)
        self.map_task = map_task
        self.path = path
        self.kind = kind
        self.detail = detail
        super().__init__(
            f"shuffle {shuffle_id} fetch failure [{kind}] "
            f"map={map_task or '?'} {path}"
            + (f": {detail}" if detail else ""))


class ShuffleWriteHandle:
    """Writer for one map task's output. The exchange hands every map
    batch over whole, so ``write_unsplit`` is the only write."""

    def write_unsplit(self, batch: GpuBatch,
                      pids: Optional[torch.Tensor]) -> None:
        """The whole map batch with each row's partition id (None for a
        one-partition stage)."""
        raise NotImplementedError

    def record_counts(self, counts: torch.Tensor, nbytes: int) -> None:
        """This map batch's live rows per partition (a device tensor)
        and its bytes, for the adaptive reader's statistics."""

    def close(self) -> None:
        pass


class ShuffleTransport:
    """Moves per-partition batches between the map and reduce sides."""

    def register_shuffle(self, shuffle_id: int, num_partitions: int) -> None:
        raise NotImplementedError

    def writer(self, shuffle_id: int, map_id: int) -> ShuffleWriteHandle:
        raise NotImplementedError

    def read_partitions(self, shuffle_id: int, first: int,
                        last: int) -> Iterator[GpuBatch]:
        """Partitions ``first`` to ``last`` in map order: a batch a map
        batch, holding those partitions' rows."""
        raise NotImplementedError

    def unregister_shuffle(self, shuffle_id: int) -> None:
        raise NotImplementedError

    def partition_stats(self, shuffle_id: int) -> Optional[List[int]]:
        """Approximate bytes per partition, or None when unknown (the
        adaptive reader then reads every partition as it is)."""
        return None

    def stage_bytes(self, shuffle_id: int) -> Optional[int]:
        """Bytes the stage holds, or None when unknown."""
        return None


class _MapEntry:
    """One map batch and its partition-id lane as one spillable unit:
    the lane rides as an extra int32 column, so a spill's download
    (which compacts the live rows) keeps each row with its partition.
    ``view(first, last)`` is partitions first..last's selection view
    over the shared buffers. Registered pinned: its writer still holds
    the batch."""

    def __init__(self, mm, batch: GpuBatch, pids: Optional[torch.Tensor]):
        self._schema = batch.schema
        self._split = pids is not None
        # the map batch's bytes, the lane left out (the stage's bytes)
        self.nbytes = batch.device_size_bytes()
        ext = batch
        if self._split:
            ext_schema = dt.Schema(
                list(batch.schema.fields)
                + [dt.StructField("__pid__", dt.INT32, False)])
            pidcol = GpuColumnVector(dt.INT32, pids.to(torch.int32))
            ext = GpuBatch(list(batch.columns) + [pidcol], ext_schema,
                           batch.row_count, selection=batch.selection)
        self._sb = mm.register(ext, pinned=True) if mm is not None \
            else None
        self._raw = ext if mm is None else None

    def view(self, first: int, last: int) -> GpuBatch:
        b = self._sb.get() if self._sb is not None else self._raw
        if not self._split:
            return b
        core = GpuBatch(b.columns[:-1], self._schema, b.row_count,
                        selection=b.selection)
        lane = b.columns[-1].data
        keep = lane == first if first == last \
            else (lane >= first) & (lane <= last)
        return core.with_selection(keep)

    def pin(self):
        if self._sb is not None:
            self._sb.pin()

    def unpin(self):
        if self._sb is not None:
            self._sb.unpin()

    def release(self):
        if self._sb is not None:
            self._sb.release()
        self._raw = None


class _LocalWriter(ShuffleWriteHandle):
    def __init__(self, transport: "LocalShuffleTransport", shuffle_id: int,
                 map_id: int):
        self._transport = transport
        self._sid = shuffle_id
        self._mid = map_id
        self._counted = False

    def write_unsplit(self, batch: GpuBatch,
                      pids: Optional[torch.Tensor]) -> None:
        entry = _MapEntry(self._transport._mm, batch, pids)
        self._transport._store(self._sid, self._mid, entry)
        self._transport._hand_over(self._sid, entry)

    def record_counts(self, counts: torch.Tensor, nbytes: int) -> None:
        self._counted = True
        self._transport._record_counts(self._sid, counts, nbytes)

    def close(self) -> None:
        if not self._counted:
            self._transport._mark_unrecorded(self._sid)


class LocalShuffleTransport(ShuffleTransport):
    """In-process shuffle store on the device; reads return each
    partition's batches in map order."""

    def set_memory_manager(self, mm) -> None:
        """Attach the spill catalog: later ``write_unsplit`` entries are
        ledger entries."""
        self._mm = mm

    def __init__(self):
        self._mm = None
        # shuffle -> [(map id, map entry)]
        self._shuffles: Dict[int, List[Tuple[int, _MapEntry]]] = {}
        # shuffle -> the entry handed over last, pinned
        self._held: Dict[int, _MapEntry] = {}
        self._nparts: Dict[int, int] = {}
        self._pending: Dict[int, List[Tuple[torch.Tensor, int]]] = {}
        self._stats: Dict[int, np.ndarray] = {}
        self._unrecorded: Dict[int, bool] = {}
        self._lock = threading.Lock()

    def register_shuffle(self, shuffle_id: int, num_partitions: int):
        with self._lock:
            self._shuffles.setdefault(shuffle_id, [])
            self._nparts[shuffle_id] = num_partitions

    def writer(self, shuffle_id: int, map_id: int) -> ShuffleWriteHandle:
        return _LocalWriter(self, shuffle_id, map_id)

    def _store(self, sid: int, map_id: int, entry: _MapEntry):
        with self._lock:
            self._shuffles[sid].append((map_id, entry))

    def _hand_over(self, sid: int, entry: _MapEntry):
        """``entry`` (pinned by its caller) is the stage's batch now in
        its taker's hands; unpin the one handed over before it."""
        with self._lock:
            prev = self._held.get(sid)
            self._held[sid] = entry
        if prev is not None:
            prev.unpin()

    def _record_counts(self, sid: int, counts: torch.Tensor, nbytes: int):
        with self._lock:
            self._pending.setdefault(sid, []).append((counts, nbytes))

    def _mark_unrecorded(self, sid: int):
        with self._lock:
            self._unrecorded[sid] = True

    def _fold_pending(self, sid: int) -> None:
        """The parked counts in one copy; each map batch's bytes spread
        over its partitions by live rows."""
        with self._lock:
            pending = self._pending.pop(sid, [])
        if not pending:
            return
        host = torch.stack([c for c, _ in pending]).cpu().numpy()
        sizes = np.zeros(host.shape[1], np.int64)
        for counts, (_, nbytes) in zip(host, pending):
            sizes += counts.astype(np.int64) * nbytes \
                // max(int(counts.sum()), 1)
        with self._lock:
            prev = self._stats.get(sid)
            self._stats[sid] = sizes if prev is None else prev + sizes

    def stage_bytes(self, shuffle_id: int) -> int:
        """Bytes the stage's map batches hold, from capacities (no sync,
        no upload of a spilled entry)."""
        return sum(e.nbytes for _, e in self._shuffles.get(shuffle_id, []))

    def partition_stats(self, shuffle_id: int) -> Optional[List[int]]:
        """Approximate bytes per partition from the writer-side counts,
        when every map batch recorded them (the exchange records them
        whenever AQE is on, the only time a reader asks); one partition
        needs none. Otherwise None."""
        n = self._nparts.get(shuffle_id)
        if n is None:
            return None
        if n == 1:
            return [self.stage_bytes(shuffle_id)]
        if not self._unrecorded.get(shuffle_id, False):
            self._fold_pending(shuffle_id)
            if shuffle_id in self._stats:
                return [int(v) for v in self._stats[shuffle_id]]
        return None

    def read_partitions(self, shuffle_id: int, first: int, last: int):
        # each view made as it is read: a spilled entry comes back only
        # when its turn comes
        for _, entry in sorted(self._shuffles.get(shuffle_id, []),
                               key=lambda e: e[0]):
            view = entry.view(first, last)
            entry.pin()
            self._hand_over(shuffle_id, entry)
            yield view

    def unregister_shuffle(self, shuffle_id: int):
        with self._lock:
            for _, entry in self._shuffles.pop(shuffle_id, None) or []:
                entry.release()
            self._held.pop(shuffle_id, None)
            self._nparts.pop(shuffle_id, None)
            self._pending.pop(shuffle_id, None)
            self._stats.pop(shuffle_id, None)
            self._unrecorded.pop(shuffle_id, None)

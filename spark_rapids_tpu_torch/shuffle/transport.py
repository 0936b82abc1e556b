"""Shuffle transport interface and the in-process store.

Counterpart of ``spark_rapids_tpu/shuffle/transport.py:95-250``
(``ShuffleWriteHandle``, ``ShuffleTransport``, ``LocalShuffleTransport``):
the seam between partition routing and how batches move. The local
store keeps every map output on the card: a partition's entries are the
exchange's selection views of each map batch (they share the batch's
buffers), read back in map order.

Writer-side statistics: with AQE on, the exchange hands the store each
map batch's live rows per partition, a few int64s counted on the device
next to the split, with no sync; ``partition_stats`` reads them all back
in one copy at the stage boundary and spreads each map batch's bytes
over its partitions by those counts, as the reference does
(``_fold_pending_stats``). The reference's spill catalog
(``set_memory_manager``) waits for ROADMAP item 14; the host-file,
multi-threaded and collective transports wait for items 16 and 17.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.batch import GpuBatch

__all__ = ["ShuffleWriteHandle", "ShuffleTransport",
           "LocalShuffleTransport"]


class ShuffleWriteHandle:
    """Writer for one map task's output."""

    def write(self, partition_id: int, batch: GpuBatch) -> None:
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

    def read_partition(self, shuffle_id: int,
                       partition_id: int) -> Iterator[GpuBatch]:
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


class _LocalWriter(ShuffleWriteHandle):
    def __init__(self, transport: "LocalShuffleTransport", shuffle_id: int,
                 map_id: int):
        self._transport = transport
        self._sid = shuffle_id
        self._mid = map_id
        self._counted = False

    def write(self, partition_id: int, batch: GpuBatch) -> None:
        self._transport._store(self._sid, partition_id, self._mid, batch)

    def record_counts(self, counts: torch.Tensor, nbytes: int) -> None:
        self._counted = True
        self._transport._record_counts(self._sid, counts, nbytes)

    def close(self) -> None:
        if not self._counted:
            self._transport._mark_unrecorded(self._sid)


class LocalShuffleTransport(ShuffleTransport):
    """In-process shuffle store on the device; reads return each
    partition's batches in map order."""

    def __init__(self):
        # shuffle -> partition -> [(map id, batch)]
        self._shuffles: Dict[int, Dict[int, List[Tuple[int, GpuBatch]]]] \
            = {}
        self._nparts: Dict[int, int] = {}
        self._pending: Dict[int, List[Tuple[torch.Tensor, int]]] = {}
        self._stats: Dict[int, np.ndarray] = {}
        self._unrecorded: Dict[int, bool] = {}
        self._lock = threading.Lock()

    def register_shuffle(self, shuffle_id: int, num_partitions: int):
        with self._lock:
            self._shuffles.setdefault(shuffle_id, {})
            self._nparts[shuffle_id] = num_partitions

    def writer(self, shuffle_id: int, map_id: int) -> ShuffleWriteHandle:
        return _LocalWriter(self, shuffle_id, map_id)

    def _store(self, sid: int, p: int, map_id: int, batch: GpuBatch):
        with self._lock:
            self._shuffles[sid].setdefault(p, []).append((map_id, batch))

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
        """Bytes the stage's map batches hold, from capacities (no sync);
        a map batch split into views counts once."""
        seen, total = set(), 0
        for entries in self._shuffles.get(shuffle_id, {}).values():
            for _, b in entries:
                key = tuple(id(c) for c in b.columns)
                if key not in seen:
                    seen.add(key)
                    total += sum(c.device_size_bytes() for c in b.columns)
        return total

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

    def read_partition(self, shuffle_id: int, partition_id: int):
        entries = self._shuffles.get(shuffle_id, {}).get(partition_id, [])
        for _, batch in sorted(entries, key=lambda e: e[0]):
            yield batch

    def unregister_shuffle(self, shuffle_id: int):
        with self._lock:
            self._shuffles.pop(shuffle_id, None)
            self._nparts.pop(shuffle_id, None)
            self._pending.pop(shuffle_id, None)
            self._stats.pop(shuffle_id, None)
            self._unrecorded.pop(shuffle_id, None)

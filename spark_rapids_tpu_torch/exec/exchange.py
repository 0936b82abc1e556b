"""Shuffle exchange.

Counterpart of ``spark_rapids_tpu/exec/exchange.py:82-436``
(``ShuffleStageHandle``, ``TpuShuffleExchangeExec``) over the local
transport. The map side streams the child's batches through
``fused_batches`` with a per-batch tail:

- one partition (``_single_tail``, ``:196``): the batch is the
  partition, and no partition id is computed;
- several (``_split_tail``, ``:173``): one partition-id computation a
  batch (Spark's Murmur3, ``ops/hash.py``); the batch and its ids go to
  the transport whole (``write_unsplit``), and a read makes one selection
  view a partition that shares the batch's buffers, so an n-way split
  costs the ids and n masks, not n compactions. With AQE on, the tail
  also counts each partition's live rows on the device for the adaptive
  reader's statistics.

The map side counts the rows it partitions under the exchange's label
for the operator metrics (the reference's ``:229-248``): the adaptive
reader drives it through ``materialize``, which its execute shim does
not see.

The local transport gets the query's memory manager
(``set_memory_manager``, the reference's ``:205-211``): each map batch is
one ledger entry, its partition lane with it, that spills under
pressure and comes back whole at its read.

Batches come out partition-major, in map order within a partition. On
the CPU the exchange runs the same body on CPU tensors
(``GpuExec.execute_cpu``) and drops an empty partition's zero-row
batches, as the reference's host exchange does; on the device a view
whose partitions hold no row of its map batch still comes out (its count
lives on the device, and reading it would be a sync a view).

``GpuCoalesceBatchesExec`` (``:509-576``) gathers small batches up to a
target row count and byte size: the planner puts it over a
``HostToDeviceExec`` whose parent is an aggregate, a join or a sort, so
those see full batches instead of a CPU island's crumbs. On the device
the group is one ``concat_batches_bounded`` (no readback), on the host
one Arrow concatenation. ``spark.rapids.shuffle.mode`` picks the transport: ``LOCAL`` (the
store above), ``HOST`` and ``MULTITHREADED`` (the host-file shuffle,
``shuffle/host.py``). The broadcast exchange and the collective
transport (``ICI``) wait for ROADMAP item 17, range and round-robin
partitioning for item 10.
"""
from __future__ import annotations

import itertools
import time
from typing import List, Optional

import pyarrow as pa
import torch

from .. import datatypes as dt
from ..config import ADAPTIVE_ENABLED, BATCH_SIZE_BYTES, SHUFFLE_MODE
from ..ops.concat import concat_batches_bounded
from ..shuffle.partitioner import Partitioning
from ..shuffle.transport import LocalShuffleTransport, ShuffleTransport
from .base import ExecCtx, GpuExec, OpContract, UnaryExec, fused_batches

__all__ = ["GpuShuffleExchangeExec", "ShuffleStageHandle",
           "GpuCoalesceBatchesExec"]

_shuffle_ids = itertools.count()


class ShuffleStageHandle:
    """The reduce side of a written shuffle stage: read partitions, ask
    for statistics, release the store."""

    def __init__(self, transport: ShuffleTransport, sid: int, n: int):
        self.transport = transport
        self.sid = sid
        self.num_partitions = n

    def partition_stats(self) -> Optional[List[int]]:
        return self.transport.partition_stats(self.sid)

    def read(self, p: int):
        yield from self.transport.read_partitions(self.sid, p, p)

    def read_range(self, first: int, last: int):
        """Partitions ``first`` to ``last``, a batch a map batch."""
        yield from self.transport.read_partitions(self.sid, first, last)

    def close(self):
        self.transport.unregister_shuffle(self.sid)


class GpuShuffleExchangeExec(UnaryExec):
    """Repartition the child's output by a ``Partitioning``."""


    CONTRACT = OpContract(
        schema_preserving=True,
        notes="repartitions rows; partition keys must be primitive")

    def __init__(self, partitioning: Partitioning, child: GpuExec,
                 transport: Optional[ShuffleTransport] = None):
        super().__init__(child)
        self.partitioning = partitioning.bind(child.output_schema)
        self.transport = transport

    def describe(self):
        return (f"ShuffleExchangeExec [{type(self.partitioning).__name__} "
                f"n={self.partitioning.num_partitions}]")

    def expressions(self):
        return list(getattr(self.partitioning, "key_exprs", []))

    def gpu_supported(self) -> Optional[str]:
        # a nested key hashes on the CPU (the reference's ``:136-137``);
        # a nested payload column stays on the device
        for e in getattr(self.partitioning, "key_exprs", []):
            if dt.is_nested(e.dtype):
                return (f"partitioning by nested type "
                        f"{e.dtype.simple_string()} not on device")
        return None

    def _resolve_transport(self, ctx: ExecCtx) -> ShuffleTransport:
        """The exchange's own transport, else one from
        ``spark.rapids.shuffle.mode`` (the reference's ``:105-125``): the
        local store, or the host-file shuffle (``HOST`` writes on the
        map side's thread, ``MULTITHREADED`` on a pool), closed with the
        query."""
        if self.transport is not None:
            return self.transport
        mode = ctx.conf.get(SHUFFLE_MODE)
        if mode == "LOCAL":
            return LocalShuffleTransport()
        if mode in ("HOST", "MULTITHREADED"):
            from ..shuffle.host import HostShuffleTransport
            t = HostShuffleTransport(
                ctx.conf, threads=0 if mode == "HOST" else None,
                device=ctx.device)
            ctx.register_cleanup(t.close)
            return t
        if mode == "ICI":
            raise NotImplementedError(
                "spark.rapids.shuffle.mode=ICI is not ported yet: the "
                "collective shuffle over NCCL waits for ROADMAP item 17")
        raise ValueError(f"unknown shuffle mode {mode!r}")

    def _single_tail(self, batch, ectx):
        """One partition: the whole batch, no ids."""
        return batch, None, None

    def _split_tail(self, batch, ectx, count: bool):
        """Partition ids once; with ``count``, each partition's live rows
        (a device tensor)."""
        n = self.partitioning.num_partitions
        pids = self.partitioning.partition_ids(batch, ectx)
        counts = None
        if count:
            routed = torch.where(batch.live_mask(), pids.to(torch.int64),
                                 torch.full_like(pids, n, dtype=torch.int64))
            counts = torch.bincount(routed, minlength=n + 1)[:n]
        return batch, pids, counts

    def materialize(self, ctx: ExecCtx) -> ShuffleStageHandle:
        """The map side: write every partition of every batch, and
        return the handle the reduce side reads."""
        transport = self._resolve_transport(ctx)
        if hasattr(transport, "set_memory_manager"):
            transport.set_memory_manager(ctx.mm)
        record = ctx.conf.get(ADAPTIVE_ENABLED)
        n = self.partitioning.num_partitions
        sid = next(_shuffle_ids)
        transport.register_shuffle(sid, n)
        ctx.metric(self, "numPartitions").set(n)
        batches_m = ctx.metric(self, "numInputBatches")
        write_t = ctx.metric(self, "writeTime")
        if n == 1:
            tail = self._single_tail
        else:
            def tail(batch, ectx):
                return self._split_tail(batch, ectx, record)
        # the map side counts the rows it partitions (the reference's
        # ``:229-248``): the adaptive reader drives the exchange through
        # materialize, not execute, whose shim would count them; the
        # claim keeps an execute above from counting twice
        opm = ctx.opm
        claim = opm.enter(self) if opm.enabled else None
        rows_m = ctx.metric(self, "rows") if claim is not None else None
        try:
            for map_id, (batch, pids, counts) in enumerate(fused_batches(
                    self, ctx, tail_fn=tail,
                    metric=ctx.metric(self, "opTime"))):
                batches_m += 1
                if rows_m is not None:
                    opm.count_rows(rows_m, batch)
                t0 = time.perf_counter()
                writer = transport.writer(sid, map_id)
                writer.write_unsplit(batch, pids)
                if counts is not None:
                    writer.record_counts(counts, batch.device_size_bytes())
                writer.close()
                write_t.value += time.perf_counter() - t0
        except BaseException:
            # a failed or cancelled map phase leaves no ledger entry
            transport.unregister_shuffle(sid)
            raise
        finally:
            if claim is not None:
                opm.exit(self, claim)
        return ShuffleStageHandle(transport, sid, n)

    def execute(self, ctx: ExecCtx):
        handle = self.materialize(ctx)
        try:
            for p in range(handle.num_partitions):
                yield from handle.read(p)
        finally:
            handle.close()

    def execute_cpu(self, ctx: ExecCtx):
        """The CPU path: the device body on CPU tensors, without the
        zero-row batches of empty partitions, which the reference's host
        exchange never makes (``:426-435``); one partition passes every
        batch through, as there."""
        n = self.partitioning.num_partitions
        for rb in super().execute_cpu(ctx):
            if n == 1 or rb.num_rows:
                yield rb


class GpuCoalesceBatchesExec(UnaryExec):
    """Concatenate small batches up to ``target_rows`` rows and
    ``spark.rapids.sql.batchSizeBytes`` (module docstring)."""


    CONTRACT = OpContract(
        schema_preserving=True,
        notes="concatenates small batches; row values unchanged")

    def __init__(self, child: GpuExec, target_rows: int = 1 << 17):
        super().__init__(child)
        self.target_rows = target_rows

    def describe(self):
        return f"CoalesceBatchesExec [target={self.target_rows}]"

    def _groups(self, items, rows_of, bytes_of, target_bytes: int):
        """Runs of consecutive non-empty items within both targets."""
        pending, rows, nbytes = [], 0, 0
        for it in items:
            n = rows_of(it)
            if n == 0:
                continue
            b = bytes_of(it)
            if pending and (rows + n > self.target_rows
                            or nbytes + b > target_bytes):
                yield pending
                pending, rows, nbytes = [], 0, 0
            pending.append(it)
            rows += n
            nbytes += b
        if pending:
            yield pending

    def execute(self, ctx: ExecCtx):
        concat_time = ctx.metric(self, "concatTime")
        out_batches = ctx.metric(self, "numOutputBatches")
        for group in self._groups(self.child.execute(ctx),
                                  lambda b: b.row_count,
                                  lambda b: b.device_size_bytes(),
                                  ctx.conf.get(BATCH_SIZE_BYTES)):
            t0 = time.perf_counter()
            out = concat_batches_bounded(group)
            concat_time.value += time.perf_counter() - t0
            out_batches += 1
            yield out

    def execute_cpu(self, ctx: ExecCtx):
        for group in self._groups(self.child.execute_cpu(ctx),
                                  lambda rb: rb.num_rows,
                                  lambda rb: rb.nbytes,
                                  ctx.conf.get(BATCH_SIZE_BYTES)):
            t = pa.Table.from_batches(group).combine_chunks()
            yield t.to_batches()[0]

"""Sort and limit operators.

Counterpart of ``spark_rapids_tpu/exec/sort.py:34-70,114-192,356-424``
(``SortOrder``, ``sort_batch_by``, ``TpuSortExec``, ``TpuLocalLimitExec``,
``TpuGlobalLimitExec``). A sort normalises its keys into orderable lanes
with Spark's direction and null placement and sorts them with **K3**
(``ops/sort_keys.sort_permutation``: packed uint64 words, one radix sort
a word; a string key by its rank, itself refined by K3 sorts), then
moves the rows with one **K4** gather
(``ops/gather.gather_batch``; a string column rides the same launch). A
global sort first concatenates the child's batches with no readback
(``concat_batches_bounded``); the sorted batch's row count is read back
once when its input carries a lazy selection, since the port keeps row
counts on the host.

When the child's batches hold more than half the memory manager's
budget (``_sort_out_of_core``, the reference's ``:158-338``), the sort
runs out of core: each batch is sorted (K3 + K4) into a run, registered
in the spill catalog and spilled to host Arrow (on to sealed disk files
past ``spark.rapids.memory.host.spillStorageSize``); then k-way merge
rounds pull the next chunk of every live run to the device beside the
carry, sort them together (K3 on the packed key words, K4 moving the
rows) and emit the prefix whose keys are at most the smallest of the
runs' last pulled keys, which no unread row can precede; the rest is the
next round's carry (one more K4 gather). A run is released as its last
chunk is pulled, and every run in a ``finally``. Metrics: ``spillTime``,
``numRuns``, ``mergeRounds``.

The limits cut the stream's row count on the host. ``TpuTopNExec``
waits for item 11: neither the SQL compiler nor the session plans it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch, bucket_rows
from ..expr.base import Expression, bind_expr
from ..ops.concat import concat_batches_bounded
from ..ops.gather import ensure_compacted, gather_batch
from ..ops.sort_keys import (SortSpec, _key_lanes, check_key_type,
                             pack_words, sort_packed, sort_permutation)
from .base import ExecCtx, GpuExec, OpContract, UnaryExec

__all__ = ["SortOrder", "GpuSortExec", "GpuLocalLimitExec",
           "GpuGlobalLimitExec", "sort_batch_by"]


@dataclasses.dataclass(frozen=True)
class SortOrder:
    """Sort key: expression, direction and null placement (Spark's
    default: ascending puts nulls first, descending last)."""
    child: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None

    def __post_init__(self):
        if self.nulls_first is None:
            object.__setattr__(self, "nulls_first", self.ascending)

    @property
    def spec(self) -> SortSpec:
        return SortSpec(self.ascending, self.nulls_first)


def sort_batch_by(batch: GpuBatch, orders: Sequence[SortOrder],
                  ectx) -> GpuBatch:
    """One batch sorted by the (bound) orders, live rows first, in
    prefix layout."""
    keys = [o.child.eval_gpu(batch, ectx) for o in orders]
    live = batch.live_mask()
    perm = sort_permutation(keys, [o.spec for o in orders], live)
    count = batch.row_count if batch.selection is None else live.sum()
    return gather_batch(batch, perm, count)


class GpuSortExec(UnaryExec):
    """Total sort (``global_sort``, the default) or per-batch sort."""

    CONTRACT = OpContract(
        schema_preserving=True,
        notes="reorders rows only; sort keys must be primitive")

    def __init__(self, orders: Sequence[SortOrder], child: GpuExec,
                 global_sort: bool = True):
        super().__init__(child)
        self.orders = [dataclasses.replace(
            o, child=bind_expr(o.child, child.output_schema))
            for o in orders]
        for o in self.orders:
            check_key_type(o.child.dtype)
        self.global_sort = global_sort

    def describe(self):
        keys = ", ".join(
            f"{o.child!r} {'ASC' if o.ascending else 'DESC'} NULLS "
            f"{'FIRST' if o.nulls_first else 'LAST'}" for o in self.orders)
        return f"SortExec [{keys}] global={self.global_sort}"

    def expressions(self):
        return [o.child for o in self.orders]

    def gpu_supported(self) -> Optional[str]:
        # a nested key orders on the CPU (``ops/sort_keys``; the
        # reference's ``:143-151``)
        for o in self.orders:
            if dt.is_nested(o.child.dtype):
                return (f"sorting by nested type "
                        f"{o.child.dtype.simple_string()} not on device")
        return None

    def execute(self, ctx: ExecCtx):
        op_time = ctx.metric(self, "opTime")
        if self.global_sort:
            batches = list(self.child.execute(ctx))
            if not batches:
                return
            total = sum(b.device_size_bytes() for b in batches)
            if len(batches) > 1 and total > ctx.mm.budget // 2:
                # input, concatenation and sorted copy would not fit
                yield from self._sort_out_of_core(batches, ctx)
                return
            t0 = time.perf_counter()
            out = sort_batch_by(concat_batches_bounded(batches),
                                self.orders, ctx.eval_ctx)
            op_time.value += time.perf_counter() - t0
            yield out
            return
        for batch in self.child.execute(ctx):
            t0 = time.perf_counter()
            out = sort_batch_by(batch, self.orders, ctx.eval_ctx)
            op_time.value += time.perf_counter() - t0
            yield out


    # --- out-of-core global sort -----------------------------------------

    def _merge_round(self, merged: GpuBatch, bidx: List[int],
                     bvalid: List[bool], ectx):
        """Sort ``merged`` and split it at the runs' boundary:
        ``(sorted batch, live rows, rows that are final)``. A row is
        final when its packed key words are at most the smallest of the
        valid boundary rows' (unsigned, lexicographic)."""
        keys = [o.child.eval_gpu(merged, ectx) for o in self.orders]
        live = merged.live_mask()
        lanes = _key_lanes(keys, [o.spec for o in self.orders], live)
        words = pack_words(lanes)
        nbits = sum(w for _, w in lanes)
        at = torch.tensor([i for i, v in zip(bidx, bvalid) if v],
                          dtype=torch.int64, device=merged.device)
        bwords = torch.stack([w[at] for w in words], 1).cpu().tolist()
        mask64 = (1 << 64) - 1
        bmin = min(tuple(v & mask64 for v in row) for row in bwords)
        swords, perm = sort_packed(words)
        # unsigned order as signed: flip the top bit of both sides
        flip = torch.tensor(-(1 << 63), dtype=torch.int64,
                            device=merged.device)
        le = torch.ones_like(live)
        for w, b in reversed(list(zip(swords, bmin))):
            u = w ^ flip
            bu = (b ^ (1 << 63)) - (1 << 64) if b < (1 << 63) \
                else b ^ (1 << 63)
            le = (u < bu) | ((u == bu) & le)
        sorted_live = ((swords[0] >> (min(64, nbits) - 1)) & 1) == 0
        counts = torch.stack([sorted_live.sum(),
                              (le & sorted_live).sum()]).cpu().tolist()
        total, safe = int(counts[0]), int(counts[1])
        return gather_batch(merged, perm, total), total, safe

    def _sort_out_of_core(self, batches: List[GpuBatch], ctx: ExecCtx):
        """External sort over spilled runs (module docstring)."""
        from ..columnar.arrow_bridge import arrow_to_device
        mm = ctx.mm
        ectx = ctx.eval_ctx
        spill_m = ctx.metric(self, "spillTime")
        rounds_m = ctx.metric(self, "mergeRounds")
        schema = self.child.output_schema
        bytes_per_row = max(1, batches[0].device_size_bytes()
                            // max(1, batches[0].capacity))
        runs = []
        try:
            t0 = time.perf_counter()
            while batches:
                run = sort_batch_by(batches.pop(0), self.orders, ectx)
                sp = mm.register(run)
                del run
                # appended before the spill: a raising spill must leave
                # the entry to the finally below
                runs.append(sp)
                sp.spill()
            spill_m.value += time.perf_counter() - t0
            ctx.metric(self, "numRuns").set(len(runs))
            hosts = [sp.get_host() for sp in runs]
            rows = [h.num_rows for h in hosts]
            k = len(runs)
            budget_rows = max(256, (mm.budget // 2) // bytes_per_row
                              // max(1, k))
            chunk = max(128, bucket_rows(budget_rows) // 2)
            cursors = [0] * k
            carry = None  # the sorted rows not yet final, compacted
            while True:
                active = [i for i in range(k) if cursors[i] < rows[i]]
                if not active:
                    if carry is not None:
                        yield carry
                    return
                parts = [] if carry is None else [carry]
                bidx, bvalid = [], []
                base = 0 if carry is None else carry.capacity
                for i in active:
                    take = min(chunk, rows[i] - cursors[i])
                    piece = arrow_to_device(
                        hosts[i].slice(cursors[i], take), schema,
                        ctx.device)
                    parts.append(piece)
                    cursors[i] += take
                    bidx.append(base + take - 1)
                    # an exhausted run imposes no boundary
                    bvalid.append(cursors[i] < rows[i])
                    base += piece.capacity
                    if cursors[i] >= rows[i]:
                        # its last chunk is on the device: its host
                        # residency drains now
                        hosts[i] = None
                        runs[i].release()
                        runs[i] = None
                merged = concat_batches_bounded(parts)
                del parts
                carry = None
                rounds_m += 1
                if not any(bvalid):
                    yield sort_batch_by(merged, self.orders, ectx)
                    return
                out, total, safe = self._merge_round(merged, bidx, bvalid,
                                                     ectx)
                del merged
                if total > safe:
                    idx = torch.arange(safe, total, dtype=torch.int32,
                                       device=ctx.device)
                    pad = bucket_rows(total - safe) - (total - safe)
                    if pad:
                        idx = torch.cat([idx, torch.zeros(
                            pad, dtype=torch.int32, device=ctx.device)])
                    carry = gather_batch(out, idx, total - safe)
                if safe:
                    yield GpuBatch(out.columns, schema, safe)
                del out
        finally:
            for sp in runs:
                if sp is not None:
                    sp.release()


class GpuLocalLimitExec(UnaryExec):
    """Per-stream limit: each batch's row count cut to the rows still
    allowed (a batch with a selection is compacted first, counted by
    ``compactedBatches``); the stream stops once the limit is
    reached."""

    CONTRACT = OpContract(schema_preserving=True,
                          notes="truncates the stream; schema unchanged")

    def __init__(self, limit: int, child: GpuExec):
        super().__init__(child)
        if limit < 0:
            raise ValueError(f"negative limit {limit}")
        self.limit = limit

    def describe(self):
        return f"LocalLimitExec [{self.limit}]"

    def execute(self, ctx: ExecCtx):
        remaining = self.limit
        if remaining == 0:
            return
        compacted = ctx.metric(self, "compactedBatches")
        for batch in self.child.execute(ctx):
            if batch.selection is not None:
                compacted += 1
            batch = ensure_compacted(batch)
            take = min(batch.row_count, remaining)
            remaining -= take
            yield GpuBatch(batch.columns, batch.schema, take)
            if remaining == 0:
                return


class GpuGlobalLimitExec(GpuLocalLimitExec):
    """Single-partition global limit: the same truncation."""

    def describe(self):
        return f"GlobalLimitExec [{self.limit}]"

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

The limits cut the stream's row count on the host. The out-of-core sort
waits for ROADMAP item 14, and ``TpuTopNExec`` for item 11: neither the
SQL compiler nor the session plans it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from ..columnar.batch import GpuBatch
from ..expr.base import Expression, bind_expr
from ..ops.concat import concat_batches_bounded
from ..ops.gather import ensure_compacted, gather_batch
from ..ops.sort_keys import SortSpec, check_key_type, sort_permutation
from .base import ExecCtx, GpuExec, UnaryExec

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

    def execute(self, ctx: ExecCtx):
        op_time = ctx.metric(self, "opTime")
        if self.global_sort:
            batches = list(self.child.execute(ctx))
            if not batches:
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


class GpuLocalLimitExec(UnaryExec):
    """Per-stream limit: each batch's row count cut to the rows still
    allowed (a batch with a selection is compacted first); the stream
    stops once the limit is reached."""

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
        for batch in self.child.execute(ctx):
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

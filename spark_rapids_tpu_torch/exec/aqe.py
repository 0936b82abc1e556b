"""Adaptive reader at a shuffle stage boundary: partition coalescing.

Counterpart of ``spark_rapids_tpu/exec/aqe.py:46-154``
(``plan_partition_groups``, ``TpuAQEShuffleReadExec``). The planner puts
the reader over every shuffle exchange while
``spark.sql.adaptive.enabled`` is on (the default). It writes the stage,
reads the per-partition byte statistics the transport gathered while
writing, and groups runs of adjacent partitions below the advisory size.
Those statistics are always free here (the local transport's writer-side
counts), so ``spark.rapids.sql.adaptive.freeStatsOnly`` changes nothing.

Where the reference concatenates a coalesced group into one batch, the
port merges the group's views of one map batch into one view, whose
selection is the union of theirs: the views share the map batch's
buffers, so coalescing copies nothing and the consumer sees one batch a
map batch instead of one a partition. Batches that are not views of one
map batch are yielded as they are.

The skew split (``split_batch`` from ``memory.py``) and the join
strategy switch (``TpuAQEJoinExec``) wait for ROADMAP items 14 and 10: a
partition the plan marks skewed is read whole, and counted in
``numSkewedPartitions``.
"""
from __future__ import annotations

from typing import List

from ..columnar.batch import GpuBatch
from ..config import (ADAPTIVE_ADVISORY_BYTES, ADAPTIVE_COALESCE,
                      ADAPTIVE_SKEW_FACTOR, ADAPTIVE_SKEW_THRESHOLD)
from .base import ExecCtx, UnaryExec
from .exchange import GpuShuffleExchangeExec

__all__ = ["GpuAQEShuffleReadExec", "plan_partition_groups",
           "merge_views"]


def plan_partition_groups(stats: List[int], advisory: int,
                          skew_factor: int, skew_threshold: int,
                          coalesce: bool):
    """Partition indices -> ``(kind, members)`` with kind ``coalesced``,
    ``skewed`` or ``plain`` (the reference's planning, ``:46``)."""
    n = len(stats)
    live = sorted(v for v in stats if v > 0)
    median = live[len(live) // 2] if live else 0
    skew_cut = max(skew_factor * median, skew_threshold)
    groups = []
    run: List[int] = []
    run_bytes = 0
    for p in range(n):
        if stats[p] >= skew_cut and median > 0:
            if run:
                groups.append(("coalesced" if len(run) > 1 else "plain",
                               run))
                run, run_bytes = [], 0
            groups.append(("skewed", [p]))
            continue
        if not coalesce:
            groups.append(("plain", [p]))
            continue
        if run and run_bytes + stats[p] > advisory:
            groups.append(("coalesced" if len(run) > 1 else "plain", run))
            run, run_bytes = [], 0
        run.append(p)
        run_bytes += stats[p]
    if run:
        groups.append(("coalesced" if len(run) > 1 else "plain", run))
    return groups


def merge_views(batches: List[GpuBatch]) -> List[GpuBatch]:
    """Views of one batch (the same column objects and row count) merged
    into one view whose live rows are the union of theirs, in order of
    first appearance; other batches pass through."""
    groups: List[List[GpuBatch]] = []
    for b in batches:
        for g in groups:
            h = g[0]
            if h.row_count == b.row_count \
                    and len(h.columns) == len(b.columns) \
                    and all(x is y for x, y in zip(h.columns, b.columns)):
                g.append(b)
                break
        else:
            groups.append([b])
    out = []
    for g in groups:
        if len(g) == 1:
            out.append(g[0])
            continue
        sel = g[0].live_mask()
        for b in g[1:]:
            sel = sel | b.live_mask()
        out.append(GpuBatch(g[0].columns, g[0].schema, g[0].row_count, sel))
    return out


class GpuAQEShuffleReadExec(UnaryExec):
    """Adaptive reader over a shuffle exchange (module docstring)."""

    def __init__(self, child: GpuShuffleExchangeExec):
        if not isinstance(child, GpuShuffleExchangeExec):
            raise TypeError("the adaptive reader goes directly over a "
                            "shuffle exchange")
        super().__init__(child)

    def describe(self):
        return "AQEShuffleReadExec"

    def execute_cpu(self, ctx: ExecCtx):
        # the exchange below is on the CPU too: its partitions in order
        yield from self.child.execute_cpu(ctx)

    def execute(self, ctx: ExecCtx):
        handle = self.child.materialize(ctx)
        coalesced_m = ctx.metric(self, "numCoalescedPartitions")
        skewed_m = ctx.metric(self, "numSkewedPartitions")
        try:
            stats = handle.partition_stats()
            if stats is None:
                for p in range(handle.num_partitions):
                    yield from handle.read(p)
                return
            conf = ctx.conf
            groups = plan_partition_groups(
                stats, conf.get(ADAPTIVE_ADVISORY_BYTES),
                conf.get(ADAPTIVE_SKEW_FACTOR),
                conf.get(ADAPTIVE_SKEW_THRESHOLD),
                conf.get(ADAPTIVE_COALESCE))
            for kind, members in groups:
                if kind == "coalesced":
                    coalesced_m.value += len(members)
                    yield from merge_views(
                        [b for p in members for b in handle.read(p)])
                    continue
                if kind == "skewed":
                    skewed_m.value += 1
                for p in members:
                    yield from handle.read(p)
        finally:
            handle.close()

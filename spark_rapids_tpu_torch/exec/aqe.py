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
port reads the group's run of adjacent partitions at once
(``ShuffleStageHandle.read_range``): one view of each map batch whose
selection holds the group's rows. The views share the map batch's
buffers, so coalescing copies nothing, the consumer sees one batch a
map batch instead of one a partition, and a spilled map batch comes
back once for the group.

A partition the plan marks skewed (``numSkewedPartitions``) is read
batch by batch, and a batch over the advisory size is halved by
``memory.split_batch`` until each piece fits, the pieces in their order
(the reference's ``:99-140``), each halving counted in
``numSkewSplits``. A half past the batch's row count, which holds only
padding, is dropped (the port keeps row counts on the host; the
reference yields it); the pieces of the partition's i-th batch (map
batch i's view) are counted in ``numSkewPieces.<i>``. The join
strategy switch (``TpuAQEJoinExec``) waits
for ROADMAP item 10.
"""
from __future__ import annotations

from typing import List

from ..config import (ADAPTIVE_ADVISORY_BYTES, ADAPTIVE_COALESCE,
                      ADAPTIVE_SKEW_FACTOR, ADAPTIVE_SKEW_THRESHOLD)
from .base import ExecCtx, OpContract, UnaryExec
from .exchange import GpuShuffleExchangeExec

__all__ = ["GpuAQEShuffleReadExec", "plan_partition_groups"]


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


class GpuAQEShuffleReadExec(UnaryExec):
    """Adaptive reader over a shuffle exchange (module docstring)."""

    CONTRACT = OpContract(
        schema_preserving=True,
        wrapper_over="GpuShuffleExchangeExec",
        notes="planner-inserted adaptive reader; only valid directly "
              "over a shuffle exchange")

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
        from ..memory import split_batch
        coalesced_m = ctx.metric(self, "numCoalescedPartitions")
        skewed_m = ctx.metric(self, "numSkewedPartitions")
        skew_m = ctx.metric(self, "numSkewSplits")
        try:
            stats = handle.partition_stats()
            if stats is None:
                for p in range(handle.num_partitions):
                    yield from handle.read(p)
                return
            conf = ctx.conf
            advisory = conf.get(ADAPTIVE_ADVISORY_BYTES)

            def halves_in_order(piece):
                # in order: the exchange's map order within a partition
                # survives the split
                if piece.device_size_bytes() > advisory \
                        and piece.capacity >= 2:
                    skew_m.value += 1
                    b1, b2 = split_batch(piece)
                    yield from halves_in_order(b1)
                    yield from halves_in_order(b2)
                elif piece.row_count:
                    # a half past the row count holds only padding
                    yield piece

            groups = plan_partition_groups(
                stats, advisory,
                conf.get(ADAPTIVE_SKEW_FACTOR),
                conf.get(ADAPTIVE_SKEW_THRESHOLD),
                conf.get(ADAPTIVE_COALESCE))
            for kind, members in groups:
                if kind == "coalesced":
                    coalesced_m.value += len(members)
                    yield from handle.read_range(members[0], members[-1])
                    continue
                if kind == "skewed":
                    skewed_m.value += 1
                    for i, b in enumerate(handle.read(members[0])):
                        # the pieces of the partition's i-th batch (map
                        # batch i's view), an account by map batch
                        pieces = ctx.metric(self, f"numSkewPieces.{i}")
                        for piece in halves_in_order(b):
                            pieces += 1
                            yield piece
                    continue
                for p in members:
                    yield from handle.read(p)
        finally:
            handle.close()

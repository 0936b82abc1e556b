"""Aggregation operator, global and grouped.

Counterpart of ``spark_rapids_tpu/exec/aggregate.py:39-265,476-515``
(``TpuHashAggregateExec``): a partial pass per input batch, then the
partials are concatenated, merged and evaluated.

The grouped path is the reference's sort-based one (``_segment_starts``,
``_group_and_gather``, ``_partial``, ``_final``): each batch's rows are
sorted by their key lanes (**K3**, ``ops/sort_keys.sorted_segments``),
keys and values are permuted in one **K4** launch, each segment is
reduced (``ops/segments.py``), and one more K4 launch gathers every
segment's first key. A string key sorts by its rank lane
(``ops/sort_keys.string_order_ranks``: refinement passes on K3), and its
column rides the K4 launches as two int32 lanes (starts, lengths). A
partial keeps its batch's capacity and marks its
groups with a lazy selection, so no count is read back until the final
aggregate's output, whose group count sizes the result. The partials
meet in ``concat_batches_bounded``; when their bytes pass a quarter of
the memory manager's budget they merge in rounds first
(``_merge_bounded``, the reference's ``:234-263,497-500``): a window of
partials within ``budget // 4`` is concatenated and merged
(``_merge_only``, the buffers kept unevaluated), its group count read
back and the result cut to it, until one partial is left; the rounds'
time is ``spillTime`` and their count ``mergeRounds``.

The collects, and an exact ``ApproxPercentile``
(``spark.rapids.sql.approxPercentile.exact``, the default), take the
reference's single pass (``:276-481``):
every input batch is concatenated (bounded, no readback), the rows
sorted by key and gathered once, each group's non-null values ordered
by one more sort of ``(dropped, group, value)``
(``expr/aggregates.value_sorted_groups``, K3), and each group's
percentile gathered at its rank (K4), a list of them as one array a
group; a collect's values in that order become each group's array
(``expr/aggregates.collect_column``: a set's duplicates compacted on
K3, the elements gathered on K4); the node's other aggregates
reduce over the same sorted segments, with no partials. The input
batches are registered in the spill catalog as they come; once their
bytes pass half the budget (``:383-440``), the batches so far are
downloaded, the rest of the stream follows, and the single pass runs
over them on CPU tensors (``cpuAggregate`` = 1), its result uploaded.
The sketch strategy rides the partial and final phases
(``_wants_single_pass``).

When the operators fused below the aggregate are q6's shape — a filter
on an AND of column-vs-literal comparisons, then a project of
``a * b`` over float32 columns, summed — the partial pass for a whole
batch is one launch of K1's engine edition
(``ops/cuda_kernels.filter_product_sum``), counted by the
``kernelDispatches`` metric. The same chain grouped by one integer key
that the project passes straight from a scan column, where the scan's
row-group statistics bound that column to at most ``FUSED_AGG_GROUPS``
values, is one launch of K2's engine edition a batch
(``filter_product_group_sum``): its partial has one slot a key value and
one for the null key, in the layout ``_partial_grouped`` gives, so the
final merges it unchanged. K2 counts the rows whose key falls outside
the statistics' range; the query raises at its download if there is one.
Every other chain runs the operators' eager code.

Under ``spark.rapids.sql.variableFloatAgg.enabled=false`` a node with a
float aggregate refuses the device (``gpu_supported_conf``, the
reference's ``:115-128``) and runs on the CPU, where its torch body on
CPU tensors gives the same bits on every run.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch, bucket_rows, row_mask
from ..columnar.column import GpuColumnVector, torch_dtype
from ..config import APPROX_PERCENTILE_EXACT, VARIABLE_FLOAT_AGG, \
    RapidsConf
from ..expr.aggregates import (GLOBAL_LANES, AggregateFunction,
                               ApproxPercentile, Sum, _Collect,
                               collect_column, percentile_list_column,
                               spark_rank0, value_sorted_groups)
from ..expr.arithmetic import Multiply
from ..expr.base import Alias, BoundReference, Expression, Literal, \
    bind_expr
from ..expr.predicates import (And, EqualTo, GreaterThan,
                               GreaterThanOrEqual, LessThan,
                               LessThanOrEqual)
from ..ops.concat import concat_batches_bounded, concat_string_columns
from ..ops.cuda_kernels import (FUSED_AGG_GROUPS, MAX_LEAVES, MAX_SLOTS,
                                FilterProductSum, Leaf,
                                filter_product_group_sum, filter_product_sum)
from ..ops.gather import gather_columns, shrink_batch
from ..ops.segments import segment_starts_sorted
from ..ops.sort_keys import (check_key_type, normalize_float_key_col,
                             sorted_segments)
from .base import ExecCtx, GpuExec, UnaryExec, fused_batches
from .basic import GpuFilterExec, GpuProjectExec, bind_all, \
    output_schema_for

__all__ = ["GpuHashAggregateExec"]

_LEAF_OPS = {EqualTo: "=", LessThan: "<", LessThanOrEqual: "<=",
             GreaterThan: ">", GreaterThanOrEqual: ">="}
_FLIPPED = {"=": "=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
_KERNEL_COLUMN_TYPES = (dt.FloatType, dt.IntegerType, dt.DateType)
_KERNEL_KEY_TYPES = (dt.IntegerType, dt.LongType)


def _segment_starts(seg: torch.Tensor) -> torch.Tensor:
    """``starts[g]``: the first sorted position of segment g."""
    return segment_starts_sorted(seg, seg.shape[0])


def _unalias(e: Expression) -> Tuple[AggregateFunction, str]:
    if isinstance(e, Alias):
        fn, name = e.child, e.name
    else:
        fn, name = e, e.pretty_name().lower()
    if not isinstance(fn, AggregateFunction):
        raise TypeError(f"not an aggregate: {e!r}")
    return fn, name


def _conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


def _leaf(e: Expression) -> Optional[Tuple[BoundReference, str, float]]:
    """``(column, op, bound)`` for a column-vs-literal comparison."""
    op = _LEAF_OPS.get(type(e))
    if op is None:
        return None
    left, right = e.children
    if isinstance(left, Literal) and isinstance(right, BoundReference):
        left, right, op = right, left, _FLIPPED[op]
    if not (isinstance(left, BoundReference) and isinstance(right, Literal)
            and isinstance(left.dtype, _KERNEL_COLUMN_TYPES)
            and right.value is not None):
        return None
    # the literal's lane value as the column type holds it (a float32
    # literal rounds to float32, as the eager path's torch.full does)
    bound = float(np.asarray(right.lane_value, dtype=left.dtype.np_dtype))
    return left, op, bound


def _filter_product_sum_plan(chain: Sequence[GpuExec],
                             aggs: Sequence[AggregateFunction]) \
        -> Optional[Tuple[List[int], FilterProductSum]]:
    """The input ordinals per kernel slot and the kernel's spec when the
    chain is Filter -> Project -> Sum(a * b) in K1's shape, else None."""
    if len(chain) != 2 or not isinstance(chain[0], GpuFilterExec) \
            or not isinstance(chain[1], GpuProjectExec):
        return None
    if len(aggs) != 1 or not isinstance(aggs[0], Sum) \
            or not isinstance(aggs[0].children[0], BoundReference):
        return None
    summed = chain[1].exprs[aggs[0].children[0].ordinal]
    if isinstance(summed, Alias):
        summed = summed.child
    if not isinstance(summed, Multiply) or not all(
            isinstance(c, BoundReference) and c.dtype == dt.FLOAT32
            for c in summed.children):
        return None
    leaves = [_leaf(e) for e in _conjuncts(chain[0].condition)]
    if None in leaves or len(leaves) > MAX_LEAVES:
        return None
    ordinals: List[int] = []

    def slot(ref: BoundReference) -> int:
        if ref.ordinal not in ordinals:
            ordinals.append(ref.ordinal)
        return ordinals.index(ref.ordinal)

    spec = FilterProductSum(
        leaves=tuple(Leaf(slot(c), op, b) for c, op, b in leaves),
        a_slot=slot(summed.children[0]), b_slot=slot(summed.children[1]))
    if len(ordinals) > MAX_SLOTS:
        return None
    return ordinals, spec


def _lane0_column(cols: List[GpuColumnVector]) -> GpuColumnVector:
    """Lane 0 of each partial buffer, stacked into one column (string
    buffers through ``ops/concat.concat_string_columns``)."""
    if cols[0].is_string_like:
        return concat_string_columns(
            [GpuColumnVector(c.dtype, None, c.valid_mask()[:1],
                             c.offsets[:2], c.chars) for c in cols],
            len(cols))
    data = torch.cat([c.data[:1] for c in cols])
    if all(c.validity is None for c in cols):
        return GpuColumnVector(cols[0].dtype, data, None)
    return GpuColumnVector(cols[0].dtype, data,
                           torch.cat([c.valid_mask()[:1] for c in cols]))


class GpuHashAggregateExec(UnaryExec):
    """Sort-based aggregation with partial and final phases; without
    group keys, the global aggregate."""

    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Expression], child: GpuExec):
        super().__init__(child)
        self.group_exprs = bind_all(group_exprs, child.output_schema)
        for e in self.group_exprs:
            check_key_type(e.dtype)
        self.aggs: List[AggregateFunction] = []
        self.agg_names: List[str] = []
        for e in agg_exprs:
            fn, name = _unalias(bind_expr(e, child.output_schema))
            self.aggs.append(fn)
            self.agg_names.append(name)
        gfields = list(output_schema_for(self.group_exprs).fields)
        self._schema = dt.Schema(
            gfields + [dt.StructField(n, a.dtype, a.nullable)
                       for a, n in zip(self.aggs, self.agg_names)])
        # partial buffers: the group keys, then each aggregate's lanes
        bfields = list(gfields)
        self._buf_slices: List[Tuple[int, int]] = []
        for i, a in enumerate(self.aggs):
            bf = a.buffer_fields
            self._buf_slices.append((len(bfields), len(bfields) + len(bf)))
            bfields.extend(dt.StructField(f"_b{i}_{f.name}", f.dtype,
                                          f.nullable) for f in bf)
        self._partial_schema = dt.Schema(bfields)

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        g = ", ".join(map(repr, self.group_exprs))
        a = ", ".join(f"{type(x).__name__.lower()}"
                      f"({', '.join(map(repr, x.children))})"
                      for x in self.aggs)
        return f"HashAggregateExec [keys=[{g}] aggs=[{a}]]"

    def expressions(self):
        return list(self.group_exprs) + list(self.aggs)

    def resident_footprint(self):
        # a percentile's single pass concatenates the whole input on the
        # device before its group sort (the reference's ``:104``)
        return any(getattr(a, "single_pass", False) for a in self.aggs)

    def gpu_supported(self) -> Optional[str]:
        """Grouping by or aggregating a nested type stays on the CPU
        (the reference's ``:129-146``); so does an aggregate's own
        refusal (a collect of nested elements)."""
        for e in self.group_exprs:
            if dt.is_nested(e.dtype):
                return (f"grouping by nested type "
                        f"{e.dtype.simple_string()} not on device")
        for a in self.aggs:
            for c in a.children:
                if dt.is_nested(c.dtype):
                    return (f"aggregating nested type "
                            f"{c.dtype.simple_string()} not on device")
            r = a.gpu_supported()
            if r:
                return r
        return None

    def gpu_supported_conf(self, conf: RapidsConf) -> Optional[str]:
        """A float aggregate's result can vary with the order of its
        additions; under ``spark.rapids.sql.variableFloatAgg.enabled=
        false`` the node runs on the CPU, where the same input gives the
        same bits on every run (the reference's ``:115-128``)."""
        if conf.get(VARIABLE_FLOAT_AGG):
            return None
        for a in self.aggs:
            if a.children and dt.is_floating(a.children[0].dtype):
                return (f"float aggregation {a.pretty_name()} disabled "
                        "by spark.rapids.sql.variableFloatAgg.enabled")
        return None

    # --- grouped phases ---------------------------------------------------

    def _group_and_gather(self, key_cols, extra_cols, live):
        """Sort by the keys; returns (sorted key cols, sorted extra col
        lists, seg, sorted_live, num_groups, out_live). Keys and extras
        move in one K4 launch."""
        perm, seg, num_groups, sorted_live = sorted_segments(key_cols,
                                                             live)
        flat = list(key_cols) + [c for cols in extra_cols for c in cols]
        moved = gather_columns(flat, perm, sorted_live)
        skeys = moved[:len(key_cols)]
        sextras, at = [], len(key_cols)
        for cols in extra_cols:
            sextras.append(moved[at:at + len(cols)])
            at += len(cols)
        out_live = row_mask(live.shape[0], num_groups, live.device)
        return skeys, sextras, seg, sorted_live, num_groups, out_live

    def _partial_grouped(self, batch: GpuBatch, ectx) -> GpuBatch:
        live = batch.live_mask()
        key_cols = [normalize_float_key_col(e.eval_gpu(batch, ectx))
                    for e in self.group_exprs]
        val_cols = [[c.eval_gpu(batch, ectx) for c in a.children]
                    for a in self.aggs]
        skeys, svals, seg, sorted_live, _, out_live = \
            self._group_and_gather(key_cols, val_cols, live)
        out_cols = gather_columns(skeys, _segment_starts(seg), out_live)
        for a, sv in zip(self.aggs, svals):
            out_cols.extend(a.update_device(sv, seg, sorted_live, out_live))
        # the groups are the prefix out_live marks; their count stays on
        # the device
        return GpuBatch(out_cols, self._partial_schema, live.shape[0],
                        selection=out_live)

    def _final_grouped(self, pbatch: GpuBatch) -> GpuBatch:
        nkeys = len(self.group_exprs)
        buf_cols = [pbatch.columns[lo:hi] for lo, hi in self._buf_slices]
        skeys, sbufs, seg, sorted_live, num_groups, out_live = \
            self._group_and_gather(pbatch.columns[:nkeys], buf_cols,
                                   pbatch.live_mask())
        out_cols = gather_columns(skeys, _segment_starts(seg), out_live)
        for a, sb in zip(self.aggs, sbufs):
            out_cols.append(a.evaluate_device(
                a.merge_device(sb, seg, sorted_live, out_live)))
        # the query's one readback: the result's row count
        n = int(num_groups)
        return shrink_batch(GpuBatch(out_cols, self._schema, n),
                            bucket_rows(n))

    def _merge_only(self, pbatch: GpuBatch) -> GpuBatch:
        """Merge partial buffers without the final evaluate, the output
        cut to its groups (one readback) and copied out of the merge's
        full-capacity buffers, so it can be merged again."""
        nkeys = len(self.group_exprs)
        buf_cols = [pbatch.columns[lo:hi] for lo, hi in self._buf_slices]
        skeys, sbufs, seg, sorted_live, num_groups, out_live = \
            self._group_and_gather(pbatch.columns[:nkeys], buf_cols,
                                   pbatch.live_mask())
        out_cols = gather_columns(skeys, _segment_starts(seg), out_live)
        for a, sb in zip(self.aggs, sbufs):
            out_cols.extend(a.merge_device(sb, seg, sorted_live, out_live))
        n = int(num_groups)
        out = shrink_batch(GpuBatch(out_cols, self._partial_schema, n),
                           bucket_rows(max(n, 128)))
        return GpuBatch([c.clone() for c in out.columns], out.schema, n)

    def _merge_bounded(self, partials: List[GpuBatch],
                       ctx: ExecCtx) -> GpuBatch:
        """Merge the partials in rounds whose bytes fit ``budget // 4``
        (at least two partials a round) until one is left."""
        window = max(1, ctx.mm.budget // 4)
        spill = ctx.metric(self, "spillTime")
        rounds = ctx.metric(self, "mergeRounds")
        while len(partials) > 1:
            t0 = time.perf_counter()
            group = [partials.pop(0)]
            gbytes = group[0].device_size_bytes()
            while partials:
                nb = partials[0].device_size_bytes()
                if len(group) >= 2 and gbytes + nb > window:
                    break
                group.append(partials.pop(0))
                gbytes += nb
            merged = self._merge_only(concat_batches_bounded(group))
            del group
            partials.append(merged)
            rounds += 1
            spill.value += time.perf_counter() - t0
        return partials[0]

    def _partial(self, batch: GpuBatch, ectx) -> GpuBatch:
        live = batch.live_mask()
        cols = []
        for a in self.aggs:
            vals = [c.eval_gpu(batch, ectx) for c in a.children]
            cols.extend(a.update(vals, live))
        return GpuBatch(cols, self._partial_schema, 1)

    def _final(self, partials: List[GpuBatch]) -> GpuBatch:
        live = torch.ones(len(partials), dtype=torch.bool,
                          device=partials[0].device)
        out = []
        for a, (lo, hi) in zip(self.aggs, self._buf_slices):
            bufs = [_lane0_column([p.columns[j] for p in partials])
                    for j in range(lo, hi)]
            out.append(a.evaluate(a.merge(bufs, live)))
        return GpuBatch(out, self._schema, 1)

    def _empty_child_batch(self, device: torch.device) -> GpuBatch:
        cols = [GpuColumnVector.nulls(f.dtype, GLOBAL_LANES, device)
                for f in self.child.output_schema]
        return GpuBatch(cols, self.child.output_schema, 0)

    def _grouped_kernel_fn(self, chain, ctx: ExecCtx):
        """K2's engine edition as the partial pass, or None when the chain
        is not K1's shape grouped by one integer scan column whose
        statistics span at most ``FUSED_AGG_GROUPS`` values."""
        plan = _filter_product_sum_plan(chain, self.aggs)
        if plan is None or len(self.group_exprs) != 1 \
                or not isinstance(self.group_exprs[0], BoundReference):
            return None
        passed = chain[1].exprs[self.group_exprs[0].ordinal]
        if isinstance(passed, Alias):
            passed = passed.child
        scan = chain[0].child
        if not isinstance(passed, BoundReference) \
                or not isinstance(passed.dtype, _KERNEL_KEY_TYPES) \
                or not hasattr(scan, "column_bounds"):
            return None
        name = scan.output_schema.fields[passed.ordinal].name
        bounds = scan.column_bounds(name)
        if bounds is None or bounds[1] - bounds[0] + 1 > FUSED_AGG_GROUPS:
            return None
        base, groups = bounds[0], bounds[1] - bounds[0] + 1
        ordinals, spec = plan
        dispatches = ctx.metric(self, "kernelDispatches")
        message = (f"column {name}: a row holds a key outside "
                   f"[{bounds[0]}, {bounds[1]}], the range its row-group "
                   "statistics give")
        key_type = torch_dtype(passed.dtype)
        slots = {}

        def key_column(device) -> GpuColumnVector:
            """``base + g`` for each group, then the null key's slot."""
            if device not in slots:
                keys = torch.arange(base, base + groups + 1, dtype=key_type,
                                    device=device)
                keys[groups] = 0
                valid = torch.ones(groups + 1, dtype=torch.bool,
                                   device=device)
                valid[groups] = False
                slots[device] = GpuColumnVector(passed.dtype, keys, valid)
            return slots[device]

        def run(batch: GpuBatch, ectx) -> GpuBatch:
            cols = [batch.columns[o] for o in ordinals]
            key = batch.columns[passed.ordinal]
            sums, nonnull, rows, outside = filter_product_group_sum(
                [c.data for c in cols], [c.validity for c in cols],
                batch.selection, batch.row_count, spec, key.data,
                key.validity, base, groups)
            dispatches.value += 1
            ctx.add_deferred_check(outside, message)
            buf = GpuColumnVector(self.aggs[0].dtype, sums, nonnull > 0)
            # Spark keeps a group whose sum is null: a group is live when
            # a row passed into it
            return GpuBatch([key_column(sums.device), buf],
                            self._partial_schema, groups + 1,
                            selection=rows > 0)

        return run

    def fused_chain_fn(self, chain, ctx: ExecCtx):
        if self.group_exprs:
            return self._grouped_kernel_fn(chain, ctx)
        plan = _filter_product_sum_plan(chain, self.aggs)
        if plan is None:
            return None
        ordinals, spec = plan
        dispatches = ctx.metric(self, "kernelDispatches")
        agg = self.aggs[0]

        def run(batch: GpuBatch, ectx) -> GpuBatch:
            cols = [batch.columns[o] for o in ordinals]
            s, count = filter_product_sum(
                [c.data for c in cols], [c.validity for c in cols],
                batch.selection, batch.row_count, spec)
            dispatches.value += 1
            return GpuBatch([agg.buffer(s, count)], self._partial_schema, 1)

        return run

    # --- the single pass (an exact percentile) ----------------------------

    def _percentile_column(self, agg: ApproxPercentile,
                           scol: GpuColumnVector, seg: torch.Tensor,
                           sorted_live: torch.Tensor, out_cap: int,
                           out_live: torch.Tensor) -> GpuColumnVector:
        """Each group's value at Spark's rank ``ceil(p * n)``, gathered
        from its sorted non-null values (``:342``): rank error 0."""
        cap = sorted_live.shape[0]
        perm, lo, n_g = value_sorted_groups(scol, seg, sorted_live, out_cap)
        picked = [perm[(lo + spark_rank0(p, n_g)).clamp(0, cap - 1)]
                  for p in agg.percentages]
        has_vals = out_live & (n_g > 0)
        if agg.is_list:
            return percentile_list_column(agg, scol, picked, has_vals)
        return gather_columns([scol], picked[0], has_vals)[0]

    def _single_pass(self, batch: GpuBatch, ectx) -> GpuBatch:
        """The whole input grouped at once (``:318``)."""
        live = batch.live_mask()
        dev = live.device
        val_cols = [[c.eval_gpu(batch, ectx) for c in a.children]
                    for a in self.aggs]
        if self.group_exprs:
            key_cols = [normalize_float_key_col(e.eval_gpu(batch, ectx))
                        for e in self.group_exprs]
            skeys, svals, seg, sorted_live, num_groups, out_live = \
                self._group_and_gather(key_cols, val_cols, live)
            out_cap = live.shape[0]
            out_cols = gather_columns(skeys, _segment_starts(seg), out_live)
        else:
            # one group: the rows stay in place, GLOBAL_LANES outputs
            svals, sorted_live, out_cap = val_cols, live, GLOBAL_LANES
            seg = torch.zeros(live.shape[0], dtype=torch.int32, device=dev)
            num_groups = 1
            out_live = row_mask(GLOBAL_LANES, 1, dev)
            out_cols = []
        for a, sv in zip(self.aggs, svals):
            if isinstance(a, ApproxPercentile):
                out_cols.append(self._percentile_column(
                    a, sv[0], seg, sorted_live, out_cap, out_live))
            elif isinstance(a, _Collect):
                out_cols.append(collect_column(a, sv[0], seg, sorted_live,
                                               out_cap, out_live))
            elif self.group_exprs:
                out_cols.append(a.evaluate_device(
                    a.update_device(sv, seg, sorted_live, out_live)))
            else:
                out_cols.append(a.evaluate(a.update(sv, live)))
        # the result's row count, read back once
        n = int(num_groups)
        return shrink_batch(GpuBatch(out_cols, self._schema, n),
                            bucket_rows(n))

    def _wants_single_pass(self, conf: RapidsConf) -> bool:
        """A collect and an exact percentile take the single pass; the
        sketch rides the partial and final phases, unless a batch's
        capacity times ``_MASS_SCALE`` would overflow its int64 compound
        keys (``:441``)."""
        for a in self.aggs:
            if isinstance(a, _Collect):
                return True
            if not isinstance(a, ApproxPercentile):
                continue
            if conf.get(APPROX_PERCENTILE_EXACT) or conf.batch_size_rows \
                    * a._MASS_SCALE > (1 << 63) - 1:
                return True
        return False

    def _execute_single_pass(self, ctx: ExecCtx):
        op_time = ctx.metric(self, "opTime")
        if ctx.eval_ctx.host:
            # a CPU run: the card's ledger does not hold these batches
            batches = list(fused_batches(self, ctx, metric=op_time))
        else:
            batches, route = self._gather_within_budget(ctx, op_time)
            if route is not None:
                yield from self._run_cpu_route(ctx, *route)
                return
        t0 = time.perf_counter()
        if not batches:
            if self.group_exprs:
                return
            batches = [self._empty_child_batch(ctx.device)]
        out = self._single_pass(concat_batches_bounded(batches),
                                ctx.eval_ctx)
        op_time.value += time.perf_counter() - t0
        yield out

    def _gather_within_budget(self, ctx: ExecCtx, op_time):
        """``(batches, None)``: the single pass's input, registered in the
        spill catalog as it comes; or ``(None, (entries, stream))`` once
        it passes ``budget // 2``: the entries so far and the rest of the
        stream, for the CPU run."""
        sbs, total, over = [], 0, False
        stream = fused_batches(self, ctx, metric=op_time)
        try:
            for b in stream:
                total += b.device_size_bytes()
                sbs.append(ctx.mm.register(b))
                if total > ctx.mm.budget // 2:
                    over = True
                    break
            if not over:
                return [sb.get() for sb in sbs], None
        except BaseException:
            over = False
            raise
        finally:
            if not over:
                for sb in sbs:
                    sb.release()
        return None, (sbs, stream)

    def _run_cpu_route(self, ctx: ExecCtx, sbs, stream):
        """The single pass over the downloaded input on CPU tensors (the
        reference's ``_cpu_aggregate`` sink), each result uploaded."""
        from ..columnar.arrow_bridge import arrow_to_device, device_to_arrow
        from .base import _ArrowSourceExec
        ctx.metric(self, "cpuAggregate").set(1)

        def downloaded():
            pending = list(sbs)
            try:
                while pending:
                    rb = pending[0].get_host()
                    pending.pop(0).release()
                    yield rb
                for b in stream:
                    yield device_to_arrow(b)
            finally:
                for sb in pending:
                    sb.release()

        node = self.with_new_children([_ArrowSourceExec(
            downloaded(), self.child.output_schema)])
        node._label_id = self._label_id
        for b in node.execute(ctx.host_ctx()):
            yield arrow_to_device(device_to_arrow(b), self._schema,
                                  ctx.device)

    def execute(self, ctx: ExecCtx):
        if self._wants_single_pass(ctx.conf):
            yield from self._execute_single_pass(ctx)
            return
        op_time = ctx.metric(self, "opTime")
        if self.group_exprs:
            partials = list(fused_batches(
                self, ctx, tail_fn=self._partial_grouped, metric=op_time))
            ctx.metric(self, "numPartials").value += len(partials)
            if not partials:
                return
            t0 = time.perf_counter()
            if sum(p.device_size_bytes() for p in partials) \
                    > ctx.mm.budget // 4:
                merged = self._merge_bounded(partials, ctx)
            else:
                merged = concat_batches_bounded(partials)
            out = self._final_grouped(merged)
            op_time.value += time.perf_counter() - t0
            yield out
            return
        partials = list(fused_batches(self, ctx, tail_fn=self._partial,
                                      metric=op_time))
        if not partials:
            partials = [self._partial(self._empty_child_batch(ctx.device),
                                      ctx.eval_ctx)]
        yield self._final(partials)

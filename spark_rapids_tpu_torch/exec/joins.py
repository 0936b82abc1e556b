"""Join operators: the shuffled hash join (staged or on a unique build),
the cross join and the nested-loop join.

Counterpart of ``spark_rapids_tpu/exec/joins.py:46-807``
(``_BaseJoinExec``, ``TpuShuffledHashJoinExec``,
``TpuCartesianProductExec``, ``TpuBroadcastNestedLoopJoinExec``) for
every join type on any number of keys, string keys included. The build
(right) side is concatenated once (``concat_batches_bounded``, no
readback); ``_fast_build_info`` then decides the path once a build, as
the reference does (``:275-363``):

- **The fast path**, for a build whose keys are unique, on inner,
  left_outer, left_semi and left_anti: each stream batch joins with no
  size readback, into the stream batch's capacity, the emitted rows
  marked by the lazy selection. A single fixed-width key is presorted
  once by **K3** (``ops/join.unique_build_probe``) and probed by binary
  search; several keys or a string key take ``unique_union_lookup``. An
  inner or left-outer join gathers the build columns into the match
  positions with one **K4** launch; a gathered string column gets the
  batch's capacity times the build's longest string, and a batch past
  ``_FAST_MAX_CHAR_CAP`` takes the staged path.
- **The staged path** (``_join_batch``), for a build with a duplicated
  key: stage A (``ops/join.join_counts``: the union sort of both sides'
  keys on K3, the build's group order on K3) with its one readback a
  stream batch of the output rows and of each string column's bytes
  (``_sized_stage_a``), then the output indices and the gather, one K4
  launch a side (``_stage_bc``).
- **Right and full outer joins** (``_execute_outer_build``, the
  reference's ``:529-560``) always take the staged path: each stream
  batch joins as inner (right) or left_outer (full) while the build's
  matched mask ORs across the batches; then the unmatched live build
  rows go out once beside nulls of the stream side
  (``_null_side_batch``: the build's own columns under a lazy
  selection, where the reference runs one more staged join of an empty
  stream batch).
- **The cross join** (no keys, or the type ``cross``) runs the staged
  path in cross mode: stage A reads no keys and sorts nothing
  (``join_counts(..., cross=True)``), then the pair gather, one K4 a
  side. Pairs past the int32 indices raise (``_sized_stage_a``, ROADMAP
  item 14).
- **The nested-loop join** (``GpuBroadcastNestedLoopJoinExec``) takes a
  condition on every join type: each stream batch's pairs (the cross
  join's stage A and gather, in the condition's schema), the condition
  over them, then the matched masks from the pair layout
  (``ops/join.pair_matched_stream``, ``pair_matched_build``) with no
  scatter into one slot; unmatched rows go out beside nulls
  (``_null_side_batch``), semi and anti joins as the stream batch under
  a selection.

Without ``build_unique_hint`` the build is analysed first: one readback
a build of its most duplicated key and its string columns' longest live
strings (``ops/join.unique_build_analysis``), which also sizes the fast
path's chars; a duplicated key takes the staged path. With the hint and
a string column to gather the analysis runs as well, and a duplicated
key then warns (``RuntimeWarning``) and takes the staged path, unless
``spark.rapids.sql.join.verifyUniqueHint`` is off, which keeps the hint
unchecked. With the hint and no string to gather nothing is read back:
under ``verifyUniqueHint`` the build's duplicate flag becomes a deferred
check that raises at the query's download.

A condition on an outer, semi or anti equi-join keeps the node off the
device (``gpu_supported``, the reference's ``:127-131``), so the planner
runs it on the CPU. There it takes the nested-loop join's shape over the
equi-join's pairs (``_execute_conditioned``): each stream batch's
matching pairs (stage A as an inner join and its gather, in the
condition's schema), the condition over them, then the matched masks
(``pair_matched_stream``; the build's by a scatter-add of the passing
pairs onto their build rows) and the unmatched rows beside nulls, all
on CPU tensors. Its device ``execute`` raises, a backstop behind the
gate. The broadcast hash join waits for the adaptive join switch and
the broadcast exchange (items 10 and 17).
"""
from __future__ import annotations

import time
import warnings
from typing import List, Optional, Sequence

import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch, bucket_bytes, bucket_rows
from ..columnar.column import GpuColumnVector, is_string_like
from ..config import JOIN_VERIFY_UNIQUE_HINT
from ..expr.base import Expression, bind_expr
from ..ops.concat import concat_batches_bounded
from ..ops.gather import gather_columns
from ..ops.join import (JOIN_TYPES, build_dup_flag, join_counts,
                        join_gather, join_indices, join_output_bytes,
                        join_total, pair_matched_build,
                        pair_matched_stream, probe_unique,
                        unique_build_analysis, unique_build_probe,
                        unique_union_lookup)
from ..ops.sort_keys import check_key_type
from .base import ExecCtx, GpuExec, OpContract
from .basic import bind_all

__all__ = ["GpuShuffledHashJoinExec", "GpuCartesianProductExec",
           "GpuBroadcastNestedLoopJoinExec"]

_EMPTY_CAPACITY = 128
# the most chars the fast path gathers into a string column of one batch
# (stream capacity x the build's longest string); past it the staged
# path's exact sizing is the better trade (the reference's)
_FAST_MAX_CHAR_CAP = 1 << 28
# the most chars a gathered string column may hold: its offsets and the
# char positions of ops/strings.assemble_strings are int32
MAX_STRING_CHARS = (1 << 31) - 1
_SEMI = ("left_semi", "left_anti")
_OUTER_BUILD = ("right_outer", "full_outer")


def _join_output_schema(left: dt.Schema, right: dt.Schema,
                        join_type: str) -> dt.Schema:
    """The reference's (``:51-62``): a side that may be missing from an
    output row becomes nullable."""
    if join_type in _SEMI:
        return left
    lf, rf = list(left.fields), list(right.fields)
    if join_type in _OUTER_BUILD:
        lf = [dt.StructField(f.name, f.dtype, True) for f in lf]
    if join_type in ("left_outer", "full_outer"):
        rf = [dt.StructField(f.name, f.dtype, True) for f in rf]
    return dt.Schema(lf + rf)


def _and_sel(batch: GpuBatch, mask: torch.Tensor) -> torch.Tensor:
    """Selection for an output sharing ``batch``'s row layout."""
    return mask if batch.selection is None else batch.selection & mask


class _BaseJoinExec(GpuExec):
    """Equi-join of a streamed left side against a built right side; a
    cross join where there are no keys."""

    # the join types a condition may carry: a post-filter of the joined
    # rows is right only where a failed match emits no row
    CONDITION_JOIN_TYPES = ("inner", "cross")

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: GpuExec, right: GpuExec,
                 condition: Optional[Expression] = None,
                 build_unique_hint: bool = False):
        super().__init__()
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type}")
        # an unchecked contract that the build keys are unique (a
        # primary-key build side); verifyUniqueHint checks it
        self.build_unique_hint = build_unique_hint
        self.children = (left, right)
        self.join_type = join_type
        self.left_keys = bind_all(left_keys, left.output_schema)
        self.right_keys = bind_all(right_keys, right.output_schema)
        for lk, rk in zip(self.left_keys, self.right_keys):
            if lk.dtype != rk.dtype:
                raise TypeError(
                    f"join key type mismatch: {lk.dtype.simple_string()} "
                    f"vs {rk.dtype.simple_string()}")
            check_key_type(lk.dtype)
        self._schema = _join_output_schema(left.output_schema,
                                           right.output_schema, join_type)
        # a condition sees both sides even when the output is left-only
        self._cond_schema = dt.Schema(list(left.output_schema.fields)
                                      + list(right.output_schema.fields))
        self.condition = None
        if condition is not None:
            self.condition = bind_expr(condition, self._cond_schema)

    @property
    def left(self) -> GpuExec:
        return self.children[0]

    @property
    def right(self) -> GpuExec:
        return self.children[1]

    @property
    def output_schema(self):
        return self._schema

    @property
    def semi(self) -> bool:
        """The output holds the stream's columns only."""
        return self.join_type in _SEMI

    @property
    def cross(self) -> bool:
        """Every live pair matches (the reference's ``_cross``)."""
        return self.join_type == "cross" or not self.left_keys

    @property
    def outer_build(self) -> bool:
        """The build's unmatched rows are emitted too."""
        return self.join_type in _OUTER_BUILD

    def gathers_build_strings(self) -> bool:
        """The output gathers a string column of the build side."""
        return not self.semi and any(
            is_string_like(f.dtype) for f in self.right.output_schema)

    def analyses_build(self) -> bool:
        """The build is analysed (one readback): without the hint, or
        with it and a build string column to size."""
        return not self.build_unique_hint or self.gathers_build_strings()

    def describe(self):
        c = f" cond={self.condition!r}" if self.condition is not None \
            else ""
        return (f"{self.pretty_name()} [{self.join_type}] "
                f"keys={list(zip(self.left_keys, self.right_keys))}{c}")

    def expressions(self):
        out = list(self.left_keys) + list(self.right_keys)
        return out + ([self.condition] if self.condition is not None
                      else [])

    def expected_output_schema(self):
        return _join_output_schema(self.left.output_schema,
                                   self.right.output_schema,
                                   self.join_type)

    def expr_bindings(self):
        # left keys bind against the left child, right keys against the
        # right, the condition against both sides' columns as they are
        # now (not the cached _cond_schema)
        out = [(k, self.left.output_schema) for k in self.left_keys]
        out += [(k, self.right.output_schema) for k in self.right_keys]
        if self.condition is not None:
            cond = dt.Schema(list(self.left.output_schema.fields)
                             + list(self.right.output_schema.fields))
            out.append((self.condition, cond))
        return out

    def gpu_supported(self) -> Optional[str]:
        if self.condition is not None \
                and self.join_type not in self.CONDITION_JOIN_TYPES:
            return (f"a non-equi condition on a {self.join_type} "
                    "equi-join runs on the CPU")
        # a join's gather repeats rows, which a nested column's elements
        # would have to be sized for (the reference's ``:134-137,698``)
        for schema in (self.left.output_schema, self.right.output_schema):
            for f in schema.fields:
                if dt.is_nested(f.dtype):
                    return (f"join over nested column {f.name} "
                            f"({f.dtype.simple_string()}) not on device")
        return None

    def _emit(self, ctx: ExecCtx, batch: GpuBatch) -> GpuBatch:
        ctx.metric(self, "numOutputBatches").value += 1
        return batch

    def _build_right(self, ctx: ExecCtx):
        """``(batch, catalog entry)``: the build side as one batch
        (bounded concat, no readback), an empty batch where the join type
        still emits stream rows, or ``(None, None)`` when the result is
        empty (``:480-489``). The batch is registered in the spill
        catalog pinned (``:445-490``), so the ledger counts it and
        eviction never picks it; the caller releases it when the stream
        ends."""
        batches = list(self.right.execute(ctx))
        if batches:
            batch = concat_batches_bounded(batches)
        elif self.join_type in ("inner", "cross", "left_semi",
                                "right_outer"):
            return None, None
        else:
            cols = [GpuColumnVector.nulls(f.dtype, _EMPTY_CAPACITY,
                                          ctx.device)
                    for f in self.right.output_schema]
            batch = GpuBatch(cols, self.right.output_schema, 0)
        return batch, ctx.mm.register(batch, pinned=True)

    def _null_side_batch(self, batch: GpuBatch, keep: torch.Tensor,
                         stream_side: bool, ctx: ExecCtx) -> GpuBatch:
        """``batch``'s live rows where ``keep`` beside nulls of the other
        side, in the output schema: the batch's own columns under a lazy
        selection, so nothing moves (the reference compacts them)."""
        other = self.right if stream_side else self.left
        nulls = [GpuColumnVector.nulls(f.dtype, batch.capacity, ctx.device)
                 for f in other.output_schema]
        cols = list(batch.columns) + nulls if stream_side \
            else nulls + list(batch.columns)
        return GpuBatch(cols, self._schema, batch.row_count,
                        selection=_and_sel(batch, keep))

    # --- the staged path --------------------------------------------------

    def _stage_a(self, lbatch: GpuBatch, rbatch: GpuBatch, ectx, jt: str):
        """Stage A: the match plan, the output rows and each string
        column's output bytes, for the join type ``jt``."""
        lkeys = [k.eval_gpu(lbatch, ectx) for k in self.left_keys]
        rkeys = [k.eval_gpu(rbatch, ectx) for k in self.right_keys]
        plan = join_counts(lkeys, rkeys, lbatch.live_mask(),
                           rbatch.live_mask(), cross=self.cross)
        return plan, join_total(plan, jt), \
            join_output_bytes(plan, lbatch, rbatch, jt)

    @staticmethod
    def _char_caps(nbytes: List[int], lbatch: GpuBatch, rbatch: GpuBatch,
                   jt: str) -> List[int]:
        """Each output column's chars (0 for a fixed-width column), the
        stream's columns first."""
        cols = list(lbatch.columns) + ([] if jt in _SEMI
                                       else list(rbatch.columns))
        it = iter(nbytes)
        return [bucket_bytes(max(next(it), 1)) if c.is_string_like else 0
                for c in cols]

    def _sized_stage_a(self, lbatch: GpuBatch, rbatch: GpuBatch,
                       ctx: ExecCtx, jt: str):
        """Stage A and its one readback: ``(plan, total, out_cap,
        char_caps)``."""
        ctx.metric(self, "stagedBatches").value += 1
        plan, total, nbytes = self._stage_a(lbatch, rbatch, ctx.eval_ctx,
                                            jt)
        sizes = torch.cat([total.reshape(1), nbytes]).tolist()
        total = sizes[0]
        char_caps = self._char_caps(sizes[1:], lbatch, rbatch, jt)
        if max([total] + char_caps) > MAX_STRING_CHARS:
            raise NotImplementedError(
                f"{self.node_label()} would emit {total} rows and up to "
                f"{max(char_caps, default=0)} chars of a string column "
                f"from one stream batch, past the int32 indices and "
                f"offsets' {MAX_STRING_CHARS}; the split of such a stream "
                "batch is not ported yet (ROADMAP item 14's split)")
        return plan, total, bucket_rows(total), char_caps

    @staticmethod
    def _stage_bc(plan, jt: str, total: int, out_cap: int,
                  char_caps: List[int], lbatch: GpuBatch, rbatch: GpuBatch,
                  schema: dt.Schema) -> GpuBatch:
        """Stages B and C: the output indices, then the gather."""
        lidx, ridx, lvalid, rvalid = join_indices(plan, jt, out_cap)
        if jt in _SEMI:
            return GpuBatch(gather_columns(lbatch.columns, lidx, lvalid,
                                           char_caps), schema, total)
        return join_gather(lbatch, rbatch, lidx, ridx, lvalid, rvalid,
                           total, schema, char_caps)

    def _join_batch(self, lbatch: GpuBatch, rbatch: GpuBatch,
                    ctx: ExecCtx, jt: Optional[str] = None):
        """The staged join of one stream batch as ``jt`` (the exec's type
        by default; the outer loop passes each batch's): ``(output, stage
        A's plan)``, the output a prefix layout sized by stage A's
        readback; an inner or cross join's condition marks its rows with
        the lazy selection."""
        jt = jt or self.join_type
        plan, total, out_cap, char_caps = self._sized_stage_a(
            lbatch, rbatch, ctx, jt)
        out = self._stage_bc(plan, jt, total, out_cap, char_caps, lbatch,
                             rbatch, self._schema)
        if self.condition is not None:
            pred = self.condition.eval_gpu(out, ctx.eval_ctx)
            keep = pred.data if pred.validity is None \
                else pred.data & pred.validity
            out = out.with_selection(keep)
        return out, plan

    # --- the fast path (a unique build) -----------------------------------

    def _fast_build_info(self, rbatch: GpuBatch, ctx: ExecCtx):
        """None (the staged path), or how the fast path probes this build:
        ``{"probe": presorted key or None (the union lookup), "maxlens":
        each build string column's longest live string}``. It costs at
        most one readback a build."""
        verify = ctx.conf.get(JOIN_VERIFY_UNIQUE_HINT)
        live_r = rbatch.live_mask()
        rkeys = [k.eval_gpu(rbatch, ctx.eval_ctx) for k in self.right_keys]
        maxlens: List[int] = []
        if self.analyses_build():
            facts = unique_build_analysis(
                rkeys, live_r, [] if self.semi else rbatch.columns).tolist()
            max_dup, maxlens = facts[0], facts[1:]
            if max_dup > 1 and (verify or not self.build_unique_hint):
                if self.build_unique_hint:
                    warnings.warn(
                        f"build_unique hint is FALSE on {self.node_label()}"
                        f" (max key duplication {max_dup}); reverting to "
                        "the staged join path", RuntimeWarning)
                return None
        probe, dup = None, None
        if len(rkeys) == 1 and not rkeys[0].is_string_like:
            rk_sorted, perm, n_elig, dup = unique_build_probe(rkeys[0],
                                                              live_r)
            probe = (rk_sorted, perm, n_elig)
        if self.build_unique_hint and verify and not self.analyses_build():
            if dup is None:
                dup = build_dup_flag(rkeys, live_r)
            ctx.add_deferred_check(
                dup,
                f"build_unique hint violated on {self.node_label()}: the "
                "build side has duplicate join keys, so fast-path results "
                "dropped matches. Remove build_unique=True or set "
                "spark.rapids.sql.join.verifyUniqueHint=false to accept "
                "the hint unchecked.")
        return {"probe": probe, "maxlens": maxlens}

    def _fast_char_caps(self, lbatch: GpuBatch, rbatch: GpuBatch,
                        info) -> Optional[List[int]]:
        """The gathered build columns' chars, or None when a string
        column would pass ``_FAST_MAX_CHAR_CAP`` (the batch goes staged).
        """
        caps, it = [], iter(info["maxlens"])
        for c in rbatch.columns:
            if not c.is_string_like:
                caps.append(0)
                continue
            need = lbatch.capacity * max(next(it), 1)
            if need > _FAST_MAX_CHAR_CAP:
                return None
            caps.append(bucket_bytes(need))
        return caps

    def _fast_join_batch(self, lbatch: GpuBatch, rbatch: GpuBatch, info,
                         ectx) -> Optional[GpuBatch]:
        """One stream batch on the fast path: output capacity = stream
        capacity, the emitted rows marked by the selection; None when its
        chars fall outside the fast path."""
        jt = self.join_type
        caps = [] if self.semi else self._fast_char_caps(lbatch, rbatch,
                                                         info)
        if caps is None:
            return None
        live_l = lbatch.live_mask()
        lkeys = [k.eval_gpu(lbatch, ectx) for k in self.left_keys]
        eligible_l = live_l
        for k in lkeys:
            if k.validity is not None:
                eligible_l = eligible_l & k.validity
        if info["probe"] is not None:
            ridx, matched = probe_unique(lkeys[0], eligible_l,
                                         *info["probe"])
        else:
            live_r = rbatch.live_mask()
            rkeys = [k.eval_gpu(rbatch, ectx) for k in self.right_keys]
            eligible_r = live_r
            for k in rkeys:
                if k.validity is not None:
                    eligible_r = eligible_r & k.validity
            ridx, matched = unique_union_lookup(
                lkeys, rkeys, live_l, live_r, eligible_l, eligible_r)
        if jt == "left_semi":
            return GpuBatch(lbatch.columns, self._schema, lbatch.row_count,
                            selection=_and_sel(lbatch, matched))
        if jt == "left_anti":
            return GpuBatch(lbatch.columns, self._schema, lbatch.row_count,
                            selection=_and_sel(lbatch, live_l & ~matched))
        out_cols = list(lbatch.columns) \
            + gather_columns(rbatch.columns, ridx, matched, caps,
                             repeat=True)
        if jt == "inner":
            sel = matched
            if self.condition is not None:
                tmp = GpuBatch(out_cols, self._cond_schema,
                               lbatch.row_count, selection=sel)
                pred = self.condition.eval_gpu(tmp, ectx)
                sel = sel & pred.data
                if pred.validity is not None:
                    sel = sel & pred.validity
            return GpuBatch(out_cols, self._schema, lbatch.row_count,
                            selection=_and_sel(lbatch, sel))
        # left_outer: every live stream row emits exactly once
        return GpuBatch(out_cols, self._schema, lbatch.row_count,
                        selection=lbatch.selection)

    # --- a condition on every join type -----------------------------------

    def _pairs(self, lbatch: GpuBatch, rbatch: GpuBatch, ctx: ExecCtx):
        """``(pair batch, ok, plan, pairs, matched build rows or None)``:
        the stream batch's pairs in the condition's schema (every live
        pair without keys: the cross join's stage A; with keys the
        inner join's matches), the pairs that pass the condition, stage
        A's plan, the pair count, and with keys the build rows with a
        passing pair."""
        jt = "cross" if self.cross else "inner"
        plan, total, out_cap, char_caps = self._sized_stage_a(
            lbatch, rbatch, ctx, jt)
        lidx, ridx, lvalid, rvalid = join_indices(plan, jt, out_cap)
        pair = join_gather(lbatch, rbatch, lidx, ridx, lvalid, rvalid,
                           total, self._cond_schema, char_caps)
        pred = self.condition.eval_gpu(pair, ctx.eval_ctx)
        ok = pair.live_mask() & pred.data
        if pred.validity is not None:
            ok = ok & pred.validity
        hit_r = None
        if not self.cross:
            hit_r = torch.zeros(rbatch.capacity, dtype=torch.int32,
                                device=ok.device).index_add_(
                0, ridx.long(), ok.to(torch.int32)) > 0
        return pair, ok, plan, total, hit_r

    def _execute_conditioned(self, ctx: ExecCtx):
        """Every join type under a condition, from each stream batch's
        pairs (``_pairs``): the passing pairs under a selection, the
        unmatched rows beside nulls, semi and anti joins as the stream
        batch under a selection; the build's matched mask ORs across
        stream batches for right and full outer joins."""
        op_time = ctx.metric(self, "opTime")
        t0 = time.perf_counter()
        rbatch, rsb = self._build_right(ctx)
        if rbatch is None:
            op_time.value += time.perf_counter() - t0
            return
        try:
            yield from self._conditioned_stream(rbatch, ctx, op_time, t0)
        finally:
            rsb.release()

    def _conditioned_stream(self, rbatch: GpuBatch, ctx: ExecCtx, op_time,
                            t0: float):
        jt = self.join_type
        ctx.metric(self, "uniqueBuild").set(0)
        matched_r = torch.zeros(rbatch.capacity, dtype=torch.bool,
                                device=ctx.device)
        # the build's live rows, read once a build: a cross plan's pair
        # row length
        live_r = int(rbatch.live_mask().sum()) \
            if self.outer_build and self.cross else 0
        op_time.value += time.perf_counter() - t0
        for lbatch in self.left.execute(ctx):
            t0 = time.perf_counter()
            pair, ok, plan, total, hit_r = self._pairs(lbatch, rbatch, ctx)
            outs = []
            if not self.semi:
                outs.append(GpuBatch(pair.columns, self._schema,
                                     pair.row_count, selection=ok))
            if self.outer_build:
                matched_r |= hit_r if hit_r is not None \
                    else pair_matched_build(plan, ok, total, live_r)
            if jt in ("left_outer", "full_outer"):
                outs.append(self._null_side_batch(
                    lbatch, ~pair_matched_stream(plan, ok), True, ctx))
            elif self.semi:
                matched_l = pair_matched_stream(plan, ok)
                keep = matched_l if jt == "left_semi" else ~matched_l
                outs.append(GpuBatch(lbatch.columns, self._schema,
                                     lbatch.row_count,
                                     selection=_and_sel(lbatch, keep)))
            op_time.value += time.perf_counter() - t0
            for out in outs:
                yield self._emit(ctx, out)
        if self.outer_build:
            yield self._emit(ctx, self._null_side_batch(rbatch, ~matched_r,
                                                        False, ctx))

    def execute(self, ctx: ExecCtx):
        if self.condition is not None \
                and self.join_type not in self.CONDITION_JOIN_TYPES:
            if not ctx.eval_ctx.host:
                raise NotImplementedError(
                    f"{self.node_label()}: {self.gpu_supported()}; the "
                    "planner places it there")
            yield from self._execute_conditioned(ctx)
            return
        op_time = ctx.metric(self, "opTime")
        t0 = time.perf_counter()
        rbatch, rsb = self._build_right(ctx)
        if rbatch is None:
            op_time.value += time.perf_counter() - t0
            return
        try:
            yield from self._equi_stream(rbatch, ctx, op_time, t0)
        finally:
            rsb.release()

    def _equi_stream(self, rbatch: GpuBatch, ctx: ExecCtx, op_time,
                     t0: float):
        fast = None
        if not (self.cross or self.outer_build):
            fast = self._fast_build_info(rbatch, ctx)
        ctx.metric(self, "uniqueBuild").set(int(fast is not None))
        op_time.value += time.perf_counter() - t0
        if self.outer_build:
            yield from self._execute_outer_build(rbatch, ctx, op_time)
            return
        for lbatch in self.left.execute(ctx):
            t0 = time.perf_counter()
            out = None
            if fast is not None:
                out = self._fast_join_batch(lbatch, rbatch, fast,
                                            ctx.eval_ctx)
            if out is None:
                out, _ = self._join_batch(lbatch, rbatch, ctx)
            op_time.value += time.perf_counter() - t0
            yield self._emit(ctx, out)

    def _execute_outer_build(self, rbatch: GpuBatch, ctx: ExecCtx,
                             op_time):
        """Right and full outer joins (``:529-560``): each stream batch
        joins as inner (right) or left_outer (full) while the build's
        matched mask ORs across the batches; then the unmatched live
        build rows, once. With no stream batch every build row is
        unmatched."""
        chunk_jt = "inner" if self.join_type == "right_outer" \
            else "left_outer"
        matched = torch.zeros(rbatch.capacity, dtype=torch.bool,
                              device=ctx.device)
        for lbatch in self.left.execute(ctx):
            t0 = time.perf_counter()
            out, plan = self._join_batch(lbatch, rbatch, ctx, chunk_jt)
            matched |= plan.matched_r
            op_time.value += time.perf_counter() - t0
            yield self._emit(ctx, out)
        t0 = time.perf_counter()
        out = self._null_side_batch(rbatch, ~matched, False, ctx)
        op_time.value += time.perf_counter() - t0
        yield self._emit(ctx, out)


class GpuShuffledHashJoinExec(_BaseJoinExec):
    """Shuffled hash join (``GpuShuffledHashJoinExec``): the local join
    core. SQL's comma joins plan it with no exchange below, as the
    reference's compiler does."""

    CONTRACT = OpContract(
        requires_copartition=True,
        notes="children that are both shuffle exchanges must agree on "
              "partitioning scheme and partition count; join keys must "
              "be primitive")


class GpuCartesianProductExec(_BaseJoinExec):
    """The cross join (``GpuCartesianProductExec``, the reference's
    ``:671-675``): every live pair, an optional condition filtering them
    as an inner join's does."""

    def __init__(self, left: GpuExec, right: GpuExec,
                 condition: Optional[Expression] = None):
        super().__init__([], [], "cross", left, right, condition)


class GpuBroadcastNestedLoopJoinExec(_BaseJoinExec):
    """The nested-loop join (``GpuBroadcastNestedLoopJoinExec``, the
    reference's ``:677-807``): every (stream row, build row) pair is
    tested against the condition, for every join type. Each stream batch
    makes its pairs by the cross join's stage A and gather in the
    condition's schema (``_pairs``); the pairs that pass go out under a
    selection, relabelled to the output schema's nullability, and the
    matched masks come from the pair layout. The build's matched mask ORs
    across stream batches for right and full outer joins. Without a
    condition it is the cross join's staged path, for the join type
    given."""

    CONDITION_JOIN_TYPES = JOIN_TYPES

    def __init__(self, join_type: str, left: GpuExec, right: GpuExec,
                 condition: Optional[Expression] = None):
        super().__init__([], [], join_type, left, right, condition)

    def execute(self, ctx: ExecCtx):
        if self.condition is None:
            yield from super().execute(ctx)
            return
        yield from self._execute_conditioned(ctx)

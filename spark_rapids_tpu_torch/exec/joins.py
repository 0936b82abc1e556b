"""Join operators: the shuffled hash join on a unique build side.

Counterpart of ``spark_rapids_tpu/exec/joins.py:46-438,491-527``
(``_BaseJoinExec``, ``TpuShuffledHashJoinExec``), the sync-free fast
path for ``inner``, ``left_outer``, ``left_semi`` and ``left_anti`` on a
single fixed-width key. The build (right) side is concatenated once and
its key presorted by **K3** (``ops/join.unique_build_probe``); each
stream (left) batch then joins with no size readback: the output keeps
the stream batch's capacity, the build columns are gathered into the
match positions by one **K4** launch, and the emitted rows are the lazy
selection mask.

With ``build_unique_hint`` the build is trusted to have unique keys and,
under ``spark.rapids.sql.join.verifyUniqueHint`` (default on), the
presort's duplicate flag becomes a deferred check that raises at the
query's download. Without the hint the build is analysed first (one
readback per build). A build side with string columns (an inner or
left-outer join gathers them) reads back its longest string once per
build, as the reference's analysis does (``exec/joins.py:290-310``):
a stream batch's gathered chars get the batch's capacity times that
length. Where the reference would take its staged join (a
duplicated build key, another join type, no keys) or its union lookup
(several keys), the port raises ``NotImplementedError``: those wait for
ROADMAP item 9.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch, bucket_bytes
from ..columnar.column import GpuColumnVector, is_string_like, torch_dtype
from ..config import JOIN_VERIFY_UNIQUE_HINT
from ..expr.base import Expression, bind_expr
from ..ops.concat import concat_batches_bounded
from ..ops.gather import gather_columns
from ..ops.join import (JOIN_TYPES, probe_unique, unique_build_analysis,
                        unique_build_probe)
from ..ops.sort_keys import check_key_type
from .base import ExecCtx, GpuExec
from .basic import bind_all

__all__ = ["GpuShuffledHashJoinExec"]

_FAST_JOIN_TYPES = ("inner", "left_outer", "left_semi", "left_anti")
_EMPTY_CAPACITY = 128


def _join_output_schema(left: dt.Schema, right: dt.Schema,
                        join_type: str) -> dt.Schema:
    if join_type in ("left_semi", "left_anti"):
        return left
    rf = list(right.fields)
    if join_type == "left_outer":
        rf = [dt.StructField(f.name, f.dtype, True) for f in rf]
    return dt.Schema(list(left.fields) + rf)


def _and_sel(batch: GpuBatch, mask: torch.Tensor) -> torch.Tensor:
    """Selection for an output sharing ``batch``'s row layout."""
    return mask if batch.selection is None else batch.selection & mask


# the most chars a gathered string column may hold: its offsets and the
# char positions of ops/strings.assemble_strings are int32
MAX_STRING_CHARS = (1 << 31) - 1


def _staged(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the staged join (join_counts / join_indices / "
        "join_gather) or the union lookup, which are not ported yet "
        "(ROADMAP item 9)")


class _BaseJoinExec(GpuExec):
    """Equi-join of a streamed left side against a built right side."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: str,
                 left: GpuExec, right: GpuExec,
                 condition: Optional[Expression] = None,
                 build_unique_hint: bool = False):
        super().__init__()
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type}")
        if join_type not in _FAST_JOIN_TYPES or not left_keys:
            raise _staged(f"a {join_type} join")
        if len(left_keys) != 1 or len(right_keys) != 1:
            raise _staged("a join on several keys")
        # an unchecked contract that the build keys are unique (a
        # primary-key build side); verifyUniqueHint checks it at the
        # download
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
            if is_string_like(lk.dtype):
                raise _staged("a join on a string key (ranks over both "
                              "sides, string_order_ranks_multi)")
        self._schema = _join_output_schema(left.output_schema,
                                           right.output_schema, join_type)
        # a condition sees both sides even when the output is left-only
        self._cond_schema = dt.Schema(list(left.output_schema.fields)
                                      + list(right.output_schema.fields))
        self.condition = None
        if condition is not None:
            if join_type != "inner":
                raise NotImplementedError(
                    f"non-equi condition on a {join_type} join is not on "
                    "the device")
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

    def describe(self):
        c = f" cond={self.condition!r}" if self.condition is not None \
            else ""
        return (f"{self.pretty_name()} [{self.join_type}] "
                f"keys={list(zip(self.left_keys, self.right_keys))}{c}")

    def expressions(self):
        out = list(self.left_keys) + list(self.right_keys)
        return out + ([self.condition] if self.condition is not None
                      else [])

    def _build_right(self, ctx: ExecCtx) -> Optional[GpuBatch]:
        """The build side as one batch (bounded concat, no readback), an
        empty batch where the join type still emits stream rows, or None
        when the result is empty."""
        batches = list(self.right.execute(ctx))
        if batches:
            return concat_batches_bounded(batches)
        if self.join_type in ("inner", "left_semi"):
            return None
        cols = [GpuColumnVector(f.dtype, torch.zeros(
                    _EMPTY_CAPACITY, dtype=torch_dtype(f.dtype),
                    device=ctx.device)) for f in self.right.output_schema]
        return GpuBatch(cols, self.right.output_schema, 0)

    def _string_maxlens(self, rbatch: GpuBatch) -> list:
        """The longest string of each build column the join gathers
        (0 for the others): one readback, only when there is one."""
        if self.join_type in ("left_semi", "left_anti"):
            return []
        strs = [c for c in rbatch.columns if c.is_string_like]
        if not strs:
            return [0] * len(rbatch.columns)
        live = rbatch.live_mask()
        found = torch.stack([
            torch.where(live, c.lengths(), torch.zeros_like(c.lengths()))
            .max() for c in strs]).cpu().tolist()
        it = iter(found)
        return [next(it) if c.is_string_like else 0
                for c in rbatch.columns]

    def _probe_build(self, rbatch: GpuBatch, ctx: ExecCtx):
        """Presort the build key once: ``(rk_sorted, perm, n_elig)``."""
        live_r = rbatch.live_mask()
        rkey = self.right_keys[0].eval_gpu(rbatch, ctx.eval_ctx)
        if not self.build_unique_hint:
            max_dup = int(unique_build_analysis([rkey], live_r)[0])
            if max_dup > 1:
                raise _staged(f"a build side with duplicated join keys "
                              f"(up to {max_dup} rows a key) on "
                              f"{self.node_label()}")
        rk_sorted, perm, n_elig, dup = unique_build_probe(rkey, live_r)
        if self.build_unique_hint and ctx.conf.get(JOIN_VERIFY_UNIQUE_HINT):
            ctx.add_deferred_check(
                dup,
                f"build_unique hint violated on {self.node_label()}: the "
                "build side has duplicate join keys, so fast-path results "
                "dropped matches. Remove build_unique=True or set "
                "spark.rapids.sql.join.verifyUniqueHint=false to accept "
                "the hint unchecked.")
        return rk_sorted, perm, n_elig

    def _join_batch(self, lbatch: GpuBatch, rbatch: GpuBatch, probe,
                    maxlens, ectx) -> GpuBatch:
        """One stream batch: output capacity = stream capacity, the
        emitted rows marked by the selection."""
        jt = self.join_type
        live_l = lbatch.live_mask()
        lkey = self.left_keys[0].eval_gpu(lbatch, ectx)
        eligible_l = live_l if lkey.validity is None \
            else live_l & lkey.validity
        ridx, matched = probe_unique(lkey, eligible_l, *probe)
        if jt == "left_semi":
            return GpuBatch(lbatch.columns, self._schema, lbatch.row_count,
                            selection=_and_sel(lbatch, matched))
        if jt == "left_anti":
            return GpuBatch(lbatch.columns, self._schema, lbatch.row_count,
                            selection=_and_sel(lbatch, live_l & ~matched))
        caps = [bucket_bytes(lbatch.capacity * max(m, 1))
                if c.is_string_like else 0
                for c, m in zip(rbatch.columns, maxlens)]
        if max(caps, default=0) > MAX_STRING_CHARS:
            raise NotImplementedError(
                f"{self.node_label()} would gather {max(caps)} chars of a "
                f"string column into one batch of {lbatch.capacity} rows, "
                f"past the int32 offsets' {MAX_STRING_CHARS}; splitting "
                "the stream batch waits for the memory manager (ROADMAP "
                "item 14)")
        out_cols = list(lbatch.columns) \
            + gather_columns(rbatch.columns, ridx, matched, caps)
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

    def execute(self, ctx: ExecCtx):
        op_time = ctx.metric(self, "opTime")
        t0 = time.perf_counter()
        rbatch = self._build_right(ctx)
        if rbatch is None:
            op_time.value += time.perf_counter() - t0
            return
        probe = self._probe_build(rbatch, ctx)
        maxlens = self._string_maxlens(rbatch)
        op_time.value += time.perf_counter() - t0
        for lbatch in self.left.execute(ctx):
            t0 = time.perf_counter()
            out = self._join_batch(lbatch, rbatch, probe, maxlens,
                                   ctx.eval_ctx)
            op_time.value += time.perf_counter() - t0
            yield out


class GpuShuffledHashJoinExec(_BaseJoinExec):
    """Shuffled hash join (``GpuShuffledHashJoinExec``): the local join
    core. SQL's comma joins plan it with no exchange below, as the
    reference's compiler does."""

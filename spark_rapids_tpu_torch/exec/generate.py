"""Generate: ``explode`` and ``posexplode``, with and without ``outer``,
over arrays and maps.

Counterpart of ``spark_rapids_tpu/exec/generate.py:59-270``
(``TpuGenerateExec``), in the reference's three stages:

- A: each row's emit count (its array's length among the live non-null
  rows; at least 1 a live row under ``outer``), and the total, read back
  once: the port's batch keeps its row count on the host, so that one
  readback sizes the output (``bucket_rows``);
- B: each output row's source row by a search over the emit counts'
  prefix sums (torch glue, as ``ops/strings.assemble_strings``), its
  position within the array, and the bytes every repeated string column
  needs at that fan-out (one readback for all of them);
- C: the repeated columns gathered by source row in one **K4** launch
  (``_gather_repeated``: a struct's children ride it, a string nested in
  a struct is sized by its own readback), and the generator's element
  columns (a map's keys and values) by element index in one more.

Each source element appears at most once in the output, so the element
columns keep their capacity. A repeated array or map column (one that
the fan-out would duplicate) keeps the operator on the CPU
(``gpu_supported``, the reference's), where the gather sizes its
elements to the output. An output past an int32 row count is ROADMAP
item 14's split: it raises, as the join does.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch, bucket_bytes, bucket_rows
from ..columnar.column import GpuColumnVector, is_list_type
from ..expr.base import BoundReference, Expression, bind_expr
from ..ops.gather import element_rows, gather_columns, list_offsets
from .base import ExecCtx, GpuExec, UnaryExec

__all__ = ["GpuGenerateExec"]

_MAX_ROWS = (1 << 31) - 1  # an int32 row index's reach


def _has_list(t: dt.DataType) -> bool:
    if is_list_type(t):
        return True
    if isinstance(t, dt.StructType):
        return any(_has_list(f.dtype) for f in t.fields)
    return False


class GpuGenerateExec(UnaryExec):
    """``explode(expr)`` after the child's other columns (Spark's
    Generate; a generator that is a plain column is dropped from the
    output, as Spark prunes it)."""

    def __init__(self, generator: Expression, child: GpuExec,
                 outer: bool = False, position: bool = False,
                 element_name: str = "col", pos_name: str = "pos"):
        super().__init__(child)
        self.generator = bind_expr(generator, child.output_schema)
        self.outer = outer
        self.position = position
        gt = self.generator.dtype
        if not is_list_type(gt):
            raise TypeError(
                f"explode needs array/map input, got {gt.simple_string()}")
        self.is_map = isinstance(gt, dt.MapType)
        gen_ord = self.generator.ordinal \
            if isinstance(self.generator, BoundReference) else None
        self.keep_ordinals = [i for i in range(len(child.output_schema))
                              if i != gen_ord]
        kept = [child.output_schema.fields[i] for i in self.keep_ordinals]
        gen_fields = []
        if position:
            gen_fields.append(dt.StructField(pos_name, dt.INT32, outer))
        if self.is_map:
            gen_fields += [dt.StructField("key", gt.key_type, outer),
                           dt.StructField("value", gt.value_type, True)]
        else:
            gen_fields.append(dt.StructField(element_name,
                                             gt.element_type, True))
        self._schema = dt.Schema(kept + gen_fields)
        self._kept_schema = dt.Schema(kept)

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        fn = "posexplode" if self.position else "explode"
        if self.outer:
            fn += "_outer"
        return f"GenerateExec [{fn}({self.generator!r})]"

    def expressions(self):
        return [self.generator]

    def gpu_supported(self) -> Optional[str]:
        for f in self._kept_schema.fields:
            if _has_list(f.dtype):
                return ("explode with repeated array/map columns not on "
                        "device (element-capacity sizing is per string "
                        "lane only)")
        return None

    def _stage_a(self, batch: GpuBatch, ectx):
        """``(emit, real, gcol, total)``: emit counts, array lengths of
        the live non-null rows, the generator column and the output's
        row count (read back)."""
        gcol = self.generator.eval_gpu(batch, ectx)
        live = batch.live_mask()
        if gcol.validity is not None:
            live_valid = live & gcol.validity
        else:
            live_valid = live
        lens = gcol.offsets[1:] - gcol.offsets[:-1]
        real = torch.where(live_valid, lens, torch.zeros_like(lens))
        emit = torch.where(live, real.clamp(min=1), torch.zeros_like(real)) \
            if self.outer else real
        total = int(emit.sum(dtype=torch.int64))
        if total > _MAX_ROWS:
            raise NotImplementedError(
                f"{self.node_label()}: an explode of {total} rows from one "
                "batch passes an int32 row index; splitting the batch is "
                "ROADMAP item 14's split")
        return emit, real, gcol, total

    def _stage_b(self, out_cap: int, emit, real, gcol, kept: GpuBatch):
        """Each output row's source row ``lidx``, its position ``k``, its
        element index, the live and real-element masks, and the bytes of
        each repeated string column at this fan-out (one readback)."""
        row, k, elem_idx, live_out = element_rows(
            list_offsets(emit), gcol.offsets[:-1], out_cap,
            gcol.children[0].capacity)
        lidx = row.to(torch.int32)
        is_real = live_out & (k < real[row])
        counts = [torch.where(live_out, c.lengths()[lidx],
                              torch.zeros_like(k)).sum(dtype=torch.int64)
                  for c in kept.columns if c.is_string_like]
        nbytes = torch.stack(counts).tolist() if counts else []
        return lidx, k, elem_idx, live_out, is_real, nbytes

    def _gather_repeated(self, kept: GpuBatch, lidx, live_out,
                         nbytes: List[int]) -> List[GpuColumnVector]:
        """The repeated columns by source row, in one K4 launch: a
        top-level string holds the bytes stage B counted, anything nested
        is sized by the gather (``repeat``)."""
        it = iter(nbytes)
        caps = [bucket_bytes(max(next(it), 1)) if c.is_string_like else 0
                for c in kept.columns]
        return gather_columns(kept.columns, lidx, live_out, caps,
                              repeat=True)

    def _explode(self, batch: GpuBatch, ectx) -> GpuBatch:
        emit, real, gcol, total = self._stage_a(batch, ectx)
        kept = GpuBatch([batch.columns[i] for i in self.keep_ordinals],
                        self._kept_schema, batch.row_count, batch.selection)
        out_cap = bucket_rows(total)
        lidx, k, elem_idx, live_out, is_real, nbytes = self._stage_b(
            out_cap, emit, real, gcol, kept)
        cols = self._gather_repeated(kept, lidx, live_out, nbytes) \
            if kept.columns else []
        if self.position:
            cols.append(GpuColumnVector(
                dt.INT32, torch.where(live_out, k, torch.zeros_like(k)),
                is_real if self.outer else live_out))
        if gcol.children[0].capacity:
            cols.extend(gather_columns(gcol.children, elem_idx, is_real))
        else:
            cols.extend(GpuColumnVector.nulls(ch.dtype, out_cap, k.device)
                        for ch in gcol.children)
        return GpuBatch(cols, self._schema, total)

    def execute(self, ctx: ExecCtx):
        op_time = ctx.metric(self, "opTime")
        for batch in self.child.execute(ctx):
            t0 = time.perf_counter()
            out = self._explode(batch, ctx.eval_ctx)
            op_time.value += time.perf_counter() - t0
            yield out

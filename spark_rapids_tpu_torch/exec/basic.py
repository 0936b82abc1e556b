"""Basic physical operators: project and the lazy filter.

Counterpart of ``spark_rapids_tpu/exec/basic.py:30-133``
(``TpuProjectExec``, ``TpuFilterExec``). The filter attaches a selection
mask and clears the validity of the rows it drops, instead of
compacting (``:106-118``). ``TpuRangeExec`` waits for a later slice.
"""
from __future__ import annotations

from typing import List, Sequence

from .. import datatypes as dt
from ..columnar.batch import GpuBatch
from ..expr.base import Expression, bind_expr
from .base import ExecCtx, GpuExec, OpContract, UnaryExec, fused_batches

__all__ = ["GpuProjectExec", "GpuFilterExec", "output_schema_for",
           "bind_all"]


def output_schema_for(exprs: Sequence[Expression]) -> dt.Schema:
    fields = []
    for i, e in enumerate(exprs):
        name = e.name if hasattr(e, "name") else f"col{i}"
        fields.append(dt.StructField(name, e.dtype, e.nullable))
    return dt.Schema(fields)


def bind_all(exprs: Sequence[Expression], schema: dt.Schema) \
        -> List[Expression]:
    return [bind_expr(e, schema) for e in exprs]


class GpuProjectExec(UnaryExec):
    """Expression evaluation over each batch."""

    def __init__(self, exprs: Sequence[Expression], child: GpuExec):
        super().__init__(child)
        self.exprs = bind_all(exprs, child.output_schema)
        self._schema = output_schema_for(self.exprs)

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        return f"ProjectExec [{', '.join(map(repr, self.exprs))}]"

    def expressions(self):
        return list(self.exprs)

    def _run(self, batch: GpuBatch, ectx) -> GpuBatch:
        cols = [e.eval_gpu(batch, ectx) for e in self.exprs]
        return GpuBatch(cols, self._schema, batch.row_count,
                        batch.selection)

    def device_fn(self):
        return self._run

    def execute(self, ctx: ExecCtx):
        yield from fused_batches(self, ctx, tail_fn=self._run,
                                 metric=ctx.metric(self, "opTime"))


class GpuFilterExec(UnaryExec):
    """Lazy boolean filter: a selection mask plus ``validity &= keep``."""

    CONTRACT = OpContract(
        schema_preserving=True,
        notes="output rows are a subset of the input; schema passes "
              "through unchanged")

    def __init__(self, condition: Expression, child: GpuExec):
        super().__init__(child)
        self.condition = bind_expr(condition, child.output_schema)
        if not isinstance(self.condition.dtype, dt.BooleanType):
            raise TypeError(
                f"filter condition must be boolean, got "
                f"{self.condition.dtype.simple_string()}")

    def describe(self):
        return f"FilterExec [{self.condition!r}]"

    def expressions(self):
        return [self.condition]

    def _run(self, batch: GpuBatch, ectx) -> GpuBatch:
        pred = self.condition.eval_gpu(batch, ectx)
        # SQL filter keeps only rows where the predicate is TRUE (not null)
        keep = pred.data if pred.validity is None \
            else pred.data & pred.validity
        out = batch.with_selection(keep)
        # dropped rows also become invalid, so every null-aware consumer
        # skips them as if they were gone
        out.columns = [c.with_validity(keep if c.validity is None
                                       else c.validity & keep)
                       for c in out.columns]
        return out

    def device_fn(self):
        return self._run

    def execute(self, ctx: ExecCtx):
        yield from fused_batches(self, ctx, tail_fn=self._run,
                                 metric=ctx.metric(self, "opTime"))

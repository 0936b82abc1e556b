"""UNION ALL.

Counterpart of ``spark_rapids_tpu/exec/misc.py:25-88`` (``TpuUnionExec``).
``TpuExpandExec`` (the ROLLUP/CUBE backbone) and ``TpuSampleExec`` from
the same file wait for ROADMAP item 13.
"""
from __future__ import annotations

from typing import Sequence

from .. import datatypes as dt
from .base import ExecCtx, GpuExec

__all__ = ["GpuUnionExec"]


class GpuUnionExec(GpuExec):
    """UNION ALL: the children's batches streamed in child order. The
    children share their column types (the SQL compiler and the
    DataFrame layer insert casts); a field is nullable when it is in any
    child, as Spark has it. Names are the first child's."""

    def __init__(self, children: Sequence[GpuExec]):
        super().__init__()
        if not children:
            raise ValueError("union needs at least one child")
        self.children = tuple(children)
        first = children[0].output_schema
        for c in children[1:]:
            if c.output_schema.types != first.types:
                raise TypeError(
                    f"union children schemas differ: {first.types} vs "
                    f"{c.output_schema.types}")
        self._schema = dt.Schema([
            dt.StructField(
                f.name, f.dtype,
                any(c.output_schema.fields[i].nullable for c in children))
            for i, f in enumerate(first.fields)])

    @property
    def output_schema(self):
        return self._schema

    def expected_output_schema(self):
        # the widths and types first: a rebuilt child narrower than the
        # first raises here, which the verifier names schema_mismatch
        first = self.children[0].output_schema
        for c in self.children[1:]:
            if c.output_schema.types != first.types:
                raise TypeError(
                    f"union children schemas differ: {first.types} vs "
                    f"{c.output_schema.types}")
        return dt.Schema([
            dt.StructField(
                f.name, f.dtype,
                any(c.output_schema.fields[i].nullable
                    for c in self.children))
            for i, f in enumerate(first.fields)])

    def describe(self):
        return f"UnionExec [{len(self.children)} children]"

    def execute(self, ctx: ExecCtx):
        for c in self.children:
            for b in c.execute(ctx):
                yield type(b)(b.columns, self._schema, b.row_count,
                              b.selection)

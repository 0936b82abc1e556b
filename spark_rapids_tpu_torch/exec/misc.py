"""UNION ALL, Expand and Sample.

Counterpart of ``spark_rapids_tpu/exec/misc.py`` (``TpuUnionExec``,
``TpuExpandExec``, ``TpuSampleExec``).

``GpuExpandExec`` (the ROLLUP/CUBE/grouping-sets backbone) emits one
batch a projection list an input batch. Its ``device_fn`` is
``_run_all``, every list over one batch concatenated into one batch, so
a partial aggregate (or an exchange) above it runs Expand in its fused
stage. Where the reference compacts the input before it concatenates,
the port's concatenation (``ops/concat.concat_batches_bounded``)
carries the inputs' live rows as the output's selection, so nothing is
gathered: Expand launches no kernel of its own.

``GpuSampleExec`` keeps a live row where the Murmur3 hash of its global
position (over live rows, the batches' counts carried across them by a
host offset) under the seed is below ``fraction * 2^32``, as the
reference does; the same rows on either device. The kept rows become the
batch's lazy selection, as the filter's do (dropped rows also lose their
validity). ``_keep_mask_np`` is the numpy oracle. Batch order fixes the
positions, so a sample is a barrier to fusion and, on the process
cluster, its region runs as one task.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from .. import datatypes as dt
from ..columnar.batch import GpuBatch
from ..expr.base import Expression
from .base import ExecCtx, GpuExec, OpContract, UnaryExec

__all__ = ["GpuUnionExec", "GpuExpandExec", "GpuSampleExec"]


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


class GpuExpandExec(UnaryExec):
    """Each input row through every projection list; the output's
    multiset is Spark's row-interleaved one."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: GpuExec):
        super().__init__(child)
        from .basic import bind_all
        if not projections:
            raise ValueError("expand needs >= 1 projection")
        self.projections = [bind_all(p, child.output_schema)
                            for p in projections]
        width = len(self.projections[0])
        if any(len(p) != width for p in self.projections) \
                or len(names) != width:
            raise ValueError("projection widths/names mismatch")
        first = self.projections[0]
        for p in self.projections[1:]:
            for i, e in enumerate(p):
                if e.dtype != first[i].dtype:
                    raise TypeError(
                        f"expand projection column {i} type mismatch")
        self._schema = dt.Schema([
            dt.StructField(n, e.dtype,
                           any(p[i].nullable for p in self.projections))
            for i, (n, e) in enumerate(zip(names, first))])

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        return f"ExpandExec [{len(self.projections)} projections]"

    def expressions(self):
        return [e for p in self.projections for e in p]

    def _project(self, exprs, batch: GpuBatch, ectx) -> GpuBatch:
        cols = [e.eval_gpu(batch, ectx) for e in exprs]
        return GpuBatch(cols, self._schema, batch.row_count,
                        batch.selection)

    def _run_all(self, batch: GpuBatch, ectx) -> GpuBatch:
        """Every projection list over one batch, as one batch: the row-wise
        map a fused stage runs (``device_fn``)."""
        from ..ops.concat import concat_batches_bounded
        return concat_batches_bounded(
            [self._project(p, batch, ectx) for p in self.projections])

    def device_fn(self):
        return self._run_all

    def execute(self, ctx: ExecCtx):
        op_time = ctx.metric(self, "opTime")
        for batch in self.child.execute(ctx):
            for p in self.projections:
                t0 = time.perf_counter()
                out = self._project(p, batch, ctx.eval_ctx)
                op_time.value += time.perf_counter() - t0
                yield out


class GpuSampleExec(UnaryExec):
    """Bernoulli sampling without replacement by a hash of (seed, global
    row position) against the fraction: the device and the oracle keep
    the same rows (Spark's per-partition XORShift sampler is not matched
    bit for bit; its distribution is)."""

    CONTRACT = OpContract(
        schema_preserving=True,
        notes="keeps a subset of the live rows by a hash of their global "
              "positions; schema passes through")

    def __init__(self, fraction: float, seed: int, child: GpuExec):
        super().__init__(child)
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        self.fraction = float(fraction)
        self.seed = int(seed)
        self._threshold = int(self.fraction * (1 << 32))

    def describe(self):
        return f"SampleExec [fraction={self.fraction} seed={self.seed}]"

    def _keep_mask(self, pos: torch.Tensor) -> torch.Tensor:
        from ..ops.hash import murmur3_int64
        seed = torch.full_like(pos, self.seed & 0xFFFFFFFF)
        h = murmur3_int64(pos & 0xFFFFFFFF, (pos >> 32) & 0xFFFFFFFF, seed)
        return h < self._threshold

    def _keep_mask_np(self, start: int, n: int) -> np.ndarray:
        """The oracle: which of ``n`` rows at global positions ``start``
        onward are kept."""
        from ..ops.hash import murmur3_long_np
        pos = np.arange(start, start + n, dtype=np.int64)
        return murmur3_long_np(pos, self.seed & 0xFFFFFFFF).astype(
            np.int64) < self._threshold

    def execute(self, ctx: ExecCtx):
        op_time = ctx.metric(self, "opTime")
        start = 0
        for batch in self.child.execute(ctx):
            t0 = time.perf_counter()
            live = batch.live_mask()
            pos = start + torch.cumsum(live.to(torch.int64), 0) - 1
            keep = live & self._keep_mask(pos)
            out = batch.with_selection(keep)
            out.columns = [c.with_validity(keep if c.validity is None
                                           else c.validity & keep)
                           for c in out.columns]
            start += int(live.sum())
            op_time.value += time.perf_counter() - t0
            yield out

"""Host <-> device transitions.

Counterpart of ``spark_rapids_tpu/exec/transitions.py:22-71``
(``DeviceToHostExec``, ``HostToDeviceExec``). The planner puts them at
every boundary between a device subtree and a CPU island
(``planner.py``), where the reference's ``GpuTransitionOverrides`` puts
its row/columnar transitions. The host currency is Arrow RecordBatches,
the device currency ``GpuBatch``.
"""
from __future__ import annotations

import time

from ..columnar.arrow_bridge import arrow_to_device, device_to_arrow
from .base import ExecCtx, OpContract, UnaryExec

__all__ = ["DeviceToHostExec", "HostToDeviceExec"]


class DeviceToHostExec(UnaryExec):
    """A device child feeding a CPU island: ``execute_cpu`` downloads the
    child's batches as Arrow, each batch's lazy selection applied."""

    CONTRACT = OpContract(schema_preserving=True,
                          notes="device->host transition; values unchanged")

    def execute(self, ctx: ExecCtx):
        # the planner puts this node under CPU parents only: a device
        # parent calling execute() is a mis-planned tree
        raise AssertionError(
            "DeviceToHostExec.execute() called from a device parent; the "
            "planner routes CPU islands through execute_cpu")

    def execute_cpu(self, ctx: ExecCtx):
        t = ctx.metric(self, "downloadTime")
        n = ctx.metric(self, "numOutputBatches")
        for b in self.child.execute(ctx):
            t0 = time.perf_counter()
            rb = device_to_arrow(b)
            t.value += time.perf_counter() - t0
            n += 1
            yield rb


class HostToDeviceExec(UnaryExec):
    """A CPU island feeding a device parent: ``execute`` uploads the
    child's Arrow batches to ``ctx.device``, string offsets and chars
    as they are."""

    CONTRACT = OpContract(schema_preserving=True,
                          notes="host->device transition; values unchanged")

    def execute(self, ctx: ExecCtx):
        t = ctx.metric(self, "uploadTime")
        n = ctx.metric(self, "numOutputBatches")
        schema = self.child.output_schema
        for rb in self.child.execute_cpu(ctx):
            t0 = time.perf_counter()
            b = arrow_to_device(rb, schema, ctx.device)
            t.value += time.perf_counter() - t0
            n += 1
            yield b

    def execute_cpu(self, ctx: ExecCtx):
        yield from self.child.execute_cpu(ctx)

from .base import (ExecCtx, GpuExec, GpuMetric, HostBatchSourceExec,
                   DeviceBatchSourceExec, collect_arrow)
from .basic import GpuProjectExec, GpuFilterExec
from .aggregate import GpuHashAggregateExec
from .joins import GpuShuffledHashJoinExec

__all__ = ["ExecCtx", "GpuExec", "GpuMetric", "HostBatchSourceExec",
           "DeviceBatchSourceExec", "collect_arrow", "GpuProjectExec",
           "GpuFilterExec", "GpuHashAggregateExec",
           "GpuShuffledHashJoinExec"]

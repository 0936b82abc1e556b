"""Fault-tolerant task scheduling for the process cluster.

Counterpart of ``spark_rapids_tpu/scheduler/``: per-task attempt
tracking with bounded retry, worker blacklisting, heartbeat liveness
with kill and respawn, straggler speculation (``task_scheduler.py``),
and a deterministic fault-injection harness so every recovery path is
testable on one host (``chaos.py``). The gang route of the mesh waits
for ROADMAP item 17.
"""
from .task_scheduler import FetchFailedError, TaskScheduler, TaskSpec

__all__ = ["TaskScheduler", "TaskSpec", "FetchFailedError"]

"""Observability: the per-operator metrics layer.

Counterpart of ``spark_rapids_tpu/obs/__init__.py`` and
``obs/opmetrics.py``: stable operator ids, the always-on per-operator
accounting the execute shims feed (``exec/base.py``), the fused-stage
timer on CUDA events, EXPLAIN ANALYZE rendering and query profiles
(``opmetrics.py``). The reference's span tracer, Prometheus registry,
flight recorder and telemetry warehouse are ROADMAP item 15's rest.
"""
from .opmetrics import (HISTORY_DIR, HISTORY_ENABLED, OP_METRICS_ENABLED,
                        OpMetricsCollector, assign_op_ids, build_profile,
                        fold_ctx, fold_snapshots, read_profiles,
                        render_analyzed, write_profile)

__all__ = ["HISTORY_DIR", "HISTORY_ENABLED", "OP_METRICS_ENABLED",
           "OpMetricsCollector", "assign_op_ids", "build_profile",
           "fold_ctx", "fold_snapshots", "read_profiles", "render_analyzed",
           "write_profile"]

"""Observability: per-operator metrics, tracing, live metrics, the flight
recorder and the telemetry warehouse.

Counterpart of ``spark_rapids_tpu/obs/__init__.py``:

- ``opmetrics``: stable operator ids, the always-on per-operator
  accounting the execute shims feed (``exec/base.py``), the fused-stage
  timer on CUDA events, EXPLAIN ANALYZE and query profiles;
- ``tracer``: a ``query`` span a collect and an ``op`` span an operator
  call, written as one Chrome trace a query under
  ``spark.rapids.trace.dir`` (off by default: ``NULL_TRACER``);
- ``metrics``: the process's ``REGISTRY`` of counters, gauges and
  histograms with bounded label sets, as Prometheus text
  (``dump_prometheus``) and, with ``spark.rapids.metrics.port`` set, on
  ``http://127.0.0.1:<port>/metrics`` and ``/status``;
- ``recorder`` and ``anomaly``: the always-on flight recorder
  (``spark.rapids.flight.enabled``), a bounded ring of memory-ledger,
  lifecycle, plan and span events, and the incident bundles built from
  it;
- ``warehouse`` and ``attribution``: one sealed row a query under
  ``spark.rapids.warehouse.dir``.

Recording is on by default and costs a few attribute updates and deque
appends; the exporters are what the conf switches on. None of them
reads anything back from the device.
"""
from .anomaly import AnomalyDetector, build_incident_bundle
from .metrics import (METRICS_PORT, REGISTRY, MetricsRegistry,
                      dump_prometheus, maybe_start_http_server,
                      render_merged_snapshots)
from .opmetrics import (HISTORY_DIR, HISTORY_ENABLED, OP_METRICS_ENABLED,
                        OpMetricsCollector, assign_op_ids, build_profile,
                        fold_ctx, fold_snapshots, read_profiles,
                        render_analyzed, write_profile)
from .recorder import RECORDER, FlightRecorder
from .tracer import (NULL_TRACER, TRACE_DIR, TRACE_MAX_FILES,
                     TRACE_MAX_SPANS, Span, Tracer, tracer_from_conf)

__all__ = ["NULL_TRACER", "Span", "Tracer", "TRACE_DIR", "TRACE_MAX_SPANS",
           "TRACE_MAX_FILES", "tracer_from_conf", "METRICS_PORT",
           "MetricsRegistry", "REGISTRY",
           "dump_prometheus", "maybe_start_http_server",
           "render_merged_snapshots", "RECORDER", "FlightRecorder",
           "AnomalyDetector", "build_incident_bundle", "HISTORY_DIR",
           "HISTORY_ENABLED", "OP_METRICS_ENABLED", "OpMetricsCollector",
           "assign_op_ids", "build_profile", "fold_ctx", "fold_snapshots",
           "read_profiles", "render_analyzed", "write_profile"]

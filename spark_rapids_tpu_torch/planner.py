"""Planner: the override pass from an operator tree to a physical plan.

Counterpart of ``spark_rapids_tpu/planner.py:45-160,201-208,404-540``
(``NodeMeta``, ``PhysicalPlan``, ``TpuOverrides``): wrap every node in a
``NodeMeta`` and tag each bottom-up with the reference's gates:

- the master switch ``spark.rapids.sql.enabled``;
- the per-operator switch ``spark.rapids.sql.exec.<Name>``;
- the operator's own gate ``gpu_supported()`` and its conf hook
  ``gpu_supported_conf(conf)`` (``variableFloatAgg`` on the aggregate, a
  condition on an outer, semi or anti equi-join);
- for every expression: ``spark.rapids.sql.expression.<Name>``, an
  ``incompat`` expression under ``spark.rapids.sql.incompatibleOps
  .enabled=false``, its gate ``gpu_supported()`` and conf hook;
- a decimal past the device's 18 digits in the operator's input or
  output or in any of its expressions (``_wide_decimal_reason``): such a
  decimal has no device layout, so everything that holds one runs on the
  CPU and no transition uploads one.

A node with a reason runs on the CPU. ``_convert`` rebuilds the tree
with ``DeviceToHostExec`` under a CPU node over a device child and
``HostToDeviceExec`` under a device node over a CPU child (plus a
``GpuCoalesceBatchesExec`` where that device node is an aggregate, a
join or a sort), and with the adaptive reader over every device shuffle
exchange while ``spark.sql.adaptive.enabled`` is on. Placement is
decided here: nothing at run time moves an operator to the CPU after a
kernel, a build or a launch fails. The memory manager's two reroutes are
the exception, and both are about memory: the degradation ladder's CPU
rung below, and an exact percentile's input over half the budget
(``exec/aggregate.py``).

``GpuOverrides.apply`` then runs the static plan verifier on the
rebuilt tree while ``spark.rapids.sql.verifyPlan`` is on (the default;
``analysis/plan_verifier.py``, the reference's ``_verify``,
``:469-483``) and raises ``PlanVerificationError``, its ``report``
attached, before any kernel runs; the report and the verifier's host
time stay on the plan (``verify_report``, ``verify_s``). Then it stamps
every node with a stable pre-order operator id (``assign_op_ids``,
``:509-511``), which the metric labels carry.

``PhysicalPlan.collect(ctx, qctx)`` (the reference's ``:163-321``)
gives the query a ``QueryContext`` from the conf while
``spark.rapids.lifecycle.enabled`` is on (the default), runs
``execute`` (device root, under the admission slot) or ``execute_cpu``
(CPU root) and returns Arrow; a CPU-rooted plan still reads the deferred
checks of the device subtrees under it. A ``TpuRetryOOM`` that climbed
the whole degradation ladder reruns the plan on ``execute_cpu`` after
dropping the aborted attempt's deferred checks and per-operator counts,
with ``ladderCpuFallback`` set on the root; at the end the query's
width-1 claim is cleared. The run's ctx and wall time stay on the plan
(``last_ctx``, ``last_wall_s``): ``explain_analyze()`` renders the tree
with each operator's metrics (EXPLAIN ANALYZE, ``:359-372``), and with
``spark.rapids.history.dir`` set each query writes one profile
(``_write_profile``, ``:340-357``).
``fallback_nodes()`` names every node placed on the CPU, and
``explain`` renders the placement (``ALL`` or ``NOT_ON_GPU``).

The collect's telemetry bracket (the reference's ``:179-242``): the
warehouse's ``QueryAttribution.begin``, then the ``query`` span (the
plan's fingerprint in its args) and, with ``spark.rapids.profile.path``
set, a ``torch.profiler`` session (CPU, and CUDA on a CUDA ctx) whose
Chrome trace lands in that directory (``last_profiler_trace``). Every
exit writes one warehouse row (completed, cancelled, degraded or
failed) and the tracer's Chrome JSON (an ``OSError`` there never fails
the query); a collect that returns observes
``rapids_query_duration_seconds`` and writes its event-log line; a
cancelled one writes a ``lifecycle``/``cancelled_query`` flight event and
a ``query_cancelled`` line (``:274-320``), and the ladder's CPU rerun a
``lifecycle``/``cpu_fallback`` event. ``GpuOverrides.apply`` records a
``plan`` flight event with the placement's fallback reasons
(``:518-530``).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import List, Optional, Sequence

import pyarrow as pa

from . import datatypes as dt
from .config import (ADAPTIVE_ENABLED, BATCH_SIZE_ROWS, EXPLAIN,
                     INCOMPATIBLE_OPS, PROFILE_PATH, SQL_ENABLED,
                     VERIFY_PLAN, RapidsConf)
from .exec.base import ExecCtx, GpuExec, collect_arrow, \
    collect_arrow_cpu, resolve_device
from .exec.transitions import DeviceToHostExec, HostToDeviceExec

__all__ = ["NodeMeta", "PhysicalPlan", "GpuOverrides"]


def _walk_expr(expr) -> List[object]:
    out = [expr]
    for c in getattr(expr, "children", ()):
        out.extend(_walk_expr(c))
    return out


def _expr_reasons(e, conf: RapidsConf) -> List[str]:
    """Why one expression node keeps its operator off the device."""
    ename = e.pretty_name()
    if not conf.is_op_enabled("expression", ename):
        return [f"expression {e!r} has been disabled by "
                f"spark.rapids.sql.expression.{ename}"]
    incompat = getattr(e, "incompat", None)
    if incompat and not conf.get(INCOMPATIBLE_OPS):
        return [f"expression {e!r} is incompatible ({incompat}) and "
                "spark.rapids.sql.incompatibleOps.enabled is false"]
    for reason in (e.gpu_supported(), e.gpu_supported_conf(conf)):
        if reason:
            return [f"expression {e!r}: {reason}"]
    return []


def _wide_decimal_reason(node: GpuExec) -> Optional[str]:
    """Why a node that holds a decimal past 18 digits stays off the
    device, or None."""
    fields = list(node.output_schema.fields)
    for c in node.children:
        fields.extend(c.output_schema.fields)
    types = [f.dtype for f in fields]
    for root in node.expressions():
        for e in _walk_expr(root):
            try:
                types.append(e.dtype)
            except (TypeError, NotImplementedError):
                continue
    for t in types:
        if dt.is_wide_decimal(t):
            return (f"{t.simple_string()} exceeds the device's 18 decimal "
                    "digits")
    return None


class NodeMeta:
    """Per-node planning state: the exec, its child metas and the
    reasons it cannot run on the device."""

    def __init__(self, node: GpuExec, children: Sequence["NodeMeta"]):
        self.node = node
        self.children = list(children)
        self.reasons: List[str] = []

    @property
    def on_device(self) -> bool:
        return not self.reasons

    def tag(self, conf: RapidsConf) -> None:
        name = self.node.pretty_name()
        if not conf.get(SQL_ENABLED):
            self.reasons.append("spark.rapids.sql.enabled is false")
        if not conf.is_op_enabled("exec", name):
            self.reasons.append(f"the operator has been disabled by "
                                f"spark.rapids.sql.exec.{name}")
        for reason in (self.node.gpu_supported(),
                       self.node.gpu_supported_conf(conf),
                       _wide_decimal_reason(self.node)):
            if reason:
                self.reasons.append(reason)
        for root in self.node.expressions():
            for e in _walk_expr(root):
                self.reasons.extend(_expr_reasons(e, conf))

    def explain_lines(self, mode: str, depth: int = 0) -> List[str]:
        pad = "  " * depth
        desc = self.node.describe()
        out = []
        if self.on_device:
            if mode == "ALL":
                out.append(f"{pad}*Exec* {desc} will run on GPU")
        else:
            out.append(f"{pad}!Exec! {desc} cannot run on GPU because "
                       + "; ".join(self.reasons))
        for c in self.children:
            out.extend(c.explain_lines(mode, depth + 1))
        return out


class PhysicalPlan:
    """Planner output: the rebuilt tree, its placement and the device it
    runs on."""

    def __init__(self, root: GpuExec, meta: NodeMeta, conf: RapidsConf,
                 device=None, source: str = "plan"):
        self.root = root
        self.meta = meta
        self.conf = conf
        self.device = device
        self.source = source
        self.verify_report = None
        self.verify_s = 0.0
        self.last_ctx: Optional[ExecCtx] = None
        self.last_wall_s: Optional[float] = None
        self.last_profile_path: Optional[str] = None
        self.last_profiler_trace: Optional[str] = None

    @property
    def root_on_device(self) -> bool:
        return self.meta.on_device

    @property
    def output_schema(self):
        return self.root.output_schema

    def fallback_nodes(self) -> List[str]:
        """The pretty name of every operator placed on the CPU, in pre-
        order (the reference's ``assert_gpu_fallback_collect`` hook)."""
        out = []

        def rec(m: NodeMeta):
            if not m.on_device:
                out.append(m.node.pretty_name())
            for c in m.children:
                rec(c)

        rec(self.meta)
        return out

    def explain(self, mode: Optional[str] = None) -> str:
        mode = mode or self.conf.get(EXPLAIN)
        if mode == "NONE":
            return ""
        return "\n".join(self.meta.explain_lines(mode))

    def collect(self, ctx: Optional[ExecCtx] = None,
                qctx=None) -> pa.Table:
        """Run the plan and return one Arrow table: the root's device
        path under the admission slot, or its CPU path when the planner
        placed it on the CPU (module docstring). A ladder-exhausted OOM
        reruns the plan on its CPU path. The telemetry bracket is the
        module docstring's."""
        from .lifecycle import LIFECYCLE_ENABLED, QueryCancelled, \
            QueryContext
        from .obs.attribution import QueryAttribution
        from .obs.metrics import QUERY_DURATION
        from .obs.tracer import TRACE_DIR
        from .tools.event_log import log_query_event, plan_fingerprint
        ctx = ctx or ExecCtx(self.conf, self.device)
        self.last_ctx = ctx
        if qctx is None:
            qctx = ctx.qctx
        if qctx is None and self.conf.get(LIFECYCLE_ENABLED):
            qctx = QueryContext.from_conf(self.conf)
        ctx.qctx = qctx
        self.last_qctx = qctx
        attrib = QueryAttribution.begin(self.conf)
        qspan = ctx.tracer.span(
            "query", cat="query",
            args={"fingerprint": plan_fingerprint(self.root)}) \
            if ctx.tracer.enabled else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with self._profiled(ctx), qspan:
                out = self._collect(ctx, qctx)
        except QueryCancelled as e:
            self._report_cancel(e, time.perf_counter() - t0)
            self._emit_warehouse(attrib, ctx, qctx,
                                 time.perf_counter() - t0, error=e)
            raise
        except BaseException as e:
            self._emit_warehouse(attrib, ctx, qctx,
                                 time.perf_counter() - t0, error=e)
            raise
        finally:
            # width-1 exclusivity must not outlive the query
            if qctx is not None:
                ctx.mm.admission.clear_exclusive(qctx.query_id)
            # a failed query's timeline is the one most wanted; a trace
            # directory that cannot be written never fails the query
            if ctx.tracer.enabled:
                with contextlib.suppress(OSError):
                    ctx.tracer.write_chrome(self.conf.get(TRACE_DIR))
        self.last_wall_s = wall_s = time.perf_counter() - t0
        QUERY_DURATION.labels(self.source, "local").observe(wall_s)
        with contextlib.suppress(OSError):
            log_query_event(self, ctx, wall_s)
        self._write_profile(ctx, wall_s)
        self._emit_warehouse(attrib, ctx, qctx, wall_s)
        return out

    @contextlib.contextmanager
    def _profiled(self, ctx: ExecCtx):
        """A ``torch.profiler`` session over the run while
        ``spark.rapids.profile.path`` is set (CPU activity, and CUDA on
        a CUDA ctx), its Chrome trace written into that directory at the
        end, even a failed run's; nothing otherwise (the profiler syncs
        the device, so it runs only where it was asked for)."""
        prof_dir = self.conf.get(PROFILE_PATH)
        if not prof_dir:
            yield
            return
        from torch import profiler as tp
        activities = [tp.ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            activities.append(tp.ProfilerActivity.CUDA)
        prof = tp.profile(activities=activities)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            path = os.path.join(
                prof_dir, f"torch-{os.getpid()}-"
                f"{int(time.time() * 1000)}.pt.trace.json")
            try:
                os.makedirs(prof_dir, exist_ok=True)
                prof.export_chrome_trace(path)
                self.last_profiler_trace = path
            except OSError:
                self.last_profiler_trace = None

    def _collect(self, ctx: ExecCtx, qctx) -> pa.Table:
        from .memory import TpuRetryOOM
        from .obs.recorder import RECORDER
        if not self.root_on_device:
            return collect_arrow_cpu(self.root, ctx)
        try:
            return collect_arrow(self.root, ctx)
        except TpuRetryOOM as oom:
            if qctx is None or not oom.ladder_exhausted:
                raise
            detail = str(oom)[:200]
        # the ladder's cpu rung (already counted by escalate): drop the
        # aborted attempt's per-operator counts, which the CPU run counts
        # again (its deferred checks and row counts went at the failure)
        RECORDER.record("lifecycle", ev="cpu_fallback",
                        query=qctx.query_id, detail=detail)
        for ms in ctx.metrics.values():
            for name in ("numOutputRows", "numOutputBatches",
                         "numPartials", "numInputBatches", "rows",
                         "batches", "outputBytes"):
                ms.pop(name, None)
        ctx.metric(self.root, "ladderCpuFallback").set(1)
        return collect_arrow_cpu(self.root, ctx)

    def _report_cancel(self, e, wall_s: float) -> None:
        """A cancelled query's evidence: a flight event and a
        ``query_cancelled`` event-log line (the token counted it in
        ``rapids_query_cancelled_total`` when it was cancelled)."""
        from .obs.recorder import RECORDER
        from .tools.event_log import log_query_cancelled
        RECORDER.record("lifecycle", ev="cancelled_query",
                        query=e.query_id, reason=e.reason,
                        wall_s=round(wall_s, 6))
        with contextlib.suppress(OSError):
            log_query_cancelled(self.conf, e, wall_s, source=self.source)

    def _emit_warehouse(self, attrib, ctx: ExecCtx, qctx, wall_s: float,
                        error=None) -> None:
        """This collect's one warehouse row: the folded per-operator
        metrics carry the scan, fusion and row figures, the counter
        deltas the spill bytes (``obs/attribution.py``); best effort."""
        if attrib is None:
            return
        from .obs.opmetrics import fold_ctx
        try:
            folded = fold_ctx(ctx)
        except Exception:  # noqa: BLE001 — a partial row beats none
            folded = {}
        attrib.finish(root=self.root, folded=folded, qctx=qctx,
                      wall_s=wall_s, source=self.source, error=error,
                      device=ctx.device)

    def _write_profile(self, ctx: ExecCtx, wall_s: float) -> None:
        """One query-profile JSON under ``spark.rapids.history.dir``
        (nothing when it is unset); a write that fails leaves
        ``last_profile_path`` None and the query's result stands."""
        from .obs.opmetrics import (HISTORY_DIR, build_profile, fold_ctx,
                                    write_profile)
        if not self.conf.get(HISTORY_DIR):
            return
        doc = build_profile(
            self.root, fold_ctx(ctx), wall_s, source=self.source,
            cluster="local", conf=self.conf, device=ctx.device,
            extra={"fallbacks": self.fallback_nodes()})
        self.last_profile_path = write_profile(self.conf, doc)

    def explain_analyze(self, formatted: bool = False) -> str:
        """The EXPLAIN ANALYZE text of the last ``collect()``: the
        executed tree, each node with its id and its rows, batches,
        times, spill and decode counters (``obs/opmetrics.py``)."""
        from .obs.opmetrics import fold_ctx, render_analyzed
        ctx = self.last_ctx
        if ctx is None:
            return self.explain("ALL") + \
                "\n(no metrics: run collect() first)"
        return render_analyzed(self.root, fold_ctx(ctx),
                               wall_s=self.last_wall_s,
                               formatted=formatted, cluster="local")


class GpuOverrides:
    """The override rule: wrap, tag, convert."""

    def __init__(self, conf: Optional[RapidsConf] = None, device=None):
        self.conf = conf or RapidsConf()
        self.device = None if device is None else resolve_device(device)

    def _wrap(self, node: GpuExec) -> NodeMeta:
        return NodeMeta(node, [self._wrap(c) for c in node.children])

    def _tag(self, meta: NodeMeta) -> None:
        for c in meta.children:
            self._tag(c)
        meta.tag(self.conf)

    def _convert(self, meta: NodeMeta) -> GpuExec:
        """Rebuild with the transitions (module docstring); the adaptive
        reader goes over a device exchange where its consumer is on the
        device too, as in the reference's ``_maybe_aqe``."""
        from .exec.aggregate import GpuHashAggregateExec
        from .exec.aqe import GpuAQEShuffleReadExec
        from .exec.exchange import GpuCoalesceBatchesExec, \
            GpuShuffleExchangeExec
        from .exec.joins import _BaseJoinExec
        from .exec.sort import GpuSortExec
        batch_sensitive = (GpuHashAggregateExec, _BaseJoinExec, GpuSortExec)
        children = []
        for c in meta.children:
            built = self._convert(c)
            if meta.on_device and not c.on_device:
                built = HostToDeviceExec(built)
                if isinstance(meta.node, batch_sensitive):
                    built = GpuCoalesceBatchesExec(
                        built, target_rows=self.conf.get(BATCH_SIZE_ROWS))
            elif not meta.on_device and c.on_device:
                built = DeviceToHostExec(built)
            if self.conf.get(ADAPTIVE_ENABLED) and c.on_device \
                    and isinstance(built, GpuShuffleExchangeExec):
                built = GpuAQEShuffleReadExec(built)
            children.append(built)
        return meta.node.with_new_children(children)

    def _verify(self, root: GpuExec):
        """The static contract pass over the rebuilt tree (transitions
        and adaptive readers included): ``(report or None, host
        seconds)``; a plan that breaks a contract raises
        ``PlanVerificationError`` before any kernel runs."""
        from .analysis.plan_verifier import (PlanVerificationError,
                                             report_rejection, verify_plan)
        if not self.conf.get(VERIFY_PLAN):
            return None, 0.0
        t0 = time.perf_counter()
        report = verify_plan(root, self.conf, self.device)
        secs = time.perf_counter() - t0
        if not report.ok:
            report_rejection(self.conf, report, root)
            raise PlanVerificationError(report)
        return report, secs

    @staticmethod
    def _record_fallbacks(meta: NodeMeta) -> None:
        """One ``plan`` flight event a planned query: how many nodes
        the placement put on the CPU and why (bounded), so an incident
        bundle shows it without planning again."""
        from .obs.recorder import RECORDER
        if not RECORDER.enabled:
            return
        reasons = []

        def rec(m: NodeMeta):
            if not m.on_device:
                reasons.append(f"{m.node.pretty_name()}: "
                               + "; ".join(m.reasons)[:120])
            for c in m.children:
                rec(c)

        rec(meta)
        RECORDER.record("plan", n_fallbacks=len(reasons),
                        fallbacks=" | ".join(reasons[:8])[:600])

    def apply(self, plan: GpuExec) -> PhysicalPlan:
        from .obs.opmetrics import assign_op_ids, plan_source
        meta = self._wrap(plan)
        self._tag(meta)
        root = self._convert(meta)
        report, secs = self._verify(root)
        # stable operator ids: the metric labels survive copies and runs
        assign_op_ids(root, force=True)
        pp = PhysicalPlan(root, meta, self.conf, self.device,
                          source=plan_source(plan))
        pp.verify_report, pp.verify_s = report, secs
        self._record_fallbacks(meta)
        mode = self.conf.get(EXPLAIN)
        if mode in ("ALL", "NOT_ON_GPU"):
            text = pp.explain(mode)
            if text:
                # stderr: scripts that drive the engine keep stdout for
                # results
                print(text, file=sys.stderr)
        return pp

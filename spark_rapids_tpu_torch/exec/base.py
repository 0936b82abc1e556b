"""Physical operator layer.

Counterpart of ``spark_rapids_tpu/exec/base.py``: ``OpContract``,
``GpuMetric``, ``ExecCtx``, ``GpuExec`` with ``LeafExec``/``UnaryExec``,
the two batch sources, ``fused_batches``, ``collect_arrow`` and
``collect_arrow_cpu``. Every operator's
``execute(ctx)`` yields device ``GpuBatch``es on ``ctx.device``.

Every operator also has the reference's CPU path, ``execute_cpu(ctx)``,
Arrow RecordBatches in and out, which the planner runs for an operator
it places off the device (a CPU island, ``planner.py``). By default it
is the operator's own torch body on CPU tensors: the children's Arrow
batches go into CPU ``GpuBatch``es (``_HostInputExec``), ``execute``
runs under ``ctx.host_ctx()`` (device
``cpu``, ``EvalCtx.host`` set, the metrics and deferred checks shared),
and each output batch comes back as Arrow with its lazy selection
applied. Every kernel wrapper takes its plain version on a CPU tensor,
so an island launches nothing on the card; what the device refuses runs
its host branch under the host flag (a RANGE window offset over any key,
a string lag default, a LIKE outside the device dialect, a condition on
an outer, semi or anti equi-join). The sources and the scan override it
(``HostBatchSourceExec`` yields its batches, the scan reads through
pyarrow). The planner's gates are ``gpu_supported()`` and
``gpu_supported_conf(conf)`` (the reference's ``tpu_supported``,
``:333``).

The ``ExecCtx`` carries the conf, the eval ctx, the device, the
metrics, the deferred device checks (a flag on the device, raised at the
query's download rather than read back when it is made), the query's
cleanups, the process's memory manager (``mm``, ``memory.py``: ledger,
spill catalog, admission, split-and-retry), the query's lifecycle
context (``qctx``, ``lifecycle.py``) and the per-operator metrics
collector (``opm``, ``obs/opmetrics.py``), as the reference's
``:99-160``. Every operator's ``execute`` and ``execute_cpu`` is wrapped
(``__init_subclass__``) with one shim (``:201-290``): the cancellation
check at each batch, and rows, batches and output bytes under the node's
label (``cpuFallback`` on the CPU path), each batch counted once where an
``execute`` delegates to ``super()`` or runs a copy of its node.
``fused_batches`` runs each fused stage under ``mm.with_retry``
(``:577-590``), its launch time in ``dispatchTime`` and its ``opTime``
to the device's completion, stamped by a CUDA event
(``_record_stage_time``, ``:468-483``); ``collect_arrow`` holds the
admission slot, its wait in ``ledgerWaitTime``, and finalizes the
metrics at the download (``:693-716``).

The static contract the plan verifier checks (``analysis/
plan_verifier.py``) lives here too: ``OpContract`` and the instance
hooks ``expected_output_schema``, ``expr_bindings``,
``resident_footprint`` and ``static_bytes_estimate`` (``:37-78,
336-390``), overridden by the operators that declare more.

The ctx also carries the query's span tracer (``tracer``,
``obs/tracer.py``: ``NULL_TRACER`` unless ``spark.rapids.trace.dir`` is
set), adopts the conf's flight-recorder bounds and starts the metrics
endpoint when ``spark.rapids.metrics.port`` is set (``:138-160``). With
tracing on, each operator call's shim opens an ``op`` span named by its
label, ``op_id`` in its args, and each fused stage one a batch under
its consumer's label, the ids of the nodes it ran in ``fused``
(``:550,576,654``). A span lasts host time; the device's stays in
``opTime``.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from .. import datatypes as dt
from ..columnar.arrow_bridge import (arrow_schema, arrow_to_device,
                                     device_to_arrow, engine_schema)
from ..columnar.batch import GpuBatch
from ..config import STAGE_FUSION, RapidsConf
from ..expr.base import EvalCtx

__all__ = ["ExecCtx", "GpuMetric", "GpuExec", "LeafExec", "UnaryExec",
           "HostBatchSourceExec", "DeviceBatchSourceExec", "OpContract",
           "collect_arrow", "collect_arrow_cpu", "fused_batches",
           "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``, which must exist; the CPU is used only
    when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the engine runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but CUDA is not "
                               "available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass(frozen=True)
class OpContract:
    """An operator class's static contract, which the plan verifier
    checks before execution (the reference's ``:37-78``); the checks
    that need an instance's data are the hooks on ``GpuExec``."""

    #: the output schema is the (first) child's, field for field; a
    #: field's nullability may only widen
    schema_preserving: bool = False
    #: the whole input is resident on the device at once, with no
    #: out-of-core path: the static byte estimate is held to the budget
    resident_footprint: bool = False
    #: children that are both shuffle exchanges agree on partitioning
    #: scheme and partition count
    requires_copartition: bool = False
    #: a planner-inserted wrapper: the child's class name
    wrapper_over: Optional[str] = None
    #: a one-line note
    notes: str = ""


class GpuMetric:
    """Accumulator metric, the GpuMetric-over-SQLMetric analog."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def __iadd__(self, v):
        self.value += v
        return self

    def set(self, v):
        self.value = v

    def __repr__(self):
        return f"{self.name}={self.value}"


class ExecCtx:
    """Per-query execution context: conf snapshot, eval ctx, device,
    metric sink, memory manager and lifecycle context."""

    def __init__(self, conf: Optional[RapidsConf] = None, device=None):
        from ..memory import DeviceMemoryManager
        from ..obs.metrics import maybe_start_http_server
        from ..obs.opmetrics import OpMetricsCollector
        from ..obs.recorder import RECORDER
        from ..obs.tracer import tracer_from_conf
        self.conf = conf or RapidsConf()
        self.device = resolve_device(device)
        self.eval_ctx = EvalCtx(
            ansi=self.conf.ansi,
            timezone=self.conf.get("spark.sql.session.timeZone"))
        self.metrics: Dict[str, Dict[str, GpuMetric]] = {}
        self.stage_fusion = self.conf.get(STAGE_FUSION)
        # per-operator accounting: the execute shims feed it, the
        # collect roots finalize it at their download
        self.opm = OpMetricsCollector(self.conf)

        self.deferred_checks: List[Tuple[torch.Tensor, str]] = []
        # the process's ledger for this device: concurrent queries share
        # its slots and budget
        self.mm = DeviceMemoryManager.shared(self.conf, self.device)
        # span tracer (the shared no-op unless spark.rapids.trace.dir is
        # set), the flight recorder's bounds, the /metrics endpoint
        self.tracer = tracer_from_conf(self.conf)
        RECORDER.configure(self.conf)
        maybe_start_http_server(self.conf)
        # set by the collect roots; the execute shims check it a batch
        self.qctx = None
        self._cleanups: List = []

    def metric(self, node: "GpuExec", name: str) -> GpuMetric:
        m = self.metrics.setdefault(node.node_label(), {})
        if name not in m:
            m[name] = GpuMetric(name)
        return m[name]

    # --- query-end cleanup ------------------------------------------------

    def register_cleanup(self, fn) -> None:
        """Run ``fn`` when the query finishes, however it finishes."""
        self._cleanups.append(fn)

    def run_cleanups(self) -> None:
        fns, self._cleanups[:] = list(self._cleanups), []
        for fn in fns:
            fn()

    def host_ctx(self) -> "ExecCtx":
        """The ctx a CPU island runs under: the same conf, metrics,
        metrics collector, deferred checks, cleanups and lifecycle
        context, device ``cpu``,
        a host eval ctx and the host ledger (``DeviceMemoryManager
        .host()``)."""
        if self.device.type == "cpu" and self.eval_ctx.host:
            return self
        from ..memory import DeviceMemoryManager
        h = copy.copy(self)
        h.device = torch.device("cpu")
        h.eval_ctx = dataclasses.replace(self.eval_ctx, host=True)
        # the card's ledger does not hold host batches: an island runs
        # under an unbounded host ledger, with no retry and no injection
        h.mm = DeviceMemoryManager.host()
        return h

    # --- deferred device-side checks --------------------------------------
    # A predicate that lives on the device (a bool or integer scalar,
    # nonzero means violated) is recorded instead of read back, and raised
    # at the query's download, before any result reaches the caller. The
    # join's build_unique hint probe and K2's key-range count use it.

    def add_deferred_check(self, flag: torch.Tensor, message: str) -> None:
        self.deferred_checks.append((flag, message))

    def discard_deferred(self) -> None:
        """Drop pending checks unread: the query failed before its
        download, and a reused ctx must not report its flags."""
        self.deferred_checks.clear()

    def check_deferred(self) -> None:
        """Read the pending checks (one copy for all) and clear them;
        raise if any is violated."""
        checks = list(self.deferred_checks)
        self.deferred_checks.clear()
        if not checks:
            return
        # one copy a device: a CPU island's flags lie on the host
        by_device: Dict[torch.device, List[int]] = {}
        for i, (f, _) in enumerate(checks):
            by_device.setdefault(f.device, []).append(i)
        values = [0] * len(checks)
        for idx in by_device.values():
            flags = torch.stack([checks[i][0].reshape(()).to(torch.int64)
                                 for i in idx]).cpu().tolist()
            for i, v in zip(idx, flags):
                values[i] = v
        bad = [msg for (_, msg), v in zip(checks, values) if v]
        if bad:
            raise RuntimeError(
                "deferred device checks failed:\n  " + "\n  ".join(bad))


def _shimmed(fn, cpu: bool):
    """An operator's ``execute`` (``cpu`` False) or ``execute_cpu``
    with the cooperative cancellation check at each batch and the
    per-operator accounting (the reference's ``_count_execute`` and
    ``_count_execute_cpu``): batches and rows under the node's label,
    output bytes on the device path, ``cpuFallback`` on the CPU path. A
    device batch's live rows under a selection stay on the device until
    the collector's ``finalize``. When a shim of the same label is
    already counting (an ``execute`` that delegates to ``super()``, a
    copy of the node run inside its own execution) the inner frame
    passes through. With tracing on, the frame that counts (or any
    frame, with op metrics off) runs inside the node's ``op`` span."""
    if getattr(fn, "_shimmed", False):
        return fn

    def run(self, ctx):
        opm = getattr(ctx, "opm", None)
        counting = opm is not None and opm.enabled and self._COUNTED
        claim = opm.enter(self) if counting else None
        tr = getattr(ctx, "tracer", None)
        if tr is None or not tr.enabled or not self._COUNTED \
                or (counting and claim is None):
            yield from _counted(fn, cpu, self, ctx, opm, claim)
            return
        with tr.span(self.node_label(), cat="op",
                     args={"op_id": getattr(self, "_op_id", None)}):
            yield from _counted(fn, cpu, self, ctx, opm, claim)

    run._shimmed = True
    run.__wrapped__ = fn
    run.__doc__ = fn.__doc__
    run.__name__ = fn.__name__
    return run


def _counted(fn, cpu: bool, node, ctx, opm, claim):
    """The shim's body: ``fn``'s batches with the cancellation check,
    counted under ``claim`` (None: not counted)."""
    qx = getattr(ctx, "qctx", None)
    if claim is None:
        if qx is None:
            yield from fn(node, ctx)
            return
        qx.check()
        for b in fn(node, ctx):
            qx.check()
            yield b
        return
    rows_m = ctx.metric(node, "rows")
    batches_m = ctx.metric(node, "batches")
    if cpu:
        ctx.metric(node, "cpuFallback").set(1)
    else:
        bytes_m = ctx.metric(node, "outputBytes")
    try:
        if qx is not None:
            qx.check()
        for b in fn(node, ctx):
            if qx is not None:
                qx.check()
            batches_m.value += 1
            if cpu:
                rows_m.value += b.num_rows
            else:
                opm.count_rows(rows_m, b)
                bytes_m.value += b.device_size_bytes()
            yield b
    finally:
        opm.exit(node, claim)


class GpuExec:
    """Base physical operator."""

    children: Tuple["GpuExec", ...] = ()

    _label_counter = 0

    #: False on the engine's internal leaves (a CPU island's inputs),
    #: which are not plan nodes and keep no metrics
    _COUNTED = True

    #: the class's static contract (``OpContract``); operators override
    CONTRACT: OpContract = OpContract()

    def __init__(self):
        GpuExec._label_counter += 1
        self._label_id = GpuExec._label_counter

    def __init_subclass__(cls, **kw):
        # every operator's own execute/execute_cpu gets the shim, as the
        # reference's (``:300-309``)
        super().__init_subclass__(**kw)
        for name, cpu in (("execute", False), ("execute_cpu", True)):
            if name in cls.__dict__:
                setattr(cls, name, _shimmed(cls.__dict__[name], cpu))

    @property
    def output_schema(self) -> dt.Schema:
        raise NotImplementedError(type(self).__name__)

    def pretty_name(self) -> str:
        n = type(self).__name__
        return n[3:] if n.startswith("Gpu") else n

    def node_label(self) -> str:
        """Metric label: ``<Op>#op<N>`` once the planner stamped a stable
        id (``obs/opmetrics.assign_op_ids``: it survives copies, pickles
        and runs of the plan), else the process-local counter."""
        oid = getattr(self, "_op_id", None)
        if oid is not None:
            return f"{self.pretty_name()}#op{oid}"
        return f"{self.pretty_name()}#{self._label_id}"

    # --- static contract (the plan verifier) --------------------------------

    @classmethod
    def contract(cls) -> OpContract:
        return cls.CONTRACT

    def expected_output_schema(self) -> Optional[dt.Schema]:
        """The output schema derived from the current children, for an
        operator whose cached schema depends on them (join, union,
        window); the verifier compares it with ``output_schema``. None
        when the schema is a function of the node's own bound
        expressions, which ``expr_bindings`` covers."""
        return None

    def expr_bindings(self) -> Sequence[Tuple[object, dt.Schema]]:
        """``(expression, input schema)`` pairs: the schema each bound
        expression resolves against. By default every ``expressions()``
        tree binds against the first child's schema."""
        if not self.children:
            return ()
        schema = self.children[0].output_schema
        return [(e, schema) for e in self.expressions()]

    def resident_footprint(self) -> bool:
        """The instance's residency, where it depends on the node's
        functions (the aggregate's single pass)."""
        return self.contract().resident_footprint

    def static_bytes_estimate(self) -> Optional[int]:
        """A leaf's byte estimate for the verifier's footprint pass
        (host batches exactly, files by their sizes); None when
        unknown."""
        return None

    def device_fn(self):
        """The per-batch function ``(GpuBatch, EvalCtx) -> GpuBatch`` when
        this operator is a row-wise map over one batch (project, lazy
        filter), the unit of stage fusion; None for barriers."""
        return None

    def fused_chain_fn(self, chain: Sequence["GpuExec"], ctx: "ExecCtx"):
        """A per-batch function that computes ``chain`` (the fused
        operators below this consumer, bottom first) together with this
        consumer's own per-batch tail in one kernel launch, or None when
        the chain does not have a kernel's shape."""
        return None

    def execute(self, ctx: ExecCtx) -> Iterator[GpuBatch]:
        raise NotImplementedError(type(self).__name__)

    def execute_cpu(self, ctx: ExecCtx) -> Iterator[pa.RecordBatch]:
        """The CPU path (module docstring): this operator's torch body on
        CPU tensors over its children's ``execute_cpu``, each output
        batch downloaded to Arrow."""
        node = self.with_new_children(
            [_HostInputExec(c, ctx) for c in self.children])
        node._label_id = self._label_id  # metrics under this node's label
        for b in node.execute(ctx.host_ctx()):
            yield device_to_arrow(b)

    # --- planner hooks ------------------------------------------------------

    def gpu_supported(self) -> Optional[str]:
        """None when the device can run this operator, else the reason
        (the reference's ``tpu_supported``)."""
        return None

    def gpu_supported_conf(self, conf: RapidsConf) -> Optional[str]:
        """The same under the session's conf (the reference's
        ``tpu_supported_conf``)."""
        return None

    def expressions(self) -> List:
        """The operator's bound expressions, for the planner's per-
        expression checks."""
        return []

    def with_new_children(self, children: Sequence["GpuExec"]) \
            -> "GpuExec":
        """A copy of this operator over new children of the same output
        schemas (the planner inserts readers this way), with its own
        metric label."""
        if list(children) == list(self.children):
            return self
        c = copy.copy(self)
        GpuExec._label_counter += 1
        c._label_id = GpuExec._label_counter
        c.children = tuple(children)
        return c

    def tree_string(self, indent: int = 0) -> str:
        lines = [("  " * indent) + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.pretty_name()

    def __repr__(self):
        return self.tree_string()


def _record_stage_time(ctx: ExecCtx, metric: Optional[GpuMetric],
                       t0: float) -> None:
    """A fused stage's ``opTime`` from its host start ``t0`` to the
    device's completion (the reference's ``:468-483``). On the card the
    collector records a CUDA event after the stage's launches and its
    watcher measures when the event completes, with no sync on this
    thread; a CPU context, and the card with op metrics off, add the
    wall time here."""
    if metric is None:
        return
    opm = ctx.opm
    if ctx.device.type != "cuda":
        opm.add_wall_time(metric, t0, "cpu")
    elif opm.enabled:
        opm.defer_stage_time(metric, t0, ctx.device)
    else:
        opm.add_wall_time(metric, t0, "wall")


def fused_batches(consumer: GpuExec, ctx: ExecCtx, tail_fn=None,
                  metric: Optional[GpuMetric] = None) \
        -> Iterator[GpuBatch]:
    """Stream the batches feeding ``consumer``, running the chain of
    fusable operators below it plus the consumer's own per-batch
    ``tail_fn`` once per batch.

    Where the reference jits the chain into one XLA program per batch,
    the port asks the consumer for a kernel of the chain's shape
    (``fused_chain_fn``; q6's filter -> product -> sum is K1, the same
    grouped over a small keyspace K2) and runs it as one launch per batch.
    Any other chain runs its operators' eager torch code in turn. The
    route is decided by the chain's shape before the first batch, never
    by a failure. When the chain's leaf is a scan that decodes on the
    device (``fused_scan_execute``), the scan runs the chain right after
    each batch's K5 decode, on the same stream. With
    ``spark.rapids.sql.stageFusion.enabled`` off every operator runs on
    its own.

    Each stage's launch time goes to the consumer's ``dispatchTime``
    and its time to the device's completion to ``metric``
    (``_record_stage_time``); every fused node, and a spliced scan,
    records the consumer's id in ``fusedInto``."""
    node = consumer.children[0]
    chain = []
    if ctx.stage_fusion:
        while isinstance(node, UnaryExec) and node.device_fn() is not None:
            chain.append(node)
            node = node.children[0]
        chain.reverse()
    fns = [n.device_fn() for n in chain]
    if tail_fn is not None:
        fns.append(tail_fn)
    if not fns:
        yield from node.execute(ctx)
        return
    oid = getattr(consumer, "_op_id", None) or consumer._label_id
    for n in chain:
        ctx.metric(n, "fusedInto").set(oid)
    ctx.metric(consumer, "fusedChainOps").set(len(fns))
    dispatch_m = ctx.metric(consumer, "dispatchTime")
    run = None
    if tail_fn is not None:
        run = consumer.fused_chain_fn(chain, ctx)
    if run is None:
        def run(b, ectx):
            for f in fns:
                b = f(b, ectx)
            return b

    # a stage's span: the consumer's label, the nodes it ran in "fused"
    label = consumer.node_label()
    span_args = {"op_id": getattr(consumer, "_op_id", None),
                 "fused": [getattr(n, "_op_id", None) for n in chain]}

    def spliced(b, ectx):
        with ctx.tracer.span(label, cat="op", args=span_args):
            t0 = time.perf_counter()
            out = run(b, ectx)
            dispatch_m.value += time.perf_counter() - t0
            _record_stage_time(ctx, metric, t0)
        return out

    def retried(b, ectx):
        # split-and-retry on device OOM: the stage reruns over the
        # batch's halves, each half's result its own stream item
        with ctx.tracer.span(label, cat="op", args=span_args):
            t0 = time.perf_counter()
            outs = ctx.mm.with_retry(b, lambda bb: run(bb, ectx),
                                     qctx=ctx.qctx)
            dispatch_m.value += time.perf_counter() - t0
            _record_stage_time(ctx, metric, t0)
        return outs

    # scan-rooted splice: a leaf that decodes on the device runs the chain
    # right after each batch's decode (no split-and-retry there); it
    # declines with None when that path is off or the ledger is past half
    # its budget
    scan_fused = getattr(node, "fused_scan_execute", None)
    gen = None if scan_fused is None or not ctx.stage_fusion \
        else scan_fused(ctx, spliced)
    if gen is not None:
        ctx.metric(node, "fusedInto").set(oid)
        span_args["fused"].append(getattr(node, "_op_id", None))
    else:
        gen = (out for b in node.execute(ctx)
               for out in retried(b, ctx.eval_ctx))
    try:
        yield from gen
    finally:
        gen.close()


# the default CPU path lives on the base class, which __init_subclass__
# does not see: an operator that inherits it is shimmed all the same
GpuExec.execute_cpu = _shimmed(GpuExec.execute_cpu, True)


class LeafExec(GpuExec):
    children = ()


class _HostInputExec(LeafExec):
    """A CPU island's input: ``child.execute_cpu`` under the outer ctx
    (a device subtree below a ``DeviceToHostExec`` runs there as
    planned), each Arrow batch put into CPU tensors."""

    _COUNTED = False

    def __init__(self, child: GpuExec, outer: ExecCtx):
        super().__init__()
        self.source = child
        self.outer = outer

    @property
    def output_schema(self):
        return self.source.output_schema

    def execute(self, ctx):
        schema = self.source.output_schema
        for rb in self.source.execute_cpu(self.outer):
            yield arrow_to_device(rb, schema, ctx.device)


class _ArrowSourceExec(LeafExec):
    """A leaf over an iterable of Arrow batches, consumed once (an
    operator's CPU run over input it already drew from the device)."""

    _COUNTED = False

    def __init__(self, batches, schema: dt.Schema):
        super().__init__()
        self.batches = batches
        self._schema = schema

    @property
    def output_schema(self):
        return self._schema

    def execute(self, ctx):
        for rb in self.batches:
            yield arrow_to_device(rb, self._schema, ctx.device)

    def execute_cpu(self, ctx):
        yield from self.batches


class UnaryExec(GpuExec):
    def __init__(self, child: GpuExec):
        super().__init__()
        self.children = (child,)

    @property
    def child(self) -> GpuExec:
        return self.children[0]

    @property
    def output_schema(self) -> dt.Schema:
        return self.child.output_schema


class HostBatchSourceExec(LeafExec):
    """Leaf over in-memory host Arrow batches (the LocalTableScan
    analog)."""

    def __init__(self, batches: Sequence[pa.RecordBatch],
                 schema: Optional[dt.Schema] = None):
        super().__init__()
        self.batches = list(batches)
        if schema is None:
            if not self.batches:
                raise ValueError("empty source needs an explicit schema")
            schema = engine_schema(self.batches[0].schema)
        self._schema = schema

    @property
    def output_schema(self):
        return self._schema

    def static_bytes_estimate(self):
        return sum(rb.nbytes for rb in self.batches)

    def _normalized(self) -> Iterator[pa.RecordBatch]:
        target = arrow_schema(self._schema)
        for rb in self.batches:
            if rb.schema != target:
                rb = pa.RecordBatch.from_arrays(
                    [rb.column(i).cast(target.field(i).type)
                     for i in range(rb.num_columns)], schema=target)
            yield rb

    def execute_cpu(self, ctx):
        yield from self._normalized()

    def execute(self, ctx):
        rows = ctx.metric(self, "numOutputRows")
        t = ctx.metric(self, "uploadTime")
        for rb in self._normalized():
            t0 = time.perf_counter()
            b = arrow_to_device(rb, self._schema, ctx.device)
            t.value += time.perf_counter() - t0
            rows += rb.num_rows
            yield b


class DeviceBatchSourceExec(LeafExec):
    """Leaf over already-resident device batches."""

    def __init__(self, batches: Sequence[GpuBatch], schema: dt.Schema):
        super().__init__()
        self.batches = list(batches)
        self._schema = schema

    @property
    def output_schema(self):
        return self._schema

    def static_bytes_estimate(self):
        return sum(b.device_size_bytes() for b in self.batches)

    def execute(self, ctx):
        yield from self.batches

    def execute_cpu(self, ctx):
        for b in self.batches:
            yield device_to_arrow(b)


def collect_arrow(plan: GpuExec, ctx: Optional[ExecCtx] = None) \
        -> pa.Table:
    """Run the plan on the device under an admission slot (its wait in
    the root's ``ledgerWaitTime``) and download the result as one Arrow
    table; the deferred device checks and the per-operator metrics are
    read at the download, and a failed run drops both."""
    ctx = ctx or ExecCtx()
    try:
        t0 = time.perf_counter()
        with ctx.mm.task_slot(ctx.qctx):
            ctx.metric(plan, "ledgerWaitTime").value += \
                time.perf_counter() - t0
            batches = [device_to_arrow(b) for b in plan.execute(ctx)]
    except BaseException:
        ctx.discard_deferred()
        ctx.opm.discard()
        raise
    finally:
        ctx.run_cleanups()
    ctx.check_deferred()
    ctx.opm.finalize()
    return pa.Table.from_batches(batches,
                                 schema=arrow_schema(plan.output_schema))


def collect_arrow_cpu(plan: GpuExec, ctx: Optional[ExecCtx] = None) \
        -> pa.Table:
    """Run the plan's CPU path (``execute_cpu`` at the root) and return
    one Arrow table; device subtrees under a ``DeviceToHostExec`` run on
    ``ctx.device``, and the deferred device checks and the per-operator
    metrics are read at the end."""
    ctx = ctx or ExecCtx()
    try:
        batches = list(plan.execute_cpu(ctx))
    except BaseException:
        ctx.discard_deferred()
        ctx.opm.discard()
        raise
    finally:
        ctx.run_cleanups()
    ctx.check_deferred()
    ctx.opm.finalize()
    return pa.Table.from_batches(batches,
                                 schema=arrow_schema(plan.output_schema))

"""Static plan verifier: operator contracts checked before execution.

Counterpart of ``spark_rapids_tpu/analysis/plan_verifier.py``.
``verify_plan`` runs one bottom-up pass over a physical tree; the
planner runs it on every rebuilt plan while ``spark.rapids.sql.
verifyPlan`` is on (the default) and raises ``PlanVerificationError``
with the report, so a broken plan is refused with a named reason before
any kernel runs instead of failing, or running out of device memory,
mid-query.

The contracts are declared on the operators (``exec/base.py``
``OpContract`` and the hooks ``expected_output_schema``,
``expr_bindings``, ``resident_footprint``, ``static_bytes_estimate``).
The defect classes (the ``reason`` names are stable API, the
reference's letter for letter):

- ``schema_mismatch``: a declared output schema disagrees with what the
  current children imply, or a bound expression names an ordinal or a
  type its input schema does not have (a stale ``with_new_children``).
- ``nullability_lie``: an output field or bound reference claims
  non-nullable over a nullable input.
- ``missing_exchange``: a shuffled hash join whose children are both
  shuffle exchanges partitioned differently (scheme or count).
- ``malformed_aqe_wrapper``: an adaptive reader over anything but a
  shuffle exchange.
- ``hbm_over_budget``: a resident-footprint operator (an aggregate's
  single pass) whose static byte estimate exceeds the memory ledger's
  device budget (``memory.resolve_device_budget``).
- ``unsupported_dtype``: sort, group, join or partition keys of a map
  type, at any depth.

The report is machine-readable (``VerifyReport.to_dict``); a refusal is
visible in the raised error's ``report.to_dict()``, in a ``plan`` /
``plan_rejected`` flight-recorder event and, with
``spark.rapids.eventLog.dir`` set, in a ``plan_rejected`` event-log line
(``report_rejection``, the reference's ``:351-366``).
``python -m spark_rapids_tpu_torch.analysis.plan_verifier --smoke
[--device DEV]`` plans every text of ``nds.PORTED_QUERIES`` and requires
each to verify clean and one seeded defect to be refused (the budget is
the device's: ``cuda:0`` unless ``--device cpu``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .. import datatypes as dt
from ..config import RapidsConf

__all__ = ["PlanVerificationError", "PlanVerifier", "VerifyReport",
           "Violation", "verify_plan", "report_rejection"]


@dataclasses.dataclass
class Violation:
    reason: str   # the defect class (module docstring)
    op: str       # the node's label, e.g. ShuffledHashJoinExec#op12
    detail: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class VerifyReport:
    def __init__(self):
        self.violations: List[Violation] = []
        self.nodes_checked = 0
        self.hbm_estimate_bytes: Optional[int] = None
        self.hbm_budget_bytes: Optional[int] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, reason: str, node, detail: str):
        self.violations.append(Violation(reason, node.node_label(), detail))

    def reasons(self) -> List[str]:
        return sorted({v.reason for v in self.violations})

    def to_dict(self) -> Dict:
        return {
            "ok": self.ok,
            "nodes_checked": self.nodes_checked,
            "violations": [v.to_dict() for v in self.violations],
            "hbm_estimate_bytes": self.hbm_estimate_bytes,
            "hbm_budget_bytes": self.hbm_budget_bytes,
        }

    def summary(self) -> str:
        if self.ok:
            return f"plan ok ({self.nodes_checked} nodes)"
        return "; ".join(f"[{v.reason}] {v.op}: {v.detail}"
                         for v in self.violations)


class PlanVerificationError(RuntimeError):
    """A plan failed static verification; ``.report`` has the details."""

    def __init__(self, report: VerifyReport):
        self.report = report
        super().__init__(f"plan rejected by the static verifier: "
                         f"{report.summary()}")


def _contains_map(t: dt.DataType) -> bool:
    if isinstance(t, dt.MapType):
        return True
    if isinstance(t, dt.ArrayType):
        return _contains_map(t.element_type)
    if isinstance(t, dt.StructType):
        return any(_contains_map(f.dtype) for f in t.fields)
    return False


def _walk_expr(expr):
    out = [expr]
    for c in getattr(expr, "children", ()):
        out.extend(_walk_expr(c))
    return out


def _schema_sig(schema: dt.Schema) -> List[Tuple[str, dt.DataType]]:
    return [(f.name, f.dtype) for f in schema.fields]


class PlanVerifier:
    """Bottom-up contract checks over one physical tree; the budget is
    that of ``device`` (the planner's), as the ledger's."""

    def __init__(self, conf: Optional[RapidsConf] = None, device=None):
        self.conf = conf or RapidsConf()
        self.device = device

    def verify(self, root) -> VerifyReport:
        from ..memory import resolve_device_budget
        report = VerifyReport()
        report.hbm_budget_bytes = resolve_device_budget(self.conf,
                                                        self.device)
        self._visit(root, report)
        return report

    def _visit(self, node, report: VerifyReport) -> Optional[int]:
        """Post-order: every check on the node, and its static output
        byte estimate (None when unknown)."""
        child_bytes = [self._visit(c, report) for c in node.children]
        report.nodes_checked += 1
        self._check_wrapper(node, report)
        self._check_schemas(node, report)
        self._check_expr_bindings(node, report)
        self._check_key_dtypes(node, report)
        self._check_copartition(node, report)
        return self._check_footprint(node, child_bytes, report)

    # --- structural checks ------------------------------------------------

    def _check_wrapper(self, node, report):
        want = node.contract().wrapper_over
        if not want:
            return
        child = node.children[0] if node.children else None
        got = type(child).__name__ if child is not None else "<none>"
        if got != want:
            report.add(
                "malformed_aqe_wrapper", node,
                f"{type(node).__name__} requires a {want} child, got "
                f"{got}")

    def _check_schemas(self, node, report):
        try:
            declared = node.output_schema
        except Exception as e:  # noqa: BLE001 — a schema that cannot be
            report.add("schema_mismatch", node,  # computed is the defect
                       f"output schema raises: {e}")
            return
        if node.contract().schema_preserving and node.children:
            self._compare_schemas(node, node.children[0].output_schema,
                                  declared, report, origin="child")
        try:
            expected = node.expected_output_schema()
        except Exception as e:  # noqa: BLE001 — a hook that cannot derive
            # a schema from the current children is the stale rebuild
            # itself: a named refusal, not a traceback
            report.add("schema_mismatch", node,
                       f"output schema cannot be derived from the "
                       f"current children: {e}")
            return
        if expected is not None:
            self._compare_schemas(node, expected, declared, report,
                                  origin="derived")

    def _compare_schemas(self, node, expected: dt.Schema,
                         declared: dt.Schema, report, origin: str):
        if _schema_sig(expected) != _schema_sig(declared):
            report.add(
                "schema_mismatch", node,
                f"declared output schema {declared!r} does not agree "
                f"with the {origin} schema {expected!r}")
            return
        for ef, df in zip(expected.fields, declared.fields):
            if ef.nullable and not df.nullable:
                report.add(
                    "nullability_lie", node,
                    f"output field {df.name} declared non-nullable but "
                    f"the {origin} schema says {ef.name} is nullable")

    def _check_expr_bindings(self, node, report):
        from ..expr.base import BoundReference
        try:
            bindings = list(node.expr_bindings())
        except Exception as e:  # noqa: BLE001 — as the schema hook
            report.add("schema_mismatch", node,
                       f"expression bindings cannot be derived from "
                       f"the current children: {e}")
            return
        for expr, schema in bindings:
            if expr is None or schema is None:
                continue
            for e in _walk_expr(expr):
                if not isinstance(e, BoundReference):
                    continue
                if not (0 <= e.ordinal < len(schema.fields)):
                    report.add(
                        "schema_mismatch", node,
                        f"expression {e!r} references ordinal "
                        f"{e.ordinal} but the input schema has "
                        f"{len(schema.fields)} columns")
                    continue
                f = schema.fields[e.ordinal]
                if e.dtype != f.dtype:
                    report.add(
                        "schema_mismatch", node,
                        f"expression {e!r} expects "
                        f"{e.dtype.simple_string()} at ordinal "
                        f"{e.ordinal} but the input column {f.name} is "
                        f"{f.dtype.simple_string()}")
                elif f.nullable and not e.nullable:
                    report.add(
                        "nullability_lie", node,
                        f"expression {e!r} claims non-nullable but "
                        f"input column {f.name} is nullable")

    def _key_exprs(self, node):
        """``(kind, key expression)`` pairs whose types some engine path
        must compare or hash."""
        name = type(node).__name__
        if name == "GpuSortExec":
            return [("sort key", o.child) for o in node.orders]
        if name == "GpuWindowExec":
            return ([("window partition key", e)
                     for e in node.part_exprs]
                    + [("window order key", o.child)
                       for o in node.orders])
        if name == "GpuHashAggregateExec":
            return [("group key", e) for e in node.group_exprs]
        if name == "GpuShuffleExchangeExec":
            part = node.partitioning
            keys = getattr(part, "key_exprs", None) or \
                [o.child for o in getattr(part, "orders", [])]
            return [("partition key", e) for e in keys]
        if hasattr(node, "left_keys") and hasattr(node, "right_keys"):
            return [("join key", e)
                    for e in list(node.left_keys) + list(node.right_keys)]
        return []

    def _check_key_dtypes(self, node, report):
        for kind, e in self._key_exprs(node):
            try:
                t = e.dtype
            except Exception:  # noqa: BLE001 — an unresolvable key is the
                continue       # binding checks' finding
            if _contains_map(t):
                report.add(
                    "unsupported_dtype", node,
                    f"{kind} {e!r} has type {t.simple_string()}: map "
                    "types cannot be compared or hashed on any engine "
                    "path")

    def _check_copartition(self, node, report):
        if not node.contract().requires_copartition:
            return
        if len(node.children) != 2:
            return
        exchanges = [self._unwrap_exchange(c) for c in node.children]
        if any(e is None for e in exchanges):
            # a child that is no exchange: the local join core's shape,
            # nothing to prove
            return
        lp, rp = (e.partitioning for e in exchanges)
        if type(lp) is not type(rp):
            report.add(
                "missing_exchange", node,
                f"join children are exchanges with different "
                f"partitioning schemes ({type(lp).__name__} vs "
                f"{type(rp).__name__})")
        elif lp.num_partitions != rp.num_partitions:
            report.add(
                "missing_exchange", node,
                f"join children are hash exchanges with different "
                f"partition counts ({lp.num_partitions} vs "
                f"{rp.num_partitions}); equal keys would land in "
                "different partitions")

    @staticmethod
    def _unwrap_exchange(node):
        from ..exec.aqe import GpuAQEShuffleReadExec
        from ..exec.exchange import GpuShuffleExchangeExec
        if isinstance(node, GpuAQEShuffleReadExec):
            node = node.children[0] if node.children else node
        return node if isinstance(node, GpuShuffleExchangeExec) else None

    # --- static device footprint -------------------------------------------

    def _check_footprint(self, node, child_bytes, report) -> Optional[int]:
        own = node.static_bytes_estimate()
        if own is None:
            known = [b for b in child_bytes if b is not None]
            own = sum(known) if known else None
        if own is not None:
            report.hbm_estimate_bytes = max(
                report.hbm_estimate_bytes or 0, own)
        try:
            resident = node.resident_footprint()
        except Exception:  # noqa: BLE001 — a broken hook must not mask
            resident = False  # the findings already collected
        if resident and own is not None \
                and report.hbm_budget_bytes is not None \
                and own > report.hbm_budget_bytes:
            report.add(
                "hbm_over_budget", node,
                f"static estimate {own} bytes must be device-resident "
                f"at once (no out-of-core path) but the HBM ledger "
                f"budget is {report.hbm_budget_bytes} bytes")
        return own


def verify_plan(root, conf: Optional[RapidsConf] = None,
                device=None) -> VerifyReport:
    """Run the contract pass; raises nothing (the planner raises
    ``PlanVerificationError`` on a report that is not ok)."""
    return PlanVerifier(conf, device).verify(root)


def report_rejection(conf: RapidsConf, report: VerifyReport, root,
                     query_id: str = "") -> None:
    """Make a refusal visible beyond the raised error: a
    ``plan_rejected`` event in the always-on flight ring and a
    ``plan_rejected`` event-log line when the event log is on."""
    from ..obs.recorder import RECORDER
    from ..tools.event_log import log_plan_rejected
    RECORDER.configure(conf)
    if RECORDER.enabled:
        RECORDER.record(
            "plan", ev="plan_rejected", query=query_id,
            n_violations=len(report.violations),
            reasons=",".join(report.reasons()),
            detail=report.summary()[:600])
    log_plan_rejected(conf, report, root, query_id=query_id)


# --- smoke -------------------------------------------------------------------

def _smoke(device) -> int:
    """Plan every text of ``nds.PORTED_QUERIES`` over the corpus's small
    tables, each verified clean, then one seeded defect (an adaptive
    reader over a source, not an exchange) refused."""
    import json

    from .. import nds
    from ..exec.aqe import GpuAQEShuffleReadExec
    from ..exec.base import HostBatchSourceExec
    from ..exec.exchange import GpuShuffleExchangeExec
    from ..planner import GpuOverrides
    from ..session import GpuSession
    from ..shuffle.partitioner import SinglePartitioning
    conf = RapidsConf()
    tables = nds.gen_tables(1 << 10)
    bad = {}
    for name in nds.PORTED_QUERIES:
        session = GpuSession(conf, device=device)
        node = nds.build_query_sql(name, session, tables)._node
        rep = verify_plan(node, conf, session.device)
        planned = GpuOverrides(conf, session.device).apply(node)
        if not rep.ok or not planned.verify_report.ok:
            bad[name] = (rep.to_dict(), planned.verify_report.to_dict())
    src = HostBatchSourceExec(tables["store"].to_batches())
    reader = GpuAQEShuffleReadExec(
        GpuShuffleExchangeExec(SinglePartitioning(), src))
    seeded = verify_plan(reader.with_new_children([src]), conf, device)
    print(json.dumps({
        "nds_clean": not bad,
        "nds_queries": len(nds.PORTED_QUERIES),
        "seeded_rejected": not seeded.ok,
        "seeded_reasons": seeded.reasons(),
    }, indent=2))
    for name, reps in bad.items():
        print(f"NOT CLEAN: {name}: {reps}")
    if bad:
        return 1
    if seeded.reasons() != ["malformed_aqe_wrapper"]:
        print("the seeded broken plan was not refused as malformed")
        return 1
    return 0


if __name__ == "__main__":
    import sys
    argv = sys.argv[1:]
    if "--smoke" in argv:
        dev = argv[argv.index("--device") + 1] if "--device" in argv \
            else None
        sys.exit(_smoke(dev))
    print("usage: python -m spark_rapids_tpu_torch.analysis.plan_verifier "
          "--smoke [--device DEV]", file=sys.stderr)
    sys.exit(2)

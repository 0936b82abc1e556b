"""Planner: the override pass from an operator tree to a physical plan.

Counterpart of ``spark_rapids_tpu/planner.py:45-160,404-540``
(``NodeMeta``, ``PhysicalPlan``, ``TpuOverrides``): wrap every node in a
``NodeMeta``, tag each bottom-up (the master switch
``spark.rapids.sql.enabled``, the per-operator and per-expression
switches ``spark.rapids.sql.exec.<Name>`` / ``.expression.<Name>``, and
each expression's device gate ``gpu_supported``, the reference's
``tpu_supported``, which names the ROADMAP item a window the device
cannot compute waits for), then rebuild the tree with the adaptive
reader over every shuffle exchange while ``spark.sql.adaptive.enabled``
is on. ``PhysicalPlan.collect`` runs the root on the device and
downloads Arrow; ``explain`` renders the placement.

The port has no CPU path: a node tagged off the device raises
``NotImplementedError`` with its reasons instead of falling back. The
reference's per-operator CPU fallback through ``execute_cpu`` and its
transitions are ROADMAP item 12's remainder. So is the static plan
verifier (``analysis/plan_verifier.py``): ``spark.rapids.sql.verifyPlan``
is not honoured yet, and its contracts (schema and nullability
agreement, co-partitioned exchanges, well-formed AQE wrappers, the HBM
footprint estimate, unsupported key types) are listed under item 12.
Operator ids, the query profile and the telemetry bracket wait for
item 15, the query lifecycle for item 14.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import pyarrow as pa

from .config import ADAPTIVE_ENABLED, EXPLAIN, SQL_ENABLED, RapidsConf
from .exec.base import ExecCtx, GpuExec, collect_arrow, resolve_device

__all__ = ["NodeMeta", "PhysicalPlan", "GpuOverrides"]


def _walk_expr(expr) -> List[object]:
    out = [expr]
    for c in getattr(expr, "children", ()):
        out.extend(_walk_expr(c))
    return out


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
        for root in self.node.expressions():
            for e in _walk_expr(root):
                ename = e.pretty_name()
                if not conf.is_op_enabled("expression", ename):
                    self.reasons.append(
                        f"expression {e!r} has been disabled by "
                        f"spark.rapids.sql.expression.{ename}")
                    continue
                gate = getattr(e, "gpu_supported", None)
                reason = gate() if gate is not None else None
                if reason:
                    self.reasons.append(f"expression {e!r}: {reason}")

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

    def off_device(self) -> List["NodeMeta"]:
        out = [] if self.on_device else [self]
        for c in self.children:
            out.extend(c.off_device())
        return out


class PhysicalPlan:
    """Planner output: the rebuilt tree, its placement and the device it
    runs on."""

    def __init__(self, root: GpuExec, meta: NodeMeta, conf: RapidsConf,
                 device=None):
        self.root = root
        self.meta = meta
        self.conf = conf
        self.device = device

    @property
    def output_schema(self):
        return self.root.output_schema

    def explain(self, mode: Optional[str] = None) -> str:
        mode = mode or self.conf.get(EXPLAIN)
        if mode == "NONE":
            return ""
        return "\n".join(self.meta.explain_lines(mode))

    def collect(self, ctx: Optional[ExecCtx] = None) -> pa.Table:
        """Run the plan on its device and download one Arrow table."""
        return collect_arrow(self.root, ctx or ExecCtx(self.conf,
                                                       self.device))


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
        from .exec.aqe import GpuAQEShuffleReadExec
        from .exec.exchange import GpuShuffleExchangeExec
        children = []
        for c in meta.children:
            built = self._convert(c)
            if self.conf.get(ADAPTIVE_ENABLED) \
                    and isinstance(built, GpuShuffleExchangeExec):
                built = GpuAQEShuffleReadExec(built)
            children.append(built)
        return meta.node.with_new_children(children)

    def apply(self, plan: GpuExec) -> PhysicalPlan:
        meta = self._wrap(plan)
        self._tag(meta)
        bad = meta.off_device()
        if bad:
            raise NotImplementedError(
                "the port has no CPU fallback (ROADMAP item 12): "
                + " | ".join(f"{m.node.pretty_name()}: "
                             + "; ".join(m.reasons) for m in bad))
        pp = PhysicalPlan(self._convert(meta), meta, self.conf, self.device)
        mode = self.conf.get(EXPLAIN)
        if mode == "ALL":
            # stderr: scripts that drive the engine keep stdout for results
            print(pp.explain(mode), file=sys.stderr)
        return pp

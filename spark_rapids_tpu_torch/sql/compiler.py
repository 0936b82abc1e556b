"""SQL resolver/compiler: typed AST -> the port's exec/expr plan.

Counterpart of ``spark_rapids_tpu/sql/compiler.py`` over the port's
operators and expressions, with the same resolution, typing and
lowering. Responsibilities:

- bind identifiers (optionally qualified) against relation scopes with
  ambiguity detection, CTE scope chains with shadowing, and the
  session catalog;
- infer/coerce types exactly like the DataFrame layer (NULL-literal
  retyping, numeric widening via the session analyzer, fractional
  division);
- lower SELECT cores into the node constructors the DataFrame API already
  uses — Project/Filter/ShuffleExchange+HashAggregate/Sort/Limit, the
  shuffled hash join and the nested-loop join — so SQL-originated plans flow through the
  same ``GpuOverrides.apply`` -> ``PhysicalPlan`` path (AQE reader,
  tagging);
- plan comma-separated FROM lists the way real NDS queries are
  written: single-table conjuncts push down to their table, equality
  conjuncts become shuffled-hash-join keys over a greedy join order,
  an item no equality reaches is cross-joined, the rest stays a
  residual filter;
- honor ``/*+ UNIQUE(alias...) */`` hints by setting the join's
  ``build_unique_hint`` (the session API's ``build_unique=`` analog);
- lower window expressions into one ``GpuWindowExec`` a distinct
  (partition, order) spec between the aggregation and the projection,
  and UNION ALL into ``GpuUnionExec`` with numeric widening and ORDER BY
  by output name or position.

Every failure raises ``SqlAnalysisError`` with a source location and a
stable ``detail`` code (``unknown_column``, ``ambiguous_column``,
``unknown_function``, ``missing_aggregation``, ...). A construct whose
expression or operator the port does not have yet (SELECT without FROM)
raises ``SqlAnalysisError(..., "unsupported_feature")`` naming its
ROADMAP item when a query reaches it. ``CAST(... AS DECIMAL(p,s))``
builds the type as the reference's (``:260-263``); a number literal
stays as the reference lexes it (``1.5`` is a double, where Spark reads
``decimal(2,1)``; ROADMAP "Things to know"). A non-equi condition on an outer, semi or
anti equi-join and a LIKE pattern outside the device regex dialect
compile as any other; the planner places their operators on the CPU.
Every join type runs: equi-joins on
the shuffled hash join, a CROSS JOIN, an ON without an equi-key and a
comma FROM item no equality reaches on the nested-loop join
(``GpuBroadcastNestedLoopJoinExec``), as in the reference. UNION DISTINCT is
outside the dialect, as in the reference (``unsupported_feature``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .. import datatypes as dt
from ..expr.aggregates import _Collect
from ..expr.base import Alias, BoundReference, Expression, Literal
from . import ast as A
from . import functions as F
from .errors import SqlAnalysisError

__all__ = ["SqlCompiler", "Rel"]


class Rel:
    """A compiled relation: exec node + per-output-column qualifier
    (the alias/table name each column is addressable through)."""

    def __init__(self, node, quals: Sequence[Optional[str]]):
        self.node = node
        self.quals = list(quals)
        assert len(self.quals) == len(node.output_schema.fields), \
            (len(self.quals), node.output_schema.names)

    @property
    def schema(self):
        return self.node.output_schema

    def ref(self, i: int) -> BoundReference:
        f = self.schema.fields[i]
        return BoundReference(i, f.dtype, f.nullable, f.name)


def _split_and(node: A.Node) -> List[A.Node]:
    if isinstance(node, A.Binary) and node.op == "AND":
        return _split_and(node.left) + _split_and(node.right)
    return [node]


def _cols_of(node) -> List[A.Col]:
    """Column references in an expression AST (no relation subtrees in
    expression position in this dialect)."""
    return [n for n in A.walk(node) if isinstance(n, A.Col)]


class SqlCompiler:
    def __init__(self, session, sql_text: str):
        self.session = session
        self.conf = session.conf
        self.sql = sql_text
        from ..config import CASE_SENSITIVE
        self.case_sensitive = bool(self.conf.get(CASE_SENSITIVE))

    # --- error helpers ----------------------------------------------------
    def err(self, msg: str, node: A.Node, detail: str) -> SqlAnalysisError:
        return SqlAnalysisError(msg, self.sql, node.loc, detail)

    def unported(self, what: str, node: A.Node,
                 item: int = 13) -> SqlAnalysisError:
        return self.err(f"{what} is not ported yet (ROADMAP item {item})",
                        node, "unsupported_feature")

    def _eq_name(self, a: str, b: str) -> bool:
        return a == b if self.case_sensitive else a.lower() == b.lower()

    # --- scope resolution -------------------------------------------------
    def _candidates(self, rel: Rel, col: A.Col) -> List[int]:
        out = []
        for i, f in enumerate(rel.schema.fields):
            if not self._eq_name(f.name, col.name):
                continue
            if col.qualifier is not None:
                q = rel.quals[i]
                if q is None or not self._eq_name(q, col.qualifier):
                    continue
            out.append(i)
        return out

    def resolve(self, rel: Rel, col: A.Col,
                grouped: bool = False) -> BoundReference:
        c = self._candidates(rel, col)
        disp = f"{col.qualifier}.{col.name}" if col.qualifier \
            else col.name
        if len(c) > 1:
            raise self.err(f"column {disp!r} is ambiguous (matches "
                           f"{len(c)} columns)", col, "ambiguous_column")
        if not c:
            if grouped:
                raise self.err(
                    f"column {disp!r} is neither grouped nor "
                    "aggregated", col, "missing_aggregation")
            names = [n for n in rel.schema.names
                     if not n.startswith("__")]
            raise self.err(f"column {disp!r} not found; available: "
                           f"{', '.join(names[:12])}", col,
                           "unknown_column")
        return rel.ref(c[0])

    def _fits(self, rel: Rel, node: A.Node) -> bool:
        """Every column of the expression resolves (unambiguously) in
        this relation."""
        cols = _cols_of(node)
        if not cols:
            return False
        return all(len(self._candidates(rel, c)) == 1 for c in cols)

    # --- expression lowering ----------------------------------------------
    def compile_expr(self, node: A.Node, rel: Rel,
                     subst: Sequence[Tuple[A.Node, int]] = (),
                     grouped: bool = False) -> Expression:
        e = self._compile(node, rel, subst, grouped)
        return self._finalize(e, node)

    def _finalize(self, e: Expression, node: A.Node) -> Expression:
        from ..session import _analyze
        analyzed = _analyze(e)
        try:
            analyzed.transform(lambda n: (n.validate(), n)[1])
        except (TypeError, ValueError) as exc:
            raise self.err(str(exc), node, "type_error") from exc
        return analyzed

    def _compile(self, node, rel, subst, grouped) -> Expression:
        for ast_key, ordinal in subst:
            if ast_key == node:
                return rel.ref(ordinal)
        method = getattr(self, "_c_" + type(node).__name__.lower(), None)
        if method is None:
            raise self.err(f"{type(node).__name__} is not valid in an "
                           "expression here", node, "unsupported_feature")
        return method(node, rel, subst, grouped)

    def _kids(self, nodes, rel, subst, grouped):
        return [self._compile(n, rel, subst, grouped) for n in nodes]

    @staticmethod
    def _retype_nulls(exprs: List[Expression]) -> List[Expression]:
        """Contextual NULL-literal typing: an untyped NULL adopts the
        type of its first typed sibling (Catalyst's null coercion)."""
        sib = next((e.dtype for e in exprs
                    if not isinstance(e.dtype, dt.NullType)), None)
        if sib is None:
            return exprs
        return [Literal(None, sib)
                if isinstance(e, Literal) and e.value is None
                and isinstance(e.dtype, dt.NullType) else e
                for e in exprs]

    def _c_col(self, node: A.Col, rel, subst, grouped):
        return self.resolve(rel, node, grouped)

    def _c_lit(self, node: A.Lit, rel, subst, grouped):
        try:
            return Literal(node.value)
        except TypeError as e:
            raise self.unported(f"the literal {node.value!r}", node) from e

    def _c_star(self, node: A.Star, rel, subst, grouped):
        raise self.err("* is only allowed as a top-level SELECT item "
                       "or inside count(*)", node, "misplaced_star")

    def _c_unary(self, node: A.Unary, rel, subst, grouped):
        child = self._compile(node.operand, rel, subst, grouped)
        if node.op == "NOT":
            from ..expr.predicates import Not
            return Not(child)
        from ..expr.arithmetic import UnaryMinus
        return UnaryMinus(child)

    def _c_binary(self, node: A.Binary, rel, subst, grouped):
        from ..expr.arithmetic import (Add, Divide, IntegralDivide,
                                       Multiply, Remainder, Subtract)
        from ..expr.predicates import (And, EqualNullSafe, EqualTo,
                                       GreaterThan, GreaterThanOrEqual,
                                       LessThan, LessThanOrEqual, Not, Or)
        from ..expr.strings import ConcatStrings
        table = {
            "OR": Or, "AND": And,
            "=": EqualTo, "<=>": EqualNullSafe,
            "<": LessThan, "<=": LessThanOrEqual,
            ">": GreaterThan, ">=": GreaterThanOrEqual,
            "+": Add, "-": Subtract, "*": Multiply, "/": Divide,
            "%": Remainder, "DIV": IntegralDivide,
            "||": ConcatStrings,
        }
        l, r = self._retype_nulls(
            self._kids((node.left, node.right), rel, subst, grouped))
        if node.op == "<>":
            return Not(EqualTo(l, r))
        cls = table.get(node.op)
        if cls is None:
            raise self.err(f"operator {node.op!r} is not supported",
                           node, "unsupported_feature")
        return cls(l, r)

    _UNIFY_ARGS = frozenset(("coalesce", "least", "greatest", "nullif"))

    def _c_func(self, node: A.Func, rel, subst, grouped):
        if F.is_aggregate_name(node.name) or node.star:
            raise self.err(
                f"aggregate function {node.name}() is not allowed "
                "here", node, "misplaced_aggregate")
        args = self._retype_nulls(
            self._kids(node.args, rel, subst, grouped))
        if node.name in self._UNIFY_ARGS:
            args = self._unify_branch_types(args, node)
        elif node.name == "if" and len(args) == 3:
            args[1:] = self._unify_branch_types(args[1:], node)
        return F.build_scalar(node, args, self.sql)

    def _c_caste(self, node: A.CastE, rel, subst, grouped):
        from ..expr.cast import Cast, cast_supported
        child = self._compile(node.operand, rel, subst, grouped)
        t = self._parse_type(node.type_name)
        if isinstance(child, Literal) and child.value is None \
                and isinstance(child.dtype, dt.NullType):
            return Literal(None, t)
        if not cast_supported(child.dtype, t):
            raise self.err(
                f"cannot cast {child.dtype.simple_string()} to "
                f"{t.simple_string()}", node, "type_error")
        return Cast(child, t)

    def _parse_type(self, tn: A.TypeName) -> dt.DataType:
        simple = {
            "boolean": dt.BOOL, "bool": dt.BOOL,
            "tinyint": dt.INT8, "byte": dt.INT8,
            "smallint": dt.INT16, "short": dt.INT16,
            "int": dt.INT32, "integer": dt.INT32,
            "bigint": dt.INT64, "long": dt.INT64,
            "float": dt.FLOAT32, "real": dt.FLOAT32,
            "double": dt.FLOAT64,
            "string": dt.STRING, "varchar": dt.STRING,
            "char": dt.STRING, "text": dt.STRING,
            "binary": dt.BINARY,
            "date": dt.DATE, "timestamp": dt.TIMESTAMP,
        }
        if tn.name in simple:
            return simple[tn.name]
        if tn.name in ("decimal", "numeric"):
            p = tn.params[0] if tn.params else 10
            s = tn.params[1] if len(tn.params) > 1 else 0
            return dt.DecimalType(p, s)
        raise self.err(f"unknown type {tn.name!r}", tn, "unknown_type")

    def _c_casee(self, node: A.CaseE, rel, subst, grouped):
        from ..expr.conditional import CaseWhen
        branches = []
        for c_ast, v_ast in node.whens:
            if node.operand is not None:
                c_ast = A.Binary(op="=", left=node.operand, right=c_ast,
                                 loc=c_ast.loc)
            c = self._compile(c_ast, rel, subst, grouped)
            v = self._compile(v_ast, rel, subst, grouped)
            branches.append((c, v))
        els = self._compile(node.else_, rel, subst, grouped) \
            if node.else_ is not None else None
        values = [v for _, v in branches] + \
            ([els] if els is not None else [])
        values = self._unify_branch_types(values, node)
        branches = [(c, values[i]) for i, (c, _) in enumerate(branches)]
        els = values[len(branches)] if els is not None else None
        for c, _ in branches:
            if not isinstance(c.dtype, dt.BooleanType):
                raise self.err("CASE WHEN condition must be boolean",
                               node, "type_error")
        return CaseWhen(branches, els)

    def _unify_branch_types(self, values: List[Expression],
                            node: A.Node) -> List[Expression]:
        """Common result type across CASE branches (and the arguments of
        coalesce, least, greatest, nullif and if's values): NULL
        literals adopt it, numerics widen by ``Cast``, anything else
        must match exactly."""
        from ..expr.cast import Cast
        typed = [v.dtype for v in values
                 if not isinstance(v.dtype, dt.NullType)]
        if not typed:
            return values
        common = typed[0]
        for t in typed[1:]:
            if t == common:
                continue
            if dt.is_numeric(t) and dt.is_numeric(common):
                common = dt.common_type(t, common)
            else:
                raise self.err(
                    f"CASE branches have incompatible types "
                    f"{common.simple_string()} vs {t.simple_string()}",
                    node, "type_error")
        out = []
        for v in values:
            if isinstance(v.dtype, dt.NullType):
                out.append(Literal(None, common))
            elif v.dtype != common:
                out.append(Cast(v, common))
            else:
                out.append(v)
        return out

    def _c_ine(self, node: A.InE, rel, subst, grouped):
        from ..expr.predicates import EqualTo, In, Not, Or
        operand = self._compile(node.operand, rel, subst, grouped)
        if all(isinstance(i, A.Lit) for i in node.items):
            e = In(operand, tuple(i.value for i in node.items))
        else:
            e = None
            for item in node.items:
                rhs = self._retype_nulls(
                    [operand,
                     self._compile(item, rel, subst, grouped)])[1]
                cmp = EqualTo(operand, rhs)
                e = cmp if e is None else Or(e, cmp)
        return Not(e) if node.negated else e

    def _c_between(self, node: A.Between, rel, subst, grouped):
        from ..expr.predicates import (And, GreaterThanOrEqual,
                                       LessThanOrEqual, Not)
        x = self._compile(node.operand, rel, subst, grouped)
        lo = self._compile(node.low, rel, subst, grouped)
        hi = self._compile(node.high, rel, subst, grouped)
        e = And(GreaterThanOrEqual(x, lo), LessThanOrEqual(x, hi))
        return Not(e) if node.negated else e

    def _c_likee(self, node: A.LikeE, rel, subst, grouped):
        from ..expr.predicates import Not
        from ..expr.strings import Like
        child = self._compile(node.operand, rel, subst, grouped)
        e = Like(child, node.pattern, node.escape)
        return Not(e) if node.negated else e

    def _c_isnulle(self, node: A.IsNullE, rel, subst, grouped):
        from ..expr.predicates import IsNotNull, IsNull
        child = self._compile(node.operand, rel, subst, grouped)
        return IsNotNull(child) if node.negated else IsNull(child)

    def _c_over(self, node: A.Over, rel, subst, grouped):
        raise self.err("window expressions are only allowed in the "
                       "SELECT list (and ORDER BY)", node,
                       "misplaced_window")

    # --- relation lowering ------------------------------------------------
    def compile_query(self, q: A.Query, env: Dict) -> Rel:
        if q.ctes:
            env = dict(env)
            for name, cq in q.ctes:
                # later CTEs (and the body) see earlier ones; a CTE
                # named like a catalog table shadows it
                env[name.lower()] = (cq, dict(env))
        if isinstance(q.body, A.SetOp):
            rel = self._compile_setop(q.body, env)
            return self._order_limit_by_name(rel, q.order_by, q.limit)
        return self.compile_select(q.body, env, q.order_by, q.limit)

    def _compile_setop(self, op: A.SetOp, env: Dict) -> Rel:
        """UNION ALL, flattened: the sides' widths must agree, their types
        position by position, numeric ones widened by a ``Cast`` under a
        project, and a NULL column cast to the other sides' type (as
        Spark does; the reference refuses it)."""
        from ..exec.basic import GpuProjectExec
        from ..exec.misc import GpuUnionExec
        from ..expr.cast import Cast
        parts: List[Rel] = []

        def flatten(n):
            if isinstance(n, A.SetOp):
                if not n.all:
                    raise self.err(
                        "UNION DISTINCT is not in the dialect subset; "
                        "use UNION ALL (wrap in SELECT DISTINCT for "
                        "dedup)", n, "unsupported_feature")
                flatten(n.left)
                flatten(n.right)
            elif isinstance(n, A.Query):
                parts.append(self.compile_query(n, env))
            else:
                parts.append(self.compile_select(n, env, (), None))

        flatten(op)
        width = len(parts[0].schema.fields)
        for p in parts[1:]:
            if len(p.schema.fields) != width:
                raise self.err(
                    f"UNION sides have different widths "
                    f"({width} vs {len(p.schema.fields)})", op,
                    "union_mismatch")
        common = list(parts[0].schema.types)
        for p in parts[1:]:
            for i, t in enumerate(p.schema.types):
                if t == common[i] or isinstance(t, dt.NullType):
                    continue
                if isinstance(common[i], dt.NullType):
                    common[i] = t  # a NULL side adopts the other's type
                elif dt.is_numeric(t) and dt.is_numeric(common[i]):
                    common[i] = dt.common_type(t, common[i])
                else:
                    raise self.err(
                        f"UNION column {i + 1} has incompatible types "
                        f"{common[i].simple_string()} vs "
                        f"{t.simple_string()}", op, "union_mismatch")
        nodes = []
        names = parts[0].schema.names
        for p in parts:
            if list(p.schema.types) == common:
                nodes.append(p.node)
                continue
            exprs = []
            for i, f in enumerate(p.schema.fields):
                e = p.ref(i)
                if f.dtype != common[i]:
                    e = Cast(e, common[i])
                exprs.append(Alias(e, names[i]))
            nodes.append(GpuProjectExec(exprs, p.node))
        return Rel(GpuUnionExec(nodes), [None] * width)

    def _order_limit_by_name(self, rel: Rel, order_items, limit) -> Rel:
        """ORDER BY and LIMIT over a set operation's result: its output
        columns by name or position only."""
        from ..exec.sort import GpuGlobalLimitExec, GpuSortExec, SortOrder
        node = rel.node
        if order_items:
            orders = []
            for oi in order_items:
                if isinstance(oi.expr, A.Lit) \
                        and isinstance(oi.expr.value, int):
                    pos = oi.expr.value
                    if not (1 <= pos <= len(rel.schema.fields)):
                        raise self.err(f"ORDER BY position {pos} out "
                                       "of range", oi.expr,
                                       "unknown_column")
                    ref = rel.ref(pos - 1)
                elif isinstance(oi.expr, A.Col):
                    ref = self.resolve(rel, oi.expr)
                else:
                    raise self.err(
                        "ORDER BY over UNION supports output columns "
                        "and positions only", oi.expr,
                        "unsupported_feature")
                orders.append(SortOrder(ref, oi.ascending,
                                        oi.nulls_first))
            node = GpuSortExec(orders, node)
        if limit is not None:
            node = GpuGlobalLimitExec(limit, node)
        return Rel(node, rel.quals)

    # --- FROM --------------------------------------------------------------
    def _lookup_table(self, t: A.Table, env: Dict) -> Rel:
        key = t.name.lower()
        if key in env:
            cq, cenv = env[key]
            rel = self.compile_query(cq, cenv)
        else:
            node = self.session._catalog_node(t.name)
            if node is None:
                raise self.err(f"table or view {t.name!r} not found",
                               t, "unknown_table")
            rel = Rel(node, [None] * len(node.output_schema.fields))
        qual = t.alias or t.name
        return Rel(rel.node, [qual] * len(rel.schema.fields))

    def compile_from_item(self, item: A.Node, env: Dict,
                          uniq: set) -> Rel:
        if isinstance(item, A.Table):
            return self._lookup_table(item, env)
        if isinstance(item, A.Derived):
            sub = self.compile_query(item.query, env)
            return Rel(sub.node, [item.alias] * len(sub.schema.fields))
        if isinstance(item, A.JoinRel):
            return self._compile_join(item, env, uniq)
        raise self.err("unsupported FROM clause element", item,
                       "unsupported_feature")

    def _rel_aliases(self, rel: Rel) -> set:
        return {q.lower() for q in rel.quals if q is not None}

    def _is_unique_hinted(self, rel: Rel, uniq: set) -> bool:
        aliases = self._rel_aliases(rel)
        return bool(aliases) and aliases <= uniq

    def _cond_scope(self, left: Rel, right: Rel) -> Rel:
        """Resolution scope for a join condition: left + right columns
        (matches the engine's ``_cond_schema`` ordinal space)."""

        class _Pseudo:
            def __init__(self, schema):
                self.output_schema = schema

        fields = list(left.schema.fields) + list(right.schema.fields)
        return Rel(_Pseudo(dt.Schema(fields)), left.quals + right.quals)

    def _join_keys(self, conjuncts: List[A.Node], left: Rel,
                   right: Rel):
        """Partition ON conjuncts into equi-key pairs and residuals."""
        lkeys, rkeys, residual = [], [], []
        for c in conjuncts:
            if isinstance(c, A.Binary) and c.op == "=":
                if self._fits(left, c.left) and self._fits(right, c.right):
                    ls, rs = c.left, c.right
                elif self._fits(right, c.left) \
                        and self._fits(left, c.right):
                    ls, rs = c.right, c.left
                else:
                    residual.append(c)
                    continue
                lk = self.compile_expr(ls, left)
                rk = self.compile_expr(rs, right)
                lk, rk = self._coerce_keys(lk, rk, c)
                lkeys.append(lk)
                rkeys.append(rk)
            else:
                residual.append(c)
        return lkeys, rkeys, residual

    def _coerce_keys(self, lk, rk, node):
        from ..session import coerce_join_keys
        if lk.dtype != rk.dtype and not (dt.is_numeric(lk.dtype)
                                         and dt.is_numeric(rk.dtype)):
            raise self.err(
                f"join key types differ: "
                f"{lk.dtype.simple_string()} vs "
                f"{rk.dtype.simple_string()}", node, "type_error")
        return coerce_join_keys(lk, rk)

    def _compile_join(self, jr: A.JoinRel, env: Dict, uniq: set) -> Rel:
        from ..exec.joins import (GpuBroadcastNestedLoopJoinExec,
                                  GpuShuffledHashJoinExec)
        left = self.compile_from_item(jr.left, env, uniq)
        right = self.compile_from_item(jr.right, env, uniq)
        out_quals = left.quals if jr.kind in ("left_semi", "left_anti") \
            else left.quals + right.quals
        if jr.kind == "cross" or jr.condition is None:
            node = GpuBroadcastNestedLoopJoinExec("cross", left.node,
                                                  right.node, None)
            return Rel(node, left.quals + right.quals)
        conjuncts = _split_and(jr.condition)
        lkeys, rkeys, residual = self._join_keys(conjuncts, left, right)
        cond = None
        if residual:
            scope = self._cond_scope(left, right)
            ast = residual[0]
            for c in residual[1:]:
                ast = A.Binary(op="AND", left=ast, right=c, loc=c.loc)
            cond = self.compile_expr(ast, scope)
        if not lkeys:
            node = GpuBroadcastNestedLoopJoinExec(jr.kind, left.node,
                                                  right.node, cond)
            return Rel(node, out_quals)
        node = GpuShuffledHashJoinExec(
            lkeys, rkeys, jr.kind, left.node, right.node, cond,
            build_unique_hint=self._is_unique_hinted(right, uniq))
        return Rel(node, out_quals)

    def _compile_comma_from(self, items: Sequence[A.Node],
                            where: Optional[A.Node], env: Dict,
                            uniq: set) -> Rel:
        """Real-NDS FROM lists: ``FROM a, b, c WHERE ...``. Single-table
        conjuncts push down to their table, two-table equality
        conjuncts drive a greedy inner-join order, an item no equality
        reaches is cross-joined (the nested-loop join), and the rest
        filters the joined result."""
        from ..exec.basic import GpuFilterExec
        from ..exec.joins import (GpuBroadcastNestedLoopJoinExec,
                                  GpuShuffledHashJoinExec)
        units = [self.compile_from_item(it, env, uniq) for it in items]
        conjuncts = _split_and(where) if where is not None else []
        edges: List[Tuple[int, int, A.Node]] = []
        residual: List[A.Node] = []
        for c in conjuncts:
            fits = [i for i, u in enumerate(units) if self._fits(u, c)]
            if len(fits) == 1 and _cols_of(c):
                i = fits[0]
                pred = self.compile_expr(c, units[i])
                self._check_bool(pred, c, "WHERE")
                units[i] = Rel(GpuFilterExec(pred, units[i].node),
                               units[i].quals)
                continue
            if isinstance(c, A.Binary) and c.op == "=":
                lf = [i for i, u in enumerate(units)
                      if self._fits(u, c.left)]
                rf = [i for i, u in enumerate(units)
                      if self._fits(u, c.right)]
                if len(lf) == 1 and len(rf) == 1 and lf[0] != rf[0]:
                    edges.append((lf[0], rf[0], c))
                    continue
            residual.append(c)
        # greedy order: start from the first non-unique-hinted unit (the
        # fact table in a star query), fold in edge-connected units —
        # each joined unit becomes the build side
        start = next((i for i, u in enumerate(units)
                      if not self._is_unique_hinted(u, uniq)), 0)
        cur = units[start]
        done = {start}
        pending = [i for i in range(len(units)) if i != start]
        used_edges: set = set()
        while pending:
            pick = None
            for j in pending:
                if any((a in done and b == j) or (b in done and a == j)
                       for a, b, _ in edges):
                    pick = j
                    break
            if pick is None:
                pick = pending[0]
                cur = Rel(GpuBroadcastNestedLoopJoinExec(
                    "cross", cur.node, units[pick].node, None),
                    cur.quals + units[pick].quals)
            else:
                lkeys, rkeys = [], []
                rel_j = units[pick]
                for ei, (a, b, c) in enumerate(edges):
                    if ei in used_edges:
                        continue
                    if not ((a in done and b == pick)
                            or (b in done and a == pick)):
                        continue
                    side_l, side_r = (c.left, c.right) \
                        if b == pick else (c.right, c.left)
                    lk = self.compile_expr(side_l, cur)
                    rk = self.compile_expr(side_r, rel_j)
                    lk, rk = self._coerce_keys(lk, rk, c)
                    lkeys.append(lk)
                    rkeys.append(rk)
                    used_edges.add(ei)
                cur = Rel(GpuShuffledHashJoinExec(
                    lkeys, rkeys, "inner", cur.node, rel_j.node, None,
                    build_unique_hint=self._is_unique_hinted(rel_j,
                                                             uniq)),
                    cur.quals + rel_j.quals)
            done.add(pick)
            pending.remove(pick)
        for c in residual:
            pred = self.compile_expr(c, cur)
            self._check_bool(pred, c, "WHERE")
            cur = Rel(GpuFilterExec(pred, cur.node), cur.quals)
        return cur

    def _check_bool(self, e: Expression, node: A.Node, what: str):
        if not isinstance(e.dtype, dt.BooleanType):
            raise self.err(f"{what} clause must be boolean, got "
                           f"{e.dtype.simple_string()}", node,
                           "type_error")

    # --- SELECT core --------------------------------------------------------
    def compile_select(self, core: A.SelectCore, env: Dict,
                       order_items: Sequence[A.OrderItem],
                       limit: Optional[int]) -> Rel:
        from ..exec.basic import GpuFilterExec, GpuProjectExec
        uniq = {a.lower() for h, args in core.hints
                if h in ("UNIQUE", "BUILD_UNIQUE") for a in args}
        # FROM + WHERE
        if not core.from_:
            raise self.unported("SELECT without FROM (TpuRangeExec)", core)
        if len(core.from_) == 1:
            rel = self.compile_from_item(core.from_[0], env, uniq)
            base_width = len(rel.schema.fields)
            if core.where is not None:
                pred = self.compile_expr(core.where, rel)
                self._check_bool(pred, core.where, "WHERE")
                rel = Rel(GpuFilterExec(pred, rel.node), rel.quals)
        else:
            rel = self._compile_comma_from(core.from_, core.where, env,
                                           uniq)
            base_width = len(rel.schema.fields)

        # star expansion: (expr_ast | precompiled ref ordinal, name, loc)
        items: List[Tuple[Optional[A.Node], Optional[int], str]] = []
        for idx, it in enumerate(core.items):
            if isinstance(it.expr, A.Star):
                q = it.expr.qualifier
                hit = False
                for i in range(base_width):
                    if q is not None and (
                            rel.quals[i] is None
                            or not self._eq_name(rel.quals[i], q)):
                        continue
                    items.append((None, i, rel.schema.fields[i].name))
                    hit = True
                if not hit:
                    raise self.err(f"{q}.* matches no columns",
                                   it.expr, "unknown_column")
            else:
                name = it.alias or A.sql_name(it.expr, idx)
                items.append((it.expr, None, name))
        alias_map = {it.alias.lower(): it.expr for it in core.items
                     if it.alias is not None
                     and not isinstance(it.expr, A.Star)}

        # aggregation
        agg_asts = self._collect_aggregates(
            [ast for ast, _, _ in items if ast is not None]
            + ([core.having] if core.having is not None else [])
            + [oi.expr for oi in order_items])
        subst: List[Tuple[A.Node, int]] = []
        grouped = bool(agg_asts or core.group_by
                       or core.having is not None)
        if grouped:
            if any(ast is None for ast, _, _ in items):
                raise self.err("SELECT * cannot be combined with "
                               "GROUP BY / aggregates", core,
                               "unsupported_feature")
            rel, subst = self._compile_aggregation(core, rel, agg_asts,
                                                   alias_map)
            if core.having is not None:
                pred = self.compile_expr(core.having, rel, subst,
                                         grouped=True)
                self._check_bool(pred, core.having, "HAVING")
                rel = Rel(GpuFilterExec(pred, rel.node), rel.quals)

        # windows (evaluated after aggregation, before projection)
        over_asts = self._collect_windows(
            [ast for ast, _, _ in items if ast is not None]
            + [oi.expr for oi in order_items])
        if over_asts:
            rel, wsubst = self._compile_windows(over_asts, rel, subst,
                                                grouped)
            subst = subst + wsubst

        # SELECT list
        out_exprs: List[Expression] = []
        out_names: List[str] = []
        for ast, ref_i, name in items:
            if ast is None:
                e = rel.ref(ref_i)
            else:
                e = self.compile_expr(ast, rel, subst, grouped)
            out_exprs.append(e)
            out_names.append(name)

        # ORDER BY resolution: output first, else pre-projection
        pre_orders, post_orders = self._resolve_order(
            order_items, items, out_exprs, out_names, rel, subst,
            grouped)
        node = rel.node
        if pre_orders is not None:
            from ..exec.sort import GpuSortExec
            if core.distinct:
                raise self.err(
                    "ORDER BY expression must be in the SELECT DISTINCT "
                    "output", order_items[0].expr, "unsupported_feature")
            node = GpuSortExec(pre_orders, node)
        node = GpuProjectExec(
            [Alias(e, n) for e, n in zip(out_exprs, out_names)], node)
        out = Rel(node, [None] * len(out_names))
        if core.distinct:
            out = self._distinct(out)
        if post_orders is not None:
            from ..exec.sort import GpuSortExec
            orders = [so_cls(out.ref(i), asc, nf)
                      for so_cls, i, asc, nf in post_orders]
            out = Rel(GpuSortExec(orders, out.node), out.quals)
        if limit is not None:
            from ..exec.sort import GpuGlobalLimitExec
            out = Rel(GpuGlobalLimitExec(limit, out.node), out.quals)
        return out

    # --- aggregation helpers ----------------------------------------------
    def _collect_aggregates(self, roots: List[A.Node]) -> List[A.Func]:
        """Aggregate Func calls outside windows, deduped structurally."""
        out: List[A.Func] = []

        def rec(n, in_agg):
            if isinstance(n, A.Over):
                return  # window-scoped aggregates are not group aggs
            if isinstance(n, (A.Query, A.Derived)):
                return
            if isinstance(n, A.Func) and (F.is_aggregate_name(n.name)
                                          or n.star):
                if in_agg:
                    raise self.err(
                        "aggregate functions cannot be nested", n,
                        "nested_aggregate")
                if n not in out:
                    out.append(n)
                for a in n.args:
                    rec(a, True)
                return
            if isinstance(n, A.Node):
                import dataclasses as _dc
                for f in _dc.fields(n):
                    if f.name == "loc":
                        continue
                    v = getattr(n, f.name)
                    for sub in (v if isinstance(v, tuple) else (v,)):
                        if isinstance(sub, (A.Node, tuple)):
                            rec_any(sub, in_agg)

        def rec_any(v, in_agg):
            if isinstance(v, tuple):
                for x in v:
                    rec_any(x, in_agg)
            elif isinstance(v, A.Node):
                rec(v, in_agg)

        for r in roots:
            rec(r, False)
        return out

    def _collect_windows(self, roots: List[A.Node]) -> List[A.Over]:
        out: List[A.Over] = []
        for r in roots:
            for n in A.walk(r):
                if isinstance(n, A.Over) and n not in out:
                    out.append(n)
        return out

    def _compile_aggregation(self, core: A.SelectCore, rel: Rel,
                             agg_asts: List[A.Func], alias_map):
        from ..config import SHUFFLE_PARTITIONS
        from ..exec.aggregate import GpuHashAggregateExec
        from ..exec.basic import GpuProjectExec
        from ..exec.exchange import GpuShuffleExchangeExec
        from ..shuffle.partitioner import HashPartitioning

        # resolve group items: positions and select aliases allowed
        group_asts: List[A.Node] = []
        key_names: List[str] = []
        for g in core.group_by:
            if isinstance(g, A.Lit) and isinstance(g.value, int):
                pos = g.value
                if not (1 <= pos <= len(core.items)) \
                        or isinstance(core.items[pos - 1].expr, A.Star):
                    raise self.err(f"GROUP BY position {pos} is not a "
                                   "select expression", g,
                                   "unknown_column")
                item = core.items[pos - 1]
                group_asts.append(item.expr)
                key_names.append(item.alias
                                 or A.sql_name(item.expr, pos - 1))
                continue
            if isinstance(g, A.Col) and g.qualifier is None \
                    and not self._candidates(rel, g) \
                    and g.name.lower() in alias_map:
                aliased = alias_map[g.name.lower()]
                if any(isinstance(n, A.Over) for n in A.walk(aliased)):
                    raise self.err("cannot GROUP BY a window "
                                   "expression", g, "unsupported_feature")
                group_asts.append(aliased)
                key_names.append(g.name)
                continue
            group_asts.append(g)
            key_names.append(g.name if isinstance(g, A.Col)
                             else f"__g{len(key_names)}")
        for a in agg_asts:
            for k in group_asts:
                if a == k:
                    raise self.err("aggregate cannot be a GROUP BY "
                                   "key", a, "unsupported_feature")

        # pre-agg projection only if some key is computed
        computed = [(i, g) for i, g in enumerate(group_asts)
                    if not isinstance(g, A.Col)]
        key_refs: List[Expression] = []
        extra_base = len(rel.schema.fields)
        if computed:
            passthrough = [rel.ref(i) for i in range(extra_base)]
            extra = []
            for i, g in computed:
                e = self.compile_expr(g, rel)
                extra.append(Alias(e, key_names[i]))
            node = GpuProjectExec(passthrough + extra, rel.node)
            rel = Rel(node, rel.quals + [None] * len(extra))
        n_extra = 0
        for i, g in enumerate(group_asts):
            if isinstance(g, A.Col):
                ref = self.resolve(rel, g)
                key_names[i] = ref.name
            else:
                ref = rel.ref(extra_base + n_extra)
                n_extra += 1
            key_refs.append(ref)

        agg_aliases = []
        for k, a in enumerate(agg_asts):
            args = self._retype_nulls(
                [self.compile_expr(arg, rel) for arg in a.args])
            fn = F.build_aggregate(a, args, self.sql) if not a.star \
                else F.build_aggregate(a, [], self.sql)
            agg_aliases.append(Alias(fn, f"__a{k}"))

        child = rel.node
        if key_refs:
            n = self.conf.get(SHUFFLE_PARTITIONS)
            child = GpuShuffleExchangeExec(
                HashPartitioning(list(key_refs), n), child)
        try:
            agg_node = GpuHashAggregateExec(list(key_refs), agg_aliases,
                                            child)
        except (TypeError, ValueError) as e:
            raise self.err(str(e), core, "type_error") from e
        out = Rel(agg_node, [None] * len(agg_node.output_schema.fields))
        subst: List[Tuple[A.Node, int]] = []
        for i, g in enumerate(group_asts):
            subst.append((g, i))
        for k, a in enumerate(agg_asts):
            subst.append((a, len(key_refs) + k))
        return out, subst

    def _compile_windows(self, over_asts: List[A.Over], rel: Rel,
                         subst, grouped):
        """One ``GpuWindowExec`` a distinct (partition, order) spec, each
        over the one before; returns the relation and the substitution of
        every OVER node by its output column."""
        from ..exec.sort import SortOrder
        from ..exec.window import GpuWindowExec
        from ..expr.window import WindowExpression, WindowFrame

        groups: List[Tuple[Tuple, List[A.Over]]] = []
        for o in over_asts:
            key = (o.partition_by, o.order_by)
            for gk, lst in groups:
                if gk == key:
                    lst.append(o)
                    break
            else:
                groups.append((key, [o]))
        wsubst: List[Tuple[A.Node, int]] = []
        for _, overs in groups:
            spec = overs[0]
            part = [self.compile_expr(p, rel, subst, grouped)
                    for p in spec.partition_by]
            orders = [SortOrder(
                self.compile_expr(oi.expr, rel, subst, grouped),
                oi.ascending, oi.nulls_first)
                for oi in spec.order_by]
            aliases = []
            base = len(rel.schema.fields)
            for k, o in enumerate(overs):
                fn_ast = o.func
                args = self._retype_nulls(
                    [self.compile_expr(a, rel, subst, grouped)
                     for a in fn_ast.args])
                if fn_ast.name in F.WINDOW_FUNCTIONS:
                    fn = F.build_window(fn_ast, args, self.sql)
                elif F.is_aggregate_name(fn_ast.name) or fn_ast.star:
                    fn = F.build_aggregate(
                        fn_ast, args if not fn_ast.star else [],
                        self.sql)
                    if isinstance(fn, _Collect):
                        raise self.err(
                            f"{fn_ast.name}() over a window is not ported "
                            "yet (ROADMAP item 8)", fn_ast,
                            "unsupported_feature")
                else:
                    raise self.err(
                        f"unknown window function {fn_ast.name}()",
                        fn_ast, "unknown_function")
                frame = None
                if o.frame is not None:
                    try:
                        frame = WindowFrame(o.frame.frame_type,
                                            o.frame.lower,
                                            o.frame.upper)
                    except ValueError as e:
                        raise self.err(str(e), o.frame,
                                       "type_error") from e
                we = WindowExpression(fn, part, orders, frame)
                try:
                    we.validate()
                except (TypeError, ValueError) as e:
                    raise self.err(str(e), o, "type_error") from e
                aliases.append(Alias(we, f"__w{len(wsubst) + k}"))
            try:
                node = GpuWindowExec(aliases, rel.node)
            except (TypeError, ValueError) as e:
                raise self.err(str(e), overs[0], "type_error") from e
            rel = Rel(node, rel.quals + [None] * len(aliases))
            for k, o in enumerate(overs):
                wsubst.append((o, base + k))
        return rel, wsubst

    def _distinct(self, rel: Rel) -> Rel:
        from ..config import SHUFFLE_PARTITIONS
        from ..exec.aggregate import GpuHashAggregateExec
        from ..exec.exchange import GpuShuffleExchangeExec
        from ..shuffle.partitioner import HashPartitioning
        refs = [rel.ref(i) for i in range(len(rel.schema.fields))]
        n = self.conf.get(SHUFFLE_PARTITIONS)
        exch = GpuShuffleExchangeExec(HashPartitioning(list(refs), n),
                                      rel.node)
        return Rel(GpuHashAggregateExec(list(refs), [], exch),
                   rel.quals)

    def _resolve_order(self, order_items, items, out_exprs, out_names,
                       rel: Rel, subst, grouped):
        """Returns (pre_orders | None, post_orders | None): post sorts
        run over the projection output; a pre sort runs underneath it
        when an order expression is not part of the output."""
        from ..exec.sort import SortOrder
        if not order_items:
            return None, None
        post: List[Tuple] = []
        pre_needed = False
        resolved: List[Tuple[str, object]] = []
        for oi in order_items:
            e = oi.expr
            if isinstance(e, A.Lit) and isinstance(e.value, int):
                pos = e.value
                if not (1 <= pos <= len(out_names)):
                    raise self.err(f"ORDER BY position {pos} out of "
                                   "range", e, "unknown_column")
                resolved.append(("out", pos - 1))
                continue
            if isinstance(e, A.Col) and e.qualifier is None:
                hits = [i for i, n in enumerate(out_names)
                        if self._eq_name(n, e.name)]
                if len(hits) == 1:
                    resolved.append(("out", hits[0]))
                    continue
                if len(hits) > 1:
                    raise self.err(f"ORDER BY column {e.name!r} is "
                                   "ambiguous in the select list", e,
                                   "ambiguous_column")
            hit = next((i for i, (ast, _, _) in enumerate(items)
                        if ast is not None and ast == e), None)
            if hit is not None:
                resolved.append(("out", hit))
                continue
            resolved.append(("expr", oi))
            pre_needed = True
        if not pre_needed:
            return None, [(SortOrder, i, oi.ascending, oi.nulls_first)
                          for (_, i), oi in zip(resolved, order_items)]
        pre = []
        for (kind, v), oi in zip(resolved, order_items):
            if kind == "out":
                e = out_exprs[v]
            else:
                e = self.compile_expr(oi.expr, rel, subst, grouped)
            pre.append(SortOrder(e, oi.ascending, oi.nulls_first))
        return pre, None

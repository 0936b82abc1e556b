"""Recursive-descent SQL parser: tokens -> typed AST.

Copied from ``spark_rapids_tpu/sql/parser.py``. Covers the reference
engine's dialect subset: SELECT lists with expressions and
aliases, FROM with tables / subqueries / comma-lists, the join family
with ON, WHERE, GROUP BY / HAVING, ORDER BY / LIMIT, window functions
with OVER (PARTITION BY / ORDER BY / ROWS|RANGE frames), CASE WHEN,
CAST, IN / BETWEEN / LIKE, UNION [ALL], WITH-clause CTEs, ``/*+ ... */``
hints, and EXPLAIN [FORMATTED].

Operator precedence (low to high): OR < AND < NOT < comparison /
IS / IN / BETWEEN / LIKE < additive (+ - ||) < multiplicative
(* / % DIV) < unary +/- < primary.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from . import ast as A
from .errors import SqlParseError
from .lexer import Token, tokenize

__all__ = ["parse", "parse_statement"]

# keywords that terminate an implicit (AS-less) alias position
_RESERVED = {
    "SELECT", "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT",
    "UNION", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "ON",
    "AS", "AND", "OR", "NOT", "ASC", "DESC", "NULLS", "WHEN", "THEN",
    "ELSE", "END", "CASE", "IN", "BETWEEN", "LIKE", "IS", "NULL",
    "WITH", "OVER", "PARTITION", "BY", "ROWS", "RANGE", "DISTINCT",
    "ALL", "EXCEPT", "INTERSECT", "SEMI", "ANTI", "OUTER", "USING",
    "EXPLAIN", "ESCAPE", "DIV",
}

_CMP_OPS = {"=", "==", "<>", "!=", "<", "<=", ">", ">=", "<=>"}
_JOIN_KINDS = {
    ("INNER",): "inner", (): "inner",
    ("LEFT",): "left_outer", ("LEFT", "OUTER"): "left_outer",
    ("RIGHT",): "right_outer", ("RIGHT", "OUTER"): "right_outer",
    ("FULL",): "full_outer", ("FULL", "OUTER"): "full_outer",
    ("LEFT", "SEMI"): "left_semi", ("SEMI",): "left_semi",
    ("LEFT", "ANTI"): "left_anti", ("ANTI",): "left_anti",
    ("CROSS",): "cross",
}


class _Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks: List[Token] = tokenize(sql)
        self.i = 0

    # --- token helpers ----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def err(self, msg: str, tok: Optional[Token] = None) -> SqlParseError:
        tok = tok or self.cur
        return SqlParseError(msg, self.sql, tok.loc)

    def advance(self) -> Token:
        t = self.cur
        if t.kind != "eof":
            self.i += 1
        return t

    def at_op(self, *ops: str) -> bool:
        return self.cur.kind == "op" and self.cur.value in ops

    def at_kw(self, *kws: str) -> bool:
        return self.cur.kind == "ident" and self.cur.upper() in kws

    def eat_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise self.err(f"expected {op!r}, found "
                           f"{self._describe(self.cur)}")
        return self.advance()

    def eat_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            raise self.err(f"expected {kw}, found "
                           f"{self._describe(self.cur)}")
        return self.advance()

    def take_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    @staticmethod
    def _describe(t: Token) -> str:
        if t.kind == "eof":
            return "end of input"
        return repr(str(t.value))

    def _ident(self, what: str) -> str:
        """An identifier (quoted or not); keywords must be quoted."""
        t = self.cur
        if t.kind == "qident":
            self.advance()
            return t.value
        if t.kind == "ident":
            if t.upper() in _RESERVED:
                raise self.err(
                    f"{what} expected, found reserved word "
                    f"{t.value!r} (quote it to use it as a name)")
            self.advance()
            return t.value
        raise self.err(f"{what} expected, found {self._describe(t)}")

    # --- statement --------------------------------------------------------
    def parse_statement(self) -> A.Statement:
        loc = self.cur.loc
        explain = analyze = formatted = False
        if self.take_kw("EXPLAIN"):
            explain = True
            # EXPLAIN ANALYZE executes the query and annotates every
            # operator with its runtime metrics; plain EXPLAIN only
            # plans. FORMATTED widens either form.
            analyze = self.take_kw("ANALYZE")
            formatted = self.take_kw("FORMATTED")
        q = self.parse_query()
        if self.cur.kind != "eof":
            raise self.err(f"unexpected {self._describe(self.cur)} "
                           "after end of statement")
        return A.Statement(query=q, explain=explain, analyze=analyze,
                           formatted=formatted, loc=loc)

    def parse_query(self) -> A.Query:
        loc = self.cur.loc
        ctes: List[Tuple[str, A.Query]] = []
        if self.take_kw("WITH"):
            while True:
                name = self._ident("CTE name")
                self.eat_kw("AS")
                self.eat_op("(")
                ctes.append((name, self.parse_query()))
                self.eat_op(")")
                if not self.at_op(","):
                    break
                self.advance()
        body = self.parse_set_expr()
        order: Tuple[A.OrderItem, ...] = ()
        limit = None
        if self.at_kw("ORDER"):
            order = self.parse_order_by()
        if self.take_kw("LIMIT"):
            t = self.cur
            if t.kind != "number" or not isinstance(t.value, int) \
                    or t.value < 0:
                raise self.err("LIMIT expects a non-negative integer")
            self.advance()
            limit = t.value
        return A.Query(ctes=tuple(ctes), body=body, order_by=order,
                       limit=limit, loc=loc)

    def parse_set_expr(self) -> A.Node:
        left = self.parse_select_term()
        while self.at_kw("UNION"):
            loc = self.cur.loc
            self.advance()
            all_ = self.take_kw("ALL")
            if not all_:
                self.take_kw("DISTINCT")
            right = self.parse_select_term()
            left = A.SetOp(op="union", all=all_, left=left, right=right,
                           loc=loc)
        if self.at_kw("EXCEPT", "INTERSECT"):
            raise self.err(f"{self.cur.upper()} is not in the dialect "
                           "subset (UNION [ALL] only)")
        return left

    def parse_select_term(self) -> A.Node:
        if self.at_op("("):
            self.advance()
            q = self.parse_query()
            self.eat_op(")")
            return q
        return self.parse_select_core()

    def parse_select_core(self) -> A.SelectCore:
        loc = self.cur.loc
        self.eat_kw("SELECT")
        hints: List[Tuple[str, Tuple[str, ...]]] = []
        while self.cur.kind == "hint":
            hints.extend(self._parse_hint(self.advance()))
        distinct = self.take_kw("DISTINCT")
        if not distinct:
            self.take_kw("ALL")
        items = [self.parse_select_item()]
        while self.at_op(","):
            self.advance()
            items.append(self.parse_select_item())
        from_: List[A.Node] = []
        if self.take_kw("FROM"):
            from_.append(self.parse_from_item())
            while self.at_op(","):
                self.advance()
                from_.append(self.parse_from_item())
        where = having = None
        group: Tuple[A.Node, ...] = ()
        if self.take_kw("WHERE"):
            where = self.parse_expr()
        if self.at_kw("GROUP"):
            self.advance()
            self.eat_kw("BY")
            g = [self.parse_expr()]
            while self.at_op(","):
                self.advance()
                g.append(self.parse_expr())
            group = tuple(g)
        if self.take_kw("HAVING"):
            having = self.parse_expr()
        return A.SelectCore(items=tuple(items), from_=tuple(from_),
                            where=where, group_by=group, having=having,
                            distinct=distinct, hints=tuple(hints),
                            loc=loc)

    def _parse_hint(self, tok: Token) -> List[Tuple[str, Tuple[str, ...]]]:
        """`/*+ NAME(arg, ...) NAME2 ... */` — unknown hints are kept;
        the compiler decides which it honors (Spark ignores unknown
        hints with a warning; here they are simply inert)."""
        try:
            sub = _Parser(tok.value)
        except SqlParseError:
            # the sub-lexer's line/col would point into the hint BODY;
            # re-anchor to the hint token in the real statement
            raise self.err(f"malformed hint {tok.value!r}",
                           tok) from None
        out: List[Tuple[str, Tuple[str, ...]]] = []
        while sub.cur.kind != "eof":
            if sub.cur.kind != "ident":
                raise self.err(f"malformed hint {tok.value!r}", tok)
            name = sub.advance().value.upper()
            args: List[str] = []
            if sub.at_op("("):
                sub.advance()
                while not sub.at_op(")"):
                    if sub.cur.kind not in ("ident", "qident"):
                        raise self.err(
                            f"malformed hint {tok.value!r}", tok)
                    args.append(sub.advance().value)
                    if sub.at_op(","):
                        sub.advance()
                sub.advance()
            out.append((name, tuple(args)))
            if sub.at_op(","):
                sub.advance()
        return out

    def parse_select_item(self) -> A.SelectItem:
        loc = self.cur.loc
        if self.at_op("*"):
            self.advance()
            return A.SelectItem(expr=A.Star(loc=loc), loc=loc)
        # t.* — an ident/qident followed by `.` `*`
        if self.cur.kind in ("ident", "qident") \
                and self.toks[self.i + 1].kind == "op" \
                and self.toks[self.i + 1].value == "." \
                and self.toks[self.i + 2].kind == "op" \
                and self.toks[self.i + 2].value == "*":
            qual = self.advance().value
            self.advance()
            self.advance()
            return A.SelectItem(expr=A.Star(qualifier=qual, loc=loc),
                                loc=loc)
        e = self.parse_expr()
        alias = self._maybe_alias()
        return A.SelectItem(expr=e, alias=alias, loc=loc)

    def _maybe_alias(self) -> Optional[str]:
        if self.take_kw("AS"):
            return self._ident("alias")
        if self.cur.kind == "qident" or (
                self.cur.kind == "ident"
                and self.cur.upper() not in _RESERVED):
            return self.advance().value
        return None

    # --- relations --------------------------------------------------------
    def parse_from_item(self) -> A.Node:
        rel = self.parse_table_factor()
        while True:
            kind = self._peek_join_kind()
            if kind is None:
                return rel
            loc = self.cur.loc
            self._eat_join_kind()
            right = self.parse_table_factor()
            cond = None
            if self.take_kw("ON"):
                cond = self.parse_expr()
            elif self.at_kw("USING"):
                raise self.err("USING join clauses are not in the "
                               "dialect subset; use ON")
            elif kind != "cross":
                # a forgotten ON must not silently become a cartesian
                # product (or widen a SEMI/ANTI schema)
                raise self.err(f"{kind.upper().replace('_', ' ')} JOIN "
                               "requires an ON clause (use CROSS JOIN "
                               "for a cartesian product)")
            rel = A.JoinRel(left=rel, right=right, kind=kind,
                            condition=cond, loc=loc)

    def _peek_join_kind(self) -> Optional[str]:
        """Join keyword sequence starting at the cursor, or None."""
        words: List[str] = []
        j = self.i
        while self.toks[j].kind == "ident" and len(words) < 3:
            w = self.toks[j].upper()
            if w == "JOIN":
                return _JOIN_KINDS.get(tuple(words))
            if w not in ("INNER", "LEFT", "RIGHT", "FULL", "CROSS",
                         "SEMI", "ANTI", "OUTER"):
                return None
            words.append(w)
            j += 1
        return None

    def _eat_join_kind(self):
        while self.cur.upper() != "JOIN":
            self.advance()
        self.advance()

    def parse_table_factor(self) -> A.Node:
        loc = self.cur.loc
        if self.at_op("("):
            self.advance()
            q = self.parse_query()
            self.eat_op(")")
            alias = self._maybe_alias()
            if alias is None:
                raise self.err("subquery in FROM needs an alias")
            return A.Derived(query=q, alias=alias, loc=loc)
        name = self._ident("table name")
        alias = self._maybe_alias()
        return A.Table(name=name, alias=alias, loc=loc)

    # --- order / window ---------------------------------------------------
    def parse_order_by(self) -> Tuple[A.OrderItem, ...]:
        self.eat_kw("ORDER")
        self.eat_kw("BY")
        items = [self.parse_order_item()]
        while self.at_op(","):
            self.advance()
            items.append(self.parse_order_item())
        return tuple(items)

    def parse_order_item(self) -> A.OrderItem:
        loc = self.cur.loc
        e = self.parse_expr()
        asc = True
        if self.take_kw("DESC"):
            asc = False
        else:
            self.take_kw("ASC")
        nulls_first = None
        if self.take_kw("NULLS"):
            if self.take_kw("FIRST"):
                nulls_first = True
            elif self.take_kw("LAST"):
                nulls_first = False
            else:
                raise self.err("expected FIRST or LAST after NULLS")
        return A.OrderItem(expr=e, ascending=asc,
                           nulls_first=nulls_first, loc=loc)

    # --- expressions ------------------------------------------------------
    def parse_expr(self) -> A.Node:
        return self._parse_or()

    def _parse_or(self) -> A.Node:
        left = self._parse_and()
        while self.at_kw("OR"):
            loc = self.advance().loc
            left = A.Binary(op="OR", left=left, right=self._parse_and(),
                            loc=loc)
        return left

    def _parse_and(self) -> A.Node:
        left = self._parse_not()
        while self.at_kw("AND"):
            loc = self.advance().loc
            left = A.Binary(op="AND", left=left, right=self._parse_not(),
                            loc=loc)
        return left

    def _parse_not(self) -> A.Node:
        if self.at_kw("NOT"):
            loc = self.advance().loc
            return A.Unary(op="NOT", operand=self._parse_not(), loc=loc)
        return self._parse_predicate()

    def _parse_predicate(self) -> A.Node:
        left = self._parse_additive()
        while True:
            if self.cur.kind == "op" and self.cur.value in _CMP_OPS:
                tok = self.advance()
                op = {"==": "=", "!=": "<>"}.get(tok.value, tok.value)
                left = A.Binary(op=op, left=left,
                                right=self._parse_additive(),
                                loc=tok.loc)
                continue
            if self.at_kw("IS"):
                loc = self.advance().loc
                neg = self.take_kw("NOT")
                self.eat_kw("NULL")
                left = A.IsNullE(operand=left, negated=neg, loc=loc)
                continue
            neg = False
            save = self.i
            if self.at_kw("NOT"):
                self.advance()
                neg = True
            if self.at_kw("IN"):
                loc = self.advance().loc
                self.eat_op("(")
                items = [self.parse_expr()]
                while self.at_op(","):
                    self.advance()
                    items.append(self.parse_expr())
                self.eat_op(")")
                left = A.InE(operand=left, items=tuple(items),
                             negated=neg, loc=loc)
                continue
            if self.at_kw("BETWEEN"):
                loc = self.advance().loc
                lo = self._parse_additive()
                self.eat_kw("AND")
                hi = self._parse_additive()
                left = A.Between(operand=left, low=lo, high=hi,
                                 negated=neg, loc=loc)
                continue
            if self.at_kw("LIKE"):
                loc = self.advance().loc
                pat = self.cur
                if pat.kind != "string":
                    raise self.err("LIKE pattern must be a string "
                                   "literal")
                self.advance()
                esc = "\\"
                if self.take_kw("ESCAPE"):
                    et = self.cur
                    if et.kind != "string" or len(et.value) != 1:
                        raise self.err("ESCAPE expects a one-character "
                                       "string literal")
                    esc = et.value
                    self.advance()
                left = A.LikeE(operand=left, pattern=pat.value,
                               escape=esc, negated=neg, loc=loc)
                continue
            if neg:
                self.i = save  # the NOT belongs to a boolean factor
            return left

    def _parse_additive(self) -> A.Node:
        left = self._parse_term()
        while self.at_op("+", "-", "||"):
            tok = self.advance()
            left = A.Binary(op=tok.value, left=left,
                            right=self._parse_term(), loc=tok.loc)
        return left

    def _parse_term(self) -> A.Node:
        left = self._parse_unary()
        while self.at_op("*", "/", "%") or self.at_kw("DIV"):
            tok = self.advance()
            op = "DIV" if tok.kind == "ident" else tok.value
            left = A.Binary(op=op, left=left,
                            right=self._parse_unary(), loc=tok.loc)
        return left

    def _parse_unary(self) -> A.Node:
        if self.at_op("-", "+"):
            tok = self.advance()
            operand = self._parse_unary()
            if tok.value == "-" and isinstance(operand, A.Lit) \
                    and isinstance(operand.value, (int, float)) \
                    and not isinstance(operand.value, bool):
                return A.Lit(value=-operand.value, loc=tok.loc)
            if tok.value == "+":
                return operand
            return A.Unary(op="-", operand=operand, loc=tok.loc)
        return self._parse_primary()

    def _parse_primary(self) -> A.Node:
        t = self.cur
        loc = t.loc
        if t.kind == "number":
            self.advance()
            return A.Lit(value=t.value, loc=loc)
        if t.kind == "string":
            self.advance()
            return A.Lit(value=t.value, loc=loc)
        if self.at_op("("):
            self.advance()
            e = self.parse_expr()
            self.eat_op(")")
            return e
        if t.kind == "qident":
            return self._parse_name()
        if t.kind != "ident":
            raise self.err(f"expression expected, found "
                           f"{self._describe(t)}")
        kw = t.upper()
        if kw == "NULL":
            self.advance()
            return A.Lit(value=None, loc=loc)
        if kw in ("TRUE", "FALSE"):
            self.advance()
            return A.Lit(value=(kw == "TRUE"), loc=loc)
        if kw == "CAST":
            self.advance()
            self.eat_op("(")
            e = self.parse_expr()
            self.eat_kw("AS")
            tn = self._parse_type_name()
            self.eat_op(")")
            return A.CastE(operand=e, type_name=tn, loc=loc)
        if kw == "CASE":
            return self._parse_case()
        if kw in ("DATE", "TIMESTAMP") \
                and self.toks[self.i + 1].kind == "string":
            self.advance()
            lit = self.advance()
            return self._typed_literal(kw, lit)
        if kw in _RESERVED:
            raise self.err(f"expression expected, found reserved word "
                           f"{t.value!r}")
        return self._parse_name()

    def _typed_literal(self, kw: str, lit: Token) -> A.Node:
        import datetime
        try:
            if kw == "DATE":
                v = datetime.date.fromisoformat(lit.value)
            else:
                v = datetime.datetime.fromisoformat(lit.value)
        except ValueError as e:
            raise self.err(f"bad {kw} literal {lit.value!r}: {e}",
                           lit) from None
        return A.Lit(value=v, loc=lit.loc)

    def _parse_case(self) -> A.Node:
        loc = self.eat_kw("CASE").loc
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.take_kw("WHEN"):
            c = self.parse_expr()
            self.eat_kw("THEN")
            v = self.parse_expr()
            whens.append((c, v))
        if not whens:
            raise self.err("CASE needs at least one WHEN branch")
        else_ = None
        if self.take_kw("ELSE"):
            else_ = self.parse_expr()
        self.eat_kw("END")
        return A.CaseE(operand=operand, whens=tuple(whens), else_=else_,
                       loc=loc)

    def _parse_name(self) -> A.Node:
        """Identifier-led expression: column, qualified column, or
        function call (optionally with OVER)."""
        t = self.advance()
        loc = t.loc
        if self.at_op("(") and t.kind == "ident":
            return self._parse_call(t)
        if self.at_op(".") and self.toks[self.i + 1].kind in (
                "ident", "qident"):
            self.advance()
            c = self.advance()
            return A.Col(name=c.value, qualifier=t.value, loc=loc)
        return A.Col(name=t.value, loc=loc)

    def _parse_call(self, name_tok: Token) -> A.Node:
        loc = name_tok.loc
        name = name_tok.value.lower()
        self.eat_op("(")
        star = False
        distinct = False
        args: List[A.Node] = []
        if self.at_op("*"):
            star = True
            self.advance()
        elif not self.at_op(")"):
            distinct = self.take_kw("DISTINCT")
            args.append(self.parse_expr())
            while self.at_op(","):
                self.advance()
                args.append(self.parse_expr())
        self.eat_op(")")
        fn = A.Func(name=name, args=tuple(args), star=star,
                    distinct=distinct, loc=loc)
        if self.at_kw("OVER"):
            return self._parse_over(fn)
        return fn

    def _parse_over(self, fn: A.Func) -> A.Over:
        loc = self.eat_kw("OVER").loc
        self.eat_op("(")
        part: List[A.Node] = []
        order: Tuple[A.OrderItem, ...] = ()
        frame = None
        if self.at_kw("PARTITION"):
            self.advance()
            self.eat_kw("BY")
            part.append(self.parse_expr())
            while self.at_op(","):
                self.advance()
                part.append(self.parse_expr())
        if self.at_kw("ORDER"):
            order = self.parse_order_by()
        if self.at_kw("ROWS", "RANGE"):
            frame = self._parse_frame()
        self.eat_op(")")
        return A.Over(func=fn, partition_by=tuple(part), order_by=order,
                      frame=frame, loc=loc)

    def _parse_frame(self) -> A.FrameSpec:
        loc = self.cur.loc
        ftype = "rows" if self.take_kw("ROWS") else None
        if ftype is None:
            self.eat_kw("RANGE")
            ftype = "range"
        if self.take_kw("BETWEEN"):
            lo = self._parse_frame_bound(lower=True)
            self.eat_kw("AND")
            hi = self._parse_frame_bound(lower=False)
        else:
            lo = self._parse_frame_bound(lower=True)
            hi = 0
        return A.FrameSpec(frame_type=ftype, lower=lo, upper=hi,
                           loc=loc)

    def _parse_frame_bound(self, lower: bool) -> Optional[int]:
        if self.take_kw("UNBOUNDED"):
            if self.take_kw("PRECEDING"):
                return None if lower else self._frame_err(
                    "UNBOUNDED PRECEDING cannot be an upper bound")
            self.eat_kw("FOLLOWING")
            if lower:
                self._frame_err(
                    "UNBOUNDED FOLLOWING cannot be a lower bound")
            return None
        if self.take_kw("CURRENT"):
            self.eat_kw("ROW")
            return 0
        t = self.cur
        if t.kind != "number" or not isinstance(t.value, int):
            raise self.err("frame bound expects an integer, UNBOUNDED "
                           "or CURRENT ROW")
        self.advance()
        if self.take_kw("PRECEDING"):
            return -t.value
        self.eat_kw("FOLLOWING")
        return t.value

    def _frame_err(self, msg: str):
        raise self.err(msg)

    def _parse_type_name(self) -> A.TypeName:
        loc = self.cur.loc
        name = self._type_word().lower()
        if name == "double" and self.at_kw("PRECISION"):
            self.advance()
        params: List[int] = []
        if self.at_op("("):
            self.advance()
            while not self.at_op(")"):
                t = self.cur
                if t.kind != "number" or not isinstance(t.value, int):
                    raise self.err("type parameter must be an integer")
                params.append(t.value)
                self.advance()
                if self.at_op(","):
                    self.advance()
            self.advance()
        return A.TypeName(name=name, params=tuple(params), loc=loc)

    def _type_word(self) -> str:
        t = self.cur
        if t.kind != "ident":
            raise self.err(f"type name expected, found "
                           f"{self._describe(t)}")
        self.advance()
        return t.value


def parse_statement(sql: str) -> A.Statement:
    """Parse one statement (query, optionally EXPLAIN-prefixed)."""
    return _Parser(sql).parse_statement()


def parse(sql: str) -> A.Query:
    """Parse a bare query (no EXPLAIN)."""
    stmt = parse_statement(sql)
    return stmt.query

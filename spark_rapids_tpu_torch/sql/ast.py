"""Typed SQL AST.

Dataclasses, one per syntactic form. Every node carries ``loc`` — the
1-based (line, col) of its first token — EXCLUDED from equality:
structural equality between AST nodes is the mechanism the compiler
uses to match SELECT-list expressions against GROUP BY keys and ORDER
BY items (``sum(x)`` in ORDER BY is "the same aggregate" as ``sum(x)``
in the SELECT list regardless of where each was written).

Copied from ``spark_rapids_tpu/sql/ast.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = [
    "Node", "Col", "Lit", "Star", "Unary", "Binary", "Func", "CastE",
    "TypeName", "CaseE", "InE", "Between", "LikeE", "IsNullE", "Over",
    "FrameSpec", "OrderItem", "SelectItem", "Table", "Derived",
    "JoinRel", "SelectCore", "SetOp", "Query", "Statement", "sql_name",
]

def _loc():
    return field(default=(0, 0), compare=False, repr=False)


@dataclass(frozen=True)
class Node:
    pass


# --- expressions ----------------------------------------------------------

@dataclass(frozen=True)
class Col(Node):
    name: str
    qualifier: Optional[str] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Lit(Node):
    value: object                      # python value; None for NULL
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Star(Node):
    qualifier: Optional[str] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Unary(Node):
    op: str                            # '-' | '+' | 'NOT'
    operand: Node = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Binary(Node):
    op: str          # OR AND = <> < <= > >= <=> + - * / % DIV ||
    left: Node = None
    right: Node = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Func(Node):
    name: str                          # lower-cased at parse time
    args: Tuple[Node, ...] = ()
    star: bool = False                 # count(*)
    distinct: bool = False
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class TypeName(Node):
    name: str                          # lower-cased
    params: Tuple[int, ...] = ()       # decimal(p, s) / varchar(n)
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class CastE(Node):
    operand: Node = None
    type_name: TypeName = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class CaseE(Node):
    operand: Optional[Node]            # CASE <operand> WHEN v ... form
    whens: Tuple[Tuple[Node, Node], ...] = ()
    else_: Optional[Node] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class InE(Node):
    operand: Node = None
    items: Tuple[Node, ...] = ()
    negated: bool = False
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Between(Node):
    operand: Node = None
    low: Node = None
    high: Node = None
    negated: bool = False
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class LikeE(Node):
    operand: Node = None
    pattern: str = ""
    escape: str = "\\"
    negated: bool = False
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class IsNullE(Node):
    operand: Node = None
    negated: bool = False
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class FrameSpec(Node):
    frame_type: str = "range"          # rows | range
    lower: Optional[int] = None        # None = UNBOUNDED PRECEDING
    upper: Optional[int] = 0           # None = UNBOUNDED FOLLOWING
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Over(Node):
    """func OVER (PARTITION BY ... ORDER BY ... frame)."""
    func: Func = None
    partition_by: Tuple[Node, ...] = ()
    order_by: Tuple["OrderItem", ...] = ()
    frame: Optional[FrameSpec] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class OrderItem(Node):
    expr: Node = None
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = Spark default (asc)
    loc: Tuple[int, int] = _loc()


# --- relations / statements ----------------------------------------------

@dataclass(frozen=True)
class SelectItem(Node):
    expr: Node = None                  # may be Star
    alias: Optional[str] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Table(Node):
    name: str = ""
    alias: Optional[str] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Derived(Node):
    query: "Query" = None
    alias: str = ""
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class JoinRel(Node):
    left: Node = None
    right: Node = None
    kind: str = "inner"   # inner left_outer right_outer full_outer
    #                       left_semi left_anti cross
    condition: Optional[Node] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class SelectCore(Node):
    items: Tuple[SelectItem, ...] = ()
    from_: Tuple[Node, ...] = ()       # comma-list of relation trees
    where: Optional[Node] = None
    group_by: Tuple[Node, ...] = ()
    having: Optional[Node] = None
    distinct: bool = False
    hints: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class SetOp(Node):
    op: str = "union"                  # only union today
    all: bool = False
    left: Node = None                  # SelectCore | SetOp | Query
    right: Node = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Query(Node):
    ctes: Tuple[Tuple[str, "Query"], ...] = ()
    body: Node = None                  # SelectCore | SetOp
    order_by: Tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    loc: Tuple[int, int] = _loc()


@dataclass(frozen=True)
class Statement(Node):
    query: Query = None
    explain: bool = False
    analyze: bool = False   # EXPLAIN ANALYZE: execute, then annotate
    formatted: bool = False
    loc: Tuple[int, int] = _loc()


def sql_name(node: Node, index: int) -> str:
    """Output column name for an unaliased select expression — Spark-ish:
    a bare/qualified column keeps its name, a function call its
    lower-cased name, anything else a positional ``_c<i>``."""
    if isinstance(node, Col):
        return node.name
    if isinstance(node, Func):
        return node.name
    if isinstance(node, Over):
        return node.func.name
    if isinstance(node, CastE) and isinstance(node.operand, Col):
        return node.operand.name
    return f"_c{index}"


def walk(node):
    """Pre-order generator over every AST node reachable from ``node``
    (tuples of nodes included)."""
    if isinstance(node, Node):
        yield node
        for f in dataclasses.fields(node):
            if f.name == "loc":
                continue
            yield from walk(getattr(node, f.name))
    elif isinstance(node, (tuple, list)):
        for item in node:
            yield from walk(item)

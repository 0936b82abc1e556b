"""SQL text front end.

Counterpart of ``spark_rapids_tpu/sql/__init__.py``: the lexer, parser,
AST and error model are the reference's (pure Python, importing nothing
outside this package); ``functions.py`` and ``compiler.py`` lower the
AST onto the port's expressions and operators. Compiled plans go
through ``GpuOverrides.apply`` like DataFrame plans.

Entry points:

- ``GpuSession.sql(text)``: a DataFrame, or the plan's text for
  ``EXPLAIN [FORMATTED] <query>``;
- ``sql_to_plan(text, session)``: ``(root exec node, parsed
  Statement)``.

Errors carry line and column, a caret snippet, and the reason slugs
``sql_parse_error`` / ``sql_analysis_error`` (``sql/errors.py``); a
construct the port has not ported raises ``SqlAnalysisError`` with the
detail ``unsupported_feature`` and names its ROADMAP item.
"""
from __future__ import annotations

from .errors import SqlAnalysisError, SqlError, SqlParseError

__all__ = ["SqlError", "SqlParseError", "SqlAnalysisError",
           "sql_to_plan", "parse_statement"]


def parse_statement(text: str):
    from .parser import parse_statement as _p
    return _p(text)


def sql_to_plan(text: str, session):
    """Parse and compile one statement: ``(root exec node, Statement)``.
    Raises ``SqlParseError`` / ``SqlAnalysisError``."""
    from .compiler import SqlCompiler
    stmt = parse_statement(text)
    rel = SqlCompiler(session, text).compile_query(stmt.query, {})
    # the query profile labels a plan compiled from SQL source=sql
    # (obs/opmetrics.plan_source)
    rel.node._sql_origin = True
    return rel.node, stmt

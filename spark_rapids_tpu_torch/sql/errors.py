"""SQL frontend error model.

Two stable reason slugs — ``sql_parse_error`` (the text is not a
sentence of the dialect) and ``sql_analysis_error`` (it parsed but
cannot be bound/typed/lowered) — mirroring the planner's named
``plan_rejected`` reasons: "why didn't my SQL run" must leave evidence.
Every error carries the 1-based line/column it points at, a
caret-annotated snippet of the offending source line, and a finer
``detail`` code (``ambiguous_column``, ``unknown_function``, ...) that
tests and log miners can match without parsing prose.

``GpuSession.sql`` logs them through ``tools/event_log.log_sql_error``
(``to_dict``, one line a failure). Copied from ``spark_rapids_tpu/sql/``.
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["SqlError", "SqlParseError", "SqlAnalysisError",
           "caret_snippet"]


def caret_snippet(sql: str, line: int, col: int) -> str:
    """The offending source line with a caret under (line, col); both
    1-based. Out-of-range locations degrade to an empty snippet rather
    than raising — error rendering must never fail."""
    lines = sql.splitlines()
    if not (1 <= line <= len(lines)):
        return ""
    src = lines[line - 1]
    caret_at = max(0, min(col - 1, len(src)))
    return f"  | {src}\n  | {' ' * caret_at}^"


class SqlError(Exception):
    """Base SQL frontend error: message + source location + slug."""

    slug = "sql_error"

    def __init__(self, message: str, sql: str = "",
                 loc: Optional[Tuple[int, int]] = None,
                 detail: str = ""):
        self.message = message
        self.sql = sql
        self.line, self.col = loc if loc else (0, 0)
        self.detail = detail
        super().__init__(self.render())

    def render(self) -> str:
        where = f" (line {self.line}, col {self.col})" \
            if self.line else ""
        snip = caret_snippet(self.sql, self.line, self.col)
        body = f"{self.slug}: {self.message}{where}"
        return f"{body}\n{snip}" if snip else body

    def to_dict(self) -> dict:
        return {
            "type": self.slug,
            "detail": self.detail,
            "message": self.message,
            "line": self.line,
            "col": self.col,
            "snippet": caret_snippet(self.sql, self.line, self.col),
        }


class SqlParseError(SqlError):
    """Lex/parse failure — the stable ``sql_parse_error`` reason."""

    slug = "sql_parse_error"


class SqlAnalysisError(SqlError):
    """Resolution/typing/lowering failure — the stable
    ``sql_analysis_error`` reason."""

    slug = "sql_analysis_error"

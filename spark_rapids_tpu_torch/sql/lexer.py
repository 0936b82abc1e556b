"""SQL lexer: text -> token stream with precise source locations.

Hand-written (no sqlglot in this image) like the parser it feeds.
Keywords are NOT a distinct token kind: every unquoted word lexes as an
``ident`` and the parser matches keywords case-insensitively, so any
keyword-colliding name can be used as an identifier by quoting it
(``"order"`` / `` `order` ``). ``/*+ ... */`` blocks survive as
``hint`` tokens (Spark's hint comments); all other comments are
skipped.

Copied from ``spark_rapids_tpu/sql/lexer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .errors import SqlParseError

__all__ = ["Token", "tokenize"]

# longest-match-first operator table
_OPERATORS = ("<=>", "||", "<=", ">=", "<>", "!=", "==",
              "(", ")", ",", ".", "+", "-", "*", "/", "%",
              "<", ">", "=")

_IDENT_START = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_IDENT_CONT = _IDENT_START | set("0123456789")
_DIGITS = set("0123456789")


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str          # ident | qident | number | string | hint | op | eof
    value: object      # text (ident/op/hint), python value (number/string)
    line: int          # 1-based
    col: int           # 1-based

    @property
    def loc(self) -> Tuple[int, int]:
        return (self.line, self.col)

    def upper(self) -> str:
        """Keyword view of an ident token."""
        return self.value.upper() if self.kind == "ident" else ""


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    line, col = 1, 1

    def err(msg, l=None, c=None):
        return SqlParseError(msg, sql, (l or line, c or col))

    def advance(k: int):
        """Move the cursor k chars, tracking line/col."""
        nonlocal i, line, col
        for _ in range(k):
            if sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        ch = sql[i]
        if ch in " \t\r\n":
            advance(1)
            continue
        if ch == "-" and sql.startswith("--", i):
            while i < n and sql[i] != "\n":
                advance(1)
            continue
        if sql.startswith("/*", i):
            is_hint = sql.startswith("/*+", i)
            l0, c0 = line, col
            end = sql.find("*/", i + 2)
            if end < 0:
                raise err("unterminated block comment", l0, c0)
            body = sql[i + 3:end] if is_hint else ""
            advance(end + 2 - i)
            if is_hint:
                toks.append(Token("hint", body.strip(), l0, c0))
            continue
        if ch == "'":
            l0, c0 = line, col
            advance(1)
            buf = []
            while True:
                if i >= n:
                    raise err("unterminated string literal", l0, c0)
                if sql[i] == "'":
                    if i + 1 < n and sql[i + 1] == "'":  # '' escape
                        buf.append("'")
                        advance(2)
                        continue
                    advance(1)
                    break
                buf.append(sql[i])
                advance(1)
            toks.append(Token("string", "".join(buf), l0, c0))
            continue
        if ch in ('"', "`"):
            l0, c0 = line, col
            closer = ch
            advance(1)
            buf = []
            while True:
                if i >= n:
                    raise err("unterminated quoted identifier", l0, c0)
                if sql[i] == closer:
                    if i + 1 < n and sql[i + 1] == closer:
                        buf.append(closer)
                        advance(2)
                        continue
                    advance(1)
                    break
                buf.append(sql[i])
                advance(1)
            if not buf:
                raise err("empty quoted identifier", l0, c0)
            toks.append(Token("qident", "".join(buf), l0, c0))
            continue
        if ch in _DIGITS or (ch == "." and i + 1 < n
                             and sql[i + 1] in _DIGITS):
            l0, c0 = line, col
            j = i
            seen_dot = seen_exp = False
            while j < n:
                c = sql[j]
                if c in _DIGITS:
                    j += 1
                elif c == "." and not seen_dot and not seen_exp:
                    # `1.` then ident would be a qualified ref on a
                    # number — SQL has no such thing; eat as float
                    seen_dot = True
                    j += 1
                elif c in "eE" and not seen_exp and j + 1 < n \
                        and (sql[j + 1] in _DIGITS
                             or (sql[j + 1] in "+-" and j + 2 < n
                                 and sql[j + 2] in _DIGITS)):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            text = sql[i:j]
            advance(j - i)
            value = float(text) if (seen_dot or seen_exp) else int(text)
            toks.append(Token("number", value, l0, c0))
            continue
        if ch in _IDENT_START:
            l0, c0 = line, col
            j = i
            while j < n and sql[j] in _IDENT_CONT:
                j += 1
            toks.append(Token("ident", sql[i:j], l0, c0))
            advance(j - i)
            continue
        matched: Optional[str] = None
        for op in _OPERATORS:
            if sql.startswith(op, i):
                matched = op
                break
        if matched is None:
            raise err(f"unexpected character {ch!r}")
        l0, c0 = line, col
        advance(len(matched))
        toks.append(Token("op", matched, l0, c0))
    toks.append(Token("eof", "", line, col))
    return toks

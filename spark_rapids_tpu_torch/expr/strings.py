"""String predicates: ``Like`` and ``RegExpLike``.

Counterpart of ``spark_rapids_tpu/expr/strings.py:201-304,397-445``.

``Like`` keeps the reference's shapes (``_simple_shape``: no escape
character and no ``_`` in the pattern). The ``exact`` shape compares
the column with the literal's bytes (``ops/strings.compare_with_
literals``). Every other pattern, the reference's prefix, suffix,
contains and prefix-and-suffix shapes included, compiles through
``ops/regex.like_to_regex`` and ``compile_pattern`` and runs on **K6**
(``ops/regex.regex_match``): one mechanism, with the same answers as
the reference's literal-fragment kernels. ``RegExpLike`` runs its
pattern on K6 as it is. A pattern the device dialect refuses (a
non-ASCII pattern, one over 64 positions, groups, bounded repeats)
raises at planning (``gpu_supported``): the reference runs it on the
host, and the port's CPU fallback waits for ROADMAP item 12. The result
keeps the column's validity; a null row's match bit is not read.

``StartsWith``, ``EndsWith``, ``Contains`` and the module's other
expressions wait for ROADMAP item 13.
"""
from __future__ import annotations

from typing import Optional

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, is_string_like
from ..ops import regex
from ..ops.strings import compare_with_literals, string_row_parts
from .base import Expression

__all__ = ["Like", "RegExpLike"]


def _match(col: GpuColumnVector, prog) -> GpuColumnVector:
    starts, lengths = string_row_parts(col)
    return GpuColumnVector(dt.BOOL, regex.regex_match(
        starts, lengths, col.validity, col.chars, prog), col.validity)


class _RegexPredicate(Expression):
    """A string predicate that runs a compiled pattern on K6."""

    def __init__(self, child: Expression):
        self.children = (child,)
        self._compiled = None

    @property
    def dtype(self):
        return dt.BOOL

    def validate(self):
        t = self.children[0].dtype
        if not is_string_like(t):
            raise TypeError(f"{type(self).__name__} needs a string, got "
                            f"{t.simple_string()}")

    def _compile(self):
        """The device program, None where none is needed, or
        ``RegexUnsupported``."""
        raise NotImplementedError

    def program(self):
        """``_compile()``, once: the program, None, or the refusal
        raised again."""
        if self._compiled is None:
            try:
                self._compiled = (self._compile(), None)
            except regex.RegexUnsupported as e:
                self._compiled = (None, str(e))
        prog, why = self._compiled
        if why is not None:
            raise regex.RegexUnsupported(why)
        return prog

    def gpu_supported(self) -> Optional[str]:
        try:
            self.program()
        except regex.RegexUnsupported as e:
            return (f"pattern {self.pattern!r} is outside the device regex "
                    f"dialect ({e}); the reference runs it on the host, and "
                    "the port's CPU fallback waits for ROADMAP item 12")
        return None


class Like(_RegexPredicate):
    """SQL ``LIKE``: ``%`` any characters, ``_`` one character (not one
    byte), both across newlines; ``escape`` quotes the next
    character."""

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        super().__init__(child)
        self.pattern = pattern
        self.escape = escape

    def _simple_shape(self):
        """The reference's literal shapes, or None."""
        p = self.pattern
        if self.escape in p or "_" in p:
            return None
        parts = p.split("%")
        if len(parts) == 1:
            return ("exact", parts[0])
        if len(parts) == 2:
            if parts[0] == "" and parts[1] == "":
                return ("all",)
            if parts[1] == "":
                return ("prefix", parts[0])
            if parts[0] == "":
                return ("suffix", parts[1])
            return ("prefix_suffix", parts[0], parts[1])
        if len(parts) == 3 and parts[0] == "" and parts[2] == "":
            return ("contains", parts[1])
        return None

    def _compile(self):
        shape = self._simple_shape()
        if shape is not None and shape[0] == "exact":
            return None
        return regex.compile_pattern(regex.like_to_regex(self.pattern,
                                                         self.escape))

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        prog = self.program()
        if prog is not None:
            return _match(c, prog)
        cmp, = compare_with_literals(c, [self.pattern.encode()])
        return GpuColumnVector(dt.BOOL, cmp == 0, c.validity)

    def __repr__(self):
        return f"({self.children[0]!r} LIKE {self.pattern!r})"


class RegExpLike(_RegexPredicate):
    """``rlike``: search semantics in the device dialect, Java's ASCII
    ``\\w \\d \\s``; ``.`` and negated classes match whole UTF-8
    characters."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__(child)
        self.pattern = pattern

    def _compile(self):
        return regex.compile_pattern(self.pattern)

    def eval_gpu(self, batch, ctx):
        return _match(self.children[0].eval_gpu(batch, ctx),
                      self.program())

    def __repr__(self):
        return f"({self.children[0]!r} RLIKE {self.pattern!r})"

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
keeps its operator off the device (``gpu_supported``), and on the CPU
the pattern runs through Python's ``re`` as the reference's host path
has it (``:299,437``): LIKE translated to an anchored pattern with
``.`` across newlines, RLIKE searched with ASCII classes, each distinct
string of the column matched once. The result keeps the column's
validity; a null row's match bit is not read.

``StartsWith``, ``EndsWith``, ``Contains`` and the module's other
expressions wait for ROADMAP item 13.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np
import pyarrow as pa
import torch

from .. import datatypes as dt
from ..columnar.column import GpuColumnVector, is_string_like
from ..ops import regex
from ..ops.strings import compare_with_literals, string_row_parts
from .base import Expression, column_to_arrow

__all__ = ["Like", "RegExpLike"]


def _match(col: GpuColumnVector, prog) -> GpuColumnVector:
    starts, lengths = string_row_parts(col)
    return GpuColumnVector(dt.BOOL, regex.regex_match(
        starts, lengths, col.validity, col.chars, prog), col.validity)


def _host_match(col: GpuColumnVector, test) -> GpuColumnVector:
    """A CPU column matched by ``test`` (a compiled Python pattern's
    ``fullmatch`` or ``search``), each distinct string once."""
    arr = column_to_arrow(col, col.capacity)
    if pa.types.is_binary(arr.type):
        arr = arr.cast(pa.string())
    enc = arr.dictionary_encode()
    hits = np.array([test(v) is not None
                     for v in enc.dictionary.to_pylist()] + [False])
    idx = enc.indices.fill_null(len(enc.dictionary)).to_numpy(
        zero_copy_only=False)
    return GpuColumnVector(dt.BOOL, torch.from_numpy(hits[idx]),
                           col.validity)


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
                    f"dialect ({e}); it runs on the CPU")
        return None

    def _host_test(self):
        """The host path's matcher: a compiled Python pattern's
        ``fullmatch`` or ``search``."""
        raise NotImplementedError

    def _host_eval(self, c: GpuColumnVector,
                   ctx) -> Optional[GpuColumnVector]:
        """The host path's result inside a CPU island for a pattern
        outside the device dialect, else None (the device program
        runs)."""
        if ctx.host and self.gpu_supported() is not None:
            return _host_match(c, self._host_test())
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

    def _host_test(self):
        out, i, p = [], 0, self.pattern
        while i < len(p):
            ch = p[i]
            if ch == self.escape and i + 1 < len(p):
                out.append(re.escape(p[i + 1]))
                i += 2
                continue
            out.append(".*" if ch == "%" else "." if ch == "_"
                       else re.escape(ch))
            i += 1
        return re.compile("".join(out), re.DOTALL).fullmatch

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        host = self._host_eval(c, ctx)
        if host is not None:
            return host
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

    def _host_test(self):
        # Java's \w \d \s are ASCII classes, as on the device
        return re.compile(self.pattern, re.ASCII).search

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        host = self._host_eval(c, ctx)
        return host if host is not None else _match(c, self.program())

    def __repr__(self):
        return f"({self.children[0]!r} RLIKE {self.pattern!r})"

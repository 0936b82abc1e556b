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

A LIKE of the literal shapes (prefix, suffix, contains, prefix and
suffix) compiles with ``literal_bytes``, so a non-ASCII literal matches
its UTF-8 bytes on K6, as the reference's literal kernels do; a general
non-ASCII pattern stays on the CPU, as there.

The rest of ``spark_rapids_tpu/expr/strings.py``:

- on the device: ``Length`` (characters: UTF-8 lead bytes), ``Upper``
  and ``Lower`` (ASCII letters; the CPU path maps every character, as
  the reference's ``pc.utf8_upper``), ``Substring`` (Spark's 1-based
  window: bytes on the device, characters on the CPU; ``incompat``, so
  ``spark.rapids.sql.incompatibleOps.enabled=false`` keeps it on the
  CPU), ``ConcatStrings`` (null if any input is), ``StartsWith``,
  ``EndsWith`` and ``Contains`` of a literal (K6; a literal past
  ``ops/regex.LITERAL_MAX_BYTES`` on the CPU), and
  ``StringTrim``, ``StringTrimLeft``, ``StringTrimRight`` (ASCII
  spaces);
- on the CPU, where the reference places them: ``StringReplace``,
  ``StringLocate``, ``StringLpad``, ``StringRpad``, ``StringRepeat``
  and ``Reverse``, each over the column's Arrow values.

Where the reference departs from Spark the port follows Spark: a
negative start before the string's beginning eats into the length
(``substr('abc', -5, 3)`` is ``'a'``; the reference clamps the start
first and gives ``'abc'``).

``RegExpReplace`` and ``RegExpExtract`` (the reference's ``:447,496``)
find each row's leftmost-longest spans on **K8**
(``ops/regex.find_spans``) and assemble the result in torch, under the
reference's gates: a pattern with alternation or one that can match the
empty string (``compile_replace_pattern``), a replacement holding ``$``
or a backslash, and an extract group other than 0 or the whole
pattern's ``(X)`` keep their operator on the CPU. A CPU operator runs
every pattern through Python's ``re`` with ``re.ASCII`` (Java's
classes), ``$n`` becoming ``\\n``, each distinct string once, as the
reference's ``eval_cpu`` does.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from .. import datatypes as dt
from ..columnar.arrow_bridge import column_from_host, host_lanes, \
    string_column_from_host
from ..columnar.column import GpuColumnVector, and_validity, \
    is_string_like
from ..ops import regex
from ..ops import strings as sops
from ..ops.strings import compare_with_literals, string_row_parts
from .base import Expression, column_to_arrow

__all__ = ["Like", "RegExpLike", "Length", "Upper", "Lower", "Substring",
           "ConcatStrings", "StartsWith", "EndsWith", "Contains",
           "StringTrim", "StringTrimLeft", "StringTrimRight",
           "StringReplace", "StringLocate", "StringLpad", "StringRpad",
           "StringRepeat", "Reverse", "RegExpReplace", "RegExpExtract"]


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
        # the literal shapes take any bytes, as the reference's literal
        # kernels; a general pattern keeps the dialect's ASCII rule
        literal = shape is not None
        return regex.compile_pattern(
            regex.like_to_regex(self.pattern, self.escape, literal),
            literal_bytes=literal)

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


# --- the rest of the reference's string functions ---------------------------

def _from_arrow(arr: pa.Array, t: dt.DataType, capacity: int,
                device) -> GpuColumnVector:
    """A host Arrow result as a column of ``capacity`` rows."""
    if is_string_like(t):
        return string_column_from_host(t, arr, capacity, device)
    values, valid = host_lanes(arr, t)
    return column_from_host(t, values, valid, capacity, device)


def _host_values(col: GpuColumnVector):
    """The column's rows as Python strings (None for null)."""
    arr = column_to_arrow(col, col.capacity)
    if pa.types.is_binary(arr.type):
        arr = arr.cast(pa.string())
    return arr


class _StringFunction(Expression):
    """A function of one string column."""

    out_type = dt.STRING

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self):
        return self.out_type

    def validate(self):
        t = self.children[0].dtype
        if not is_string_like(t):
            raise TypeError(f"{type(self).__name__} needs a string, got "
                            f"{t.simple_string()}")


class _HostStringFunction(_StringFunction):
    """A string function the reference runs on its host path only: the
    planner keeps its operator on the CPU, where ``host`` maps the
    column's Arrow values."""

    host_reason = "runs on the CPU"

    def gpu_supported(self) -> Optional[str]:
        return self.host_reason

    def host(self, arr: pa.Array) -> pa.Array:
        raise NotImplementedError

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        if not ctx.host:
            raise NotImplementedError(
                f"{type(self).__name__} {self.host_reason}, where the "
                "planner places it")
        out = self.host(_host_values(c))
        return _from_arrow(out, self.dtype, c.capacity, c.device)


class Length(_StringFunction):
    """char_length: UTF-8 characters, not bytes (Spark)."""

    out_type = dt.INT32

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        counts = sops.utf8_lead_counts(c)
        n = counts[c.offsets[1:].long()] - counts[c.offsets[:-1].long()]
        return GpuColumnVector(dt.INT32, n.to(torch.int32), c.validity)


class _CaseMap(_StringFunction):
    """ASCII case mapping on the device (the reference's
    ``upper_ascii_tpu``); every character on the CPU path."""

    to_upper = True

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        if ctx.host:
            arr = _host_values(c)
            fn = pc.utf8_upper if self.to_upper else pc.utf8_lower
            return _from_arrow(fn(arr), self.dtype, c.capacity, c.device)
        return sops.case_map_ascii(c, self.to_upper)


class Upper(_CaseMap):
    to_upper = True


class Lower(_CaseMap):
    to_upper = False


class Substring(Expression):
    """substring(str, pos, len): Spark's 1-based window (module
    docstring); bytes on the device, characters on the CPU."""

    incompat = "byte-based substring differs from Spark on non-ASCII"

    def __init__(self, child: Expression, pos: Expression,
                 length: Expression):
        self.children = (child, pos, length)

    @property
    def dtype(self):
        return dt.STRING

    def validate(self):
        if not is_string_like(self.children[0].dtype):
            raise TypeError("substring needs a string")
        for c in self.children[1:]:
            if not dt.is_integral(c.dtype):
                raise TypeError("substring's position and length are "
                                "integers")

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        p = self.children[1].eval_gpu(batch, ctx)
        ln = self.children[2].eval_gpu(batch, ctx)
        valid = and_validity(and_validity(c.validity, p.validity),
                             ln.validity)
        cut = sops.substring_chars if ctx.host else sops.substring_bytes
        return cut(c, p.data, ln.data, valid)


class ConcatStrings(Expression):
    """concat(s1, s2, ...): null if any input is null."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self):
        return dt.STRING

    def validate(self):
        for c in self.children:
            if not is_string_like(c.dtype):
                raise TypeError(f"concat needs strings, got "
                                f"{c.dtype.simple_string()}")

    def eval_gpu(self, batch, ctx):
        cols = [c.eval_gpu(batch, ctx) for c in self.children]
        valid = None
        for c in cols:
            valid = and_validity(valid, c.validity)
        return sops.concat_strings(cols, valid)


class _LiteralPatternMatch(_RegexPredicate):
    """startswith/endswith/contains of a literal: K6 runs the literal's
    bytes, any of them (``regex.compile_literal``). A literal past
    ``regex.LITERAL_MAX_BYTES``, or whose DFA does not fit K6, keeps
    its operator on the CPU, where Python's ``str`` method answers."""

    kind = ""
    method = ""

    def __init__(self, child: Expression, pattern: str):
        super().__init__(child)
        self.pattern = pattern

    def _compile(self):
        return regex.compile_literal(self.pattern, self.kind)

    def gpu_supported(self) -> Optional[str]:
        try:
            self.program()
        except regex.RegexUnsupported as e:
            return (f"{self.pretty_name()} of a literal K6 cannot take "
                    f"({e}); it runs on the CPU")
        return None

    def _host_test(self):
        def test(s, method=self.method, lit=self.pattern):
            return True if getattr(s, method)(lit) else None
        return test

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        host = self._host_eval(c, ctx)
        return host if host is not None else _match(c, self.program())

    def __repr__(self):
        return f"{self.pretty_name()}({self.children[0]!r}, " \
            f"{self.pattern!r})"


class StartsWith(_LiteralPatternMatch):
    kind, method = "prefix", "startswith"


class EndsWith(_LiteralPatternMatch):
    kind, method = "suffix", "endswith"


class Contains(_LiteralPatternMatch):
    kind, method = "contains", "__contains__"


class StringTrim(_StringFunction):
    """trim(): strips ASCII spaces (0x20), Spark's default trim."""

    left = True
    right = True

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        return sops.trim_spaces(c, self.left, self.right)


class StringTrimLeft(StringTrim):
    left, right = True, False


class StringTrimRight(StringTrim):
    left, right = False, True


class StringReplace(_HostStringFunction):
    """replace(str, search, replace) with literal search (host)."""

    host_reason = "string replace runs on host"

    def __init__(self, child: Expression, search: str, replacement: str):
        super().__init__(child)
        self.search = search
        self.replacement = replacement

    def host(self, arr):
        if self.search == "":
            return arr
        return pc.replace_substring(arr, pattern=self.search,
                                    replacement=self.replacement)


class StringLocate(_HostStringFunction):
    """locate(substr, str[, pos]): the 1-based position of the first
    occurrence at or after character ``pos``, 0 when there is none or
    ``pos`` is below 1 (host)."""

    out_type = dt.INT32
    host_reason = "locate runs on host"

    def __init__(self, substr: str, child: Expression, pos: int = 1):
        super().__init__(child)
        self.substr = substr
        self.pos = pos

    def host(self, arr):
        out = []
        for v in arr.to_pylist():
            if v is None:
                out.append(None)
            elif self.pos <= 0:
                out.append(0)
            else:
                out.append(v.find(self.substr, self.pos - 1) + 1)
        return pa.array(out, pa.int32())


class _Pad(_HostStringFunction):
    left = True
    host_reason = "pad runs on host"

    def __init__(self, child: Expression, length: int, pad: str = " "):
        super().__init__(child)
        self.length = length
        self.pad = pad

    def host(self, arr):
        out = []
        for v in arr.to_pylist():
            if v is None:
                out.append(None)
            elif len(v) >= self.length:
                out.append(v[:max(self.length, 0)])
            elif not self.pad:
                out.append(v)
            else:
                fill = (self.pad * self.length)[:self.length - len(v)]
                out.append(fill + v if self.left else v + fill)
        return pa.array(out, pa.string())


class StringLpad(_Pad):
    left = True


class StringRpad(_Pad):
    left = False


class StringRepeat(_HostStringFunction):
    host_reason = "repeat runs on host"

    def __init__(self, child: Expression, times: int):
        super().__init__(child)
        self.times = times

    def host(self, arr):
        return pa.array([None if v is None else v * max(self.times, 0)
                         for v in arr.to_pylist()], pa.string())


class Reverse(_HostStringFunction):
    """reverse(str): characters in reverse order (host)."""

    host_reason = "reverse runs on host"

    def host(self, arr):
        return pa.array([None if v is None else v[::-1]
                         for v in arr.to_pylist()], pa.string())


# --- regexp_replace and regexp_extract: K8's spans ---------------------------

class _SpanFunction(_StringFunction):
    """A string function over a pattern's spans (``ops/regex``), K8 on
    the device; a pattern the gates refuse keeps its operator on the
    CPU. On the CPU ``host`` runs Python's ``re``, for any pattern."""

    def __init__(self, child: Expression, pattern: str):
        super().__init__(child)
        self.pattern = pattern
        self._compiled = None

    def _compile(self):
        """``(program, None)`` or ``(None, reason)``."""
        raise NotImplementedError

    def program(self):
        if self._compiled is None:
            self._compiled = self._compile()
        return self._compiled[0]

    #: the SQL name the refusal's reason gives, as the reference's
    sql_name = ""

    def gpu_supported(self) -> Optional[str]:
        self.program()
        why = self._compiled[1]
        return None if why is None else \
            f"{self.sql_name} {self.pattern!r}: {why}"

    def host(self, values):
        raise NotImplementedError

    def device(self, c: GpuColumnVector, prog) -> GpuColumnVector:
        raise NotImplementedError

    def eval_gpu(self, batch, ctx):
        c = self.children[0].eval_gpu(batch, ctx)
        if not ctx.host:
            why = self.gpu_supported()
            if why is not None:
                raise NotImplementedError(f"{why}, where the planner "
                                          "places it")
            return self.device(c, self.program())
        # the CPU path is Python's re whatever the pattern, as the
        # reference's eval_cpu (its $ also matches before a final \n)
        arr = _host_values(c)
        enc = arr.dictionary_encode()
        out = pa.array([self.host(v) for v in enc.dictionary.to_pylist()],
                       pa.string()).take(enc.indices)
        return _from_arrow(out, self.dtype, c.capacity, c.device)

    def __repr__(self):
        return f"{self.pretty_name()}({self.children[0]!r}, " \
            f"{self.pattern!r})"


class RegExpReplace(_SpanFunction):
    """``regexp_replace``: every non-overlapping match replaced by a
    literal; a ``$`` group or backslash replacement on the CPU."""

    sql_name = "regexp_replace"

    def __init__(self, child: Expression, pattern: str, replacement: str):
        super().__init__(child, pattern)
        self.replacement = replacement

    def _compile(self):
        prog, why = regex.compile_replace_pattern(self.pattern)
        if why is None and ("$" in self.replacement
                            or "\\" in self.replacement):
            return None, "$group / escape replacements run on host"
        return prog, why

    def host(self, v):
        rx = re.compile(self.pattern, re.ASCII)
        return rx.sub(re.sub(r"\$(\d)", r"\\\1", self.replacement), v)

    def device(self, c, prog):
        return regex.regex_replace(c, prog, self.replacement.encode())


class RegExpExtract(_SpanFunction):
    """``regexp_extract``: the first match's group, '' where none. On
    the device for group 0 and for a whole-pattern group ``(X)`` with
    group 1, the dialect having no inner groups."""

    sql_name = "regexp_extract"

    def __init__(self, child: Expression, pattern: str, group: int = 1):
        super().__init__(child, pattern)
        self.group = group

    def _effective_pattern(self) -> Optional[str]:
        p = self.pattern
        if self.group == 0:
            return p
        if self.group == 1 and len(p) >= 2 and p[0] == "(" \
                and p[-1] == ")" and p[-2] != "\\" \
                and "(" not in p[1:-1] and ")" not in p[1:-1]:
            return p[1:-1]  # (X) with group 1 is the whole match of X
        return None

    def _compile(self):
        eff = self._effective_pattern()
        if eff is None:
            return None, (f"capture group {self.group} needs group "
                          "tracking; runs on host")
        return regex.compile_replace_pattern(eff)

    def host(self, v):
        m = re.compile(self.pattern, re.ASCII).search(v)
        if m is None:
            return ""
        g = m.group(self.group)
        return g if g is not None else ""

    def device(self, c, prog):
        return regex.regex_extract(c, prog)

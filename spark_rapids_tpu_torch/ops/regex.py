"""Regular expressions on the device: the host compiler and K6.

Counterpart of ``spark_rapids_tpu/ops/regex.py:1-452``. The host half is
the reference's, copied (pure Python and numpy): the restricted dialect
(literals, escapes ``\\d \\w \\s`` and their negations, character
classes with ranges and negation, ``.``, the anchors ``^`` and ``$``,
the quantifiers ``* + ?`` on single atoms, top-level alternation),
compiled into a Glushkov position automaton of at most ``_MAX_STATES``
positions (``compile_pattern``, ``:269``), and ``like_to_regex``
(``:347``), which turns a SQL LIKE pattern into a fully anchored pattern
of that dialect (``%`` and ``_`` become ``[\\s\\S]``, which matches
any whole UTF-8 character, newlines included). A pattern outside the
dialect raises ``RegexUnsupported``.

The matcher (the reference's ``regex_match_device``, ``:378``, a
``jax.lax.while_loop`` over byte positions with an ``(n, S) @ (S, S)``
step) is **K6**, ``csrc/regex_match.cu``, one thread a row read through
its start offset and length, each row stopping as soon as it has matched
or no position can fire again. It has two routes, chosen by the
program's tables alone (``program_tables``):

- **A, a DFA**: ``build_dfa`` runs the subset construction over the
  position automaton on the host, once a program: a class a byte, a
  state a reachable active set, a 16-bit entry a (state, class) with the
  two accept flags. A step is two shared-memory lookups, and a row is
  read 16 bytes at a time. It is taken when the states times the
  classes fit ``DFA_MAX_ENTRIES``;
- **B, position sets**: the active set one ``uint64``, the byte classes
  (``acc``) and the follow relation in shared memory, one follow lookup
  a fired position, for a program whose DFA does not fit.

``compile_literal`` gives a ``startswith``/``endswith``/``contains``
literal past 64 bytes (up to ``LITERAL_MAX_BYTES``) no position
automaton but its DFA, built straight from its bytes: route A only.

``regex_match`` is its wrapper; ``regex_match_torch``, the reference's
loop in torch (one ``.item()`` of the longest live string, then one
step a byte position), is its plain version, which only a CPU tensor
takes (a long literal's steps its DFA). The caller masks validity: a
null row steps as an empty one.

The spans (the reference's ``:453-702``) carry ``regexp_replace`` and
``regexp_extract``: each row's non-overlapping leftmost-longest match
spans. ``compile_replace_pattern`` sends a pattern with alternation
(leftmost-first in Java) or one that can match the empty string to the
CPU, as the reference does. The finder is **K8**
(``csrc/regex_spans.cu``, one thread a row, on route B's position sets):
``find_spans`` is its wrapper and ``find_spans_torch``, the reference's
two phases in torch (``regex_find_spans_device``, ``:475``: a backward
walk over every row finding the positions where a match can start,
then a forward walk committing each row's greedy spans), its plain
version. ``regex_replace`` and ``regex_extract`` assemble the output
strings from the spans in torch (``:568-702``), the same code on either
device.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["RegexUnsupported", "RegexProgram", "compile_pattern",
           "compile_literal", "LITERAL_MAX_BYTES", "like_to_regex",
           "literal_regex", "regex_match", "regex_match_torch",
           "regex_bytes_read", "program_tables", "position_tables",
           "build_dfa", "follow_byte_tables", "Dfa", "MAX_STATES",
           "DFA_MAX_ENTRIES", "compile_replace_pattern",
           "replace_program_supported", "follow_t_byte_tables",
           "span_tables", "find_spans", "find_spans_torch",
           "replace_char_cap", "regex_replace", "regex_extract"]

_MAX_STATES = 64


class RegexUnsupported(Exception):
    """Pattern outside the device dialect — caller falls back to host."""


def _class_for_escape(ch: str) -> np.ndarray:
    m = np.zeros(256, bool)
    if ch == "d":
        m[ord("0"):ord("9") + 1] = True
    elif ch == "w":
        m[ord("0"):ord("9") + 1] = True
        m[ord("a"):ord("z") + 1] = True
        m[ord("A"):ord("Z") + 1] = True
        m[ord("_")] = True
    elif ch == "s":
        for c in " \t\n\r\f\v":
            m[ord(c)] = True
    elif ch in "DWS":
        m = ~_class_for_escape(ch.lower())
    elif ch == "n":
        m[ord("\n")] = True
    elif ch == "t":
        m[ord("\t")] = True
    elif ch == "r":
        m[ord("\r")] = True
    elif ch in ".^$*+?()[]{}|\\/-":
        m[ord(ch)] = True
    else:
        raise RegexUnsupported(f"escape \\{ch} not in device dialect")
    return m


def _parse_class(p: str, i: int) -> Tuple[np.ndarray, int]:
    """[...] starting at p[i] == '['; returns (256-bool mask, next i)."""
    i += 1
    neg = i < len(p) and p[i] == "^"
    if neg:
        i += 1
    m = np.zeros(256, bool)
    first = True
    while i < len(p) and (p[i] != "]" or first):
        first = False
        if p[i] == "\\":
            if i + 1 >= len(p):
                raise RegexUnsupported("dangling escape in class")
            sub = _class_for_escape(p[i + 1])
            m |= sub
            i += 2
            continue
        lo = p[i]
        if ord(lo) > 127:
            raise RegexUnsupported("non-ASCII character class")
        if i + 2 < len(p) and p[i + 1] == "-" and p[i + 2] != "]":
            hi = p[i + 2]
            if ord(lo) > ord(hi):
                raise RegexUnsupported(f"bad range {lo}-{hi}")
            m[ord(lo):ord(hi) + 1] = True
            i += 3
        else:
            m[ord(lo)] = True
            i += 1
    if i >= len(p):
        raise RegexUnsupported("unterminated character class")
    i += 1  # skip ]
    return (~m if neg else m), i


def _parse_branch(branch: str, literal_bytes: bool = False):
    """-> (anchored_start, anchored_end, [(class, quant)]).
    quant in '1?*+'. With ``literal_bytes`` a non-ASCII literal character
    is its UTF-8 bytes, one single-byte atom each (no quantifier may
    follow it); without, it is refused."""
    i = 0
    anchored_start = branch.startswith("^")
    if anchored_start:
        i = 1
    # a final "$" anchors unless an odd run of backslashes escapes it
    anchored_end = branch.endswith("$") and \
        (len(branch) - 1 - len(branch[:-1].rstrip("\\"))) % 2 == 0
    end = len(branch) - 1 if anchored_end else len(branch)
    atoms: List[Tuple[np.ndarray, str]] = []
    while i < end:
        c = branch[i]
        if c in "(){":
            raise RegexUnsupported(f"'{c}' (groups/bounded repeats) not "
                                   "in device dialect")
        if c in "^$":
            raise RegexUnsupported("mid-pattern anchor")
        if c == "[":
            m, i = _parse_class(branch, i)
        elif c == "\\":
            if i + 1 >= end:
                raise RegexUnsupported("dangling escape")
            m = _class_for_escape(branch[i + 1])
            i += 2
        elif c == ".":
            m = np.ones(256, bool)
            m[ord("\n")] = False  # Java default: . excludes newline
            i += 1
        elif c in "*+?":
            raise RegexUnsupported("quantifier without atom")
        else:
            if ord(c) > 127:
                if not literal_bytes:
                    raise RegexUnsupported("non-ASCII pattern byte")
                if i + 1 < end and branch[i + 1] in "*+?":
                    raise RegexUnsupported("quantified non-ASCII character")
                # quant "b": one literal byte, not a character class
                for byte in c.encode():
                    m = np.zeros(256, bool)
                    m[byte] = True
                    atoms.append((m, "b"))
                i += 1
                continue
            m = np.zeros(256, bool)
            m[ord(c)] = True
            i += 1
        quant = "1"
        if i < end and branch[i] in "*+?":
            quant = branch[i]
            i += 1
            if i < end and branch[i] in "*+?":
                raise RegexUnsupported("stacked quantifiers")
        atoms.append((m, quant))
    return anchored_start, anchored_end, atoms


class RegexProgram:
    """Compiled position-automaton tables (numpy, embedded as constants
    into the device program)."""

    __slots__ = ("acc", "follow", "first_anchored", "first_floating",
                 "accept_any", "accept_end", "always_match",
                 "empty_only_match", "n_states", "min_len",
                 "host_tables", "device_tables")

    def __init__(self):
        self.n_states = 0
        self.acc = np.zeros((256, 0), bool)
        self.follow = np.zeros((0, 0), bool)
        self.first_anchored = np.zeros(0, bool)
        self.first_floating = np.zeros(0, bool)
        self.accept_any = np.zeros(0, bool)
        self.accept_end = np.zeros(0, bool)
        self.always_match = False     # matches every (non-null) string
        self.empty_only_match = False  # ^$-style: matches len==0 rows
        self.min_len = 1  # minimal match width in bytes (replace sizing)
        # K6's route and tables (program_tables), built at the first
        # launch, and on each device, copied at the first launch there
        self.host_tables = None
        self.device_tables = {}


def _split_alternation(p: str) -> List[str]:
    out, cur, i = [], [], 0
    depth = 0
    while i < len(p):
        c = p[i]
        if c == "\\":
            cur.append(p[i:i + 2])
            i += 2
            continue
        if c == "[":
            j = i + 1
            if j < len(p) and p[j] == "^":
                j += 1
            if j < len(p) and p[j] == "]":
                j += 1
            while j < len(p) and p[j] != "]":
                j += 2 if p[j] == "\\" else 1
            cur.append(p[i:j + 1])
            i = j + 1
            continue
        if c == "|" and depth == 0:
            out.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(c)
        i += 1
    out.append("".join(cur))
    return out


class _Fragment:
    """One atom's position-automaton fragment. ASCII-only atoms are a
    single position; atoms that can match non-ASCII characters expand
    into a UTF-8 character automaton (one position per byte of each
    encoding length), so device matching is per CHARACTER, not per byte
    (ADVICE r4 medium)."""

    __slots__ = ("masks", "first", "last", "follow")

    def __init__(self, masks, first, last, follow):
        self.masks = masks      # List[np.ndarray(256, bool)] per position
        self.first = first      # local position indices legal at start
        self.last = last        # local position indices completing it
        self.follow = follow    # local (i, j) internal byte transitions


_CONT = np.zeros(256, bool)
_CONT[0x80:0xC0] = True
_LEAD2 = np.zeros(256, bool)
_LEAD2[0xC2:0xE0] = True
_LEAD3 = np.zeros(256, bool)
_LEAD3[0xE0:0xF0] = True
_LEAD4 = np.zeros(256, bool)
_LEAD4[0xF0:0xF5] = True


def _atom_fragment(m: np.ndarray) -> _Fragment:
    """Class mask -> fragment. A mask with any char >= 0x80 means the
    atom matches non-ASCII CHARACTERS (an ASCII pattern can only say
    "all of them" — via `.`, negation, \\D \\W \\S or [\\s\\S]), so the
    multi-byte branches join the automaton."""
    if not m[128:].any():
        return _Fragment([m], [0], [0], [])
    ascii_m = m.copy()
    ascii_m[128:] = False
    masks, first, last, follow = [], [], [], []
    if ascii_m.any():
        masks.append(ascii_m)
        first.append(0)
        last.append(0)
    b = len(masks)
    masks += [_LEAD2, _CONT]                    # 2-byte sequence
    first.append(b)
    last.append(b + 1)
    follow.append((b, b + 1))
    b = len(masks)
    masks += [_LEAD3, _CONT, _CONT]             # 3-byte sequence
    first.append(b)
    last.append(b + 2)
    follow += [(b, b + 1), (b + 1, b + 2)]
    b = len(masks)
    masks += [_LEAD4, _CONT, _CONT, _CONT]      # 4-byte sequence
    first.append(b)
    last.append(b + 3)
    follow += [(b, b + 1), (b + 1, b + 2), (b + 2, b + 3)]
    return _Fragment(masks, first, last, follow)


def compile_pattern(pattern: str,
                    literal_bytes: bool = False) -> RegexProgram:
    """Compile, or raise RegexUnsupported. A non-ASCII pattern is refused
    (the reference's dialect), unless ``literal_bytes``: then a non-ASCII
    literal character matches its UTF-8 byte sequence
    (``_parse_branch``), which the literal shapes of LIKE and
    ``startswith``/``endswith``/``contains`` need, as the reference's
    literal kernels take any bytes."""
    if not literal_bytes and any(ord(c) > 127 for c in pattern):
        raise RegexUnsupported("non-ASCII pattern")
    prog = RegexProgram()
    branches = [_parse_branch(b, literal_bytes)
                for b in _split_alternation(pattern)]
    frag_branches = []
    n = 0
    for a_start, a_end, atoms in branches:
        frags = [(_Fragment([m], [0], [0], []), "1") if q == "b"
                 else (_atom_fragment(m), q) for m, q in atoms]
        n += sum(len(f.masks) for f, _ in frags)
        frag_branches.append((a_start, a_end, frags))
    if n > _MAX_STATES:
        raise RegexUnsupported(f"{n} positions > {_MAX_STATES}")
    prog.n_states = n
    prog.acc = np.zeros((256, n), bool)
    prog.follow = np.zeros((n, n), bool)
    prog.first_anchored = np.zeros(n, bool)
    prog.first_floating = np.zeros(n, bool)
    prog.accept_any = np.zeros(n, bool)
    prog.accept_end = np.zeros(n, bool)

    base = 0
    branch_min = []
    for a_start, a_end, frags in frag_branches:
        branch_min.append(sum(1 for _, q in frags if q not in "*?"))
        k = len(frags)
        nullable = [q in "*?" for _, q in frags]
        if k == 0 or all(nullable):
            # empty-matchable branch: unanchored/half-anchored search
            # always finds the empty match; fully anchored matches only
            # empty strings
            if a_start and a_end:
                prog.empty_only_match = True
            else:
                prog.always_match = True
        # global position index of each fragment's start
        starts = []
        b = base
        for f, _ in frags:
            starts.append(b)
            b += len(f.masks)
        for i, (f, q) in enumerate(frags):
            s0 = starts[i]
            for p, m in enumerate(f.masks):
                prog.acc[:, s0 + p] = m
            for (p, r) in f.follow:
                prog.follow[s0 + p, s0 + r] = True
            # firsts: everything before i nullable
            if all(nullable[:i]):
                tgt = prog.first_anchored if a_start \
                    else prog.first_floating
                for p in f.first:
                    tgt[s0 + p] = True
            # lasts: everything after i nullable
            if all(nullable[i + 1:]):
                tgt = prog.accept_end if a_end else prog.accept_any
                for p in f.last:
                    tgt[s0 + p] = True
            # repetition: * and + loop last -> first
            if q in "*+":
                for p in f.last:
                    for r in f.first:
                        prog.follow[s0 + p, s0 + r] = True
            # cross-fragment follow: j > i with the gap nullable
            for j in range(i + 1, k):
                if all(nullable[i + 1:j]):
                    fj = frags[j][0]
                    for p in f.last:
                        for r in fj.first:
                            prog.follow[s0 + p, starts[j] + r] = True
                if not nullable[j]:
                    break
        base = b
    prog.min_len = max(1, min(branch_min) if branch_min else 1)
    return prog


def literal_regex(text: str) -> str:
    """A literal string in the device dialect (compile it with
    ``literal_bytes=True`` when it holds non-ASCII characters)."""
    specials = ".^$*+?()[]{}|\\/"
    return "".join("\\" + c if c in specials else c for c in text)


def like_to_regex(pattern: str, escape: str = "\\",
                  literal_bytes: bool = False) -> str:
    """SQL LIKE -> the device regex dialect, fully anchored. LIKE
    wildcards match ANY character including newlines (unlike regex `.`,
    which follows Java's no-DOTALL default), so % and _ translate to
    the all-bytes class [\\s\\S], not dot. Raises RegexUnsupported for
    non-ASCII, as the reference does, unless ``literal_bytes``: then a
    non-ASCII character stays a literal, for
    ``compile_pattern(..., literal_bytes=True)``."""
    out = ["^"]
    i = 0
    specials = ".^$*+?()[]{}|\\/"
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            out.append("\\" + nxt if nxt in specials else nxt)
            i += 2
            continue
        if c == "%":
            out.append("[\\s\\S]*")
        elif c == "_":
            out.append("[\\s\\S]")
        elif c in specials:
            out.append("\\" + c)
        else:
            if ord(c) > 127 and not literal_bytes:
                raise RegexUnsupported("non-ASCII LIKE pattern")
            out.append(c)
        i += 1
    out.append("$")
    return "".join(out)



#: the longest literal ``compile_literal`` takes past ``MAX_STATES``
LITERAL_MAX_BYTES = 1024


def compile_literal(text: str, kind: str) -> RegexProgram:
    """``startswith`` (``kind`` "prefix"), ``endswith`` ("suffix") or
    ``contains`` of ``text``: its UTF-8 bytes, any of them, as the
    reference's literal kernels take them. Within ``MAX_STATES`` bytes
    the literal compiles as a pattern. A longer one, up to
    ``LITERAL_MAX_BYTES``, has no position automaton (``n_states`` is
    its byte count): its one table is the DFA that ``_literal_dfa``
    builds straight from the bytes, so it runs on route A only (route
    B's sets are one ``uint64``). Raises RegexUnsupported past that, or
    where the DFA passes ``DFA_MAX_ENTRIES``."""
    lit = literal_regex(text)
    pattern = {"prefix": "^" + lit, "suffix": lit + "$",
               "contains": lit}[kind]
    raw = text.encode()
    if len(raw) <= _MAX_STATES:
        return compile_pattern(pattern, literal_bytes=True)
    if len(raw) > LITERAL_MAX_BYTES:
        raise RegexUnsupported(f"a literal of {len(raw)} bytes > "
                               f"{LITERAL_MAX_BYTES}")
    dfa = _literal_dfa(raw, kind)
    if dfa is None:
        raise RegexUnsupported(f"the DFA of a {len(raw)}-byte literal "
                               f"passes DFA_MAX_ENTRIES ({DFA_MAX_ENTRIES})")
    prog = RegexProgram()
    prog.n_states = len(raw)
    prog.host_tables = ("dfa", dfa)
    return prog


MAX_STATES = _MAX_STATES


# --- K6: the matcher -------------------------------------------------------

def _bits(masks: np.ndarray) -> np.ndarray:
    """Bool rows over positions as uint64 bit sets (bit s for position
    s)."""
    weights = np.uint64(1) << np.arange(masks.shape[-1], dtype=np.uint64)
    return (masks.astype(np.uint64) * weights).sum(axis=-1,
                                                   dtype=np.uint64)


# Route A's cap: the states times the classes of a DFA, 2 B an entry, so
# its table is at most 64 KB of shared memory (with the 256-byte class
# map): three blocks an SM fit in an H100's 228 KB. A state id has 14
# bits, the entry's top two bits are the accept flags.
DFA_MAX_ENTRIES = 1 << 15
_DFA_MAX_STATES = 1 << 14
_DFA_ANY = 1 << 14   # the byte fired an accept_any position: matched
_DFA_END = 1 << 15   # it fired an accept_end position: matched if last


class Dfa:
    """A program's deterministic automaton (``build_dfa``): ``classes``
    (256 uint8, a byte's class), ``trans`` (``n_states x n_classes``
    uint16: the next state in the low 14 bits, ``_DFA_ANY`` and
    ``_DFA_END`` above), the start state 0, and ``dead`` (the empty
    active set's state, or -1)."""

    __slots__ = ("classes", "trans", "n_states", "n_classes", "dead")

    def __init__(self, classes, trans, dead):
        self.classes, self.trans, self.dead = classes, trans, dead
        self.n_states, self.n_classes = trans.shape


def follow_byte_tables(prog: RegexProgram) -> np.ndarray:
    """``(ceil(S / 8), 256)`` uint64: ``T[k][b]`` is the OR of
    ``follow[8k + i]`` over the set bits ``i`` of ``b``, so the positions
    that may follow a fired set ``f`` are the OR over ``k`` of
    ``T[k][(f >> 8k) & 255]`` (``build_dfa`` steps every class of a state
    at once with them)."""
    fb = np.zeros(_MAX_STATES, np.uint64)
    fb[:prog.n_states] = _bits(prog.follow)
    tabs = np.zeros((max(1, -(-prog.n_states // 8)), 256), np.uint64)
    b = np.arange(256)
    for k in range(tabs.shape[0]):
        for i in range(8):
            tabs[k, (b >> i) & 1 == 1] |= fb[8 * k + i]
    return tabs


def follow_t_byte_tables(prog: RegexProgram) -> np.ndarray:
    """``follow_byte_tables`` of the transposed relation: ``T[k][b]`` is
    the OR over the set bits ``i`` of ``b`` of the positions ``p`` whose
    follow set holds ``8k + i``, so the positions that can step into a
    set ``r`` are the OR over ``k`` of ``T[k][(r >> 8k) & 255]`` (K8's
    backward walk)."""
    t = RegexProgram()
    t.n_states, t.follow = prog.n_states, prog.follow.T
    return follow_byte_tables(t)


def _follow_of(tabs: np.ndarray, fired: np.ndarray) -> np.ndarray:
    out = np.zeros_like(fired)
    for k in range(tabs.shape[0]):
        out |= tabs[k][((fired >> np.uint64(8 * k))
                        & np.uint64(255)).astype(np.intp)]
    return out


def build_dfa(prog: RegexProgram,
              max_entries: int = DFA_MAX_ENTRIES) -> Optional[Dfa]:
    """The subset construction over ``prog``'s position automaton, or
    None when its states times its classes pass ``max_entries``. The
    classes are the distinct ``acc`` rows (bytes that fire the same
    positions); state 0 is ``first_anchored | first_floating``; from
    active set ``a`` class ``c`` fires ``a & acc[c]`` and moves to the
    follow set of that OR ``first_floating``. An entry whose fired set
    meets ``accept_any`` ends the row matched, so its successor is not
    explored (its entry holds state 0). The row stops where the state is
    ``dead``: no position can fire again."""
    reps, classes = np.unique(_bits(prog.acc), return_inverse=True)
    n_cls = len(reps)
    tabs = follow_byte_tables(prog)
    first_f = np.uint64(_bits(prog.first_floating))
    any_mask = np.uint64(_bits(prog.accept_any))
    end_mask = np.uint64(_bits(prog.accept_end))
    start = int(np.uint64(_bits(prog.first_anchored)) | first_f)
    ids = {start: 0}
    order = [start]
    rows = []
    limit = min(_DFA_MAX_STATES, max_entries // n_cls)
    while len(rows) < len(order):
        fired = np.uint64(order[len(rows)]) & reps
        nxt = _follow_of(tabs, fired) | first_f
        flags = np.where((fired & any_mask) != 0, _DFA_ANY, 0) \
            | np.where((fired & end_mask) != 0, _DFA_END, 0)
        row = np.zeros(n_cls, np.uint16)
        for c in range(n_cls):
            if flags[c] & _DFA_ANY:
                row[c] = _DFA_ANY
                continue
            t = ids.setdefault(int(nxt[c]), len(order))
            if t == len(order):
                if t >= limit:
                    return None
                order.append(int(nxt[c]))
            row[c] = t | flags[c]
        rows.append(row)
    return Dfa(classes.astype(np.uint8), np.stack(rows), ids.get(0, -1))


def _literal_dfa(raw: bytes, kind: str,
                 max_entries: int = DFA_MAX_ENTRIES) -> Optional[Dfa]:
    """The DFA of a literal, as ``build_dfa`` encodes one, or None when
    it passes ``max_entries``: a class for each distinct byte of the
    literal and one for every other byte; state i has matched the
    literal's first i bytes. A prefix moves to i + 1 on byte i and to
    the dead state ``L`` on any other; a suffix or a contains follows
    the Knuth-Morris-Pratt automaton (the subset construction of a
    literal's position automaton is that automaton). A contains ends
    the row matched where it reaches ``L`` (any-accept); a suffix
    flags the entry (end-accept) and stays in state ``L``, whose row is
    that of the literal's longest proper border."""
    size = len(raw)
    distinct = sorted(set(raw))
    n_cls = len(distinct) + 1
    n_states = size if kind == "contains" else size + 1
    if n_states * n_cls > max_entries or n_states > _DFA_MAX_STATES \
            or n_cls > 256:
        return None
    classes = np.zeros(256, np.uint8)
    classes[distinct] = np.arange(1, n_cls)
    lit = classes[list(raw)].astype(np.intp)
    if kind == "prefix":
        trans = np.full((size + 1, n_cls), size, np.int64)
        trans[np.arange(size), lit] = np.arange(1, size + 1)
        trans[size - 1, lit[size - 1]] = _DFA_ANY
        return Dfa(classes, trans.astype(np.uint16), size)
    trans = np.zeros((size + 1, n_cls), np.int64)
    trans[0, lit[0]] = 1
    border = 0
    for i in range(1, size + 1):
        trans[i] = trans[border]
        if i < size:
            trans[i, lit[i]] = i + 1
            border = trans[border, lit[i]]
    full = trans == size
    trans[full] = _DFA_ANY if kind == "contains" else size | _DFA_END
    return Dfa(classes, trans[:n_states].astype(np.uint16), -1)


def position_tables(prog: RegexProgram) -> np.ndarray:
    """Route B's tables, one uint64 array: ``acc[0:256]`` (the positions
    byte c may fire) and ``follow[256:320]`` (the positions that may read
    the byte after position s)."""
    if prog.n_states > _MAX_STATES:
        raise ValueError(f"a program of {prog.n_states} positions has no "
                         f"route B (at most {_MAX_STATES})")
    follow = np.zeros(_MAX_STATES, np.uint64)
    follow[:prog.n_states] = _bits(prog.follow)
    return np.concatenate([_bits(prog.acc), follow])


def program_tables(prog: RegexProgram):
    """``(route, tables)``: the program as K6 reads it, the route chosen
    by the size of its tables alone, built once and kept on the program.

    Route ``"dfa"`` (A), where ``build_dfa`` fits ``DFA_MAX_ENTRIES``:
    ``tables`` is the ``Dfa``; K6 stages its class map (256 B) and its
    transitions (``n_states x n_classes`` x 2 B, at most 64 KB) in shared
    memory, and a step is two shared lookups. Route ``"positions"`` (B),
    otherwise: ``tables`` is ``position_tables`` (2.5 KB), and a step is
    one ``acc`` lookup and one ``follow`` lookup a fired position; the
    start, accept and flag masks go by value. On an H100 neither route
    nears the bound of the bytes it reads: a step is a chain of
    dependent shared lookups, and a warp waits for its longest row
    (``csrc/regex_match.cu``; ``PERF.md`` section 6)."""
    if prog.host_tables is None:
        dfa = build_dfa(prog)
        prog.host_tables = ("dfa", dfa) if dfa is not None \
            else ("positions", position_tables(prog))
    return prog.host_tables


def _dfa_loop(starts: torch.Tensor, lengths: torch.Tensor,
              validity: Optional[torch.Tensor], chars: torch.Tensor,
              prog: RegexProgram) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(matched, bytes read a row)`` of a program past ``MAX_STATES``
    positions (``compile_literal``'s long literals, whose only tables
    are their DFA): route A stepped in torch, a byte a row a step, as
    ``csrc/regex_match.cu`` steps it. State 0 first; a row is matched
    at an entry's any-accept bit, or at its end-accept bit on the row's
    last byte, and stops there or at the dead state."""
    dev = starts.device
    dfa = program_tables(prog)[1]
    n = starts.shape[0]
    lens = lengths.to(torch.int64)
    live = lens if validity is None else torch.where(
        validity, lens, torch.zeros_like(lens))
    ccap = max(chars.shape[0], 1)
    chars = chars if chars.shape[0] else torch.zeros(1, dtype=torch.uint8,
                                                     device=dev)
    trans = torch.from_numpy(dfa.trans.astype(np.int64)).to(dev)
    classes = torch.from_numpy(dfa.classes.astype(np.int64)).to(dev)
    matched = torch.full((n,), bool(prog.always_match), device=dev)
    if prog.empty_only_match:
        matched |= lens == 0
    state = torch.zeros(n, dtype=torch.int64, device=dev)
    going = ~matched & (state != dfa.dead)
    reads = torch.zeros(n, dtype=torch.int64, device=dev)
    s64 = starts.to(torch.int64)
    for j in range(int(live.max()) if n else 0):
        going &= j < live
        if not bool(going.any()):
            break
        reads += going
        e = trans[state, classes[chars[(s64 + j).clamp(0, ccap - 1)]
                                 .long()]]
        hit = going & (((e & _DFA_ANY) != 0)
                       | (((e & _DFA_END) != 0) & (j == live - 1)))
        matched |= hit
        going &= ~hit
        state = torch.where(going, e & (_DFA_ANY - 1), state)
        going &= state != dfa.dead
    return matched, reads


def _match_loop(starts: torch.Tensor, lengths: torch.Tensor,
                validity: Optional[torch.Tensor], chars: torch.Tensor,
                prog: RegexProgram) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(matched, bytes read a row)``: the reference's loop, counting
    the bytes a row reads before it stops (matched, or no position
    left); ``_dfa_loop`` for a program past ``MAX_STATES`` positions."""
    if prog.n_states > _MAX_STATES:
        return _dfa_loop(starts, lengths, validity, chars, prog)
    dev = starts.device
    n = starts.shape[0]
    lens = lengths.to(torch.int64)
    live_lens = lens if validity is None else torch.where(
        validity, lens, torch.zeros_like(lens))
    ccap = max(chars.shape[0], 1)
    chars = chars if chars.shape[0] else torch.zeros(1, dtype=torch.uint8,
                                                     device=dev)
    acc = torch.from_numpy(prog.acc).to(dev)
    follow = torch.from_numpy(prog.follow.astype(np.float32)).to(dev)
    first_f = torch.from_numpy(prog.first_floating).to(dev)
    accept_any = torch.from_numpy(prog.accept_any).to(dev)
    accept_end = torch.from_numpy(prog.accept_end).to(dev)
    matched = torch.full((n,), bool(prog.always_match), device=dev)
    if prog.empty_only_match:
        matched |= lens == 0
    active = (torch.from_numpy(prog.first_anchored).to(dev)
              | first_f).expand(n, prog.n_states)
    reads = torch.zeros(n, dtype=torch.int64, device=dev)
    s64 = starts.to(torch.int64)
    longest = int(live_lens.max()) if n else 0
    for j in range(longest):
        if not (bool(active.any()) and bool((~matched).any())):
            break
        c = chars[(s64 + j).clamp(0, ccap - 1)].long()
        in_row = j < live_lens
        reads += in_row & ~matched & active.any(dim=1)
        fired = active & acc[c] & in_row[:, None]
        matched = matched | (fired & accept_any).any(dim=1)
        matched = matched | ((fired & accept_end).any(dim=1)
                             & (j == live_lens - 1))
        active = ((fired.to(torch.float32) @ follow) > 0) | first_f
    return matched, reads


def regex_match_torch(starts: torch.Tensor, lengths: torch.Tensor,
                      validity: Optional[torch.Tensor],
                      chars: torch.Tensor,
                      prog: RegexProgram) -> torch.Tensor:
    """The reference's matcher in torch: ``(n,)`` bool, does ``prog``
    match each row's bytes (search semantics). Row i is
    ``chars[starts[i] : starts[i] + lengths[i]]``; a null row steps as
    an empty one. One readback (the longest live string) fixes the
    byte positions; each step gathers a byte a row, fires the positions
    its class allows, tests the accepts, and moves along the follow
    relation by one ``(n, S) @ (S, S)`` product. A long literal of
    ``compile_literal`` steps its DFA instead (``_dfa_loop``)."""
    return _match_loop(starts, lengths, validity, chars, prog)[0]


def regex_bytes_read(starts: torch.Tensor, lengths: torch.Tensor,
                     validity: Optional[torch.Tensor], chars: torch.Tensor,
                     prog: RegexProgram) -> int:
    """The bytes of ``chars`` the matcher must read for these rows: each
    row up to where it stops (the kernel's bound counts these)."""
    return int(_match_loop(starts, lengths, validity, chars, prog)[1].sum())


class _RegexArgs(ctypes.Structure):
    """Mirror of ``RegexArgs`` in the CUDA source."""
    _fields_ = [("tables", ctypes.c_void_p),
                ("starts", ctypes.c_void_p),
                ("lengths", ctypes.c_void_p),
                ("validity", ctypes.c_void_p),
                ("chars", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("n", ctypes.c_int64),
                ("n_chars", ctypes.c_int64),
                ("table_bytes", ctypes.c_int64),
                ("first_anchored", ctypes.c_uint64),
                ("first_floating", ctypes.c_uint64),
                ("accept_any", ctypes.c_uint64),
                ("accept_end", ctypes.c_uint64),
                ("route", ctypes.c_int32),
                ("n_classes", ctypes.c_int32),
                ("dead", ctypes.c_int32),
                ("flags", ctypes.c_int32)]


def _library():
    from ._build import load
    lib = load("regex_match")
    if not getattr(lib, "_spark_ready", False):
        lib.spark_regex_args_size.argtypes = []
        lib.spark_regex_args_size.restype = ctypes.c_int
        lib.spark_regex_launch.argtypes = [ctypes.c_void_p,
                                           ctypes.c_void_p]
        lib.spark_regex_launch.restype = ctypes.c_int
        if lib.spark_regex_args_size() != ctypes.sizeof(_RegexArgs):
            raise RuntimeError(
                f"RegexArgs is {lib.spark_regex_args_size()} bytes in the "
                f"CUDA source but {ctypes.sizeof(_RegexArgs)} in ctypes")
        lib._spark_ready = True
    return lib


def _check_inputs(starts, lengths, validity, chars) -> None:
    n = starts.shape[0]
    for t, want in ((starts, torch.int32), (lengths, torch.int32),
                    (validity, torch.bool), (chars, torch.uint8)):
        if t is None:
            continue
        if t.dtype != want or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"K6 takes contiguous 1-D {want} here, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t is not chars and t.shape[0] != n:
            raise ValueError(f"K6's row inputs must hold {n} rows, one "
                             f"holds {t.shape[0]}")
        if t.device != starts.device:
            raise ValueError("K6's inputs must be on one device")


def _table_bytes(route: str, tables) -> np.ndarray:
    """A route's tables as the bytes K6 stages, padded to 16."""
    if route == "dfa":
        raw = np.concatenate([tables.classes, tables.trans.ravel().view(
            np.uint8)])
    else:
        raw = tables.view(np.uint8)
    return np.concatenate([raw, np.zeros(-len(raw) % 16, np.uint8)])


def _device_tables(prog: RegexProgram, route: str,
                   device: torch.device) -> torch.Tensor:
    """The route's tables on ``device``, copied at their first launch
    there and kept on the program (no copy a launch)."""
    got = prog.device_tables.get((route, device))
    if got is None:
        chosen, tables = program_tables(prog)
        if route != chosen:
            if route == "dfa":
                raise ValueError("this program's DFA passes "
                                 f"DFA_MAX_ENTRIES ({DFA_MAX_ENTRIES})")
            tables = position_tables(prog)
        got = torch.from_numpy(_table_bytes(route, tables)).to(device)
        prog.device_tables[(route, device)] = got
    return got


def regex_match(starts: torch.Tensor, lengths: torch.Tensor,
                validity: Optional[torch.Tensor], chars: torch.Tensor,
                prog: RegexProgram, route: Optional[str] = None) \
        -> torch.Tensor:
    """K6: ``(n,)`` bool, does ``prog`` match each row's bytes (search
    semantics; rows as ``regex_match_torch`` reads them). A CPU input
    takes the plain version; a CUDA input launches the kernel once, on
    the program's route (``program_tables``), or on ``route`` ("dfa" or
    "positions") where a check names one."""
    from .cuda_kernels import _on_cpu
    if _on_cpu([starts, lengths, validity, chars]):
        return regex_match_torch(starts, lengths, validity, chars, prog)
    _check_inputs(starts, lengths, validity, chars)
    n = starts.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=starts.device)
    if n == 0:
        return out
    route = route or program_tables(prog)[0]
    if route not in ("dfa", "positions"):
        raise ValueError(f"K6 has no route {route!r}")
    tables = _device_tables(prog, route, starts.device)
    args = _RegexArgs()
    args.tables, args.table_bytes = tables.data_ptr(), tables.shape[0]
    args.starts, args.lengths = starts.data_ptr(), lengths.data_ptr()
    args.validity = None if validity is None else validity.data_ptr()
    args.chars = chars.data_ptr() if chars.shape[0] else None
    args.out = out.data_ptr()
    args.n, args.n_chars = n, chars.shape[0]
    args.flags = int(prog.always_match) | (int(prog.empty_only_match) << 1)
    if route == "dfa":
        dfa = program_tables(prog)[1]
        args.route, args.n_classes, args.dead = 0, dfa.n_classes, dfa.dead
    else:
        args.route = 1
        args.first_anchored, args.first_floating, args.accept_any, \
            args.accept_end = (int(_bits(m)) for m in (
                prog.first_anchored, prog.first_floating, prog.accept_any,
                prog.accept_end))
    stream = torch.cuda.current_stream(starts.device).cuda_stream
    err = _library().spark_regex_launch(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"regex_match kernel launch failed: cudaError "
                           f"{err}")
    regex_match.launches += 1
    return out


regex_match.launches = 0


# --- spans: regexp_replace and regexp_extract -------------------------------
# Leftmost-longest equals Java's leftmost-greedy for the dialect restricted
# to a single branch; alternation is leftmost-first in Java ('a|ab' on
# "ab" picks 'a'), so a pattern with branches runs on the CPU. A pattern
# that can match the empty string does too: Java finds an empty match at
# every position, and the spans are at least a byte wide.

def compile_replace_pattern(pattern: str):
    """``(program, None)`` where the spans are exact for ``pattern``, else
    ``(None, reason)``: one compilation, which the caller keeps."""
    try:
        prog = compile_pattern(pattern)
    except RegexUnsupported as e:
        return None, str(e)
    if len(_split_alternation(pattern)) > 1:
        return None, ("alternation is leftmost-first in Java but "
                      "leftmost-longest on device; runs on host")
    if prog.always_match or prog.empty_only_match:
        return None, "pattern can match the empty string; runs on host"
    return prog, None


def replace_program_supported(pattern: str) -> Optional[str]:
    """None where the spans are exact for ``pattern``, else the reason
    it runs on the CPU."""
    return compile_replace_pattern(pattern)[1]


def span_tables(prog: RegexProgram) -> np.ndarray:
    """K8's tables, one uint64 array: ``acc[0:256]``, then the follow
    byte tables and the transposed ones (``K = ceil(S / 8)`` tables of
    256 each)."""
    return np.concatenate([_bits(prog.acc),
                           follow_byte_tables(prog).ravel(),
                           follow_t_byte_tables(prog).ravel()])


def _span_masks(prog: RegexProgram):
    first = prog.first_anchored | prog.first_floating
    anchored = bool(prog.first_anchored.any()) \
        and not prog.first_floating.any()
    return first, anchored


def find_spans_torch(offsets: torch.Tensor, chars: torch.Tensor,
                     validity: Optional[torch.Tensor], prog: RegexProgram,
                     first_only: bool = False):
    """K8's function in plain PyTorch, the reference's two phases:
    ``(in_match, match_start, n_matches, first_s, first_e)``, two bool
    lanes over ``chars`` (the byte is inside a span, it starts one), each
    row's span count, and its first span row-relative (-1, -1 where none);
    with ``first_only`` a row stops after its first span. A null row has
    none."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - starts
    live = lens if validity is None else torch.where(
        validity, lens, torch.zeros_like(lens))
    ccap = max(chars.shape[0], 1)
    chars = chars if chars.shape[0] else torch.zeros(1, dtype=torch.uint8,
                                                     device=dev)
    first_np, anchored = _span_masks(prog)
    acc = torch.from_numpy(prog.acc).to(dev)
    follow = torch.from_numpy(prog.follow.astype(np.float32)).to(dev)
    follow_t = follow.t().contiguous()
    first = torch.from_numpy(first_np).to(dev)
    accept_any = torch.from_numpy(prog.accept_any).to(dev)
    accept_end = torch.from_numpy(prog.accept_end).to(dev)
    longest = int(live.max()) if n else 0
    # phase 1: R[j], the positions that, reading byte j, can begin a
    # suffix that reaches an accept; a match starts at j where R[j]
    # meets the first positions
    can_start = torch.zeros(ccap + 1, dtype=torch.bool, device=dev)
    r_next = torch.zeros(n, prog.n_states, dtype=torch.bool, device=dev)
    for j in range(longest - 1, -1, -1):
        pos = (starts + j).clamp(0, ccap - 1)
        in_row = j < live
        acc_here = accept_any[None, :] \
            | (accept_end[None, :] & (j == live - 1)[:, None])
        cont = (r_next.to(torch.float32) @ follow_t) > 0
        r = acc[chars[pos].long()] & in_row[:, None] & (acc_here | cont)
        hit = (r & first[None, :]).any(dim=1) & in_row
        if anchored:
            hit &= j == 0
        can_start[torch.where(hit, pos, ccap)] = True
        r_next = r
    can_start = can_start[:ccap]
    # phase 2: each row walks forward; at a start it runs the automaton
    # from the first positions, keeping the last accept, and commits the
    # span where the automaton dies or the row ends, then goes on from
    # the span's end (or one past a start that found none)
    j = torch.zeros(n, dtype=torch.int64, device=dev)
    matching = torch.zeros(n, dtype=torch.bool, device=dev)
    mstart = torch.zeros(n, dtype=torch.int64, device=dev)
    last_end = torch.full((n,), -1, dtype=torch.int64, device=dev)
    active = torch.zeros(n, prog.n_states, dtype=torch.bool, device=dev)
    n_matches = torch.zeros(n, dtype=torch.int32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    first_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    first_e = torch.full((n,), -1, dtype=torch.int32, device=dev)
    delta = torch.zeros(ccap + 1, dtype=torch.int32, device=dev)
    span_first = torch.zeros(ccap + 1, dtype=torch.bool, device=dev)
    while bool((j < live).any()):
        pos = (starts + j).clamp(0, ccap - 1)
        in_row = (j < live) & ~done
        start_here = can_start[pos] & in_row & ~matching
        active = torch.where(start_here[:, None], first[None, :], active)
        matching = matching | start_here
        mstart = torch.where(start_here, j, mstart)
        last_end = torch.where(start_here, -1, last_end)
        fired = active & acc[chars[pos].long()] & (matching & in_row)[:, None]
        at_last = j == live - 1
        accepts = fired & (accept_any[None, :]
                           | (accept_end[None, :] & at_last[:, None]))
        last_end = torch.where(matching & accepts.any(dim=1), j + 1,
                               last_end)
        nxt = (fired.to(torch.float32) @ follow) > 0
        alive = nxt.any(dim=1) & (j + 1 < live)
        commit = matching & in_row & ~alive
        have = commit & (last_end > mstart)
        delta.index_add_(0, torch.where(have, starts + mstart, ccap),
                         torch.ones(n, dtype=torch.int32, device=dev))
        delta.index_add_(0, torch.where(have, (starts + last_end).clamp(
            max=ccap), ccap), torch.full((n,), -1, dtype=torch.int32,
                                         device=dev))
        span_first[torch.where(have, starts + mstart, ccap)] = True
        is_first = have & (n_matches == 0)
        first_s = torch.where(is_first, mstart.to(torch.int32), first_s)
        first_e = torch.where(is_first, last_end.to(torch.int32), first_e)
        n_matches = n_matches + have.to(torch.int32)
        if first_only:
            done = done | have
        j = torch.where(in_row & commit,
                        torch.where(have, last_end, mstart + 1), j + 1)
        matching = matching & ~commit
        active = nxt
    # the spans are disjoint and inside their rows: +1 at a span's start
    # and -1 at its end, summed, is the in-span mask
    in_match = torch.cumsum(delta[:ccap], 0) > 0
    return (in_match, span_first[:ccap], n_matches, first_s, first_e)


class _SpanArgs(ctypes.Structure):
    """Mirror of ``SpanArgs`` in ``csrc/regex_spans.cu``."""
    _fields_ = [("tables", ctypes.c_void_p),
                ("offsets", ctypes.c_void_p),
                ("validity", ctypes.c_void_p),
                ("chars", ctypes.c_void_p),
                ("in_match", ctypes.c_void_p),
                ("match_start", ctypes.c_void_p),
                ("n_matches", ctypes.c_void_p),
                ("first_s", ctypes.c_void_p),
                ("first_e", ctypes.c_void_p),
                ("n", ctypes.c_int64),
                ("n_chars", ctypes.c_int64),
                ("first", ctypes.c_uint64),
                ("accept_any", ctypes.c_uint64),
                ("accept_end", ctypes.c_uint64),
                ("n_tables", ctypes.c_int32),
                ("anchored", ctypes.c_int32),
                ("first_only", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


def _span_library():
    from ._build import load
    lib = load("regex_spans")
    if not getattr(lib, "_spark_ready", False):
        lib.spark_spans_args_size.argtypes = []
        lib.spark_spans_args_size.restype = ctypes.c_int
        lib.spark_spans_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.spark_spans_launch.restype = ctypes.c_int
        if lib.spark_spans_args_size() != ctypes.sizeof(_SpanArgs):
            raise RuntimeError(
                f"SpanArgs is {lib.spark_spans_args_size()} bytes in the "
                f"CUDA source but {ctypes.sizeof(_SpanArgs)} in ctypes")
        lib._spark_ready = True
    return lib


def find_spans(offsets: torch.Tensor, chars: torch.Tensor,
               validity: Optional[torch.Tensor], prog: RegexProgram,
               first_only: bool = False):
    """K8: each row's non-overlapping leftmost-longest spans of ``prog``,
    as ``find_spans_torch`` returns them. A CPU input takes the plain
    version; a CUDA input launches the kernel once."""
    from .cuda_kernels import _on_cpu
    if _on_cpu([offsets, chars, validity]):
        return find_spans_torch(offsets, chars, validity, prog, first_only)
    if prog.n_states > _MAX_STATES:
        raise ValueError(f"K8 takes at most {_MAX_STATES} positions")
    for t, want in ((offsets, torch.int32), (chars, torch.uint8),
                    (validity, torch.bool)):
        if t is None:
            continue
        if t.dtype != want or t.dim() != 1 or t.device != offsets.device:
            raise ValueError(f"K8 takes 1-D {want} on one device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dev = offsets.device
    n = offsets.shape[0] - 1
    if validity is not None and validity.shape[0] != n:
        raise ValueError(f"K8's validity must hold {n} rows")
    offsets, chars = offsets.contiguous(), chars.contiguous()
    validity = None if validity is None else validity.contiguous()
    ccap = max(chars.shape[0], 1)
    in_match = torch.zeros(ccap, dtype=torch.bool, device=dev)
    match_start = torch.zeros(ccap, dtype=torch.bool, device=dev)
    n_matches = torch.zeros(n, dtype=torch.int32, device=dev)
    first_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    first_e = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return in_match, match_start, n_matches, first_s, first_e
    tables = prog.device_tables.get(("spans", dev))
    if tables is None:
        tables = torch.from_numpy(span_tables(prog).view(np.int64)).to(dev)
        prog.device_tables[("spans", dev)] = tables
    first, anchored = _span_masks(prog)
    args = _SpanArgs()
    args.tables = tables.data_ptr()
    args.offsets = offsets.data_ptr()
    args.validity = None if validity is None else validity.data_ptr()
    args.chars = chars.data_ptr() if chars.shape[0] else None
    args.in_match, args.match_start = in_match.data_ptr(), \
        match_start.data_ptr()
    args.n_matches, args.first_s, args.first_e = n_matches.data_ptr(), \
        first_s.data_ptr(), first_e.data_ptr()
    args.n, args.n_chars = n, chars.shape[0]
    args.first, args.accept_any, args.accept_end = (
        int(_bits(m)) for m in (first, prog.accept_any, prog.accept_end))
    args.n_tables = max(1, -(-prog.n_states // 8))
    args.anchored, args.first_only = int(anchored), int(first_only)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _span_library().spark_spans_launch(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"regex span kernel launch failed: cudaError "
                           f"{err}")
    find_spans.launches += 1
    return in_match, match_start, n_matches, first_s, first_e


find_spans.launches = 0


def replace_char_cap(col, prog: RegexProgram, repl_len: int) -> int:
    """The replaced column's chars capacity without a readback: the
    unmatched bytes plus ``repl_len`` a match, the matches at most the
    chars over the pattern's shortest match (the reference's
    ``:664``)."""
    from ..columnar.batch import bucket_bytes
    ccap = max(int(col.chars.shape[0]), 1)
    return bucket_bytes(ccap + (ccap // max(prog.min_len, 1)) * repl_len
                        + 16)


def _row_of_chars(offsets: torch.Tensor, size: int) -> torch.Tensor:
    """Each position's row under monotone ``offsets``, clamped to the
    rows."""
    n = offsets.shape[0] - 1
    i = torch.arange(size, dtype=offsets.dtype, device=offsets.device)
    return (torch.searchsorted(offsets, i, right=True) - 1).clamp(
        0, max(n - 1, 0))


def regex_replace(col, prog: RegexProgram, repl: bytes,
                  char_cap: Optional[int] = None):
    """``regexp_replace`` with a literal replacement: every span of each
    row replaced by ``repl`` (the reference's ``regex_replace_device``,
    ``:568``), a string column of ``char_cap`` bytes
    (``replace_char_cap`` by default)."""
    from ..columnar.column import GpuColumnVector
    if char_cap is None:
        char_cap = replace_char_cap(col, prog, len(repl))
    offs = col.offsets
    dev = offs.device
    n = offs.shape[0] - 1
    in_match, mstart, _, _, _ = find_spans(offs, col.chars, col.validity,
                                           prog)
    ccap = in_match.shape[0]
    chars = col.chars if col.chars.shape[0] else torch.zeros(
        1, dtype=torch.uint8, device=dev)
    lr = len(repl)
    i = torch.arange(ccap, dtype=torch.int64, device=dev)
    in_rows = (i >= offs[0].to(torch.int64)) & (i < offs[n].to(torch.int64)) \
        if n > 0 else torch.zeros(ccap, dtype=torch.bool, device=dev)
    contrib = torch.where(~in_match, 1, torch.where(mstart, lr, 0))
    contrib = torch.where(in_rows, contrib, 0)
    ends = torch.cumsum(contrib, 0)
    out_off = ends - contrib
    total = ends[-1:]
    # a row starting at the buffer's end (every byte before it taken)
    # begins at the total, not at the clamped last position's offset
    row_starts = offs[:-1].to(torch.int64)
    row_out = torch.where(row_starts >= ccap, total,
                          out_off[row_starts.clamp(0, ccap - 1)])
    new_offsets = torch.cat([row_out, total]).to(torch.int32)
    out = torch.zeros(char_cap + 1, dtype=torch.uint8, device=dev)
    keep = ~in_match & in_rows
    out[torch.where(keep, out_off, char_cap)] = chars[:ccap]
    if lr:
        at = torch.where(mstart & in_rows, out_off, char_cap)
        for k, b in enumerate(repl):
            out[torch.where(at < char_cap, at + k, char_cap)] = b
    return GpuColumnVector(col.dtype, None, col.validity, new_offsets,
                           out[:char_cap])


def regex_extract(col, prog: RegexProgram):
    """``regexp_extract`` of the whole match: each row's first span, ''
    where there is none, the column's validity kept (the reference's
    ``regex_extract_device``, ``:672``)."""
    from ..columnar.column import GpuColumnVector
    offs = col.offsets
    dev = offs.device
    n = offs.shape[0] - 1
    _, _, _, first_s, first_e = find_spans(offs, col.chars, col.validity,
                                           prog, first_only=True)
    ccap = max(col.chars.shape[0], 1)
    chars = col.chars if col.chars.shape[0] else torch.zeros(
        1, dtype=torch.uint8, device=dev)
    out_len = torch.where(first_e > first_s, first_e - first_s, 0)
    new_offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.cumsum(out_len.to(torch.int64), 0)])
    row = _row_of_chars(new_offsets, ccap)
    i = torch.arange(ccap, dtype=torch.int64, device=dev)
    src = offs[:-1].to(torch.int64)[row] + first_s.to(torch.int64)[row] \
        + (i - new_offsets[:-1][row]) if n > 0 else i
    live = i < new_offsets[-1]
    out = torch.where(live, chars[src.clamp(0, ccap - 1)],
                      torch.zeros((), dtype=torch.uint8, device=dev))
    return GpuColumnVector(col.dtype, None, col.validity,
                           new_offsets.to(torch.int32), out)

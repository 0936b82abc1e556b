"""The port's string functions (``spark_rapids_tpu_torch/expr/strings.py``,
``ops/strings.py``) against the JAX package's on the CPU.

Inputs are seeded: empty strings, spaces at either end, tabs, ASCII,
2- to 4-byte UTF-8 characters, strings past 64 bytes, 15% null.
Tolerance: every result is exact (strings, integers, booleans, nulls).

- ``Length`` (characters), ``Upper``/``Lower`` (ASCII on the device,
  every character on the CPU path), ``ConcatStrings``, the trims and
  ``StartsWith``/``EndsWith``/``Contains`` (K6's plain version here:
  the position automaton up to 64 bytes, the literal's DFA past it,
  itself held to the position automaton on short literals) against
  the reference's ``eval_tpu``; past ``LITERAL_MAX_BYTES`` the CPU;
- ``Substring``: the device path cuts bytes, as the reference's
  ``eval_tpu``; the CPU path cuts characters, as its ``eval_cpu``. Where
  the reference departs from Spark (a negative start before the string
  clamps to 0 there; Spark lets it eat into the length) both paths are
  held to Spark's rule, in Python;
- ``StringReplace``, ``StringLocate``, the pads, ``StringRepeat`` and
  ``Reverse`` refuse the device, as the reference's do, and their CPU
  path equals the reference's ``eval_cpu`` (a negative pad length gives
  the empty string, as in Spark; the reference slices from the end);
- a LIKE of the literal shapes with a non-ASCII literal compiles for K6
  (the device), a general non-ASCII LIKE and a non-ASCII RLIKE do not,
  as in the reference, and all equal the reference.
"""
import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.expr.strings as js
import spark_rapids_tpu_torch.expr.strings as ts
from spark_rapids_tpu.expr.base import Literal as JLit
from spark_rapids_tpu_torch.expr.base import Literal as TLit
from torch_function_cases import batch, eval_both, port_only, same, strings

N = 400


@pytest.fixture(scope="module")
def rb():
    rng = np.random.default_rng(7)
    return batch({"s": (pa.string(), strings(N, rng)),
                  "t": (pa.string(), strings(N, rng)),
                  "p": (pa.int32(), rng.integers(-8, 9, N).astype(np.int32)),
                  "n": (pa.int32(), rng.integers(-2, 12, N)
                        .astype(np.int32))}, seed=7)


SIMPLE = ["Length", "Upper", "Lower", "StringTrim", "StringTrimLeft",
          "StringTrimRight"]


@pytest.mark.parametrize("name", SIMPLE)
def test_device_string_functions_equal_the_reference(rb, name):
    got, want = eval_both(rb, lambda c: getattr(ts, name)(c("s")),
                          lambda c: getattr(js, name)(c("s")))
    same(got, want)


@pytest.mark.parametrize("name", SIMPLE)
def test_cpu_string_functions_equal_the_reference(rb, name):
    got, want = eval_both(rb, lambda c: getattr(ts, name)(c("s")),
                          lambda c: getattr(js, name)(c("s")), host=True)
    same(got, want)


def test_concat_equals_the_reference(rb):
    got, want = eval_both(
        rb, lambda c: ts.ConcatStrings(c("s"), TLit("-é-"), c("t")),
        lambda c: js.ConcatStrings(c("s"), JLit("-é-"), c("t")))
    same(got, want)


def _spark_substr(s, pos, length, unit):
    """Spark's substringSQL over ``unit`` (characters, or UTF-8
    bytes)."""
    if s is None or pos is None or length is None:
        return None
    seq = s if unit == "chars" else s.encode()
    n = len(seq)
    start = pos - 1 if pos > 0 else (n + pos if pos < 0 else 0)
    end = min(start + max(length, 0), n)
    start = max(start, 0)
    out = seq[start:end] if end > start else seq[:0]
    return out if unit == "chars" else out.decode("utf-8", "replace")


@pytest.mark.parametrize("host", [False, True], ids=["device", "cpu"])
def test_substring_on_each_path(rb, host):
    got, want = eval_both(rb, lambda c: ts.Substring(c("s"), c("p"),
                                                     c("n")),
                          lambda c: js.Substring(c("s"), c("p"), c("n")),
                          host=host)
    unit = "chars" if host else "bytes"
    spark = [_spark_substr(s, p, n, unit) for s, p, n in zip(
        rb.column("s").to_pylist(), rb.column("p").to_pylist(),
        rb.column("n").to_pylist())]
    if not host:
        # a byte cut inside a character: the bytes, whatever they decode
        # to; compare the raw bytes through the Arrow binary view
        got_b = got.cast(pa.binary()).to_pylist()
        spark_b = []
        for s, p, n in zip(rb.column("s").to_pylist(),
                           rb.column("p").to_pylist(),
                           rb.column("n").to_pylist()):
            if s is None or p is None or n is None:
                spark_b.append(None)
                continue
            b = s.encode()
            start = p - 1 if p > 0 else (len(b) + p if p < 0 else 0)
            end = min(start + max(n, 0), len(b))
            start = max(start, 0)
            spark_b.append(b[start:end] if end > start else b"")
        assert got_b == spark_b
        # the reference agrees where its start clamp is Spark's rule
        same_rule = [s is None or p is None or p >= 0 or len(s.encode()) + p
                     >= 0 for s, p in zip(rb.column("s").to_pylist(),
                                          rb.column("p").to_pylist())]
        assert [g for g, k in zip(got_b, same_rule) if k] == \
            [w for w, k in zip(want.cast(pa.binary()).to_pylist(),
                               same_rule) if k]
        return
    same(got, spark)
    same_rule = [s is None or p is None or p >= 0 or len(s) + p >= 0
                 for s, p in zip(rb.column("s").to_pylist(),
                                 rb.column("p").to_pylist())]
    same(got, want, where=same_rule)


def test_substring_corners():
    rb = pa.record_batch({"s": pa.array(["abc", "héllo", ""])})
    for pos, length, want in ((0, 2, ["ab", "hé", ""]),
                              (1, 2, ["ab", "hé", ""]),
                              (-5, 3, ["a", "hél", ""]),
                              (-2, 10, ["bc", "lo", ""]),
                              (2, -1, ["", "", ""])):
        got = port_only(rb, lambda c: ts.Substring(
            c("s"), TLit(pos), TLit(length)), host=True)
        assert got.to_pylist() == want, (pos, length, got)
    assert ts.Substring(TLit("a"), TLit(1), TLit(1)).incompat == \
        js.Substring(JLit("a"), JLit(1), JLit(1)).incompat


LITERALS = ["", "o", "Bo", "ics", "é", "ne r", "日本", "ab" * 40 + "é",
            "x" * 70, "a.b", "(", "%", "a\\", "\\$", "$"]


@pytest.mark.parametrize("name", ["StartsWith", "EndsWith", "Contains"])
def test_literal_matches_equal_the_reference(rb, name):
    for lit in LITERALS:
        got, want = eval_both(rb, lambda c: getattr(ts, name)(c("s"), lit),
                              lambda c: getattr(js, name)(c("s"), lit))
        same(got, want)
        # K6 takes every literal: past 64 positions on its DFA route
        prog = getattr(ts, name)(TLit("x"), lit).program()
        assert prog.n_states == len(lit.encode()), lit


HOST = [("StringReplace", ("o", "0"), ("o", "0")),
        ("StringReplace", ("", "z"), ("", "z")),
        ("StringLpad", (8, "*"), (8, "*")),
        ("StringRpad", (3, "#é"), (3, "#é")),
        ("StringLpad", (12, ""), (12, "")),
        ("StringRepeat", (3,), (3,)),
        ("StringRepeat", (-1,), (-1,)),
        ("Reverse", (), ())]


@pytest.mark.parametrize("name,targs,jargs", HOST,
                         ids=[f"{h[0]}{h[1]}" for h in HOST])
def test_host_string_functions_equal_the_reference(rb, name, targs, jargs):
    got, want = eval_both(rb, lambda c: getattr(ts, name)(c("s"), *targs),
                          lambda c: getattr(js, name)(c("s"), *jargs),
                          host=True)
    same(got, want)
    assert getattr(ts, name)(TLit("a"), *targs).gpu_supported() == \
        getattr(js, name)(JLit("a"), *jargs).tpu_supported()
    with pytest.raises(NotImplementedError, match="where the planner"):
        port_only(rb, lambda c: getattr(ts, name)(c("s"), *targs))


@pytest.mark.parametrize("pos", [1, 2, 0, -1, 5])
def test_locate_equals_the_reference(rb, pos):
    got, want = eval_both(rb, lambda c: ts.StringLocate("o", c("s"), pos),
                          lambda c: js.StringLocate("o", c("s"), pos),
                          host=True)
    same(got, want)


def test_negative_pad_length_is_empty_as_in_spark():
    rb = pa.record_batch({"s": pa.array(["abc", None])})
    got = port_only(rb, lambda c: ts.StringLpad(c("s"), -1, "*"), host=True)
    assert got.to_pylist() == ["", None]


@pytest.mark.parametrize("pattern,device", [
    ("%é", True), ("é%", True), ("%é%", True), ("é%s", True),
    ("%é_%", False), ("_é", False)])
def test_non_ascii_like_placement_and_results(rb, pattern, device):
    like = ts.Like(TLit("x"), pattern)
    assert (like.gpu_supported() is None) == device
    jlike = js.Like(JLit("x"), pattern)
    assert (jlike.tpu_supported() is None) == device
    if device:
        got, want = eval_both(rb, lambda c: ts.Like(c("s"), pattern),
                              lambda c: js.Like(c("s"), pattern))
        same(got, want)
    got, want = eval_both(rb, lambda c: ts.Like(c("s"), pattern),
                          lambda c: js.Like(c("s"), pattern), host=True)
    same(got, want)
    # a non-ASCII RLIKE stays off the device, as in the reference
    assert ts.RegExpLike(TLit("x"), "é").gpu_supported() is not None
    assert js.RegExpLike(JLit("x"), "é").tpu_supported() is not None


#: literals past K6's 64 positions, with borders (a prefix that is also
#: a suffix) for the DFA's fall-backs, and non-ASCII bytes
LONG_LITERALS = ["ab" * 40 + "é", "x" * 70, "abab" * 20 + "abac",
                 "日本" * 12 + "aab" * 3, "aaab" * 17]


def _long_rows(lit: str, rng) -> list:
    """Rows around ``lit``: itself, with text before and after, cut by
    one character at either end, twice over, overlapping itself, and
    short random words."""
    pieces = [lit, "x" + lit, lit + "é", "é" + lit + "z", lit[1:],
              lit[:-1], lit + lit, lit[:len(lit) // 2] + lit, "", "ab",
              lit[:-1] + lit[-1] * 2, "q" * len(lit)]
    return [pieces[i] for i in rng.integers(0, len(pieces), 60)]


@pytest.mark.parametrize("lit", LONG_LITERALS)
def test_long_literals_run_on_k6_and_equal_the_reference(lit):
    """A literal past 64 positions compiles for K6's DFA route
    (``regex.compile_literal``), as the reference keeps any literal on
    its device; each shape equals the reference and Python."""
    from spark_rapids_tpu_torch.ops import regex
    rows = _long_rows(lit, np.random.default_rng(len(lit)))
    rb = batch({"s": (pa.string(), rows)}, seed=3)
    for name, fn in (("StartsWith", str.startswith),
                     ("EndsWith", str.endswith),
                     ("Contains", str.__contains__)):
        e = getattr(ts, name)(TLit("x"), lit)
        assert e.gpu_supported() is None
        assert regex.program_tables(e.program())[0] == "dfa"
        got, want = eval_both(rb, lambda c: getattr(ts, name)(c("s"), lit),
                              lambda c: getattr(js, name)(c("s"), lit))
        same(got, want)
        assert got.to_pylist() == [None if r is None else fn(r, lit)
                                   for r in rb.column(0).to_pylist()]


def test_a_literal_past_k6_runs_on_the_cpu():
    """Past ``LITERAL_MAX_BYTES`` the operator stays on the CPU, where
    Python's ``str`` methods answer (the reference keeps it on its
    device: a departure ``ROADMAP.md`` records)."""
    from spark_rapids_tpu_torch.ops import regex
    lit = "ab" * (regex.LITERAL_MAX_BYTES // 2) + "c"
    rows = ["z" + lit, lit + "z", lit, "ab", None, ""]
    rb = batch({"s": (pa.string(), rows)}, seed=5, null_share=0.0)
    for name, fn in (("StartsWith", str.startswith),
                     ("EndsWith", str.endswith),
                     ("Contains", str.__contains__)):
        assert getattr(ts, name)(TLit("x"), lit).gpu_supported() is not None
        got, _ = eval_both(rb, lambda c: getattr(ts, name)(c("s"), lit),
                           None, host=True)
        assert got.to_pylist() == [None if r is None else fn(r, lit)
                                   for r in rows]


@pytest.mark.parametrize("kind", ["prefix", "suffix", "contains"])
def test_literal_dfa_equals_the_position_automaton(kind):
    """``_literal_dfa`` (the long literals' tables), stepped by its plain
    version, equals the position automaton's plain version on literals
    of at most 64 bytes that both can take: borders, repeats,
    non-ASCII bytes, over rows that hold them at every offset."""
    import torch
    from spark_rapids_tpu_torch.ops import regex
    rng = np.random.default_rng(21)
    lits = ["a", "aa", "aab", "abab", "abcab", "aabaab", "éé", "日a日",
            "abacabad"] + ["".join(rng.choice(list("abé"), 9))
                           for _ in range(12)]
    for lit in lits:
        rows = ["".join(rng.choice(list("abé日c"), rng.integers(0, 14)))
                for _ in range(200)] + [lit, lit * 2, "x" + lit, ""]
        raw = [r.encode() for r in rows]
        offs = np.cumsum([0] + [len(r) for r in raw])
        args = (torch.from_numpy(offs[:-1].astype(np.int32)),
                torch.from_numpy(np.diff(offs).astype(np.int32)),
                torch.from_numpy(np.arange(len(rows)) % 7 != 3),
                torch.from_numpy(np.frombuffer(b"".join(raw), np.uint8)
                                 .copy()))
        prog = regex.compile_literal(lit, kind)
        want = regex.regex_match_torch(*args, prog)
        wide = regex.RegexProgram()
        wide.n_states = regex.MAX_STATES + 1
        wide.host_tables = ("dfa", regex._literal_dfa(lit.encode(), kind))
        got = regex.regex_match_torch(*args, wide)
        assert torch.equal(got, want), (lit, kind)
"""LIKE and RLIKE on the CPU: the port's regex compiler, its K6 plain
version and its ``Like``/``RegExpLike`` held to the JAX package
(``spark_rapids_tpu.ops.regex``, ``expr/strings.py``) and to Python's
``re``.

- ``compile_pattern``'s tables (``acc``, ``follow``, the four position
  masks, the two flags, ``min_len``) equal the reference's over
  ``tests/test_regex.py``'s patterns and a seeded fuzz corpus, and so do
  its refusals, with the 64-position boundary (64 compile, 65 raise);
- ``like_to_regex`` equals the reference's;
- the plain matcher (``regex_match_torch``, and the wrapper on the CPU)
  equals ``regex_match_device`` bit for bit on generated strings: UTF-8
  characters of 1-4 bytes, newlines, empty rows, nulls, and rows whose
  start lies inside an inherited chars buffer;
- ``Like`` in every shape (exact, prefix, suffix, contains,
  prefix-and-suffix, all, general), with ``ESCAPE`` and ``NOT LIKE``,
  and ``RegExpLike``, through the port's project against the
  reference's ``eval_tpu`` and against ``re`` (LIKE's wildcards across
  newlines, ``_`` one character; RLIKE with ASCII classes). Booleans and
  nulls exact."""
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.ops.regex as jrx
from spark_rapids_tpu.columnar.column import TpuColumnVector
from spark_rapids_tpu.exec.base import HostBatchSourceExec as JSource
from spark_rapids_tpu.exec.base import collect_arrow as j_collect
from spark_rapids_tpu.exec.basic import TpuProjectExec
from spark_rapids_tpu.expr import Alias as JAlias
from spark_rapids_tpu.expr import Not as JNot
from spark_rapids_tpu.expr import UnresolvedColumn as jcol
from spark_rapids_tpu.expr.strings import Like as JLike
from spark_rapids_tpu.expr.strings import RegExpLike as JRegExpLike
from spark_rapids_tpu_torch.exec.base import ExecCtx
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec as TSource
from spark_rapids_tpu_torch.exec.base import collect_arrow as t_collect
from spark_rapids_tpu_torch.exec.basic import GpuProjectExec
from spark_rapids_tpu_torch.expr import Alias as TAlias
from spark_rapids_tpu_torch.expr import Not as TNot
from spark_rapids_tpu_torch.expr import UnresolvedColumn as tcol
from spark_rapids_tpu_torch.expr.strings import Like, RegExpLike
from spark_rapids_tpu_torch.ops import regex as trx

DIALECT_PATTERNS = [
    "abc", "^abc", "abc$", "^abc$", "a.c", "ab*c", "ab+c", "ab?c",
    "[abc]x", "[^abc]x", "[a-f0-9]+", "\\d+", "\\w+z", "\\s",
    "cat|dog|bird", "^x*", "a[b-d]*e$", "^\\d\\d-\\d\\d", "x.*y", ".*",
    "a*", "^$", "colou?r", "[A-Z][a-z]+", "end\\.$", "a|", "\\.com$",
    "[\\s\\S]", "\\S+", "^\\W+$", "[^x]*",
]
REFUSED = ["(ab)+", "a{2,3}", "(?i)abc", "a(?=b)", "\\bword", "a|b|(cd)",
           "café", "(a)", "a{2}", "a**", "[z-a]", "\\q", "*a", "[abc",
           "a^b", "\\"]
LIKE_PATTERNS = ["%o%s%", "a%b_c", "100\\%", "a.b", "_", "%", "%%", "",
                 "x[y]*", "%$^%", "a|b%", "\\_%", "%\\\\%"]
STRINGS = ["", "abc", "xabc", "abcx", "a c", "abbbc", "ac", "bx", "zx",
           "deadbeef", "12-34x", "x123y", "cat", "hotdog", "birds",
           "color", "colour", "Widget", "a.c", "end.", "foo.com", "aaa",
           "cde", None, "CAT", "42", " ", "ab\ncd", "é", "aé", "日本語x",
           "naïve", "𝄞clef", "mixé\nline", "a_c", "100%", "a%b", "xos",
           "Sports", "Books", None, "a\nb\nc"]


def _tables_equal(got, want):
    for f in ("acc", "follow", "first_anchored", "first_floating",
              "accept_any", "accept_end"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in ("always_match", "empty_only_match", "n_states", "min_len"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("pattern", DIALECT_PATTERNS)
def test_compiled_tables_match_the_reference(pattern):
    _tables_equal(trx.compile_pattern(pattern), jrx.compile_pattern(pattern))


def _fuzz_patterns(seed=5, n=80):
    rng = np.random.default_rng(seed)
    atoms = ["a", "b", "0", ".", "\\d", "\\w", "\\s", "\\S", "[ab]",
             "[^a]", "[a-c0-9]", "x", "\\.", "é"]
    out = []
    for _ in range(n):
        branches = []
        for _ in range(rng.integers(1, 3)):
            parts = ["^"] if rng.random() < 0.3 else []
            for _ in range(rng.integers(0, 5)):
                parts.append(atoms[rng.integers(len(atoms))]
                             + ["", "", "*", "+", "?"][rng.integers(5)])
            if rng.random() < 0.3:
                parts.append("$")
            branches.append("".join(parts))
        out.append("|".join(branches))
    return out


def test_fuzz_corpus_compiles_or_refuses_like_the_reference():
    compiled = 0
    for pattern in _fuzz_patterns():
        try:
            want = jrx.compile_pattern(pattern)
        except jrx.RegexUnsupported:
            with pytest.raises(trx.RegexUnsupported):
                trx.compile_pattern(pattern)
            continue
        _tables_equal(trx.compile_pattern(pattern), want)
        compiled += 1
    assert compiled > 40


@pytest.mark.parametrize("pattern", REFUSED)
def test_refusals_match_the_reference(pattern):
    with pytest.raises(jrx.RegexUnsupported):
        jrx.compile_pattern(pattern)
    with pytest.raises(trx.RegexUnsupported):
        trx.compile_pattern(pattern)


def test_64_positions_compile_and_65_raise():
    # each LIKE % is 10 positions ([\s\S]: ASCII and the 2-, 3- and
    # 4-byte UTF-8 chains)
    assert trx.compile_pattern(trx.like_to_regex("%o%s%")).n_states == 32
    at_64 = trx.like_to_regex("%a%b%c%d%%")   # 6 x 10 + 4
    assert trx.compile_pattern(at_64).n_states == trx.MAX_STATES == 64
    assert jrx.compile_pattern(at_64).n_states == 64
    at_65 = trx.like_to_regex("%a%b%c%d%%e")
    for mod in (trx, jrx):
        with pytest.raises(mod.RegexUnsupported, match="65 positions"):
            mod.compile_pattern(at_65)
    with pytest.raises(trx.RegexUnsupported):
        trx.compile_pattern(trx.like_to_regex("%" * 7))


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_like_to_regex_matches_the_reference(pattern):
    for esc in ("\\", "!"):
        assert trx.like_to_regex(pattern, esc) \
            == jrx.like_to_regex(pattern, esc)
    with pytest.raises(trx.RegexUnsupported):
        trx.like_to_regex("%é%")


def _py(pattern: str) -> "re.Pattern":
    """The dialect's pattern for Python's ``re``: ``$`` is the end of the
    string only (Java's and Python's ``$`` also match before a final
    newline; the reference's dialect does not, and the port follows it;
    ROADMAP section C), and the classes are ASCII."""
    return re.compile(re.sub(r"(?<!\\)\$", r"\\Z", pattern), re.ASCII)


def _text(seed, n):
    """``(python strings, offsets, chars)``: UTF-8 text with 1- to 4-byte
    characters, newlines and empty rows."""
    rng = np.random.default_rng(seed)
    alphabet = list("abco s.0\n") + ["é", "日", "𝄞"]
    strs = ["".join(rng.choice(alphabet, rng.integers(0, 14)).tolist())
            for _ in range(n)]
    raw = [s.encode() for s in strs]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in raw])])
    return strs, offsets.astype(np.int32), np.frombuffer(b"".join(raw),
                                                         np.uint8)


MATCH_PATTERNS = ["a+b", "[ab]c*", "^c|0$", "\\d", "\\s", "a.b", "b?c",
                  "[^a]+$", "^.$", "..", "o.*s", "\\S+", "^$", "a*"]


@pytest.mark.parametrize("pattern", MATCH_PATTERNS)
def test_plain_matcher_matches_the_reference(pattern):
    """On rows inside an inherited chars buffer (the offsets start 5
    bytes in, after bytes no row covers), with nulls."""
    strs, offsets, chars = _text(3, 200)
    shift = 5
    chars = np.concatenate([np.frombuffer(b"zz\n\xc3x", np.uint8), chars])
    offsets = offsets + shift
    valid = np.random.default_rng(4).random(len(strs)) > 0.1
    import jax.numpy as jnp
    col = TpuColumnVector(None, validity=jnp.asarray(valid),
                          offsets=jnp.asarray(offsets),
                          chars=jnp.asarray(chars))
    want = np.asarray(jrx.regex_match_device(col, jrx.compile_pattern(
        pattern)))
    prog = trx.compile_pattern(pattern)
    starts = torch.from_numpy(offsets[:-1].copy())
    lengths = torch.from_numpy(np.diff(offsets).astype(np.int32))
    args = (starts, lengths, torch.from_numpy(valid),
            torch.from_numpy(chars.copy()), prog)
    for got in (trx.regex_match_torch(*args), trx.regex_match(*args)):
        assert np.array_equal(got.numpy(), want), pattern
    py = np.array([_py(pattern).search(s) is not None for s in strs])
    assert np.array_equal(want[valid], py[valid]), pattern


def _like_re(pattern: str, escape: str) -> "re.Pattern":
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return re.compile("(?s)" + "".join(out))


LIKE_CASES = [("abc", "\\"), ("a%", "\\"), ("%c", "\\"), ("%o%", "\\"),
              ("a%c", "\\"), ("%", "\\"), ("%o%s%", "\\"), ("a_c", "\\"),
              ("_", "\\"), ("__", "\\"), ("%\n%", "\\"), ("a_b", "\\"),
              ("100!%", "!"), ("a!_c", "!"), ("%!%%", "!"), ("é", "\\"),
              ("", "\\")]


@pytest.mark.parametrize("negate", [False, True], ids=["like", "not_like"])
def test_like_matches_the_reference_and_re(negate):
    rb = pa.record_batch({"s": pa.array(STRINGS, pa.string())})
    texprs = [TAlias(Like(tcol("s"), p, e), f"m{i}")
              for i, (p, e) in enumerate(LIKE_CASES)]
    jexprs = [JAlias(JLike(jcol("s"), p, e), f"m{i}")
              for i, (p, e) in enumerate(LIKE_CASES)]
    if negate:
        texprs = [TAlias(TNot(a.child), a.name) for a in texprs]
        jexprs = [JAlias(JNot(a.child), a.name) for a in jexprs]
    got = t_collect(GpuProjectExec(texprs, TSource([rb])),
                    ExecCtx(device="cpu"))
    want = j_collect(TpuProjectExec(jexprs, JSource([rb])))
    for i, (p, e) in enumerate(LIKE_CASES):
        g = got.column(f"m{i}").to_pylist()
        assert g == want.column(f"m{i}").to_pylist(), (p, e)
        rx = _like_re(p, e)
        py = [None if s is None else (rx.fullmatch(s) is not None) != negate
              for s in STRINGS]
        assert g == py, (p, e)


def test_rlike_matches_the_reference_and_re():
    rb = pa.record_batch({"s": pa.array(STRINGS, pa.string())})
    pats = DIALECT_PATTERNS
    got = t_collect(GpuProjectExec(
        [TAlias(RegExpLike(tcol("s"), p), f"m{i}")
         for i, p in enumerate(pats)], TSource([rb])), ExecCtx(device="cpu"))
    want = j_collect(TpuProjectExec(
        [JAlias(JRegExpLike(jcol("s"), p), f"m{i}")
         for i, p in enumerate(pats)], JSource([rb])))
    for i, p in enumerate(pats):
        g = got.column(f"m{i}").to_pylist()
        assert g == want.column(f"m{i}").to_pylist(), p
        py = [None if s is None else _py(p).search(s) is not None
              for s in STRINGS]
        assert g == py, p


def test_patterns_outside_the_dialect_raise_at_planning():
    """They raised at planning until the CPU fallback was ported: the
    planner now places the project on the CPU, where the pattern runs
    through Python's ``re`` (LIKE anchored, ``.`` across newlines;
    RLIKE searched with ASCII classes), and the device path still
    refuses it."""
    from spark_rapids_tpu_torch.planner import GpuOverrides
    rb = pa.record_batch({"s": pa.array(STRINGS, pa.string())})

    def like(p):
        return re.compile("".join(".*" if c == "%" else "." if c == "_"
                                  else re.escape(c) for c in p),
                          re.DOTALL).fullmatch

    # a non-ASCII literal shape (contains, prefix) runs on the device
    # since the SQL function slice, as the reference's literal kernels
    # have it: K6 takes the literal's bytes
    for e, test in ((Like(tcol("s"), "%é%"), like("%é%")),
                    (Like(tcol("s"), "日本%"), like("日本%"))):
        plan = GpuProjectExec([TAlias(e, "m")], TSource([rb]))
        pp = GpuOverrides(device="cpu").apply(plan)
        assert pp.fallback_nodes() == []
        assert pp.collect().column("m").to_pylist() == [
            None if s is None else test(s) is not None for s in STRINGS]
    for e, test in ((Like(tcol("s"), "%é_%"), like("%é_%")),
                    (RegExpLike(tcol("s"), "(ab)+"),
                     re.compile("(ab)+", re.ASCII).search),
                    (Like(tcol("s"), "%a%b%c%d%%e"), like("%a%b%c%d%%e")),
                    (RegExpLike(tcol("s"), "日本"),
                     re.compile("日本").search)):
        plan = GpuProjectExec([TAlias(e, "m")], TSource([rb]))
        pp = GpuOverrides(device="cpu").apply(plan)
        assert pp.fallback_nodes() == ["ProjectExec"]
        assert pp.collect().column("m").to_pylist() == [
            None if s is None else test(s) is not None for s in STRINGS]
        with pytest.raises(trx.RegexUnsupported):
            t_collect(plan, ExecCtx(device="cpu"))
    # the exact shape needs no regex: a non-ASCII literal runs
    plan = GpuProjectExec([TAlias(Like(tcol("s"), "aé"), "m")],
                          TSource([rb]))
    got = GpuOverrides(device="cpu").apply(plan).collect()
    assert got.column("m").to_pylist() == [None if s is None else s == "aé"
                                           for s in STRINGS]


# --- K6's route tables: the DFA (route A) and the follow byte tables ------

def _dfa_match(prog, starts, lengths, valid, chars) -> np.ndarray:
    """Route A in numpy (tests only): the DFA of ``trx.program_tables``
    stepped a byte a row as ``csrc/regex_match.cu`` steps it: state 0
    first, a row decided by the flags before its first byte, matched on
    an entry's any-accept bit or on its end-accept bit at the row's last
    live byte, stopped at the dead state; bytes read at the clamped
    position, an empty buffer as one zero byte."""
    route, dfa = trx.program_tables(prog)
    assert route == "dfa"
    lens = lengths.astype(np.int64)
    live = lens if valid is None else np.where(valid, lens, 0)
    matched = np.full(len(lens), bool(prog.always_match))
    if prog.empty_only_match:
        matched |= lens == 0
    state = np.zeros(len(lens), np.int64)
    going = ~matched & (state != dfa.dead)
    buf = chars if len(chars) else np.zeros(1, np.uint8)
    for j in range(int(live.max()) if len(lens) else 0):
        going &= j < live
        c = buf[np.clip(starts.astype(np.int64) + j, 0, len(buf) - 1)]
        e = dfa.trans[state, dfa.classes[c]].astype(np.int64)
        hit = going & (((e & trx._DFA_ANY) != 0)
                       | (((e & trx._DFA_END) != 0) & (j == live - 1)))
        matched |= hit
        going &= ~hit
        state = np.where(going, e & (trx._DFA_ANY - 1), state)
        going &= state != dfa.dead
    return matched


def _edge_rows():
    """The edge rows of ``kernel_checks.k6_cases``: the empty string, a
    null row, overlapping rows out of order inside one buffer."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    c = next(c for c in kc.k6_cases("cpu", text_rows=1 << 4)
             if c["name"].startswith("edges_'%o%s%'"))
    return tuple(c[k].numpy() for k in ("starts", "lengths", "validity",
                                        "chars"))


# every pattern this file compiles, for LIKE (ASCII, "\\" escapes) and
# RLIKE, once each
ROUTE_A_PATTERNS = list(dict.fromkeys(
    [(p, False) for p in DIALECT_PATTERNS + MATCH_PATTERNS]
    + [(p, True) for p in LIKE_PATTERNS]
    + [(p, True) for p, e in LIKE_CASES if e == "\\" and p.isascii()]))


@pytest.mark.parametrize(
    "pattern,like", ROUTE_A_PATTERNS,
    ids=[f"{'like' if k else 'rlike'}:{p!r}" for p, k in ROUTE_A_PATTERNS])
def test_dfa_rows_match_the_reference_and_the_plain_version(pattern, like):
    """The DFA's rows equal ``regex_match_device`` (JAX on the CPU) and
    ``regex_match_torch`` on generated text (1- to 4-byte characters,
    newlines, empty rows, nulls) and on ``k6_cases``' edge rows."""
    import jax.numpy as jnp
    rx = trx.like_to_regex(pattern) if like else pattern
    prog, jprog = trx.compile_pattern(rx), jrx.compile_pattern(rx)
    strs, offsets, chars = _text(6, 120)
    valid = np.random.default_rng(7).random(len(strs)) > 0.1
    inputs = [(offsets[:-1], np.diff(offsets).astype(np.int32), valid,
               chars), _edge_rows()]
    for starts, lengths, v, buf in inputs:
        got = _dfa_match(prog, starts, lengths, v, buf)
        plain = trx.regex_match_torch(
            torch.from_numpy(starts.copy()), torch.from_numpy(lengths.copy()),
            torch.from_numpy(v.copy()), torch.from_numpy(buf.copy()), prog)
        assert np.array_equal(got, plain.numpy()), rx
        if starts is offsets[:-1]:
            col = TpuColumnVector(None, validity=jnp.asarray(v),
                                  offsets=jnp.asarray(offsets),
                                  chars=jnp.asarray(buf))
            want = np.asarray(jrx.regex_match_device(col, jprog))
            assert np.array_equal(got, want), rx


def test_k6_cases_take_route_a_but_the_blowup():
    """Every ``k6_cases`` pattern (at most 44 positions) takes the DFA,
    except ``K6_BLOWUP``: 17 positions, but an 'a' may start a match at
    each of the last 16 bytes, so its DFA needs a state for each subset
    of them (about 2^16) and passes ``DFA_MAX_ENTRIES``: route B."""
    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    routes = {}
    for c in kc.k6_cases("cpu", text_rows=1 << 4):
        assert c["prog"].n_states <= 44
        routes[c["pattern"]] = trx.program_tables(c["prog"])[0]
    assert routes.pop(kc.K6_BLOWUP) == "positions"
    assert set(routes.values()) == {"dfa"}
    # the corpus's and the text's LIKE patterns: small DFAs
    for pattern, states in (("%o%s%", 22), (kc.K6_LIKE, 45)):
        dfa = trx.build_dfa(trx.compile_pattern(trx.like_to_regex(pattern)))
        assert dfa.n_states == states and dfa.n_classes <= 10


@pytest.mark.parametrize("pattern", ["a" + "[ab]" * 16,
                                     "a" + "[a-z ]" * 16])
def test_a_blowup_pattern_passes_the_cap_and_takes_route_b(pattern):
    prog = trx.compile_pattern(pattern)
    assert prog.n_states == 17
    assert trx.build_dfa(prog) is None
    route, tables = trx.program_tables(prog)
    assert route == "positions"
    assert np.array_equal(tables[:256], trx._bits(prog.acc))
    assert np.array_equal(tables[256:256 + 17], trx._bits(prog.follow))
    assert not tables[256 + 17:].any()
    # a cap of fewer entries than the small pattern needs: route B too
    small = trx.compile_pattern("a[ab][ab]")
    dfa = trx.build_dfa(small)
    assert dfa is not None
    assert trx.build_dfa(small, dfa.n_states * dfa.n_classes - 1) is None


def test_follow_byte_tables_give_the_follow_sets():
    """``T[k][b]``, ORed over the bytes of a fired set, equals the OR of
    ``follow`` over its bits, for random sets over the fuzz corpus and
    the 64-position pattern."""
    rng = np.random.default_rng(11)
    pats = _fuzz_patterns()[:40] + [trx.like_to_regex("%a%b%c%d%%")]
    for pattern in pats:
        try:
            prog = trx.compile_pattern(pattern)
        except trx.RegexUnsupported:
            continue
        s = prog.n_states
        tabs = trx.follow_byte_tables(prog)
        assert tabs.shape == (max(1, -(-s // 8)), 256)
        bits = rng.random((50, s)) < 0.3
        fired = trx._bits(bits) if s else np.zeros(50, np.uint64)
        want = [np.bitwise_or.reduce(trx._bits(prog.follow[row]))
                if row.any() else np.uint64(0) for row in bits]
        assert np.array_equal(trx._follow_of(tabs, fired),
                              np.array(want, np.uint64)), pattern

"""``regexp_replace`` and ``regexp_extract`` on the CPU against the JAX
package: the spans (K8's plain version, ``ops/regex.find_spans_torch``)
against the reference's ``regex_find_spans_device`` on JAX's CPU
backend, all five outputs equal, with ``first_only`` off and on; the
expressions through each package's device and host paths
(``torch_function_cases.eval_both``); the gates' reasons, word for word;
the row that starts at the chars buffer's end; and a gated pattern that
keeps its project on the CPU, through both packages' sessions
(``torch_dual_run.dual_run_frames``). Text rows carry nulls, empty
strings, newlines and multi-byte characters.
"""
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_tpu.expr as jexpr
import spark_rapids_tpu_torch.expr as texpr
from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.columnar import arrow_to_device as j_upload
from spark_rapids_tpu.columnar.column import TpuColumnVector
from spark_rapids_tpu.ops import regex as jrx
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.columnar import arrow_to_device as t_upload
from spark_rapids_tpu_torch.columnar.column import GpuColumnVector
from spark_rapids_tpu_torch.expr.base import column_to_arrow
from spark_rapids_tpu_torch.ops import regex as trx
from torch_dual_run import dual_run_frames
from torch_function_cases import eval_both

ALPHABET = list("aeiouxyzAB .o\n01239") + ["é", "日"]
PATTERNS = ["[aeiou]+", "o", "[A-Z][a-z]+", "a.?o", "^[ax]+", "o+$",
            "x*y", "\\s+", ".o", "[^ ]+", "\\d\\d?\\d?", "[a-z ]" * 12]


def _text(seed=3, n=300):
    rng = np.random.default_rng(seed)
    vals = [None if rng.random() < 0.1 else
            "".join(rng.choice(ALPHABET, rng.integers(0, 40)))
            for _ in range(n)]
    vals[1:4] = ["", "", None]
    return pa.record_batch([pa.array(vals, pa.string())], names=["s"])


@pytest.fixture(scope="module")
def rb():
    return _text()


def _both(rb):
    tc = t_upload(rb, None, torch.device("cpu")).columns[0]
    jc = j_upload(rb).columns[0]
    return tc, jc


def _spans_equal(got, want, n):
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if k < 2:  # the two lanes over the chars
            size = min(len(g), len(w))
            assert (g[:size] == w[:size]).all(), k
            assert not g[size:].any() and not w[size:].any(), k
        else:
            assert (g[:n] == w[:n]).all(), k


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_spans_match_the_reference(rb, pattern, first_only):
    prog, why = trx.compile_replace_pattern(pattern)
    jprog, jwhy = jrx.compile_replace_pattern(pattern)
    assert why == jwhy
    tc, jc = _both(rb)
    got = trx.find_spans(tc.offsets, tc.chars, tc.validity, prog,
                         first_only)
    want = jrx.regex_find_spans_device(jc, jprog, first_only=first_only)
    _spans_equal(got, want, rb.num_rows)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_replace_matches_the_reference(rb, pattern):
    for repl in ("*", "", "<>"):
        for host in (False, True):
            got, want = eval_both(
                rb, lambda c: texpr.RegExpReplace(c("s"), pattern, repl),
                lambda c: jexpr.RegExpReplace(c("s"), pattern, repl),
                host=host)
            assert got.equals(want), (pattern, repl, host)


@pytest.mark.parametrize("pattern,group", [
    ("([A-Z][a-z]+)", 1), ("[aeiou]+", 0), ("(o+)", 1), ("(\\d\\d?)", 1),
    ("^[ax]+", 0), ("([a-z]+$)", 1)])
def test_extract_matches_the_reference(rb, pattern, group):
    for host in (False, True):
        got, want = eval_both(
            rb, lambda c: texpr.RegExpExtract(c("s"), pattern, group),
            lambda c: jexpr.RegExpExtract(c("s"), pattern, group),
            host=host)
        assert got.equals(want), (pattern, group, host)


GATED = [("replace", "o|e", "*"), ("replace", "a*", "*"),
         ("replace", "^$", "*"), ("replace", "[aeiou]", "$1"),
         ("replace", "[aeiou]", "\\\\"), ("replace", "(ab)+", "*"),
         ("extract", "(a)(b)", 2), ("extract", "([a-z]+)x([a-z])", 1),
         ("extract", "x|y", 0), ("replace", "[aeiou]+", "*")]


def _expr(mod, kind, pattern, arg, child):
    return (mod.RegExpReplace(child, pattern, arg) if kind == "replace"
            else mod.RegExpExtract(child, pattern, arg))


@pytest.mark.parametrize("kind,pattern,arg", GATED)
def test_gates_and_their_reasons_are_the_references(rb, kind, pattern, arg):
    """The same patterns run on the device, and a refused one gives the
    reference's reason; its host path answers as the reference's."""
    from spark_rapids_tpu.expr.base import BoundReference as JRef
    from spark_rapids_tpu_torch.expr.base import BoundReference as TRef
    te = _expr(texpr, kind, pattern, arg, TRef(0, tdt.STRING))
    je = _expr(jexpr, kind, pattern, arg, JRef(0, jdt.STRING))
    assert te.gpu_supported() == je.tpu_supported()

    def host(mod, build):
        try:
            return eval_both(rb, build, None, host=True)[0] \
                if mod is texpr else eval_both(
                    rb, lambda c: _expr(texpr, kind, pattern, arg, c("s")),
                    build, host=True)[1]
        except re.error as e:  # Python's re refuses both the same way
            return type(e)
    got = host(texpr, lambda c: _expr(texpr, kind, pattern, arg, c("s")))
    want = host(jexpr, lambda c: _expr(jexpr, kind, pattern, arg, c("s")))
    assert got == want if isinstance(got, type) else got.equals(want)


def test_a_row_starting_at_the_buffers_end():
    """Rows whose bytes fill the chars buffer exactly, then empty rows
    that start at its end: the replaced rows and the offsets equal the
    reference's (the case its ``ops/regex.py:646-652`` note names)."""
    offs = np.array([0, 3, 5, 5, 5], np.int32)
    chars = np.frombuffer(b"aoxoo", np.uint8)
    valid = np.array([True, True, True, False])
    tc = GpuColumnVector(tdt.STRING, None, torch.from_numpy(valid),
                         torch.from_numpy(offs), torch.from_numpy(
                             chars.copy()))
    jc = TpuColumnVector(jdt.STRING, validity=jnp.asarray(valid),
                         offsets=jnp.asarray(offs), chars=jnp.asarray(chars))
    for pattern in ("o", "[ao]+", "x"):
        prog, _ = trx.compile_replace_pattern(pattern)
        jprog, _ = jrx.compile_replace_pattern(pattern)
        for repl in (b"", b"<*>"):
            got = trx.regex_replace(tc, prog, repl)
            want = jrx.regex_replace_device(
                jc, jprog, repl, jrx.replace_char_cap(jc, jprog, len(repl)))
            assert got.offsets.tolist() == np.asarray(want.offsets).tolist()
            n = int(got.offsets[-1])
            assert got.chars[:n].tolist() == \
                np.asarray(want.chars)[:n].tolist()
            rows = [bytes(chars[a:b]).decode() for a, b in
                    zip(offs[:-1], offs[1:])]
            assert column_to_arrow(got, 4).to_pylist() == [
                re.sub(pattern, repl.decode(), v) if ok else None
                for v, ok in zip(rows, valid)]
        _, _, n_matches, fs, fe = trx.find_spans(
            tc.offsets, tc.chars, tc.validity, prog)
        _, _, jn, jfs, jfe = jrx.regex_find_spans_device(jc, jprog)
        assert n_matches.tolist() == np.asarray(jn).tolist()
        assert fs.tolist() == np.asarray(jfs).tolist()
        assert fe.tolist() == np.asarray(jfe).tolist()


@pytest.fixture(scope="module")
def nds_paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(1 << 12),
                            str(tmp_path_factory.mktemp("nds")))


@pytest.mark.parametrize("parts", ["1", "16"])
def test_a_gated_pattern_runs_on_the_cpu(nds_paths, parts):
    """An alternation and a ``$1`` replacement keep their project on the
    CPU in both packages; the rows equal the reference's."""
    def build(s, E):
        c = E.UnresolvedColumn
        return s.table("item").select(
            c("i_item_sk"),
            E.Alias(E.RegExpReplace(c("i_category"), "o|e", "*"), "alt"),
            E.Alias(E.RegExpReplace(c("i_category"), "([aeiou])", "<$1>"),
                    "grp"),
            E.Alias(E.RegExpExtract(c("i_category"), "([A-Z])([a-z]+)", 2),
                    "g2"))
    got, _, pp, jpp = dual_run_frames(
        build, nds_paths, {"spark.sql.shuffle.partitions": parts})
    assert pp.fallback_nodes() and jpp.fallback_nodes()
    assert got.column("alt")[0].as_py() != ""

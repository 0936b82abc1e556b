"""Complex expressions, explode and the nested fallbacks on the CPU: the
port's plans held to the JAX package's over the same seeded batches
(``tests/test_complex_types.py``'s cases).

- ``GetStructField`` (and nested), ``GetArrayItem`` over long, string
  and double elements with a literal and a column index (out of range
  and null give null), ``CreateNamedStruct``, ``Size``, ``MapKeys`` and
  ``MapValues``;
- ``explode``, ``posexplode`` and ``outer`` over arrays, string elements,
  maps and several batches, and explode -> filter -> project;
- the fallbacks of ``test_complex_types.py:158-197`` with
  ``fallback_nodes()`` equal to the reference's: a sort by a struct and
  an explode beside a repeated array (rows equal to the reference's),
  and a group-by over a struct (the reference's CPU aggregate cannot
  hash a struct's dict, so the rows are held to Python);
- a struct key through the hash exchange, on the CPU;
- an explode past an int32 row count raises, naming ROADMAP item 14.
"""
import collections

import pyarrow as pa
import pytest
import torch

from data_gen import (ArrayGen, DoubleGen, IntegerGen, LongGen, MapGen,
                      StringGen, StructGen, gen_table)
from asserts import _norm_nested as _norm

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import datatypes as jdt
from spark_rapids_tpu.exec import HostBatchSourceExec as JS
from spark_rapids_tpu.exec import TpuFilterExec as JF
from spark_rapids_tpu.exec import TpuGenerateExec as JG
from spark_rapids_tpu.exec import TpuProjectExec as JP
from spark_rapids_tpu.exec.aggregate import TpuHashAggregateExec as JA
from spark_rapids_tpu.exec.sort import SortOrder as JO
from spark_rapids_tpu.exec.sort import TpuSortExec as JSort
from spark_rapids_tpu.expr.aggregates import Count as JC
from spark_rapids_tpu.planner import overrides

import spark_rapids_tpu_torch.expr as TE
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec as TA
from spark_rapids_tpu_torch.exec.base import HostBatchSourceExec as TS
from spark_rapids_tpu_torch.exec.basic import GpuFilterExec as TF
from spark_rapids_tpu_torch.exec.basic import GpuProjectExec as TP
from spark_rapids_tpu_torch.exec.generate import GpuGenerateExec as TG
from spark_rapids_tpu_torch.exec.sort import GpuSortExec as TSort
from spark_rapids_tpu_torch.exec.sort import SortOrder as TO
from spark_rapids_tpu_torch.expr.aggregates import Count as TC
from spark_rapids_tpu_torch.planner import GpuOverrides

PKG = {"j": (JE, jdt, JS, JP, JF, JG), "t": (TE, tdt, TS, TP, TF, TG)}


def _both(build, gens, n=200, seed=77, batches=1, ordered=True):
    """``build(E, dt, Source, Project, Filter, Generate, rbs)`` in both
    packages over the same batches: rows, types and ``fallback_nodes()``
    equal; returns the port's table."""
    rbs = [gen_table(gens, n, seed + i) for i in range(batches)]
    jpp = overrides(build(*PKG["j"], rbs))
    tpp = GpuOverrides(device="cpu").apply(build(*PKG["t"], rbs))
    want, got = jpp.collect(), tpp.collect()
    assert got.schema == want.schema, (got.schema, want.schema)
    g, w = _norm(got.to_pylist()), _norm(want.to_pylist())
    if not ordered:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    assert g == w
    assert tpp.fallback_nodes() == jpp.fallback_nodes()
    return got, tpp


def test_get_struct_field():
    g = StructGen([("a", IntegerGen()), ("b", StringGen(max_len=6)),
                   ("c", DoubleGen())])
    _both(lambda E, dt, S, P, F, G, rbs: P(
        [E.Alias(E.GetStructField(E.UnresolvedColumn("c0"), f), f)
         for f in "abc"], S(rbs)), [g])


def test_get_struct_field_nested():
    g = StructGen([("in", StructGen([("x", DoubleGen())]))])
    _both(lambda E, dt, S, P, F, G, rbs: P(
        [E.Alias(E.GetStructField(E.GetStructField(
            E.UnresolvedColumn("c0"), "in"), "x"), "x")], S(rbs)), [g])


@pytest.mark.parametrize("elem_gen", [LongGen(), StringGen(max_len=5),
                                      DoubleGen()],
                         ids=["long", "string", "double"])
def test_get_array_item(elem_gen):
    def build(E, dt, S, P, F, G, rbs):
        a = E.UnresolvedColumn("c0")
        return P([E.Alias(E.GetArrayItem(a, E.Literal(0, dt.INT32)),
                          "first"),
                  E.Alias(E.GetArrayItem(a, E.Literal(2, dt.INT32)),
                          "third"),
                  E.Alias(E.GetArrayItem(a, E.UnresolvedColumn("c1")),
                          "dyn")], S(rbs))
    _both(build, [ArrayGen(elem_gen),
                  IntegerGen(min_val=-1, max_val=5, null_frac=0.1)])


def test_create_named_struct():
    _both(lambda E, dt, S, P, F, G, rbs: P([E.Alias(E.CreateNamedStruct(
        ["x", "y"], [E.UnresolvedColumn("c0"), E.UnresolvedColumn("c1")]),
        "s")], S(rbs)), [IntegerGen(), StringGen(max_len=5)])


def test_size_and_map_projections():
    def build(E, dt, S, P, F, G, rbs):
        a, m = E.UnresolvedColumn("c0"), E.UnresolvedColumn("c1")
        return P([E.Alias(E.Size(a), "asz"), E.Alias(E.Size(m), "msz"),
                  E.Alias(E.MapKeys(m), "ks"), E.Alias(E.MapValues(m), "vs")],
                 S(rbs))
    _both(build, [ArrayGen(LongGen()),
                  MapGen(StringGen(max_len=4, nullable=False), LongGen())])


@pytest.mark.parametrize("outer", [False, True], ids=["inner", "outer"])
@pytest.mark.parametrize("position", [False, True],
                         ids=["explode", "posexplode"])
def test_explode_array(outer, position):
    _both(lambda E, dt, S, P, F, G, rbs: G(
        E.UnresolvedColumn("c0"), S(rbs), outer=outer, position=position),
        [ArrayGen(LongGen()), IntegerGen(), StringGen(max_len=6)])


def test_explode_string_elements():
    _both(lambda E, dt, S, P, F, G, rbs: G(E.UnresolvedColumn("c0"),
                                           S(rbs)),
          [ArrayGen(StringGen(max_len=8)), LongGen()])


@pytest.mark.parametrize("position", [False, True],
                         ids=["explode", "posexplode"])
def test_explode_map(position):
    _both(lambda E, dt, S, P, F, G, rbs: G(
        E.UnresolvedColumn("c0"), S(rbs), outer=True, position=position),
        [MapGen(StringGen(max_len=4, nullable=False), LongGen()),
         IntegerGen()])


def test_explode_multi_batch():
    _both(lambda E, dt, S, P, F, G, rbs: G(E.UnresolvedColumn("c0"),
                                           S(rbs)),
          [ArrayGen(IntegerGen()), LongGen()], n=120, batches=3)


def test_explode_of_the_only_column():
    """A generator that is the batch's only column: the reference's
    stage B sizes its output by the kept columns' capacity, which is 0
    there, and gives wrong rows (ROADMAP queue C); the port's equal
    Spark's, here held to Python."""
    m = pa.array([[("a", 1)], [], None, [("b", 2), ("c", 3)]],
                 pa.map_(pa.string(), pa.int32()))
    rb = pa.record_batch({"t": m})
    got = GpuOverrides(device="cpu").apply(TG(
        TE.UnresolvedColumn("t"), TS([rb]), outer=True,
        position=True)).collect().to_pylist()
    assert got == [{"pos": 0, "key": "a", "value": 1},
                   {"pos": None, "key": None, "value": None},
                   {"pos": None, "key": None, "value": None},
                   {"pos": 0, "key": "b", "value": 2},
                   {"pos": 1, "key": "c", "value": 3}]
    ref = overrides(JG(JE.UnresolvedColumn("t"), JS([rb]), outer=True,
                       position=True)).collect().to_pylist()
    assert ref != got


def test_explode_then_filter_then_project():
    def build(E, dt, S, P, F, G, rbs):
        g = G(E.UnresolvedColumn("c0"), S(rbs))
        f = F(E.GreaterThan(E.UnresolvedColumn("col"),
                            E.Literal(0, dt.INT64)), g)
        return P([E.Alias(E.UnresolvedColumn("col"), "v"),
                  E.Alias(E.UnresolvedColumn("c1"), "k")], f)
    _both(build, [ArrayGen(LongGen(), max_len=5), IntegerGen()])


def test_explode_then_explode():
    """An array of arrays exploded twice: the inner arrays are the first
    explode's elements."""
    def build(E, dt, S, P, F, G, rbs):
        once = G(E.UnresolvedColumn("c0"), S(rbs), element_name="inner")
        return G(E.UnresolvedColumn("inner"), once, position=True)
    _both(build, [ArrayGen(ArrayGen(IntegerGen(), max_len=4)),
                  StringGen(max_len=5)])


def test_dataframe_explode(tmp_path):
    import pyarrow.parquet as pq
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import GpuSession
    rb = gen_table([ArrayGen(DoubleGen()), LongGen()], 150, seed=8,
                   names=["xs", "k"])
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.Table.from_batches([rb]), path)
    conf = {"spark.rapids.sql.format.parquet.deviceDecode.enabled": "false"}
    got = GpuSession(conf, device="cpu").read_parquet(path).explode(
        "xs", outer=True, position=True).collect()
    want = TpuSession(conf).read_parquet(path).explode(
        "xs", outer=True, position=True).collect()
    assert got.schema == want.schema
    assert _norm(got.to_pylist()) == _norm(want.to_pylist())


# --- the fallbacks -----------------------------------------------------------

def test_nested_sort_falls_back():
    got, pp = _both(lambda E, dt, S, P, F, G, rbs: (
        JSort if E is JE else TSort)([(JO if E is JE else TO)(
            E.UnresolvedColumn("c0"))], S(rbs)),
        [StructGen([("a", IntegerGen())]), LongGen()], n=60)
    assert pp.fallback_nodes() == ["SortExec"]


def test_nested_groupby_falls_back():
    rbs = [gen_table([StructGen([("a", IntegerGen(min_val=0, max_val=3))],
                                null_frac=0.0), LongGen()], 60, seed=77)]
    jpp = overrides(JA([JE.UnresolvedColumn("c0")],
                       [JE.Alias(JC(), "n")], JS(rbs)))
    tpp = GpuOverrides(device="cpu").apply(
        TA([TE.UnresolvedColumn("c0")], [TE.Alias(TC(), "n")], TS(rbs)))
    assert tpp.fallback_nodes() == jpp.fallback_nodes() \
        == ["HashAggregateExec"]
    want = collections.Counter(
        None if r is None else r["a"] for r in rbs[0].column(0).to_pylist())
    got = {(None if r["c0"] is None else r["c0"]["a"]): r["n"]
           for r in tpp.collect().to_pylist()}
    assert got == dict(want)


def test_explode_nested_passthrough_falls_back():
    got, pp = _both(lambda E, dt, S, P, F, G, rbs: G(
        E.UnresolvedColumn("c0"), S(rbs)),
        [ArrayGen(LongGen()), ArrayGen(IntegerGen())], n=60)
    assert pp.fallback_nodes() == ["GenerateExec"]


def test_struct_key_through_the_hash_exchange():
    """Grouping by a struct behind a 4-way exchange: both on the CPU,
    the struct hashed field by field (Spark's Murmur3 of a struct)."""
    from spark_rapids_tpu_torch.session import GpuSession
    rb = gen_table([StructGen([("a", IntegerGen(min_val=0, max_val=4)),
                               ("b", StringGen(max_len=2))]),
                    LongGen()], 300, seed=19, names=["s", "v"])
    s = GpuSession({"spark.sql.shuffle.partitions": "4"}, device="cpu")
    df = s.create_dataframe(pa.Table.from_batches([rb])).group_by(
        TE.UnresolvedColumn("s")).agg(TE.Alias(TC(), "n"))
    pp = df._plan()
    assert set(pp.fallback_nodes()) == {"HashAggregateExec",
                                        "ShuffleExchangeExec"}
    want = collections.Counter(
        None if r is None else (r["a"], r["b"])
        for r in rb.column(0).to_pylist())
    got = {(None if r["s"] is None else (r["s"]["a"], r["s"]["b"])): r["n"]
           for r in pp.collect().to_pylist()}
    assert got == dict(want)


def test_window_partitioned_by_a_struct_is_placed_on_the_cpu():
    from spark_rapids_tpu_torch.exec.window import GpuWindowExec
    from spark_rapids_tpu_torch.expr.window import (RowNumber,
                                                    WindowExpression)
    rb = gen_table([StructGen([("a", IntegerGen(min_val=0, max_val=3))]),
                    LongGen(nullable=False)], 50, seed=4)
    we = WindowExpression(RowNumber(), [TE.UnresolvedColumn("c0")],
                          [TO(TE.UnresolvedColumn("c1"))])
    plan = GpuWindowExec([TE.Alias(we, "rn")], TS([rb]))
    pp = GpuOverrides(device="cpu").apply(plan)
    assert pp.fallback_nodes() == ["WindowExec"]
    # each struct value's rows numbered 1.. in c1's order
    rows = pp.collect().to_pylist()
    by_key = collections.defaultdict(list)
    for r in rows:
        key = None if r["c0"] is None else ("struct", r["c0"]["a"])
        by_key[key].append((r["c1"], r["rn"]))
    assert len(rows) == rb.num_rows
    for seq in by_key.values():
        assert [rn for _, rn in sorted(seq)] == list(range(1, len(seq) + 1))


def test_explode_past_int32_raises_naming_item_14():
    """An outer explode whose empty rows push one batch's output past an
    int32 row index: the split is ROADMAP item 14's."""
    from spark_rapids_tpu_torch.columnar.batch import GpuBatch
    from spark_rapids_tpu_torch.columnar.column import GpuColumnVector
    from spark_rapids_tpu_torch.expr.base import EvalCtx
    n = 8
    offsets = torch.full((n + 1,), (1 << 31) - 1, dtype=torch.int32)
    offsets[0] = 0
    arr = GpuColumnVector(tdt.ArrayType(tdt.INT32), None, None, offsets,
                          children=[GpuColumnVector(
                              tdt.INT32, torch.zeros(4, dtype=torch.int32))])
    schema = tdt.Schema([tdt.StructField("a", arr.dtype)])
    rb = pa.record_batch({"a": pa.array([[1]], pa.list_(pa.int32()))})
    ex = TG(TE.UnresolvedColumn("a"), TS([rb], schema), outer=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        ex._stage_a(GpuBatch([arr], schema, n), EvalCtx())

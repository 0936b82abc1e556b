"""The SQL slice on the CPU: ``GpuSession.sql`` over Parquet files
against the JAX package's ``TpuSession`` on the same files.

Every ``SQL_QUERIES`` text parses to the same AST in both packages.
q3 and q55 (and q42, q52, which need nothing unported) run from SQL text
with device page decode on, over files written to ``tmp_path`` at
``n_sales = 1 << 14``, at ``spark.sql.shuffle.partitions`` 1 and 16,
against the reference's runs at the same settings: the integer columns
and the row order equal, the float sums within rel 1e-9, and the scans'
chunk counters equal. The numpy/pyarrow oracle
agrees too. A query with an unported construct raises; an operator
the conf disables runs on the CPU."""
import math

import pytest

from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.planner import TpuOverrides
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.sql import parse_statement as jparse
from spark_rapids_tpu.tools import nds as jnds
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.session import GpuSession
from spark_rapids_tpu_torch.sql import SqlAnalysisError, SqlParseError
from spark_rapids_tpu_torch.sql import parse_statement as tparse
from torch_dual_run import assert_same_rows

N_SALES = 1 << 14
RTOL = 1e-9
RUNS = [(q, p) for q in ("q3", "q55", "q42", "q52") for p in (1, 16)]


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


def _scan_chunks(metrics):
    """Sorted (deviceChunks, fallbackChunks) of every scan."""
    return sorted((m["deviceChunks"].value, m["fallbackChunks"].value)
                  for label, m in metrics.items()
                  if label.startswith("FileScanExec"))


@pytest.fixture(scope="module")
def reference(paths):
    """The JAX package's rows and scan counters for every run."""
    out = {}
    for parts in sorted({p for _, p in RUNS}):
        s = TpuSession(conf={"spark.sql.shuffle.partitions": str(parts)})
        jnds.register_frames(s, {k: s.read_parquet(p)
                                 for k, p in paths.items()})
        for q, p in RUNS:
            if p != parts:
                continue
            pp = TpuOverrides(s.conf).apply(s.sql(jnds.SQL_QUERIES[q])._node)
            ctx = JCtx(s.conf)
            out[q, p] = pp.collect(ctx), _scan_chunks(ctx.metrics)
    return out


def _port(paths, q, parts, **conf):
    conf["spark.sql.shuffle.partitions"] = str(parts)
    s = GpuSession(conf, device="cpu")
    nds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    pp = GpuOverrides(s.conf, s.device).apply(s.sql(nds.SQL_QUERIES[q])._node)
    ctx = TCtx(s.conf, "cpu")
    return pp.collect(ctx), _scan_chunks(ctx.metrics)


def _same_rows(got, want, floats):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows > 0
    for name in got.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if name in floats:
            assert all(math.isclose(a, b, rel_tol=RTOL)
                       for a, b in zip(g, w)), (name, g, w)
        else:
            assert g == w, name


@pytest.mark.parametrize("name", sorted(nds.SQL_QUERIES))
def test_every_corpus_text_parses_to_the_reference_ast(name):
    text = nds.SQL_QUERIES[name]
    assert text == jnds.SQL_QUERIES[name]
    assert repr(tparse(text)) == repr(jparse(text))


@pytest.mark.parametrize("q,parts", RUNS,
                         ids=[f"{q}-p{p}" for q, p in RUNS])
def test_sql_query_matches_the_reference(paths, tables, reference, q, parts):
    got, chunks = _port(paths, q, parts)
    want, want_chunks = reference[q, parts]
    _same_rows(got, want, nds.FLOAT_COLUMNS[q])
    _same_rows(got, nds.oracle(q, tables), nds.FLOAT_COLUMNS[q])
    assert chunks == want_chunks
    assert all(fb == 0 and dev > 0 for dev, fb in chunks)


@pytest.mark.parametrize("aqe", ["true", "false"])
def test_partitions_and_adaptive_reader_give_the_same_rows(paths, tables,
                                                            aqe):
    want = nds.oracle("q3", tables)
    for parts in (1, 16):
        got, _ = _port(paths, "q3", parts,
                       **{"spark.sql.adaptive.enabled": aqe})
        _same_rows(got, want, nds.FLOAT_COLUMNS["q3"])


def test_the_plan_has_the_exchange_and_the_adaptive_reader(paths):
    s = GpuSession({"spark.sql.shuffle.partitions": "16"}, device="cpu")
    nds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    pp = GpuOverrides(s.conf, s.device).apply(
        s.sql(nds.SQL_QUERIES["q3"])._node)
    tree = pp.root.tree_string()
    assert "AQEShuffleReadExec" in tree
    assert "ShuffleExchangeExec [HashPartitioning n=16]" in tree
    assert tree.count("ShuffledHashJoinExec") == 2
    assert "GlobalLimitExec [10]" in tree and "SortExec" in tree
    text = s.sql("EXPLAIN " + nds.SQL_QUERIES["q3"])
    assert "will run on GPU" in text and "cannot" not in text


# the construct each query's first raise names; q7, q_pivot,
# q_in_between, q_not_or and q_customer_age's constructs (avg, CASE, IN,
# NOT, CAST), and q_union's, q_rank's, q_rownum's and q_rolling's (UNION
# ALL, windows) are ported, and those queries now compile and run
UNPORTED = {
    "q_like": "LIKE", "q7": "avg", "q_pivot": "CASE",
    "q_union": "UNION", "q_rank": "window", "q_in_between": "IN (",
    "q_not_or": "NOT", "q_customer_age": "CAST",
    "q_percentile": "approx_percentile", "q_rownum": "window",
    "q_rolling": "window", "q97": "duplicated",
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_constructs_raise_and_name_their_item(paths, name):
    s = GpuSession(device="cpu")
    nds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    if name in nds.PORTED_QUERIES:
        assert s.sql(nds.SQL_QUERIES[name]).collect().num_rows > 0
        return
    with pytest.raises((SqlAnalysisError, NotImplementedError)) as e:
        s.sql(nds.SQL_QUERIES[name]).collect()
    if isinstance(e.value, SqlAnalysisError):
        assert e.value.detail == "unsupported_feature"
    assert "ROADMAP item" in str(e.value)
    assert UNPORTED[name].lower() in str(e.value).lower()


def test_errors_keep_the_reference_slugs(paths):
    s = GpuSession(device="cpu")
    nds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    with pytest.raises(SqlParseError):
        s.sql("SELECT FROM WHERE")
    with pytest.raises(SqlAnalysisError) as e:
        s.sql("SELECT no_such_column FROM item")
    assert e.value.detail == "unknown_column"
    with pytest.raises(SqlAnalysisError) as e:
        s.sql("SELECT frobnicate(i_brand_id) FROM item")
    assert e.value.detail == "unknown_function"
    # a FROM item no equality joins raised naming ROADMAP item 9 until
    # the nested-loop join was ported: it is a cross join, held to the
    # reference's rows
    from torch_dual_run import dual_run
    got, _ = dual_run("SELECT i_item_sk FROM item, date_dim", paths)
    assert got.num_rows == 200 * 730


def test_unported_dataframe_methods_raise(paths, tmp_path):
    s = GpuSession(device="cpu")
    df = s.read_parquet(paths["item"])
    # cache() is ported (the spill catalog): tests/test_torch_out_of_core.py;
    # explode too (tests/test_torch_nested_exprs.py), which refuses a
    # string column as the reference's does; sample and write raised
    # naming ROADMAP item 13 until they were ported: they run now, held
    # to the reference (tests/test_torch_expand_sample.py,
    # tests/test_torch_write_read.py)
    from spark_rapids_tpu.session import TpuSession
    ref = TpuSession().read_parquet(paths["item"])
    assert df.sample(0.5, seed=3).collect().equals(
        ref.sample(0.5, seed=3).collect())
    files = df.write(str(tmp_path / "out"))
    assert s.read_parquet(files).collect().equals(df.collect())
    with pytest.raises(TypeError, match="array/map"):
        df.explode("i_category")


def test_a_disabled_operator_raises_instead_of_falling_back(paths,
                                                            tables):
    """It raised until the CPU fallback was ported: the disabled sort
    now runs on the CPU between transitions, and q3 still equals its
    oracle."""
    s = GpuSession({"spark.rapids.sql.exec.SortExec": "false"},
                   device="cpu")
    nds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    pp = GpuOverrides(s.conf, s.device).apply(
        s.sql(nds.SQL_QUERIES["q3"])._node)
    assert pp.fallback_nodes() == ["SortExec"]
    assert_same_rows(pp.collect(), nds.oracle("q3", tables), ordered=True)


def test_dataframe_api_runs_q55(paths, tables):
    from spark_rapids_tpu_torch.expr import (And, GreaterThanOrEqual,
                                             LessThan, Literal, Sum,
                                             UnresolvedColumn as col)
    from spark_rapids_tpu_torch.expr.base import Alias
    s = GpuSession({"spark.sql.shuffle.partitions": "4"}, device="cpu")
    ss, it = s.read_parquet(paths["store_sales"]), s.read_parquet(
        paths["item"])
    it = it.filter(And(GreaterThanOrEqual(col("i_manufact_id"), Literal(20)),
                       LessThan(col("i_manufact_id"), Literal(40)))) \
        .select("i_item_sk", "i_brand_id")
    df = (ss.select("ss_item_sk", "ss_ext_sales_price")
          .join(it, on=[("ss_item_sk", "i_item_sk")], build_unique=True)
          .group_by("i_brand_id")
          .agg(Alias(Sum(col("ss_ext_sales_price")), "rev"))
          .order_by("rev", "i_brand_id", ascending=[False, True])
          .limit(20))
    _same_rows(df.collect(), nds.oracle("q55", tables),
               nds.FLOAT_COLUMNS["q55"])


@pytest.mark.parametrize("q", ["q3", "q55"])
def test_sql_over_in_memory_tables(tables, q):
    """``build_query_sql`` registers the tables as in-memory frames (the
    host-batch source, strings included) instead of files."""
    s = GpuSession({"spark.sql.shuffle.partitions": "3"}, device="cpu")
    got = nds.build_query_sql(q, s, tables).collect()
    _same_rows(got, nds.oracle(q, tables), nds.FLOAT_COLUMNS[q])

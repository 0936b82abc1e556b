"""The NDS corpus from SQL on the CPU: every query the port runs
(``nds.PORTED_QUERIES``: q3, q42, q52, q55, q96, q_topn, q7, q_pivot,
q_customer_age, q_price_band, q_cte, q_having, q_in_between, q_agg_expr,
q_not_or, q_rank, q_rownum, q_rolling, q_union) at
``spark.sql.shuffle.partitions`` 1 and 16, over Parquet
files of ``n_sales = 1 << 14`` written to a temporary directory, held to
the JAX package through the dual-run assert (``torch_dual_run``: names
and Arrow types equal, ints, strings and nulls exact, floats rel 1e-9,
row order exact where the query orders it, the scans' chunk counters
equal) and to the port's numpy/pyarrow oracle (``nds.oracle``, the same
tolerance). The other three raise ``SqlAnalysisError
("unsupported_feature")`` or ``NotImplementedError`` naming their ROADMAP
item, and never run another way."""
import pytest

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.sql import SqlAnalysisError
from torch_dual_run import assert_same_rows, dual_run

N_SALES = 1 << 14
RUNS = [(q, p) for q in nds.PORTED_QUERIES for p in (1, 16)]


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


@pytest.mark.parametrize("q,parts", RUNS, ids=[f"{q}-p{p}" for q, p in RUNS])
def test_query_matches_reference_and_oracle(paths, tables, q, parts):
    got, _ = dual_run(nds.SQL_QUERIES[q], paths,
                      {"spark.sql.shuffle.partitions": str(parts)})
    assert got.num_rows > 0
    assert_same_rows(got, nds.oracle(q, tables), ordered=True, label=q)


def test_ansi_mode_gives_the_reference_rows(paths):
    """Under ``spark.sql.ansi.enabled`` the reference's device path gives
    the same values (its raises live in its host path), and so does the
    port: ``/`` and the casts of q_agg_expr and q_customer_age."""
    for q in ("q_agg_expr", "q_customer_age", "q_having"):
        dual_run(nds.SQL_QUERIES[q], paths,
                 {"spark.sql.ansi.enabled": "true"})


@pytest.mark.parametrize("name", sorted(nds.UNPORTED_QUERIES))
def test_unported_queries_raise_naming_their_item(paths, name):
    s = nds.session_over_files(paths, device="cpu")
    with pytest.raises((SqlAnalysisError, NotImplementedError)) as e:
        s.sql(nds.SQL_QUERIES[name]).collect()
    if isinstance(e.value, SqlAnalysisError):
        assert e.value.detail == "unsupported_feature"
    assert f"ROADMAP item {nds.UNPORTED_QUERIES[name]})" in str(e.value) \
        or f"ROADMAP item {nds.UNPORTED_QUERIES[name]} " in str(e.value)


def test_the_corpus_is_split_in_two():
    assert set(nds.PORTED_QUERIES) | set(nds.UNPORTED_QUERIES) \
        == set(nds.SQL_QUERIES)
    assert not set(nds.PORTED_QUERIES) & set(nds.UNPORTED_QUERIES)

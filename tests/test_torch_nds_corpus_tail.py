"""The NDS corpus from SQL on the CPU, the last queries (q_in_between,
q_percentile, q97, q_like) at ``spark.sql.shuffle.partitions`` 1 and 16,
each held to the JAX package through the dual-run assert and to
``nds.oracle`` by ``nds_corpus.check_query``; an ANSI run; and the
corpus's bounds. The other queries are in
``tests/test_torch_nds_corpus_*.py``, one group a file
(``nds_corpus.GROUPS``), over the same tables: ``n_sales = 1 << 14``
written to Parquet files in a temporary directory. SQL constructs the
port does not run yet raise ``SqlAnalysisError("unsupported_feature")``
or ``NotImplementedError`` naming their ROADMAP item, and never run
another way; the RIGHT and FULL OUTER JOIN cases of that test raised
until the outer joins were ported and now hold the port's rows to the
reference's, and its LIKE patterns outside the device dialect raised
until the CPU fallback was ported and now run on the CPU."""
import pytest

from nds_corpus import GROUPS, check_query, paths, runs, tables  # noqa: F401
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.sql import SqlAnalysisError
from spark_rapids_tpu_torch.planner import GpuOverrides
from torch_dual_run import assert_same_rows, dual_run, run_reference


@runs("tail")
def test_query_matches_reference_and_oracle(paths, tables, q, parts):
    check_query(paths, tables, q, parts)


def test_ansi_mode_gives_the_reference_rows(paths):
    """Under ``spark.sql.ansi.enabled`` the reference's device path gives
    the same values (its raises live in its host path), and so does the
    port: ``/`` and the casts of q_agg_expr and q_customer_age."""
    for q in ("q_agg_expr", "q_customer_age", "q_having"):
        dual_run(nds.SQL_QUERIES[q], paths,
                 {"spark.sql.ansi.enabled": "true"})


# raised naming ROADMAP item 9 until the outer joins were ported: held
# to the reference's rows since
PORTED_SINCE = {
    "right_outer_join": "SELECT ss_item_sk, i_brand_id FROM store_sales "
                        "RIGHT JOIN item ON ss_item_sk = i_item_sk",
    "full_outer_join": "SELECT ss_item_sk, i_brand_id FROM store_sales "
                       "FULL OUTER JOIN item ON ss_item_sk = i_item_sk",
}
# raised naming ROADMAP item 12 until the CPU fallback was ported: the
# filter runs on the CPU, held to the reference's all-CPU rows
FALLBACK_SINCE = {
    "non_ascii_like": "SELECT i_item_sk FROM item "
                      "WHERE i_category LIKE '%é%'",
    "like_over_64_positions": "SELECT i_item_sk FROM item "
                              "WHERE i_category LIKE '%a%b%c%d%%e'",
}
#: where each runs now: a non-ASCII LIKE of a literal shape on the
#: device since the SQL function slice (K6 takes the literal's bytes, as
#: the reference's literal kernels do), a pattern past 64 positions on
#: the CPU
FALLBACK_PLACEMENT = {"non_ascii_like": [],
                      "like_over_64_positions": ["FilterExec"]}
UNPORTED_SQL = {
    "union_distinct": ("SELECT s_state FROM store UNION "
                       "SELECT s_state FROM store", None),
}


@pytest.mark.parametrize("name", sorted(list(UNPORTED_SQL)
                                       + list(FALLBACK_SINCE))
                         + sorted(PORTED_SINCE))
def test_unported_sql_raises_naming_its_item(paths, name):
    if name in PORTED_SINCE:
        got, _ = dual_run(PORTED_SINCE[name], paths)
        assert got.num_rows > 0
        return
    if name in FALLBACK_SINCE:
        sql = FALLBACK_SINCE[name]
        s = nds.session_over_files(paths, device="cpu")
        pp = GpuOverrides(s.conf, s.device).apply(s.sql(sql)._node)
        assert pp.fallback_nodes() == FALLBACK_PLACEMENT[name]
        want, _ = run_reference(sql, paths,
                                {"spark.rapids.sql.enabled": "false"})
        assert_same_rows(pp.collect(), want, ordered=False)
        return
    sql, item = UNPORTED_SQL[name]
    s = nds.session_over_files(paths, device="cpu")
    with pytest.raises((SqlAnalysisError, NotImplementedError)) as e:
        s.sql(sql).collect()
    if isinstance(e.value, SqlAnalysisError):
        assert e.value.detail == "unsupported_feature"
    if item is not None:
        assert f"ROADMAP item {item}" in str(e.value), str(e.value)


def test_list_percentile_raises_naming_item_2(paths):
    """A list of percentages returns an array (the SQL dialect has no
    array literal, so it comes through the DataFrame API): it no longer
    raises, and equals the reference's."""
    from spark_rapids_tpu_torch.expr import Alias, UnresolvedColumn
    from spark_rapids_tpu_torch.expr.aggregates import ApproxPercentile
    s = nds.session_over_files(paths, device="cpu")
    df = s.table("store_sales").group_by(UnresolvedColumn("ss_store_sk"))
    got = df.agg(Alias(ApproxPercentile(UnresolvedColumn("ss_sales_price"),
                                        [0.25, 0.5]), "p")).collect()
    from spark_rapids_tpu.expr import Alias as JAlias
    from spark_rapids_tpu.expr import UnresolvedColumn as JCol
    from spark_rapids_tpu.expr.aggregates import \
        ApproxPercentile as JApproxPercentile
    from spark_rapids_tpu.session import TpuSession
    js = TpuSession()
    want = js.read_parquet(paths["store_sales"]).group_by(
        JCol("ss_store_sk")).agg(JAlias(JApproxPercentile(
            JCol("ss_sales_price"), [0.25, 0.5]), "p")).collect()
    assert_same_rows(got, want, ordered=False)


def test_the_corpus_is_split_in_two():
    assert set(nds.PORTED_QUERIES) | set(nds.UNPORTED_QUERIES) \
        == set(nds.SQL_QUERIES)
    assert not set(nds.PORTED_QUERIES) & set(nds.UNPORTED_QUERIES)


def test_every_ported_query_has_one_file():
    grouped = [q for g in GROUPS.values() for q in g]
    assert sorted(grouped) == sorted(nds.PORTED_QUERIES)

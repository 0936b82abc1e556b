"""The NDS corpus from SQL on the CPU, the window and UNION ALL queries (q_rank,
q_rownum, q_rolling, q_union), at
``spark.sql.shuffle.partitions`` 1 and 16: each held to the JAX package
through the dual-run assert and to ``nds.oracle`` by
``nds_corpus.check_query``."""
from nds_corpus import check_query, paths, runs, tables  # noqa: F401


@runs("window")
def test_query_matches_reference_and_oracle(paths, tables, q, parts):
    check_query(paths, tables, q, parts)

"""The NDS corpus from SQL on the CPU, the queries of casts, CASE and averages (q7,
q_pivot, q_customer_age, q_price_band), at
``spark.sql.shuffle.partitions`` 1 and 16: each held to the JAX package
through the dual-run assert and to ``nds.oracle`` by
``nds_corpus.check_query``."""
from nds_corpus import check_query, paths, runs, tables  # noqa: F401


@runs("expr")
def test_query_matches_reference_and_oracle(paths, tables, q, parts):
    check_query(paths, tables, q, parts)

"""Shared parts of the NDS corpus tests (``tests/test_torch_nds_corpus_*``):
the tables at ``n_sales = 1 << 14`` and their Parquet files, the query
groups the files split the corpus into, and the check every query run
makes. The JAX package's compiles on the CPU take most of a run's time,
so each file holds a few queries, both partition counts of a query in
one file (one worker), and pytest-xdist's workers (``--dist loadfile``)
run the files side by side."""
import pytest

from spark_rapids_tpu_torch import nds
from torch_dual_run import assert_same_rows, dual_run

N_SALES = 1 << 14

# one group a file, in the corpus's order
GROUPS = {
    "reports": ["q3", "q42", "q52", "q55", "q96", "q_topn"],
    "expr": ["q7", "q_pivot", "q_customer_age", "q_price_band"],
    "filters": ["q_cte", "q_having", "q_agg_expr", "q_not_or"],
    "window": ["q_rank", "q_rownum", "q_rolling", "q_union"],
    "tail": ["q_in_between", "q_percentile", "q97", "q_like"],
}


def runs(group: str):
    """``pytest.mark.parametrize`` of a group's queries at partitions 1
    and 16, with the case ids ``<query>-p<partitions>``."""
    rs = [(q, p) for q in GROUPS[group] for p in (1, 16)]
    return pytest.mark.parametrize("q,parts", rs,
                                   ids=[f"{q}-p{p}" for q, p in rs])


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))


def check_query(paths, tables, q: str, parts: int) -> None:
    """``q`` at ``parts`` partitions through the dual-run assert, and
    held to the oracle; a float column that is no sum or average
    (``nds.FLOAT_COLUMNS``) exactly."""
    got, ref = dual_run(nds.SQL_QUERIES[q], paths,
                        {"spark.sql.shuffle.partitions": str(parts)})
    assert got.num_rows > 0
    want = nds.oracle(q, tables)
    assert_same_rows(got, want, ordered=True, label=q)
    for name in got.column_names:
        if name not in nds.FLOAT_COLUMNS[q]:
            assert got.column(name).to_pylist() \
                == ref.column(name).to_pylist() \
                == want.column(name).to_pylist(), (q, name)

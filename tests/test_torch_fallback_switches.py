"""The fallback switches on the CPU, the port against the reference's
all-CPU rows (``tests/torch_fallback_cases.py``), at 2^12 store_sales
rows and ``spark.sql.shuffle.partitions`` 4:

- every operator of the port, under its own
  ``spark.rapids.sql.exec.<Name>=false``, on a corpus or ``nds_joins``
  text that has it (``HostBatchSourceExec``, ``LocalLimitExec`` and
  ``CartesianProductExec``, which no text plans, on a plan built by
  hand, against pyarrow): the rows, and ``fallback_nodes()`` equal to
  the reference's placement;
- one ``spark.rapids.sql.expression.<Name>=false`` from each ``expr/``
  module, the same way (``math`` and ``datetime`` too, and the string
  functions and moments of the SQL function slice, on texts the
  reference's SQL also runs);
- the 22 corpus texts and the nine join texts under
  ``spark.rapids.sql.enabled=false``: every node on the CPU, no device
  at all.

Tolerance: ints, strings and nulls exact, floats rel 1e-9."""
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.exec.joins import GpuCartesianProductExec
from spark_rapids_tpu_torch.exec.sort import GpuLocalLimitExec
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.tools import nds_joins
from torch_dual_run import assert_same_rows
from torch_fallback_cases import N_SALES, check_text

PARTS = {"spark.sql.shuffle.partitions": "4"}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(N_SALES),
                            str(tmp_path_factory.mktemp("nds")))


#: texts of the SQL function slice the reference's SQL also runs
FUNCTION_TEXTS = {
    "fn_math": "SELECT ss_store_sk, SUM(SQRT(ss_sales_price)) AS s, "
               "SUM(FLOOR(ss_net_profit)) AS f FROM store_sales "
               "GROUP BY ss_store_sk",
    "fn_dates": "SELECT y, m, COUNT(*) AS n FROM (SELECT YEAR(DATE_ADD("
                "CAST('2000-01-01' AS DATE), ss_sold_date_sk)) AS y, "
                "MONTH(DATE_ADD(CAST('2000-01-01' AS DATE), "
                "ss_sold_date_sk)) AS m FROM store_sales) t GROUP BY y, m",
    "fn_strings": "SELECT SUBSTR(i_category, 1, 3) AS p, UPPER(i_category) "
                  "AS u, COUNT(*) AS n FROM store_sales JOIN item ON "
                  "ss_item_sk = i_item_sk GROUP BY SUBSTR(i_category, 1, "
                  "3), UPPER(i_category)",
    "fn_moments": "SELECT ss_store_sk, STDDEV_SAMP(ss_net_profit) AS sd "
                  "FROM store_sales GROUP BY ss_store_sk",
}


def _sql(q: str) -> str:
    return FUNCTION_TEXTS.get(q) or nds.SQL_QUERIES.get(q) \
        or nds_joins.SQL_QUERIES[q]


# an operator the port plans from SQL -> a text that has it
OPERATOR_TEXTS = {
    "FileScanExec": "q3", "FilterExec": "q3", "ProjectExec": "q3",
    "HashAggregateExec": "q3", "ShuffleExchangeExec": "q3",
    "ShuffledHashJoinExec": "q3", "SortExec": "q3",
    "GlobalLimitExec": "q3", "WindowExec": "q_rank",
    "UnionExec": "q_union", "BroadcastNestedLoopJoinExec": "q_band_year",
}


@pytest.mark.parametrize("name", sorted(OPERATOR_TEXTS))
def test_each_operator_under_its_switch(paths, name):
    conf = dict(PARTS, **{f"spark.rapids.sql.exec.{name}": "false"})
    pp = check_text(_sql(OPERATOR_TEXTS[name]), paths, conf, label=name)
    assert name in pp.fallback_nodes()
    assert set(pp.fallback_nodes()) == {name}


def _limit(rb, n):
    return GpuLocalLimitExec(n, tbase.HostBatchSourceExec([rb])), \
        pa.Table.from_batches([rb.slice(0, n)]), True


def _cross(rb, n):
    small = rb.slice(0, n).rename_columns(["b", "t"])
    plan = GpuCartesianProductExec(tbase.HostBatchSourceExec([rb]),
                                   tbase.HostBatchSourceExec([small]))
    ia, ib = np.divmod(np.arange(rb.num_rows * n), n)
    want = pa.table({c: rb.column(c).take(ia) for c in ("a", "s")}
                    | {c: small.column(c).take(ib) for c in ("b", "t")})
    return plan, want, False


# the operators no SQL text plans, on a plan built by hand
HAND_BUILT = {"HostBatchSourceExec": _limit, "LocalLimitExec": _limit,
              "CartesianProductExec": _cross}


@pytest.mark.parametrize("name", sorted(HAND_BUILT))
def test_hand_built_operator_under_its_switch(name):
    """The switched node on the CPU, the rest on the device: a limit
    over a host source gives its first rows, the cross join every pair
    (as a multiset)."""
    rng = np.random.default_rng(3)
    rb = pa.record_batch({"a": pa.array(rng.integers(0, 9, 50)),
                          "s": pa.array([str(v) for v in range(50)])})
    plan, want, ordered = HAND_BUILT[name](rb, 7)
    conf = RapidsConf({f"spark.rapids.sql.exec.{name}": "false"})
    pp = GpuOverrides(conf, "cpu").apply(plan)
    assert pp.fallback_nodes() == [name]
    assert_same_rows(pp.collect(), want, ordered=ordered)


# one expression from each expr/ module -> a text that evaluates it
EXPRESSION_TEXTS = {
    "Alias": "q3",                 # base
    "EqualTo": "q3",               # predicates
    "Multiply": "q_customer_age",  # arithmetic
    "Cast": "q_customer_age",      # cast
    "CaseWhen": "q_pivot",         # conditional
    "Like": "q_like",              # strings
    "Sum": "q3",                   # aggregates
    "Rank": "q_rank",              # window
    "Sqrt": "fn_math",             # math
    "Floor": "fn_math",            # math
    "Year": "fn_dates",            # datetime
    "DateAdd": "fn_dates",         # datetime
    "Substring": "fn_strings",     # strings, the incompat one
    "Upper": "fn_strings",         # strings
    "StddevSamp": "fn_moments",    # aggregates, item 8's rest
}


@pytest.mark.parametrize("name", sorted(EXPRESSION_TEXTS))
def test_each_expr_module_under_a_switch(paths, name):
    conf = dict(PARTS, **{f"spark.rapids.sql.expression.{name}": "false"})
    pp = check_text(_sql(EXPRESSION_TEXTS[name]), paths, conf, label=name)
    assert pp.fallback_nodes()
    assert name in pp.explain("NOT_ON_GPU")


ALL_TEXTS = list(nds.PORTED_QUERIES) + list(nds_joins.QUERIES)


@pytest.mark.parametrize("q", ALL_TEXTS)
def test_every_text_with_the_gpu_disabled(paths, q):
    conf = dict(PARTS, **{"spark.rapids.sql.enabled": "false"})
    pp = check_text(_sql(q), paths, conf, label=q)
    assert pp.fallback_nodes() and not pp.root_on_device
    assert "will run on GPU" not in pp.explain("ALL")


@pytest.mark.parametrize("allow", ["true", "false"])
def test_incompatible_ops_place_substring_as_the_reference(paths, allow):
    """``Substring`` is ``incompat`` (bytes on the device): under
    ``spark.rapids.sql.incompatibleOps.enabled=false`` its operator runs
    on the CPU, cutting characters, as the reference places it."""
    conf = dict(PARTS, **{"spark.rapids.sql.incompatibleOps.enabled":
                          allow})
    pp = check_text(_sql("fn_strings"), paths, conf, label=allow)
    assert bool(pp.fallback_nodes()) == (allow == "false")

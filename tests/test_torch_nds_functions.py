"""The SQL function registry end to end on the CPU: the ten texts of
``spark_rapids_tpu_torch/tools/nds_functions.py`` (``chip_smoke.py``
phase 13's), every name of the reference's registry, and the re-anchor
probe's seven texts that only the reference ran.

- Each text at 2^12 ``store_sales`` rows and 1 and 4 partitions over
  Parquet files: its rows held to the module's oracle
  (``nds_functions.check``: ints, strings and dates exact, floats rel
  1e-9, FIRST/LAST after a join to a value of their group) and its
  ``fallback_nodes()`` to ``FALLBACK``; where the reference's SQL runs
  the text, at 1 partition to the reference too
  (``torch_dual_run.dual_run``; its runs' compiles take most of the
  file's time). The
  reference's SQL cannot run ``q_fn_match``, ``q_fn_dates``,
  ``q_fn_math`` and ``q_fn_host``: its builders hand ``startswith``,
  ``trunc``, ``replace`` and the others expressions where its
  constructors take Python values, and its math asserts a double input
  (``pow(x, 2)``); those functions are held to the reference
  expression by expression in ``tests/test_torch_functions_*.py``.
- Every name of the reference's ``_scalar_table`` and ``_agg_table``
  builds and runs in the port; ``collect_list``/``collect_set`` build
  and equal the reference's arrays.
- MIN/MAX over a string, STDDEV, FIRST, UPPER, ROUND and CAST to string
  equal the reference, and so does COUNT(1).
"""
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.tools import nds_functions as fn
from torch_dual_run import dual_run

N_SALES = 1 << 12
#: the texts the reference's SQL runs
REFERENCE_RUNS = ("q_fn_cv", "q_fn_moments", "q_fn_minmax_str",
                  "q_fn_window_moments", "q_fn_strings", "q_fn_casts")


@pytest.fixture(scope="module")
def tables():
    return nds.gen_tables(N_SALES)


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("fn")))


RUNS = [(q, p) for q in fn.QUERIES for p in (1, 4)]


@pytest.mark.parametrize("q,parts", RUNS, ids=[f"{q}-p{p}" for q, p in RUNS])
def test_function_texts_equal_their_oracle(tables, paths, q, parts):
    conf = {"spark.sql.shuffle.partitions": str(parts)}
    s = nds.session_over_files(paths, conf, device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(s.sql(fn.SQL_QUERIES[q])._node)
    assert pp.fallback_nodes() == fn.FALLBACK[q]
    got = pp.collect()
    fn.check(q, got, tables)
    if q in REFERENCE_RUNS and parts == 1:
        dual_run(fn.SQL_QUERIES[q], paths, conf)


#: an expression over the NDS tables for every scalar name of the
#: reference's registry
SCALAR_CALLS = {
    "abs": "abs(ss_net_profit)", "sqrt": "sqrt(ss_sales_price)",
    "cbrt": "cbrt(ss_net_profit)", "exp": "exp(ss_quantity / 50.0)",
    "ln": "ln(ss_sales_price)", "log": "log(ss_sales_price)",
    "log10": "log10(ss_sales_price)", "log2": "log2(ss_sales_price)",
    "pow": "pow(ss_net_profit, 2)", "power": "power(ss_quantity, 0.5)",
    "sin": "sin(ss_net_profit)", "cos": "cos(ss_net_profit)",
    "tan": "tan(ss_net_profit)", "asin": "asin(ss_quantity / 100.0)",
    "acos": "acos(ss_quantity / 100.0)", "atan": "atan(ss_net_profit)",
    "atan2": "atan2(ss_net_profit, ss_sales_price)",
    "floor": "floor(ss_net_profit)", "ceil": "ceil(ss_net_profit)",
    "ceiling": "ceiling(ss_net_profit)", "sign": "sign(ss_net_profit)",
    "signum": "signum(ss_quantity)", "round": "round(ss_quantity, -1)",
    "bround": "bround(ss_quantity, -1)", "isnan": "isnan(ss_net_profit)",
    "length": "length(i_category)", "char_length": "char_length(i_category)",
    "upper": "upper(i_category)", "ucase": "ucase(i_category)",
    "lower": "lower(i_category)", "lcase": "lcase(i_category)",
    "substring": "substring(i_category, 2, 3)",
    "substr": "substr(i_category, -3, 2)",
    "concat": "concat(i_category, '/', i_category)",
    "trim": "trim(i_category)", "ltrim": "ltrim(i_category)",
    "rtrim": "rtrim(i_category)",
    "replace": "replace(i_category, 'o', 'OO')",
    "locate": "locate('o', i_category, 2)",
    "lpad": "lpad(i_category, 9, '.')", "rpad": "rpad(i_category, 9, '.')",
    "repeat": "repeat(i_category, 2)", "reverse": "reverse(i_category)",
    "startswith": "startswith(i_category, 'Bo')",
    "endswith": "endswith(i_category, 'ics')",
    "contains": "contains(i_category, 'o')",
    "coalesce": "coalesce(ss_quantity, 0)",
    "nullif": "nullif(ss_quantity, 5)", "least": "least(ss_quantity, 50)",
    "greatest": "greatest(ss_quantity, 50)",
    "if": "if(ss_quantity > 50, 'big', 'small')",
    "year": "year(date_add(cast('2000-01-01' as date), ss_quantity))",
    "month": "month(date_add(cast('2000-01-01' as date), ss_quantity))",
    "day": "day(date_add(cast('2000-01-01' as date), ss_quantity))",
    "dayofmonth": "dayofmonth(cast('2000-02-29' as date))",
    "quarter": "quarter(date_add(cast('2000-01-01' as date), ss_quantity))",
    "dayofweek": "dayofweek(cast('2000-02-29' as date))",
    "weekday": "weekday(cast('2000-02-29' as date))",
    "dayofyear": "dayofyear(cast('2000-12-31' as date))",
    "last_day": "last_day(cast('2000-02-10' as date))",
    "hour": "hour(cast('2000-02-10 10:11:12' as timestamp))",
    "minute": "minute(cast('2000-02-10 10:11:12' as timestamp))",
    "second": "second(cast('2000-02-10 10:11:12' as timestamp))",
    "date_add": "date_add(cast('2000-01-31' as date), ss_quantity)",
    "date_sub": "date_sub(cast('2000-01-31' as date), ss_quantity)",
    "datediff": "datediff(cast('2000-03-01' as date), "
                "cast('2000-02-01' as date))",
    "add_months": "add_months(cast('2000-01-31' as date), ss_quantity)",
    "months_between": "months_between(cast('2000-03-31' as date), "
                      "cast('2000-02-29' as date))",
    "trunc": "trunc(cast('2000-05-17' as date), 'QUARTER')",
    "unix_timestamp": "unix_timestamp(cast('2000-01-01' as date))",
    "from_unixtime": "from_unixtime(ss_sold_date_sk)",
}
AGG_CALLS = {n: f"{n}(ss_net_profit)" for n in (
    "sum", "min", "max", "avg", "mean", "first", "last", "stddev",
    "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop")}
AGG_CALLS.update(count="count(ss_quantity)",
                 approx_percentile="approx_percentile(ss_quantity, 0.5)")


def test_every_registry_name_builds_and_runs(tables):
    from spark_rapids_tpu.sql import functions as jf
    from spark_rapids_tpu_torch.session import GpuSession
    assert set(SCALAR_CALLS) == set(jf.SCALAR_FUNCTIONS)
    assert set(AGG_CALLS) | {"collect_list", "collect_set"} == \
        set(jf.AGGREGATE_FUNCTIONS)
    s = GpuSession(device="cpu")
    nds.register_frames(s, {k: s.create_dataframe(v.slice(0, 64))
                            for k, v in tables.items()})
    cols = ", ".join(f"{call} AS c_{name}"
                     for name, call in SCALAR_CALLS.items())
    out = s.sql(f"SELECT {cols} FROM store_sales JOIN item "
                "ON ss_item_sk = i_item_sk").collect()
    assert out.num_columns == len(SCALAR_CALLS) and out.num_rows > 0
    aggs = ", ".join(f"{call} AS a_{name}" for name, call in AGG_CALLS.items())
    out = s.sql(f"SELECT ss_store_sk, {aggs} FROM store_sales "
                "GROUP BY ss_store_sk").collect()
    assert out.num_columns == len(AGG_CALLS) + 1 and out.num_rows > 0


@pytest.mark.parametrize("name", ["collect_list", "collect_set"])
def test_collects_name_item_2(tables, name):
    """They raised naming item 2 until the collects were ported: each
    builds from SQL and equals the reference's array."""
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import GpuSession
    sql = f"SELECT {name}(s_state) AS v FROM t"
    s = GpuSession(device="cpu")
    s.register_table("t", s.create_dataframe(tables["store"]))
    js = TpuSession()
    js.register_table("t", js.create_dataframe(tables["store"]))
    got, want = s.sql(sql).collect(), js.sql(sql).collect()
    assert got.schema.types == want.schema.types
    assert got.to_pylist() == want.to_pylist() and got.num_rows == 1


PROBE = {
    "min_max_string": "SELECT s_state, MIN(i_category) AS lo, "
                      "MAX(i_category) AS hi FROM store_sales JOIN item ON "
                      "ss_item_sk = i_item_sk JOIN store ON ss_store_sk = "
                      "s_store_sk GROUP BY s_state",
    "min_string_global": "SELECT MIN(i_category) AS lo, MAX(i_category) "
                         "AS hi FROM item",
    "stddev": "SELECT ss_store_sk, STDDEV(ss_net_profit) AS sd FROM "
              "store_sales GROUP BY ss_store_sk",
    "first": "SELECT FIRST(ss_net_profit) AS f, LAST(ss_quantity) AS l "
             "FROM store_sales",
    "upper": "SELECT UPPER(i_category) AS u, COUNT(*) AS n FROM item "
             "GROUP BY UPPER(i_category)",
    "round": "SELECT ss_store_sk, SUM(ROUND(ss_sales_price, 1)) AS r "
             "FROM store_sales GROUP BY ss_store_sk",
    "cast_string": "SELECT CAST(ss_quantity AS STRING) AS q, COUNT(*) AS n "
                   "FROM store_sales GROUP BY CAST(ss_quantity AS STRING)",
    # COUNT of a literal counts rows, nulls of the other columns included
    "count_literal": "SELECT ss_store_sk, COUNT(1) AS n, COUNT(*) AS m, "
                     "COUNT(ss_quantity) AS q FROM store_sales "
                     "GROUP BY ss_store_sk",
}


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("name", list(PROBE))
def test_probe_texts_equal_the_reference(paths, name, parts):
    conf = {"spark.sql.shuffle.partitions": str(parts)}
    got, _ = dual_run(PROBE[name], paths, conf)
    assert got.num_rows > 0
    if name == "count_literal":
        assert got.column("n").to_pylist() == got.column("m").to_pylist()
    if name == "first":
        # one partition of one batch: the order is the file's
        t = pa.concat_tables([pa.parquet.read_table(paths["store_sales"])])
        if parts == 1:
            assert got.column("f")[0].as_py() == \
                t.column("ss_net_profit")[0].as_py()

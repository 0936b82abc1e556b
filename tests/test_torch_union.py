"""UNION ALL on the CPU: ``GpuUnionExec``, the compiler's set operations
and ``DataFrame.union``, held to the JAX package through the dual-run
assert (``torch_dual_run``: one SQL text through both packages over the
same Parquet files; names and Arrow types equal, ints, strings and nulls
exact, floats rel 1e-9, the row order exact where the query orders it,
the scans' chunk counters equal). The files are the NDS tables at
``n_sales = 1 << 12``, written to a temporary directory."""
import pytest

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.session import GpuSession
from spark_rapids_tpu_torch.sql import SqlAnalysisError
from torch_dual_run import assert_same_rows, dual_run

N_SALES = 1 << 12


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return nds.write_tables(nds.gen_tables(N_SALES),
                            str(tmp_path_factory.mktemp("nds")))


def _port_session(paths):
    s = GpuSession(device="cpu")
    nds.register_frames(s, {k: s.read_parquet(p) for k, p in paths.items()})
    return s


TWO = """
SELECT s_store_sk AS k, s_state AS v FROM store WHERE s_store_sk < 5
UNION ALL
SELECT i_item_sk AS k, i_category AS v FROM item WHERE i_brand_id < 3
"""
THREE = """
SELECT d_year AS y, d_moy AS m FROM date_dim WHERE d_date_sk < 40
UNION ALL
SELECT d_year AS y, d_qoy AS m FROM date_dim WHERE d_date_sk > 700
UNION ALL
SELECT c_birth_year AS y, c_birth_year AS m FROM customer
WHERE c_customer_sk < 9
"""
# int32 with int64 and with double: each side widened under a project
WIDENING = """
SELECT i_brand_id AS a, i_current_price AS b FROM item WHERE i_item_sk < 30
UNION ALL
SELECT ss_item_sk, ss_quantity FROM store_sales WHERE ss_quantity > 97
"""
BY_NAME = """
SELECT s_state AS st, s_store_sk AS k FROM store
UNION ALL
SELECT s_state, s_store_sk + 100 FROM store
ORDER BY st, k DESC
"""
BY_POSITION = """
SELECT d_moy, d_year FROM date_dim WHERE d_date_sk < 100
UNION ALL
SELECT d_qoy, d_year FROM date_dim WHERE d_date_sk >= 600
ORDER BY 2 DESC, 1
LIMIT 17
"""
SQL = {"two": TWO, "three": THREE, "widening": WIDENING,
       "order_by_name": BY_NAME, "order_by_position": BY_POSITION}


@pytest.mark.parametrize("name", sorted(SQL))
def test_union_all_matches_the_reference(paths, name):
    got, _ = dual_run(SQL[name], paths)
    assert got.num_rows > 0


def test_the_first_sides_names_win(paths):
    """Sides named apart: the union's columns take the first side's
    names. The reference's device path yields each side's batches under
    that side's names, so its collect refuses the mixed schemas; the port
    is held to the reference's rows of the same query with the names
    made equal."""
    s = _port_session(paths)
    got = s.sql(THREE.replace("AS y, d_qoy AS m", ", d_qoy")
                .replace("c_birth_year AS y, c_birth_year AS m",
                         "c_birth_year, c_birth_year")).collect()
    _, want = dual_run(THREE, paths)
    assert got.column_names == ["y", "m"]
    assert_same_rows(got, want, ordered=False)


def test_widening_types(paths):
    got, _ = dual_run(WIDENING, paths)
    assert [str(t) for t in got.schema.types] == ["int64", "double"]


def test_nullability_is_the_or_of_the_sides(paths):
    """A literal is not nullable; a NULL on the other side makes the
    union's column nullable, as in Spark and the reference's plan. The
    reference's collect refuses this query (its device path yields the
    first side's batches as not nullable), so the rows are held to
    pyarrow's."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    sql = ("SELECT 1 AS x, s_state FROM store UNION ALL "
           "SELECT CAST(NULL AS INT), s_state FROM store")
    s = _port_session(paths)
    j = TpuSession()
    jnds.register_frames(j, {k: j.read_parquet(p) for k, p in paths.items()})
    assert s.sql(sql).schema.fields[0].nullable
    assert j.sql(sql).schema.fields[0].nullable
    both_literals = ("SELECT 1 AS x FROM store UNION ALL "
                     "SELECT 2 FROM store")
    assert s.sql(both_literals).schema.fields[0].nullable is False
    assert j.sql(both_literals).schema.fields[0].nullable is False
    got = s.sql(sql).collect()
    states = pq.read_table(paths["store"]).column("s_state").to_pylist()
    assert got.column("x").to_pylist() == [1] * 25 + [None] * 25
    assert got.column("s_state").to_pylist() == states * 2


@pytest.mark.parametrize("sql", [
    "SELECT s_store_sk FROM store UNION ALL "
    "SELECT s_store_sk, s_state FROM store",
    "SELECT s_state FROM store UNION ALL SELECT s_store_sk FROM store"],
    ids=["width", "types"])
def test_mismatched_sides_raise(paths, sql):
    with pytest.raises(SqlAnalysisError) as e:
        _port_session(paths).sql(sql)
    assert e.value.detail == "union_mismatch"


def test_union_distinct_is_outside_the_dialect(paths):
    with pytest.raises(SqlAnalysisError) as e:
        _port_session(paths).sql(
            "SELECT s_state FROM store UNION SELECT s_state FROM store")
    assert e.value.detail == "unsupported_feature"


def test_order_by_an_expression_over_a_union_raises(paths):
    with pytest.raises(SqlAnalysisError) as e:
        _port_session(paths).sql(
            "SELECT s_store_sk AS k FROM store UNION ALL "
            "SELECT s_store_sk FROM store ORDER BY k + 1")
    assert e.value.detail == "unsupported_feature"


def test_dataframe_union_matches_the_reference(paths):
    """``DataFrame.union`` by position; the reference's sides are named
    alike (its collect refuses sides named apart)."""
    from spark_rapids_tpu.exec.base import ExecCtx as JCtx
    from spark_rapids_tpu.expr import Alias as JAlias
    from spark_rapids_tpu.expr import UnresolvedColumn as jcol
    from spark_rapids_tpu.planner import TpuOverrides
    from spark_rapids_tpu.session import TpuSession
    s = _port_session(paths)
    a = s.table("store").select("s_store_sk", "s_state")
    b = s.table("item").select("i_item_sk", "i_category")
    got = a.union(b).collect()
    j = TpuSession()
    ja = j.read_parquet(paths["store"]).select("s_store_sk", "s_state")
    jb = j.read_parquet(paths["item"]).select(
        JAlias(jcol("i_item_sk"), "s_store_sk"),
        JAlias(jcol("i_category"), "s_state"))
    want = TpuOverrides(j.conf).apply(ja.union(jb)._node).collect(JCtx())
    assert_same_rows(got, want, ordered=True)
    assert got.num_rows == 25 + 200
    with pytest.raises(TypeError, match="union children schemas differ"):
        a.union(s.table("item").select("i_category", "i_item_sk"))

"""``GroupedData.pivot`` on the CPU against the JAX package: Spark's
rewrite into one ``If``-masked aggregate a pivot value, with explicit
values and with values inferred by one more query, one aggregate
(columns named by the value) and several (``value_aggname``), a
``count(*)``, a string and an integer pivot column and a null among its
values, at 1 and 16 partitions; each package's session over the same
table, the rows compared exactly as multisets (floats rel 1e-9). The
counterparts of the reference's ``tests/test_session.py:130-183``,
with pandas' pivot as their oracle too."""
import numpy as np
import pyarrow as pa
import pytest

from torch_dual_run import assert_same_rows

PARTS = ["1", "16"]


def _table():
    rng = np.random.default_rng(8)
    n = 400
    dept = rng.choice(["eng", "ops", "fin"], n).tolist()
    dept[5] = None
    return pa.table({
        "dept": pa.array(dept),
        "year": pa.array(rng.choice([2023, 2024], n)),
        "pay": pa.array(rng.integers(50, 200, n).astype("int64")),
        "bonus": pa.array(rng.uniform(0, 10, n)),
    })


def _sessions(parts):
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu_torch.session import GpuSession
    conf = {"spark.sql.shuffle.partitions": parts}
    return (GpuSession(conf, device="cpu"), TpuSession(dict(conf)))


def _both(parts, build):
    """``build(session, expr module, aggregates module)`` through both
    packages: (port's table, reference's table)."""
    import spark_rapids_tpu.expr as jexpr
    import spark_rapids_tpu.expr.aggregates as jagg
    import spark_rapids_tpu_torch.expr as texpr
    import spark_rapids_tpu_torch.expr.aggregates as tagg
    ts, js = _sessions(parts)
    t = _table()
    got = build(ts.create_dataframe(t), texpr, tagg).collect()
    want = build(js.create_dataframe(t), jexpr, jagg).collect()
    assert_same_rows(got, want, ordered=False)
    return got, want


@pytest.mark.parametrize("parts", PARTS)
def test_pivot_explicit_values(parts):
    def build(df, E, A):
        return df.group_by("dept").pivot("year", [2023, 2024]).agg(
            E.Alias(A.Sum(E.UnresolvedColumn("pay")), "s"))
    got, _ = _both(parts, build)
    assert got.column_names == ["dept", "2023", "2024"]
    pdf = _table().to_pandas()
    want = pdf.pivot_table(index="dept", columns="year", values="pay",
                           aggfunc="sum")
    rows = {r["dept"]: r for r in got.to_pylist()}
    for dept, row in want.iterrows():
        assert rows[dept]["2023"] == row[2023]
        assert rows[dept]["2024"] == row[2024]


@pytest.mark.parametrize("parts", PARTS)
def test_pivot_inferred_values_and_multi_agg(parts):
    """Values inferred (sorted, the null dropped), ``count(*)`` and a MAX
    named ``value_aggname``."""
    def build(df, E, A):
        return df.group_by("year").pivot("dept").agg(
            E.Alias(A.Count(), "n"), E.Alias(A.Max(E.UnresolvedColumn(
                "pay")), "m"), E.Alias(A.Sum(E.UnresolvedColumn("bonus")),
                                       "b"))
    got, _ = _both(parts, build)
    assert got.column_names == ["year"] + [
        f"{d}_{a}" for d in ("eng", "fin", "ops") for a in ("n", "m", "b")]
    pdf = _table().to_pandas()
    g = {r["year"]: r for r in got.to_pylist()}
    for dept in ("eng", "ops", "fin"):
        sub = pdf[pdf.dept == dept].groupby("year").agg(
            n=("pay", "size"), m=("pay", "max"))
        for year, row in sub.iterrows():
            assert g[year][f"{dept}_n"] == row["n"]
            assert g[year][f"{dept}_m"] == row["m"]


@pytest.mark.parametrize("parts", PARTS)
def test_pivot_unaliased_aggregate_and_an_integer_pivot(parts):
    """A single unaliased aggregate names columns by value alone; a value
    with no rows in a group gives a null sum and a zero count."""
    def build(df, E, A):
        f = df.filter(E.GreaterThan(E.UnresolvedColumn("pay"),
                                    E.Literal(150)))
        return f.group_by("dept").pivot("year", [2023, 2024, 1999]).agg(
            A.Sum(E.UnresolvedColumn("bonus")))
    got, _ = _both(parts, build)
    assert got.column_names == ["dept", "2023", "2024", "1999"]
    assert set(got.column("1999").to_pylist()) == {None}


def test_pivot_rejects_a_non_aggregate():
    import spark_rapids_tpu_torch.expr as texpr
    ts, _ = _sessions("1")
    with pytest.raises(TypeError, match="must be an aggregate"):
        ts.create_dataframe(_table()).group_by("dept").pivot(
            "year", [2023]).agg(texpr.UnresolvedColumn("pay"))

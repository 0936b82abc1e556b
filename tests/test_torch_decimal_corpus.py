"""The decimal texts (``spark_rapids_tpu_torch/tools/nds_decimals.py``)
from SQL over Parquet files written as Spark writes decimals, at 1 and
16 partitions: every text held to its oracle (pyarrow's cents and
Python's ``decimal``, exactly) and its placement to ``FALLBACK``; the
texts the JAX package can run held to it too, rows, types and scan
counters (``torch_dual_run``), and every text's static plan verifier
report to the reference's.

``q_dec_arith`` and ``q_dec_wide`` are held to the oracle alone: the
reference fails on a float ``IN`` list over a decimal, and cannot hold
a decimal past 18 digits (ROADMAP "Things to know").
"""
import pytest

from torch_dual_run import dual_run, run_port

from spark_rapids_tpu.analysis.plan_verifier import verify_plan as jverify
from spark_rapids_tpu.planner import TpuOverrides
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.tools import nds as jnds
from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.analysis.plan_verifier import verify_plan
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.tools import nds_decimals as nd

#: the texts the reference cannot run (module docstring)
PORT_ONLY = ("q_dec_arith", "q_dec_wide")


@pytest.fixture(scope="module")
def tables():
    return nd.decimal_tables(nds.gen_tables(1 << 12))


@pytest.fixture(scope="module")
def paths(tables, tmp_path_factory):
    return nds.write_tables(tables, str(tmp_path_factory.mktemp("nds_dec")))


@pytest.mark.parametrize("parts", [1, 16])
@pytest.mark.parametrize("q", nd.QUERIES)
def test_text_matches_oracle_and_reference(tables, paths, q, parts):
    conf = {"spark.sql.shuffle.partitions": str(parts)}
    if q in PORT_ONLY:
        got, chunks = run_port(nd.SQL_QUERIES[q], paths, conf)
        assert all(f == 0 for _, f in chunks), chunks
    else:
        got, _ = dual_run(nd.SQL_QUERIES[q], paths, conf)
    nd.check(q, got, tables)
    s = nds.session_over_files(paths, conf, device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(s.sql(nd.SQL_QUERIES[q])._node)
    assert pp.fallback_nodes() == nd.FALLBACK[q]


def test_the_reference_cannot_run_the_port_only_texts(paths):
    from torch_dual_run import run_reference
    for q in PORT_ONLY:
        with pytest.raises(Exception):
            run_reference(nd.SQL_QUERIES[q], paths)


@pytest.mark.parametrize("parts", [1, 16])
def test_verifier_reports_equal_the_reference(paths, parts):
    """Every text's plan verifies clean in both packages, with the same
    nodes checked and the same device-resident estimate (a Decimal64
    column is 8 bytes a row in both)."""
    conf = {"spark.sql.shuffle.partitions": str(parts),
            "spark.rapids.memory.device.budgetBytes": str(1 << 30)}
    for q in nd.QUERIES:
        s = nds.session_over_files(paths, conf, device="cpu")
        pp = GpuOverrides(s.conf, s.device).apply(
            s.sql(nd.SQL_QUERIES[q])._node)
        rep = verify_plan(pp.root, s.conf, s.device)
        assert rep.ok, (q, rep.summary())
        assert pp.verify_report.to_dict() == rep.to_dict()
        if q in PORT_ONLY:
            continue
        js = TpuSession(dict(conf))
        jnds.register_frames(js, {k: js.read_parquet(p)
                                  for k, p in paths.items()})
        jpp = TpuOverrides(js.conf).apply(js.sql(nd.SQL_QUERIES[q])._node)
        jrep = jverify(jpp.root, js.conf)
        assert jrep.ok, (q, jrep.summary())
        assert rep.hbm_estimate_bytes == jrep.hbm_estimate_bytes, q
        assert rep.hbm_budget_bytes == jrep.hbm_budget_bytes, q

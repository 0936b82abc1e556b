"""The nested texts (``spark_rapids_tpu_torch/tools/nds_nested.py``) on
the CPU at 2^12 store_sales lines (about 480 tickets), at 1 and 16
partitions, through both packages: one builder a text
(``build(session, E)``), run by ``tests/torch_dual_run.dual_run_frames``
(SQL for ``q_collect``, by ``dual_run``).

Each text's rows and Arrow types equal the reference's and the module's
oracle (floats rel 1e-9), its ``fallback_nodes()`` equal the reference's
and ``FALLBACK``, and its verifier report (nodes checked, the HBM
estimate and budget) equals the reference's. The reference reads the
ticket file with device decode off, since its device-decode scan reads a
nested column as nulls (``tests/test_torch_nested_columns.py``); the
port's scan counters are then held to the files: each row group's flat
columns device chunks, its nested ones host chunks (reason ``nested``).
``q_nest_fallback`` groups by a struct, which the reference's CPU
aggregate cannot hash, so its rows are held to the oracle alone.
"""
import pyarrow.parquet as pq
import pytest

from torch_dual_run import dual_run, dual_run_frames, run_port_frames

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.analysis.plan_verifier import verify_plan
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.tools import nds_nested as nn

from spark_rapids_tpu.analysis.plan_verifier import verify_plan as jverify
from spark_rapids_tpu.config import RapidsConf as JConf

BUDGET = str(1 << 30)
HOST_DECODE = {"spark.rapids.sql.format.parquet.deviceDecode.enabled":
               "false"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tables = nn.nested_tables(nds.gen_tables(1 << 12))
    paths = nn.write_tables(tables, str(tmp_path_factory.mktemp("nested")))
    return tables, paths


def _port_chunks(root, tables, paths):
    """Each device scan's ``(deviceChunks, fallbackChunks)`` from its
    file: row groups x flat columns, row groups x nested columns."""
    by_path = {p: k for k, p in paths.items()}
    out = []

    def walk(node):
        if isinstance(node, GpuFileScanExec):
            groups = dev = host = 0
            for p in node.paths:
                t = tables[by_path[p]]
                g = pq.ParquetFile(p).metadata.num_row_groups
                nested = nn.nested_columns(t)
                dev += g * (t.num_columns - nested)
                host += g * nested
            out.append((dev, host))
        for c in node.children:
            walk(c)
    walk(root)
    return out


def _same_verdicts(pp, jpp, conf):
    from spark_rapids_tpu_torch.config import RapidsConf
    rep = verify_plan(pp.root, RapidsConf(conf), "cpu")
    jrep = jverify(jpp.root, JConf(conf))
    assert rep.ok and jrep.ok, (rep.summary(), jrep.summary())
    assert rep.nodes_checked == jrep.nodes_checked
    assert rep.hbm_estimate_bytes == jrep.hbm_estimate_bytes
    assert rep.hbm_budget_bytes == jrep.hbm_budget_bytes == int(BUDGET)


@pytest.mark.parametrize("parts", [1, 16])
@pytest.mark.parametrize("q", [q for q in nn.QUERIES
                               if q != "q_nest_fallback"])
def test_text_matches_reference_and_oracle(corpus, q, parts):
    tables, paths = corpus
    conf = {"spark.sql.shuffle.partitions": str(parts),
            "spark.rapids.memory.device.budgetBytes": BUDGET}
    if q in nn.SQL_QUERIES:
        got, _ = dual_run(nn.SQL_QUERIES[q], paths, conf)
        nn.check(q, got, tables)
        return
    got, _, pp, jpp = dual_run_frames(
        nn.BUILDERS[q], paths, conf, ref_conf=HOST_DECODE,
        port_chunks=lambda pp: _port_chunks(pp.root, tables, paths),
        label=q)
    nn.check(q, got, tables)
    assert pp.fallback_nodes() == jpp.fallback_nodes() == nn.FALLBACK[q]
    _same_verdicts(pp, jpp, dict(conf, **HOST_DECODE))


@pytest.mark.parametrize("parts", [1, 16])
def test_struct_fallback_text(corpus, parts):
    from spark_rapids_tpu.planner import TpuOverrides
    from spark_rapids_tpu.session import TpuSession
    from spark_rapids_tpu.tools import nds as jnds
    from torch_dual_run import _reference_namespace
    tables, paths = corpus
    q = "q_nest_fallback"
    conf = {"spark.sql.shuffle.partitions": str(parts),
            "spark.rapids.memory.device.budgetBytes": BUDGET}
    got, chunks, pp = run_port_frames(nn.BUILDERS[q], paths, conf)
    nn.check(q, got, tables)
    assert chunks == sorted(_port_chunks(pp.root, tables, paths))
    js = TpuSession(conf=dict(conf))
    jnds.register_frames(js, {k: js.read_parquet(p)
                              for k, p in paths.items()})
    jpp = TpuOverrides(js.conf).apply(
        nn.BUILDERS[q](js, _reference_namespace())._node)
    assert pp.fallback_nodes() == jpp.fallback_nodes() == nn.FALLBACK[q]
    _same_verdicts(pp, jpp, conf)

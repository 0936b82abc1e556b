"""``sample`` and ROLLUP through Expand on the process cluster
(``GpuProcessCluster(n_workers=2, device="cpu")``, real worker
processes) against the same plans in process, the JAX package and the
texts' oracles (``tools/nds_dataframe``: ``df_sample``, ``df_rollup``)
at 16 partitions over the NDS tables at 2^12 store_sales rows. Sample's
rows depend on every row's global position, so its region must run as
one task: the map stage under its exchange has one task; Expand's region
is outside the row-wise set too (``cluster._leaf_split_ok``). Rows are
held with ``assert_same_rows`` (floats at rel 1e-9)."""
import pytest

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.cluster import GpuProcessCluster
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import ExecCtx
from spark_rapids_tpu_torch.planner import GpuOverrides
from spark_rapids_tpu_torch.tools import nds_dataframe as ndf
from torch_dual_run import assert_same_rows, run_reference_frames

STAGE_TIMEOUT = {"spark.rapids.tpu.scheduler.stageTimeout": "60",
                 "spark.rapids.tpu.task.timeout": "60"}
CONF16 = {"spark.sql.shuffle.partitions": "16"}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = GpuProcessCluster(n_workers=2, device="cpu",
                          conf=RapidsConf(dict(STAGE_TIMEOUT)),
                          root=str(tmp_path_factory.mktemp("cluster")))
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tables = nds.gen_tables(1 << 12)
    return tables, nds.write_tables(tables,
                                    str(tmp_path_factory.mktemp("nds")))


def _reference_namespace():
    from spark_rapids_tpu import datatypes, expr
    from spark_rapids_tpu.exec import TpuExpandExec
    from spark_rapids_tpu.expr import aggregates
    from spark_rapids_tpu.session import DataFrame
    return ndf.namespace(expr, aggregates, datatypes, TpuExpandExec,
                         DataFrame)


@pytest.mark.parametrize("name", ["df_sample", "df_rollup"])
def test_text_on_the_cluster_equals_in_process(cluster, data, name):
    tables, paths = data
    s = nds.session_over_files(paths, dict(CONF16, **STAGE_TIMEOUT),
                               device="cpu")
    pp = GpuOverrides(s.conf, s.device).apply(
        ndf.BUILDERS[name](s, ndf.port_namespace())._node)
    got = cluster.run_query(pp)
    local = pp.collect(ExecCtx(s.conf, "cpu"))
    assert_same_rows(got, local, ordered=False, label=name)
    want, _, _ = run_reference_frames(ndf.BUILDERS[name], paths, CONF16,
                                      _reference_namespace())
    assert_same_rows(got, want, ordered=False, label=name)
    ndf.check(name, got, ndf.oracle(name, tables))
    qid = cluster._query_seq
    maps = {e["task"] for e in cluster.last_scheduler.events
            if e["event"] == "task_ok"
            and e["task"].startswith(f"q{qid}s") and "m" in e["task"]}
    assert len(maps) == 1, maps  # the region under the exchange is whole

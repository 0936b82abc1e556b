"""The slice end to end on the CPU: TPC-H q6 from Parquet files through
the port (``GpuFileScanExec(device="cpu")`` -> filter -> project -> sum)
against the JAX package's ``build_q6`` plan over ``TpuFileScanExec``, both
with device page decode off. Three small files with several padded
batches each; one clean file set, one with nulls and NaNs. Revenue must
agree to rel 1e-9 and numOutputRows exactly. Device page decode is on
only where a test names it."""
import numpy as np
import pytest

import spark_rapids_tpu.datatypes as jdt
from bench import build_q6 as jax_build_q6
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.exec.base import ExecCtx as JCtx
from spark_rapids_tpu.exec.base import collect_arrow as jcollect
from spark_rapids_tpu.io import TpuFileScanExec
from spark_rapids_tpu_torch import datatypes as tdt
from spark_rapids_tpu_torch import tpch
from spark_rapids_tpu_torch.config import RapidsConf as TConf
from spark_rapids_tpu_torch.exec.base import ExecCtx as TCtx
from spark_rapids_tpu_torch.exec.base import collect_arrow as tcollect
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.ops import cuda_kernels as ck

ROWS = 60_000
SETTINGS = {"spark.rapids.sql.format.parquet.deviceDecode.enabled": "false",
            "spark.rapids.sql.batchSizeRows": str(1 << 15)}
NAMES = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
TYPES = ["FLOAT32", "FLOAT32", "FLOAT32", "DATE"]


def _schema(dt):
    return dt.Schema([dt.StructField(n, getattr(dt, t), True)
                      for n, t in zip(NAMES, TYPES)])


def _files(directory, dirty):
    cols = tpch.gen_lineitem(ROWS, seed=1)
    validity = None
    if dirty:
        rng = np.random.default_rng(2)
        for name in ("l_quantity", "l_discount"):
            cols[name][rng.random(ROWS) < 0.03] = np.nan
        validity = {name: rng.random(ROWS) > 0.04
                    for name in ("l_quantity", "l_extendedprice",
                                 "l_shipdate")}
    return tpch.write_lineitem(cols, str(directory), n_files=3,
                               row_group_size=1 << 14, validity=validity)


def _scan_rows(ctx):
    return [m["numOutputRows"].value for label, m in ctx.metrics.items()
            if label.startswith("FileScanExec")]


@pytest.fixture(scope="module", params=["clean", "nulls_nan"])
def fileset(request, tmp_path_factory):
    paths = _files(tmp_path_factory.mktemp(request.param),
                   request.param != "clean")
    plan, _ = jax_build_q6(TpuFileScanExec(paths, schema=_schema(jdt)))
    ctx = JCtx(JConf(dict(SETTINGS)))
    revenue = jcollect(plan, ctx).column("revenue")[0].as_py()
    return paths, revenue, _scan_rows(ctx)


def _port_q6(paths, extra=None):
    ctx = TCtx(TConf({**SETTINGS, **(extra or {})}), device="cpu")
    plan = tpch.build_q6(GpuFileScanExec(paths, schema=_schema(tdt)))
    out = tcollect(plan, ctx)
    assert out.num_rows == 1
    return out.column("revenue")[0].as_py(), ctx


def _close(got, want):
    return abs(got - want) <= 1e-9 * max(1.0, abs(want))


@pytest.mark.parametrize("extra", [
    None,
    {"spark.rapids.sql.format.parquet.reader.type": "PERFILE"},
    {"spark.rapids.sql.format.parquet.reader.type": "COALESCING"},
    {"spark.rapids.sql.scan.prefetchBatches": "0"},
    {"spark.rapids.sql.stageFusion.enabled": "false"},
], ids=["default", "perfile", "coalescing", "serial_upload", "no_fusion"])
def test_q6_from_parquet_matches_reference(fileset, extra):
    paths, want, want_rows = fileset
    launches = ck.filter_product_sum.launches
    got, ctx = _port_q6(paths, extra)
    assert _close(got, want), (got, want)
    assert _scan_rows(ctx) == want_rows == [ROWS]
    # the CPU takes K1's plain version: no kernel launch here
    assert ck.filter_product_sum.launches == launches
    dispatches = [m["kernelDispatches"].value for m in ctx.metrics.values()
                  if "kernelDispatches" in m]
    if extra is None:
        # 20,000 rows a file in batches of 1 << 15: one padded batch each
        assert dispatches == [3]
    if extra == {"spark.rapids.sql.stageFusion.enabled": "false"}:
        assert dispatches == []


def test_q6_matches_host_oracle(fileset):
    paths, want, _ = fileset
    oracle, rows = tpch.host_q6(paths)
    assert rows > 0
    assert _close(want, oracle) and _close(_port_q6(paths)[0], oracle)


def test_device_decode_is_refused(fileset):
    """Device page decode, the reference's default, is no longer refused:
    it gives the host-decode revenue. Nor is a string or a decimal column
    any more: a string or decimal field the files lack reads as nulls
    beside the same revenue."""
    paths, want, want_rows = fileset
    ctx = TCtx(TConf(), device="cpu")
    plan = tpch.build_q6(GpuFileScanExec(paths, schema=_schema(tdt)))
    got = tcollect(plan, ctx).column("revenue")[0].as_py()
    assert _close(got, want), (got, want)
    assert _scan_rows(ctx) == want_rows
    strings = tdt.Schema(list(_schema(tdt).fields)
                         + [tdt.StructField("s", tdt.STRING, True)])
    scan = tcollect(GpuFileScanExec(paths, schema=strings),
                    TCtx(TConf(), device="cpu"))
    assert scan.column("s").null_count == scan.num_rows == sum(want_rows)
    got = tcollect(tpch.build_q6(GpuFileScanExec(paths, schema=strings)),
                   TCtx(TConf(), device="cpu")).column("revenue")[0].as_py()
    assert _close(got, want), (got, want)
    decimals = tdt.Schema(list(_schema(tdt).fields)
                          + [tdt.StructField("d", tdt.DecimalType(9, 2),
                                             True)])
    scan = tcollect(GpuFileScanExec(paths, schema=decimals),
                    TCtx(TConf(), device="cpu"))
    assert scan.column("d").null_count == scan.num_rows == sum(want_rows)
    got = tcollect(tpch.build_q6(GpuFileScanExec(paths, schema=decimals)),
                   TCtx(TConf(), device="cpu")).column("revenue")[0].as_py()
    assert _close(got, want), (got, want)

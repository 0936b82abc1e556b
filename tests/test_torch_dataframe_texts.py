"""The DataFrame API's rest (``spark_rapids_tpu_torch/tools/
nds_dataframe.py``: ROLLUP through Expand, ``sample``, a pivot with
inferred values, ``hash``/``xxhash64``, ``regexp_replace``/
``regexp_extract``, and the write/read round trips through Parquet with
Hive partitions, ORC, CSV and Hive text) on the CPU at 2^12 store_sales
rows, at 1 and 16 partitions, through both packages' sessions
(``torch_dual_run.dual_run_frames``: rows and Arrow types equal, floats
rel 1e-9, scan counters equal) and against the module's oracles
(numpy, pyarrow, Python's ``re``; ``nds_dataframe.check``). Each
package writes its round trips under its own directory; the reference
writes a Hive-partitioned file's row groups as pyarrow's default
flushes them, the port one a partition, so the port's Parquet read-back
holds its scan counters to its own files. The step-0 checks of the
slice sit here too: no module of the port imports the JAX package, and
the session and the write default to the card."""
import os
import sys

import pyarrow.parquet as pq
import pytest

from torch_dual_run import dual_run_frames

from spark_rapids_tpu_torch import nds
from spark_rapids_tpu_torch.io.scan import GpuFileScanExec
from spark_rapids_tpu_torch.tools import nds_dataframe as ndf

N_SALES = 1 << 12
PARTS = ["1", "16"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tables = nds.gen_tables(N_SALES)
    paths = nds.write_tables(tables, str(tmp_path_factory.mktemp("nds")))
    return tables, paths


def _reference_namespace():
    from spark_rapids_tpu import datatypes, expr
    from spark_rapids_tpu.exec import TpuExpandExec
    from spark_rapids_tpu.expr import aggregates
    from spark_rapids_tpu.session import DataFrame
    return ndf.namespace(expr, aggregates, datatypes, TpuExpandExec,
                         DataFrame)


NAMESPACES = None


def _namespaces():
    global NAMESPACES
    if NAMESPACES is None:
        NAMESPACES = (ndf.port_namespace(), _reference_namespace())
    return NAMESPACES


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", ndf.TEXTS)
def test_text_matches_the_reference_and_its_oracle(data, name, parts):
    tables, paths = data
    got, _, pp, _ = dual_run_frames(
        ndf.BUILDERS[name], paths, {"spark.sql.shuffle.partitions": parts},
        ordered=False, label=name, namespaces=_namespaces())
    ndf.check(name, got, ndf.oracle(name, tables))
    assert not pp.fallback_nodes()


def _port_file_chunks(pp):
    """The port's device scans' chunks: its files' row groups x columns,
    none on the host."""
    out = []

    def walk(node):
        if isinstance(node, GpuFileScanExec):
            dev = sum(pq.ParquetFile(p).metadata.num_row_groups
                      * pq.ParquetFile(p).metadata.num_columns
                      for p in node.paths)
            out.append((dev, 0))
        for c in node.children:
            walk(c)
    walk(pp.root)
    return out


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("kind", ndf.ROUNDTRIPS)
def test_round_trip_matches_the_reference_and_pyarrow(data, kind, parts,
                                                      tmp_path):
    tables, paths = data
    got, _, pp, _ = dual_run_frames(
        ndf.roundtrip_builder(kind, str(tmp_path)), paths,
        {"spark.sql.shuffle.partitions": parts}, ordered=False, label=kind,
        namespaces=_namespaces(),
        port_chunks=_port_file_chunks if kind == "parquet_hive" else None)
    ndf.check(kind, got, ndf.roundtrip_oracle(kind, tables, str(tmp_path)),
              keys=got.column_names)


def test_no_module_of_the_port_imports_the_jax_package():
    """Step 0: every module of the port, this slice's among them,
    imported in a fresh process, loads neither jax nor the JAX
    package."""
    import subprocess
    code = (
        "import pkgutil, importlib, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'spark_rapids_tpu' or "
        "m.startswith('spark_rapids_tpu.')]\n"
        "print(bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1] == "[]"


def test_the_entry_points_default_to_the_card():
    """Step 0: a session, and so its reads, writes and plans, is on
    ``cuda:0`` unless the caller names the CPU."""
    import torch
    from spark_rapids_tpu_torch.exec.base import resolve_device
    from spark_rapids_tpu_torch.session import GpuSession
    if torch.cuda.is_available():
        assert GpuSession().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GpuSession()
    assert resolve_device("cpu") == torch.device("cpu")
